"""q-series generators and the magic-series count via NTT convolution.

Re-design of reference examples/magic-series/ (SURVEY.md 2.3):

* ``q_pochhammer_coeffs``       <- calculate_q_pochhammer
  (gaussian-polynomial.hpp:19-45): coefficients of (q;q)_k.
* ``restricted_partition_series`` <- RestrictedPartition
  (restricted-partition.hpp): the power series of 1/(q;q)_k, whose n-th
  coefficient is p(n | parts <= k); here a vectorized numpy prefix-sum DP
  instead of the reference's streaming (k+1)^2 rolling table.
* ``gaussian_binomial_coefficient`` <- calculate_gaussian_polynomial_coefficient
  (gaussian-polynomial.hpp:148-244): extracts [q^r] qbinom(n, k) as
  numerator x (1/(q;q)_k) with the product computed by NTT convolution --
  either one padded transform or chunked block convolution that reuses a
  fixed-size NTT (the reference's overlap-free streaming division).
* ``magic_series_count``: M(m) = [q^(m^2(m-1)/2)] qbinom(m^2, m)
  (gaussian-polynomial.hpp:246-251), the end-to-end integration proof that
  forward/inverse/pointwise compose.

All coefficient vectors are canonical uint64 residues mod N.
"""

from __future__ import annotations

import numpy as np

from ..field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, Modulus
from .convolve import make_convolver, poly_multiply


def _mod_add_u64(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """(a + b) mod N elementwise for residues < N <= 2^64, pure uint64.

    The wrapping sum s = a + b mod 2^64 needs one conditional subtract: if
    it wrapped (s < a) the true sum is s + 2^64 and s - N (wrapping) is the
    reduced value; if s >= N likewise.
    """
    N = np.uint64(modulus)
    s = a + b
    return np.where((s < a) | (s >= N), s - N, s)


def _mod_sub_u64(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """(a - b) mod N elementwise for residues < N <= 2^64, pure uint64."""
    N = np.uint64(modulus)
    s = a - b
    return np.where(a < b, s + N, s)


def q_pochhammer_coeffs(
    k: int, degree: int, modulus: int, *, use_native: bool = True
) -> np.ndarray:
    """Coefficients [0..degree] of (q;q)_k = prod_{i=1}^{k} (1 - q^i) mod N.

    Iterated multiplication by (1 - q^i), truncated at ``degree``
    (reference gaussian-polynomial.hpp:19-45 without the exact-size
    requirement: truncation makes it usable as a series factor).  Served by
    the native C++ generator (native/series.cc) when available;
    ``use_native=False`` forces the numpy model (the test oracle).
    """
    if use_native:
        from .. import native

        out = native.qpochhammer(k, degree, modulus)
        if out is not None:
            return out
    coeff = np.zeros(degree + 1, dtype=np.uint64)
    coeff[0] = 1
    for i in range(1, k + 1):
        if i > degree:
            break
        coeff[i:] = _mod_sub_u64(coeff[i:], coeff[: degree + 1 - i], modulus)
    return coeff


def restricted_partition_series(
    k: int, degree: int, modulus: int, *, use_native: bool = True
) -> np.ndarray:
    """Coefficients [0..degree] of 1/(q;q)_k mod N.

    The n-th coefficient is p(n | parts <= k).  Native path: the C++
    streaming generator with the reference's O(k^2) rolling ring-buffer
    state (native/series.cc <- reference restricted-partition.hpp:37-50).
    Numpy fallback/oracle: each factor 1/(1 - q^i) applied by the binary
    telescoping identity

        (1 - x)(1+x)(1+x^2)(1+x^4)...(1+x^(2^T)) = 1 - x^(2^(T+1)),

    i.e. 1/(1 - q^i) == prod_t (1 + q^(i*2^t)) mod q^(degree+1): k*log2(r)
    full-vector shifted adds -- at the reference's m = 100 scale (k = 100,
    degree = 495,000) under a second where the naive prefix recurrence
    takes minutes.
    """
    if use_native:
        from .. import native

        stream = native.restricted_partition_stream(k, modulus)
        if stream is not None:
            with stream:
                return stream.next(degree + 1)
    c = np.zeros(degree + 1, dtype=np.uint64)
    c[0] = 1
    for i in range(1, k + 1):
        t = i
        while t <= degree:
            c[t:] = _mod_add_u64(c[t:], c[: degree + 1 - t], modulus)
            t *= 2
    return c


def _qbinom_numerator(
    n: int, k: int, degree: int, modulus: int, *, use_native: bool = True
) -> np.ndarray:
    """Coefficients [0..degree] of prod_{i=n-k+1}^{n} (1 - q^i) mod N.

    Native path evaluates the k+1 Rothe segments (native/series.cc <-
    reference gaussian-polynomial.hpp:52-146); numpy fallback is the direct
    truncated product.
    """
    if use_native and k <= n:
        from .. import native

        out = native.gauss_numerator_range(0, degree + 1, n, k, modulus)
        if out is not None:
            return out
    coeff = np.zeros(degree + 1, dtype=np.uint64)
    coeff[0] = 1
    for i in range(n - k + 1, n + 1):
        if i > degree:
            continue
        coeff[i:] = _mod_sub_u64(coeff[i:], coeff[: degree + 1 - i], modulus)
    return coeff


def gaussian_binomial_coefficient(
    n: int,
    k: int,
    r: int,
    modulus: int = FLAGSHIP_MODULUS,
    generator: int = FLAGSHIP_GENERATOR,
    *,
    ntt=None,
    chunk: int | None = None,
) -> int:
    """[q^r] of the Gaussian binomial qbinom(n, k) mod N.

    qbinom(n, k) = numerator / (q;q)_k as power series; the division is a
    multiplication by the restricted-partition series, computed on device by
    NTT convolution.  ``chunk`` selects the block-convolution path: the
    series is processed in blocks of that many coefficients reusing one
    fixed-size NTT, mirroring the reference's chunked streaming division
    (gaussian-polynomial.hpp:196-241).
    """
    inv = restricted_partition_series(k, r, modulus)
    if chunk is None:
        num = _qbinom_numerator(n, k, r, modulus)
        prod = poly_multiply(num, inv, modulus, generator, out_len=r + 1, ntt=ntt)
        return int(prod[r])
    # Block convolution: coefficient r of num * inv =
    # sum over blocks b of num: conv(num[b], inv-window) aligned at r.
    # Numerator blocks stream from the native Rothe-segment generator when
    # available (reference gaussian-polynomial.hpp:52-146 streams the
    # numerator the same way); otherwise from the materialized polynomial.
    from .. import native

    if native.available() and k <= n:

        def num_block(start: int) -> np.ndarray:
            ln = min(chunk, r + 1 - start)
            return native.gauss_numerator_range(start, ln, n, k, modulus)

    else:
        num = _qbinom_numerator(n, k, r, modulus)

        def num_block(start: int) -> np.ndarray:
            return num[start : start + chunk]

    if ntt is None:
        size = 1 << max(2, (2 * chunk - 1).bit_length())
        ntt = make_convolver(modulus, generator, size)
    acc = 0
    for start in range(0, r + 1, chunk):
        num_blk = num_block(start)
        if not num_blk.any():
            continue
        # inv window that can contribute to coefficient r via this block
        w_hi = r - start  # highest inv index needed
        w_lo = max(0, r - (start + len(num_blk) - 1))
        inv_win = inv[w_lo : w_hi + 1]
        prod = poly_multiply(num_blk, inv_win, modulus, generator, ntt=ntt)
        idx = r - start - w_lo
        if 0 <= idx < len(prod):
            acc = (acc + int(prod[idx])) % modulus
    return acc


def magic_series_count(
    m: int,
    modulus: int = FLAGSHIP_MODULUS,
    generator: int = FLAGSHIP_GENERATOR,
    **kw,
) -> int:
    """Number of magic series of order m, mod N.

    M(m) = [q^(m^2(m-1)/2)] qbinom(m^2, m)
    (reference gaussian-polynomial.hpp:246-251).  Exact as an integer
    whenever M(m) < N.
    """
    r = m * m * (m - 1) // 2
    if m == 1:
        return 1
    return gaussian_binomial_coefficient(m * m, m, r, modulus, generator, **kw)


# -- host golden model (exact Python ints, test oracle) -----------------------


def magic_series_count_exact(m: int) -> int:
    """Independent exact count via integer polynomial arithmetic.

    Coefficient extraction from prod_{i=1}^{m^2} (1 + z q^i) at z^m,
    q^(m(m^2+1)/2) -- the defining generating function, no shared code with
    the NTT pipeline (the role of the reference's big-int ground truth,
    test-magic-series.cpp:300-334).  Feasible for m <= 6.
    """
    target = m * (m * m + 1) // 2
    # dp[j][s] = number of j-subsets of {1..i} with sum s
    dp = [[0] * (target + 1) for _ in range(m + 1)]
    dp[0][0] = 1
    for i in range(1, m * m + 1):
        for j in range(min(m, i), 0, -1):
            row, prev = dp[j], dp[j - 1]
            for s in range(target, i - 1, -1):
                if prev[s - i]:
                    row[s] += prev[s - i]
    return dp[m][target]
