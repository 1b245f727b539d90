"""Kinnaes closed-form magic-series count: NTT-free roots-of-unity sum.

Re-design of reference examples/magic-series-kinnaes/kinnaes.hpp
(SURVEY.md 2.3): evaluates

    M(m) = ( 2 * sum_{j=1}^{n/2} T_j  +  C(m^2, m) ) / n   (mod N)

    T_j = prod_{l=1}^{m} (w^{j(m^2-m+l)} - 1)
          ---------------------------------------   with w a primitive n-th
          w^{j r} * prod_{l=1}^{m} (w^{j l} - 1)    root of unity, r = m^2(m-1)/2

which samples the Gaussian binomial at all n-th roots of unity and averages
out every exponent except r; exact when n > r (kinnaes.hpp:28-56 computes the
same pairing j <-> n-j into a half-range sum plus the j=0 binomial term).

Where the reference vectorizes over SVE lanes with fraction-free accumulation
(kinnaes.hpp:107-146), this version lays all n/2 values of j across a
device vector: per-lane w^j by binary powering, an m-step lax.fori_loop of
elementwise Montgomery products, Fermat batch inversion of the denominators,
and a log-depth modular sum reduction.  This doubles as the raw-modmul
throughput showcase the reference intends it to be.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..field.limb import FieldConsts, U64, u64_from_int
from ..field.modulus import Modulus


def _small_primes(limit: int):
    sieve = np.ones(limit + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(limit**0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return np.flatnonzero(sieve)


def kinnaes_length(m: int) -> int:
    """Smallest odd n > r = m^2(m-1)/2 whose prime factors all exceed m.

    The closed form needs n > r for exactness and every denominator factor
    (w^{jl} - 1, l <= m) nonzero at all n-th roots with j != 0 -- hence no
    prime factor of n may be <= m.  Single source of the n-search shared by
    ``kinnaes_parameters`` and examples/magic_series_crosscheck.
    """
    r = m * m * (m - 1) // 2
    primes = _small_primes(max(m, 3))
    n = r + 1
    if n % 2 == 0:
        n += 1
    while not all(n % int(p) for p in primes):
        n += 2
    return n


def kinnaes_parameters(m: int, bits: int = 62, skip: int = 0) -> tuple[int, int, int]:
    """(N, generator, n) for the closed form: n odd with every prime factor
    > m (so the denominator products never vanish at any n-th root of unity
    with j != 0), n > r for exactness, and N = k*n + 1 prime.

    ``skip`` returns the (skip+1)-th prime below 2^bits (descending), so a
    test matrix can collect several independent moduli per width -- the way
    the reference's generated matrix has two primes per width
    (reference test-magic-series-kinnaes.cpp:20-65).

    Role of reference generate-parameters.py (sympy) in pure Python: the
    reference likewise scans n in (r, 2r) requiring min prime factor > m,
    then collects primes N = k*n + 1.
    """
    n = kinnaes_length(m)
    # Largest primes N = k*n + 1 below 2^bits, descending.
    from ..field.modulus import find_generator, is_probable_prime

    k = ((1 << bits) - 2) // n
    while k > 0:
        N = k * n + 1
        if is_probable_prime(N):
            if skip == 0:
                return N, find_generator(N), n
            skip -= 1
        k -= 1
    raise ValueError("no prime found")


# -- host golden model (exact Python ints) ------------------------------------


def kinnaes_magic_series_count_host(
    m: int, modulus: int, generator: int, n: int
) -> int:
    """Exact host evaluation of the closed form (test oracle)."""
    N = modulus
    mod = Modulus(N, generator)
    w = mod.get_root_forward(n)
    r = m * m * (m - 1) // 2
    total = 0
    for j in range(1, n // 2 + 1):
        wj = pow(w, j, N)
        num = den = 1
        t_num = pow(wj, m * m - m + 1, N)
        t_den = wj
        for _ in range(m):
            num = num * (t_num - 1) % N
            den = den * (t_den - 1) % N
            t_num = t_num * wj % N
            t_den = t_den * wj % N
        den = den * pow(wj, r, N) % N
        total = (total + num * pow(den, N - 2, N)) % N
    comb = math.comb(m * m, m) % N
    return (2 * total + comb) * pow(n, N - 2, N) % N


# -- device implementation ----------------------------------------------------


def _mont_one(mod: Modulus, shape) -> U64:
    """Montgomery form of 1 (= R mod N) broadcast to ``shape``.

    Built with ``jnp.full`` so inside jit it traces to a scalar broadcast --
    an O(n/2) host array here would be baked into the HLO as a literal and
    re-shipped per call (CLAUDE.md: pass/construct arrays, don't close over
    them)."""
    r = mod.montgomery_r
    return U64(
        jnp.full(shape, np.uint32(r >> 32), jnp.uint32),
        jnp.full(shape, np.uint32(r & 0xFFFFFFFF), jnp.uint32),
    )


def _pow_by_lane_index(
    fc: FieldConsts, mod: Modulus, base: int, jd: jnp.ndarray, bits: int
) -> U64:
    """base^{jd} per lane in **Montgomery form**, by binary powering.

    ``jd`` is a traced uint32 lane-index array (a jit argument, not a baked
    constant) and ``bits`` the static number of index bits to scan.  All
    products run in the Montgomery domain so each step is a single
    ``mont_mul_full`` -- the squared base is a host int converted with
    ``to_montgomery`` per bit (the role of the reference's per-lane powering
    in kinnaes.hpp:107-124, restructured so no R^2 correction multiplies are
    needed on device).
    """
    from ..field.limb import u64_select

    N = mod.modulus
    result = _mont_one(mod, jd.shape)
    sq = base % N
    for b in range(bits):
        mult = fc.mont_mul_full(result, u64_from_int(mod.to_montgomery(sq)))
        take = (jd >> np.uint32(b)) & np.uint32(1) != 0
        result = u64_select(take, mult, result)
        sq = sq * sq % N
    return result


def _reduce_fractions(fc: FieldConsts, num: U64, den: U64, mul) -> tuple[U64, U64]:
    """Fraction-free log-depth reduction of sum(num[i]/den[i]).

    The reference accumulates (num_sum, den_sum) the same way across lanes
    and iterations (kinnaes.hpp:133-146, 149-158); here each level halves
    the vector: (n1, d1) + (n2, d2) -> (n1*d2 + n2*d1, d1*d2).
    """

    def slice2(x, a, b):
        return U64(x.hi[a:b], x.lo[a:b])

    n = num.lo.shape[0]
    while n > 1:
        half = n // 2
        n1, d1 = slice2(num, 0, half), slice2(den, 0, half)
        n2, d2 = slice2(num, half, 2 * half), slice2(den, half, 2 * half)
        ns = fc.add(mul(n1, d2), mul(n2, d1))
        ds = mul(d1, d2)
        if n % 2:
            ns = U64(
                jnp.concatenate([ns.hi, num.hi[2 * half :]]),
                jnp.concatenate([ns.lo, num.lo[2 * half :]]),
            )
            ds = U64(
                jnp.concatenate([ds.hi, den.hi[2 * half :]]),
                jnp.concatenate([ds.lo, den.lo[2 * half :]]),
            )
            n = half + 1
        else:
            n = half
        num, den = ns, ds
    return num, den


def kinnaes_magic_series_count(
    m: int,
    modulus: int | None = None,
    generator: int | None = None,
    n: int | None = None,
) -> int:
    """Device evaluation of the Kinnaes closed form; exact when M(m) < N.

    Every lane value is carried in the **Montgomery domain** end to end, so
    each logical product is exactly one ``mont_mul_full`` (the accumulated R
    factors cancel in the final num/den ratio) -- matching the reference's
    one-multiply-per-product inner loop (kinnaes.hpp:107-146).
    """
    if m == 1:
        return 1  # M(1) = 1; the j-lane layout below needs n > 1
    r = m * m * (m - 1) // 2
    if modulus is None:
        modulus, generator, n = kinnaes_parameters(m)
    N = modulus
    mod = Modulus(N, generator)
    if (N - 1) % n:
        raise ValueError("n must divide N - 1")
    if n <= r:
        raise ValueError("need n > r for exactness")
    fc = FieldConsts.from_modulus(mod, lazy=False)
    w = mod.get_root_forward(n)

    bits = (n // 2).bit_length()  # max lane index is n // 2
    mul = fc.mont_mul_full  # Montgomery-domain product (aR * bR -> abR)

    # Two SEPARATE jit programs, not one: compiling the powering/product
    # loop and the fraction-reduction tree into a single XLA module makes
    # XLA:CPU re-materialize the producer chain into every reduction
    # level's consumers (measured: m=8, 113 lanes, 20 s runtime in one
    # module vs ~5 ms split; optimization_barrier does not cut it).  Two
    # dispatches chain asynchronously, so the extra hop costs nothing.
    @jax.jit
    def per_lane_terms(jd):
        # jd (the O(n/2) lane-index vector) is a jit ARGUMENT and the
        # Montgomery-one vectors are in-trace broadcasts: nothing
        # O(n)-sized is closed over (closures are baked into the HLO).
        wj = _pow_by_lane_index(fc, mod, w, jd, bits)  # w^j, Mont form
        t_num0 = _pow_by_lane_index(fc, mod, pow(w, m * m - m + 1, N), jd, bits)
        one = _mont_one(mod, jd.shape)

        def body(_, carry):
            num, den, t_num, t_den = carry
            num = mul(num, fc.sub(t_num, one))
            den = mul(den, fc.sub(t_den, one))
            t_num = mul(t_num, wj)
            t_den = mul(t_den, wj)
            return num, den, t_num, t_den

        num, den, _, _ = jax.lax.fori_loop(
            0, m, body, (one, one, t_num0, wj)
        )
        den = mul(den, _pow_by_lane_index(fc, mod, pow(w, r, N), jd, bits))
        return num, den

    @jax.jit
    def reduce_terms(num, den):
        return _reduce_fractions(fc, num, den, mul)

    jd = jnp.arange(1, n // 2 + 1, dtype=jnp.uint32)
    s_num, s_den = reduce_terms(*per_lane_terms(jd))

    def scalar(x: U64) -> int:
        return (int(np.asarray(x.hi)[0]) << 32) | int(np.asarray(x.lo)[0])

    # Both sides carry the same power of R (each accumulated the same number
    # of Montgomery products level-for-level), so the ratio is exact mod N.
    s_int = scalar(s_num) * pow(scalar(s_den), N - 2, N) % N
    comb = math.comb(m * m, m) % N
    return (2 * s_int + comb) * pow(n, N - 2, N) % N
