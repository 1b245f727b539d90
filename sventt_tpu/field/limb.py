"""64-bit modular arithmetic as paired uint32 limbs.

Every 64-bit field element is carried as a pair of uint32 arrays
``U64(hi, lo)`` and products are assembled from 16-bit partial products (4
native uint32 multiplies per 32x32->64), so the arithmetic needs nothing
wider than 32-bit integer lanes.  Whether a native uint64 path is faster on
the GPU is an open question (ROADMAP.md queue 1).  This module re-designs
the reference's modmul engines:

* ``mont_mul`` / ``mont_mul_full``  <-  PAdic64 Montgomery ("p-adic") multiply
  (reference include/sventt/modmul/scalar/p-adic-64.hpp:35-45 and
  include/sventt/modmul/sve/p-adic-64.hpp:76-115).
* ``shoup_mul``  <-  FixedPoint64 Shoup multiply
  (reference include/sventt/modmul/scalar/fixed-point-64.hpp:48-55).
* ``add_lazy`` / ``sub_lazy``  <-  the lazy [0, 2N) add/subtract with the
  branchless min-trick (reference modmul/sve/p-adic-64.hpp:40-62).
* ``butterfly_forward`` / ``butterfly_inverse`` / ``butterfly_inverse_scaled``
  <-  the DIF/DIT butterflies that live on the modmul engine in the reference
  (modmul/sve/p-adic-64.hpp:117-246), including the double-twiddle variant
  that folds the 1/m inverse scaling into the final layer (:180-223).

Everything here is shape-polymorphic pure ``jnp`` and runs identically under
XLA on any backend.

Range discipline (SURVEY.md section 4.2):  with ``lazy=True`` (requires
``bit_width(N) <= 62``) values live in the redundant range [0, 2N) and the
harness compares residues mod N; ``lazy=False`` keeps canonical [0, N) with
carry-aware paths and supports moduli up to 2^64 (the flagship modulus
``2^64 - 1827*2^31 + 1`` is 64-bit).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .modulus import MASK32, MASK64, Modulus

_U32 = jnp.uint32


class U64(NamedTuple):
    """A 64-bit unsigned integer as two uint32 limb arrays (hi, lo).

    Registered as a pytree via NamedTuple, so U64 values flow through jit
    and shard_map transparently.
    """

    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return self.lo.shape

    def astype_u64(self) -> np.ndarray:
        """Host-side: collapse to a numpy uint64 array (for tests/IO)."""
        return (np.asarray(self.hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
            self.lo, dtype=np.uint64
        )


def u64_from_int(value: int, shape=(), dtype=_U32) -> U64:
    """Broadcast a Python int constant to a U64 of the given shape."""
    value &= MASK64
    hi = jnp.full(shape, np.uint32(value >> 32), dtype=dtype)
    lo = jnp.full(shape, np.uint32(value & MASK32), dtype=dtype)
    return U64(hi, lo)


def u64_from_numpy(arr) -> U64:
    """Split a numpy uint64 (or object/int) array into uint32 limb pairs."""
    a = np.asarray(arr, dtype=np.uint64)
    return U64(
        jnp.asarray((a >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(a.astype(np.uint32)),
    )


def u64_to_numpy(x: U64) -> np.ndarray:
    return x.astype_u64()


# ---------------------------------------------------------------------------
# 32-bit primitive products
# ---------------------------------------------------------------------------


def mul32_wide(a, b) -> U64:
    """32x32 -> 64 full product via 16-bit partials (4 u32 multiplies).

    The analogue of SVE's svmul/svmulh pair
    (reference modmul/sve/p-adic-64.hpp:76-95 uses hardware 64-bit svmulh;
    here it is assembled from u16 halves in 32-bit lanes).
    """
    a_lo = a & _U32(0xFFFF)
    a_hi = a >> _U32(16)
    b_lo = b & _U32(0xFFFF)
    b_hi = b >> _U32(16)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = lh + hl
    mid_carry = (mid < lh).astype(_U32)  # carry into bit 48 => 2^16 in hi
    lo = ll + (mid << _U32(16))
    lo_carry = (lo < ll).astype(_U32)
    hi = hh + (mid >> _U32(16)) + (mid_carry << _U32(16)) + lo_carry
    return U64(hi, lo)


def mulhi32(a, b):
    """High 32 bits of a 32x32 product."""
    return mul32_wide(a, b).hi


# ---------------------------------------------------------------------------
# u64 add/sub/compare
# ---------------------------------------------------------------------------


def u64_add(a: U64, b: U64) -> U64:
    """(a + b) mod 2^64."""
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    return U64(a.hi + b.hi + carry, lo)


def u64_add_carry(a: U64, b: U64):
    """(a + b) mod 2^64 plus the carry-out bit (uint32 0/1)."""
    lo = a.lo + b.lo
    c0 = (lo < a.lo).astype(_U32)
    hi = a.hi + b.hi
    c1 = (hi < a.hi).astype(_U32)
    hi = hi + c0
    c2 = (hi < c0).astype(_U32)
    return U64(hi, lo), c1 | c2


def u64_sub(a: U64, b: U64) -> U64:
    """(a - b) mod 2^64."""
    lo = a.lo - b.lo
    borrow = (a.lo < b.lo).astype(_U32)
    return U64(a.hi - b.hi - borrow, lo)


def u64_sub_borrow(a: U64, b: U64):
    """(a - b) mod 2^64 plus the borrow-out bit (uint32 0/1)."""
    lo = a.lo - b.lo
    b0 = (a.lo < b.lo).astype(_U32)
    hi = a.hi - b.hi
    b1 = (a.hi < b.hi).astype(_U32)
    b2 = (hi < b0).astype(_U32)
    return U64(hi - b0, lo), b1 | b2


def u64_lt(a: U64, b: U64):
    """a < b as a bool array."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def u64_geq(a: U64, b: U64):
    return ~u64_lt(a, b)


def u64_select(pred, a: U64, b: U64) -> U64:
    """pred ? a : b, elementwise."""
    return U64(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


def u64_min(a: U64, b: U64) -> U64:
    """Unsigned 64-bit minimum -- the branchless lazy-reduction workhorse
    (the analogue of the reference's svmin trick,
    modmul/sve/p-adic-64.hpp:101-115)."""
    return u64_select(u64_lt(a, b), a, b)


def u64_eq_zero(a: U64):
    return (a.hi | a.lo) == _U32(0)


# ---------------------------------------------------------------------------
# u64 multiplies
# ---------------------------------------------------------------------------


def u64_mullo(a: U64, b: U64) -> U64:
    """Low 64 bits of a*b (6 VPU multiplies)."""
    p00 = mul32_wide(a.lo, b.lo)
    hi = p00.hi + a.lo * b.hi + a.hi * b.lo
    return U64(hi, p00.lo)


def u64_mul_wide(a: U64, b: U64) -> tuple[U64, U64]:
    """Full 128-bit product as (hi64, lo64) (16 VPU multiplies)."""
    p00 = mul32_wide(a.lo, b.lo)
    p01 = mul32_wide(a.lo, b.hi)
    p10 = mul32_wide(a.hi, b.lo)
    p11 = mul32_wide(a.hi, b.hi)
    # limb 1: p00.hi + p01.lo + p10.lo
    w1 = p00.hi + p01.lo
    c1 = (w1 < p00.hi).astype(_U32)
    w1b = w1 + p10.lo
    c1 = c1 + (w1b < w1).astype(_U32)
    # limb 2: p01.hi + p10.hi + p11.lo + c1
    w2 = p01.hi + p10.hi
    c2 = (w2 < p01.hi).astype(_U32)
    w2b = w2 + p11.lo
    c2 = c2 + (w2b < w2).astype(_U32)
    w2c = w2b + c1
    c2 = c2 + (w2c < c1).astype(_U32)
    # limb 3: p11.hi + c2
    w3 = p11.hi + c2
    return U64(w3, w2c), U64(w1b, p00.lo)


def u64_mulhi(a: U64, b: U64) -> U64:
    """High 64 bits of a*b."""
    return u64_mul_wide(a, b)[0]


def u64_const_like(value: int, like: U64) -> U64:
    """A scalar constant broadcastable against ``like`` (weak 0-d arrays)."""
    value &= MASK64
    return U64(_U32(value >> 32), _U32(value & MASK32))


# ---------------------------------------------------------------------------
# Sparse-modulus ("Solinas") multiply chains.
#
# NTT-friendly primes are sparse: N = c*2^s + 1 (Proth form, e.g. the test
# modulus 58*2^56 + 1) or N = 2^64 - c*2^s + 1 (Solinas form, e.g. the
# flagship 2^64 - 1827*2^31 + 1 and Goldilocks 2^64 - 2^32 + 1).  Products
# with N then reduce to one small-constant multiply plus shifts -- cutting
# the 16-multiply u64_mulhi(q, N) of Montgomery reduction to ~4.
# Detection is automatic in FieldConsts.from_modulus; the generic path
# remains for arbitrary moduli.
# ---------------------------------------------------------------------------


def solinas_capable(N: int) -> bool:
    """Whether the Solinas direct-reduction engine supports this modulus:
    high form N = 2^64 - eps with eps = c*2^s - 1 and bit_width(eps) <= 42
    (three folds converge; see u64_reduce128_sparse_high)."""
    form, c, s = detect_sparse_modulus(N)
    return form == "high" and c.bit_length() + s <= 42


def detect_sparse_modulus(N: int, max_c_bits: int = 20):
    """(form, c, s) with form 'low' (N = c*2^s + 1), 'high'
    (N = 2^64 - c*2^s + 1) or 'generic'."""
    candidates = []
    M = N - 1
    s = (M & -M).bit_length() - 1
    c = M >> s
    if c.bit_length() <= max_c_bits:
        candidates.append(("low", c, s))
    M = ((1 << 64) - N + 1) & MASK64
    if M:
        s = (M & -M).bit_length() - 1
        c = M >> s
        if c.bit_length() <= max_c_bits:
            candidates.append(("high", c, s))
    if not candidates:
        return ("generic", 0, 0)
    return min(candidates, key=lambda t: t[1])


def _mul_small_shift(q: U64, c: int, s: int):
    """(q * c) << s as four uint32 limbs (W3, W2, W1, W0), exact.

    Requires c * 2^s < 2^64 (guaranteed when c*2^s + 1 or 2^64 - c*2^s + 1
    is the modulus), so the 128-bit result never overflows.  ``c`` and ``s``
    are Python ints -- the multiplies are by scalar constants and XLA folds
    the zero partial products of small c.
    """
    cc = _U32(c)
    lo_p = mul32_wide(q.lo, cc)  # q.lo * c
    hi_p = mul32_wide(q.hi, cc)  # q.hi * c
    # q*c = T2*2^64 + T1*2^32 + T0
    t0 = lo_p.lo
    t1 = lo_p.hi + hi_p.lo
    carry = (t1 < lo_p.hi).astype(_U32)
    t2 = hi_p.hi + carry
    limbs = [t0, t1, t2, jnp.zeros_like(t0)]
    # shift left by s across 32-bit limbs
    ls, sb = divmod(s, 32)
    out = []
    for i in range(4):
        w = jnp.zeros_like(t0)
        src = i - ls
        if 0 <= src < 4:
            w = w | (limbs[src] << _U32(sb)) if sb else limbs[src]
        if sb and 0 <= src - 1 < 4:
            w = w | (limbs[src - 1] >> _U32(32 - sb))
        out.append(w)
    return out[3], out[2], out[1], out[0]


def u64_mulhi_sparse(q: U64, form: str, c: int, s: int) -> U64:
    """hi64(q * N) for a sparse modulus N (exact; range [0, N))."""
    w3, w2, w1, w0 = _mul_small_shift(q, c, s)
    if form == "low":
        # q*N = (q*c << s) + q: add q at the bottom, propagate carries up.
        y0 = w0 + q.lo
        c0 = (y0 < w0).astype(_U32)
        y1 = w1 + q.hi
        c1 = (y1 < w1).astype(_U32)
        y1b = y1 + c0
        c1 = c1 | (y1b < c0).astype(_U32)
        y2 = w2 + c1
        c2 = (y2 < c1).astype(_U32)
        y3 = w3 + c2
        return U64(y3, y2)
    # high: q*N = q*2^64 - Y with Y = (q*c << s) - q >= 0;
    # hi64 = q - hi64(Y) - (lo64(Y) != 0).
    y0 = w0 - q.lo
    b0 = (w0 < q.lo).astype(_U32)
    y1 = w1 - q.hi
    b1 = (w1 < q.hi).astype(_U32)
    y1b = y1 - b0
    b1 = b1 | (y1 < b0).astype(_U32)
    y2 = w2 - b1
    b2 = (w2 < b1).astype(_U32)
    y3 = w3 - b2
    hi = u64_sub(q, U64(y3, y2))
    nz = ((y1b | y0) != _U32(0)).astype(_U32)
    return u64_sub(hi, U64(jnp.zeros_like(nz), nz))


def u64_mullo_sparse(q: U64, form: str, c: int, s: int) -> U64:
    """lo64(q * N) for a sparse modulus N."""
    w3, w2, w1, w0 = _mul_small_shift(q, c, s)
    del w3, w2
    p = U64(w1, w0)
    if form == "low":
        return u64_add(p, q)  # lo64((q*c << s) + q)
    return u64_sub(q, p)  # lo64(q*(2^64 - c*2^s + 1)) = lo64(q - (q*c << s))


# ---------------------------------------------------------------------------
# Solinas direct reduction: a*w mod N from the raw 128-bit product, for
# "high"-form sparse moduli N = 2^64 - eps with eps = c*2^s - 1 small
# (flagship 2^64 - 1827*2^31 + 1: eps < 2^42; Goldilocks 2^64 - 2^32 + 1:
# eps = 2^32 - 1).  The identity 2^64 === eps (mod N) folds the high
# word repeatedly: hi*2^64 + lo === hi*eps + lo, and hi*eps =
# (hi*c << s) - hi is a small-constant multiply chain.  Three folds plus a
# masked carry fold land in [0, 2^64); one min-subtract yields canonical
# [0, N) (for these N, r >= N implies r - N < eps, so a single fold
# suffices from the full u64 range).
#
# This is the 64-bit analogue of the Shoup engine (companion-FREE, plain-
# domain twiddles): where Shoup needs bit_width(N) <= 63 for its [0, 2N)
# output, Solinas needs sparseness instead -- exactly what the >= 63-bit
# NTT moduli have.  Reference role: the store_precomputation=false
# compute-for-bytes trade (reference layer/sve/radix-two.hpp:96-138),
# realized as an alternative modmul engine rather than a twiddle
# recurrence.
# ---------------------------------------------------------------------------


def _fold_eps(hi: U64, lo: U64, c: int, s: int):
    """(hi, lo) -> (hi', lo') with hi'*2^64 + lo' = hi*eps + lo, exact.

    hi*eps = (hi*c << s) - hi with c*2^s - 1 = eps < 2^64, so the 128-bit
    intermediate (w3, w2, w1, w0) never overflows.
    """
    w3, w2, w1, w0 = _mul_small_shift(hi, c, s)
    t, brw = u64_sub_borrow(U64(w1, w0), hi)
    u, cry = u64_add_carry(t, lo)
    top = u64_sub(U64(w3, w2), U64(jnp.zeros_like(brw), brw))
    top = u64_add(top, U64(jnp.zeros_like(cry), cry))
    return top, u


def u64_reduce128_sparse_high(hi: U64, lo: U64, c: int, s: int) -> U64:
    """(hi*2^64 + lo) mod N in [0, 2^64) for N = 2^64 - (c*2^s - 1).

    Requires bit_width(eps) = bit_width(c) + s <= 42 so three folds
    converge (flagship: 42; Goldilocks: 32).  The result is a u64
    representative; callers wanting canonical [0, N) apply the single
    min-fold (see FieldConsts.solinas_mul).
    """
    # fold 1: H < 2^64 -> H1 < 2^(eps_bits + 1)
    h1, l1 = _fold_eps(hi, lo, c, s)
    # fold 2: H1 small -> H2 < 2^(2*eps_bits - 64 + 1)
    h2, l2 = _fold_eps(h1, l1, c, s)
    # fold 3: H2 fits one limb; H2*eps < 2^(3*eps_bits - 64) <= 2^62 fits u64
    h2c = mul32_wide(h2.lo, _U32(c))
    ls, sb = divmod(s, 32)
    if ls == 0:
        y = U64(
            (h2c.hi << _U32(sb)) | (h2c.lo >> _U32(32 - sb)) if sb else h2c.hi,
            h2c.lo << _U32(sb) if sb else h2c.lo,
        )
    else:  # s in [32, 64): low limb of h2c shifts into the high limb
        y = U64(h2c.lo << _U32(sb) if sb else h2c.lo, jnp.zeros_like(h2c.lo))
    y = u64_sub(y, h2)  # h2*eps = (h2*c << s) - h2, no borrow (eps >= 1)
    r, c3 = u64_add_carry(y, l2)
    # fold 4: masked + eps on the final carry; cannot re-carry (wrapped
    # r < eps implies r + eps < 2*eps < 2^64)
    eps = (c << s) - 1
    mask = jnp.zeros_like(c3) - c3
    return u64_add(
        r, U64(mask & _U32(eps >> 32), mask & _U32(eps & MASK32))
    )


# ---------------------------------------------------------------------------
# Modulus-bound engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldConsts:
    """All compile-time constants the device kernels need for one modulus.

    The analogue of binding ``Modulus<N, g>`` into a modmul engine type
    (reference modmul/scalar/p-adic-64.hpp:11-14).  Constructed on the host,
    every field is a Python int baked into the traced program as a literal.
    """

    modulus: int
    montgomery_inverse: int  # N^-1 mod 2^64
    lazy: bool  # values in [0, 2N) vs canonical [0, N)
    #: Twiddle-multiply engine: "montgomery" (PAdic64, reference
    #: modmul/sve/p-adic-64.hpp), "shoup" (FixedPoint64, reference
    #: modmul/scalar/fixed-point-64.hpp), or "solinas" (companion-free
    #: direct fold reduction for sparse-high >= 63-bit moduli -- the
    #: 64-bit analogue of Shoup; twiddles plain-domain, no wp array).
    #: Shoup needs one fewer u64 multiply per butterfly but requires
    #: bit_width(N) <= 62 here (lazy range discipline); pointwise
    #: data*data products always use Montgomery (Shoup needs a
    #: precomputed companion).
    modmul: str = "montgomery"
    #: Sparse-modulus (Solinas/Proth) multiply chain for products with N:
    #: "low" (N = c*2^s + 1), "high" (N = 2^64 - c*2^s + 1) or "generic".
    #: Auto-detected; cuts the hi64(q*N) of Montgomery reduction from 16
    #: multiplies to ~4 (all test/flagship/Goldilocks moduli qualify).
    n_form: str = "generic"
    n_c: int = 0
    n_s: int = 0

    @classmethod
    def from_modulus(
        cls, mod: Modulus, lazy: bool | None = None, modmul: str = "montgomery"
    ) -> "FieldConsts":
        if lazy is None:
            lazy = mod.bit_width <= 62
        if lazy and mod.bit_width > 62:
            raise ValueError(
                "lazy [0,2N) arithmetic requires bit_width(N) <= 62; "
                f"modulus has {mod.bit_width} bits"
            )
        if modmul == "auto":
            # Montgomery by default; the size-dependent choice lives in
            # plan/wrapper.py _resolve_modmul.
            modmul = "montgomery"
        if modmul not in ("montgomery", "shoup", "solinas"):
            raise ValueError(f"unknown modmul engine {modmul!r}")
        if modmul == "shoup" and not lazy:
            raise ValueError("shoup engine requires lazy mode (bit_width <= 62)")
        form, c, s = detect_sparse_modulus(mod.modulus)
        if modmul == "solinas" and not solinas_capable(mod.modulus):
            raise ValueError(
                "solinas engine requires a sparse-high modulus "
                "N = 2^64 - (c*2^s - 1) with bit_width(c*2^s) <= 42"
            )
        return cls(mod.modulus, mod.montgomery_inverse, lazy, modmul, form, c, s)

    def _mulhi_n(self, q: U64) -> U64:
        """hi64(q * N) via the sparse chain when the modulus allows."""
        if self.n_form != "generic":
            return u64_mulhi_sparse(q, self.n_form, self.n_c, self.n_s)
        return u64_mulhi(q, u64_const_like(self.modulus, q))

    def _mullo_n(self, q: U64) -> U64:
        """lo64(q * N) via the sparse chain when the modulus allows."""
        if self.n_form != "generic":
            return u64_mullo_sparse(q, self.n_form, self.n_c, self.n_s)
        return u64_mullo(q, u64_const_like(self.modulus, q))

    # -- addition/subtraction ------------------------------------------------

    def add(self, a: U64, b: U64) -> U64:
        """a + b staying in-range.

        lazy: [0,2N) inputs/outputs via the min-trick (needs 4N < 2^64);
        canonical: [0,N) with carry-aware wrap for 63/64-bit moduli
        (reference modmul/sve/p-adic-64.hpp:40-62 dual paths).
        """
        if self.lazy:
            s = u64_add(a, b)  # < 4N < 2^64
            return u64_min(s, u64_sub(s, u64_const_like(2 * self.modulus, s)))
        s, carry = u64_add_carry(a, b)
        n = u64_const_like(self.modulus, s)
        wrapped = u64_sub(s, n)
        take_wrapped = (carry != _U32(0)) | u64_geq(s, n)
        return u64_select(take_wrapped, wrapped, s)

    def sub(self, a: U64, b: U64) -> U64:
        """a - b staying in-range."""
        if self.lazy:
            # a - b + 2N in (0, 4N) then min-reduce back to [0, 2N)
            d = u64_add(u64_sub(a, b), u64_const_like(2 * self.modulus, a))
            return u64_min(d, u64_sub(d, u64_const_like(2 * self.modulus, d)))
        d, borrow = u64_sub_borrow(a, b)
        fixed = u64_add(d, u64_const_like(self.modulus, d))
        return u64_select(borrow != _U32(0), fixed, d)

    def normalize(self, a: U64) -> U64:
        """Map [0, 2N) -> canonical [0, N) (reference multiply_normalize's
        min(c, c-N) trick, modmul/sve/p-adic-64.hpp:101-115)."""
        if not self.lazy:
            return a
        return u64_min(a, u64_sub(a, u64_const_like(self.modulus, a)))

    # -- Montgomery multiply ---------------------------------------------------

    def mont_mul(self, a: U64, w: U64, wp: U64) -> U64:
        """Montgomery multiply with a precomputed companion.

        ``w`` is a twiddle in Montgomery form, ``wp = w * N^-1 mod 2^64`` its
        companion (prepared host-side).  Returns
        ``hi64(a*w) - hi64(lo64(a*wp) * N) + N``:

        * lazy mode: result in (0, 2N) -- identical contract to reference
          modmul/scalar/p-adic-64.hpp:35-45; valid for any ``a`` with
          ``a * w < 2^64 * N``.
        * canonical mode: conditionally subtract N for a [0, N) result.
        """
        q = u64_mullo(a, wp)
        ab1 = u64_mulhi(a, w)
        return self._redc_finish(ab1, q)

    def _redc_finish(self, ab1: U64, q: U64) -> U64:
        """Shared tail of both Montgomery multiplies: ab1 - hi64(q*N), with
        the +N bias (lazy, (0,2N) result; reference sve/p-adic-64.hpp:88-89)
        or borrow-conditional +N (canonical [0,N) for 63/64-bit moduli;
        reference sve/p-adic-64.hpp:90-92)."""
        qn1 = self._mulhi_n(q)
        if self.lazy:
            return u64_add(u64_sub(ab1, qn1), u64_const_like(self.modulus, ab1))
        d = u64_sub(ab1, qn1)
        fixed = u64_add(d, u64_const_like(self.modulus, d))
        return u64_select(u64_lt(ab1, qn1), fixed, d)

    def mont_mul_full(self, a: U64, b: U64) -> U64:
        """Montgomery multiply without a precomputed companion.

        Computes the companion on the fly (``q = lo64(a*b) * N^-1``): used by
        device-side twiddle-table generation and pointwise products where the
        right operand is data, not a prepared constant (the role of reference
        modmul/scalar/p-adic-64.hpp:31-33 which calls precompute inline).
        """
        ab_hi, ab_lo = u64_mul_wide(a, b)
        q = u64_mullo(ab_lo, u64_const_like(self.montgomery_inverse, ab_lo))
        return self._redc_finish(ab_hi, q)

    def shoup_mul(self, a: U64, w: U64, wp: U64) -> U64:
        """Shoup multiply: a*w - hi64(a*wp)*N, result in [0, 2N).

        ``wp = floor(w * 2^64 / N)`` prepared host-side
        (reference modmul/scalar/fixed-point-64.hpp:48-55).  ``w`` is in the
        plain domain, any ``a < 2^64`` is accepted; requires
        bit_width(N) <= 63 so [0, 2N) fits in 64 bits.
        """
        if self.modulus.bit_length() > 63:
            raise ValueError("Shoup multiply requires bit_width(N) <= 63")
        hi = u64_mulhi(a, wp)
        t = self._mullo_n(hi)
        c = u64_sub(u64_mullo(a, w), t)
        if self.lazy:
            return c
        return u64_min(c, u64_sub(c, u64_const_like(self.modulus, c)))

    def solinas_mul(self, a: U64, w: U64) -> U64:
        """Companion-free direct multiply: a*w mod N, canonical [0, N).

        ``w`` is a PLAIN-domain twiddle (no Montgomery factor, no
        companion array): the full 128-bit product is folded down via
        2^64 === eps (mod N) for sparse-high N (u64_reduce128_sparse_high),
        then one min-subtract canonicalizes -- for these N, r >= N implies
        r - N < eps, so a single fold covers the whole u64 range.  Accepts
        any ``a`` < 2^64.  The 64-bit analogue of shoup_mul (which needs
        bit_width(N) <= 63); requires FieldConsts.n_form == "high".
        """
        hi, lo = u64_mul_wide(a, w)
        r = u64_reduce128_sparse_high(hi, lo, self.n_c, self.n_s)
        return u64_min(r, u64_sub(r, u64_const_like(self.modulus, r)))

    # -- butterflies -------------------------------------------------------------

    def twiddle_mul(self, a: U64, w: U64, wp: U64 | None) -> U64:
        """Multiply by a prepared twiddle pair, via the configured engine.

        Montgomery: ``w`` in Montgomery form, ``wp = w * N^-1 mod 2^64``.
        Shoup: ``w`` plain canonical, ``wp = floor(w * 2^64 / N)``.
        Solinas: ``w`` plain canonical, no companion (``wp`` ignored).
        Table builders (ops/twiddle.py) prepare the matching companion.
        """
        if self.modmul == "shoup":
            return self.shoup_mul(a, w, wp)
        if self.modmul == "solinas":
            return self.solinas_mul(a, w)
        return self.mont_mul(a, w, wp)

    def butterfly_forward(self, x0: U64, x1: U64, w: U64, wp: U64) -> tuple[U64, U64]:
        """DIF (Gentleman-Sande) butterfly: (x0 + x1, (x0 - x1) * w).

        Reference modmul/sve/p-adic-64.hpp:142-178.  In lazy mode the
        difference is biased by +2N before the twiddle multiply so the
        multiplicand stays in (0, 4N) (reference layer/scalar/radix-two.hpp:50
        applies the same +2N bias).
        """
        y0 = self.add(x0, x1)
        if self.lazy:
            d = u64_add(u64_sub(x0, x1), u64_const_like(2 * self.modulus, x0))
        else:
            d = self.sub(x0, x1)
        return y0, self.twiddle_mul(d, w, wp)

    def butterfly_forward_notwiddle(self, x0: U64, x1: U64) -> tuple[U64, U64]:
        """DIF butterfly with w == 1 (reference modmul/sve/p-adic-64.hpp:117-140)."""
        return self.add(x0, x1), self.sub(x0, x1)

    def butterfly_inverse(self, x0: U64, x1: U64, w: U64, wp: U64) -> tuple[U64, U64]:
        """DIT butterfly: t = x1 * w; (x0 + t, x0 - t)
        (reference modmul/sve/p-adic-64.hpp:225-246)."""
        t = self.twiddle_mul(x1, w, wp)
        return self.add(x0, t), self.sub(x0, t)

    def butterfly_inverse_scaled(
        self, x0: U64, x1: U64, s: U64, sp: U64, sw: U64, swp: U64
    ) -> tuple[U64, U64]:
        """Final-layer DIT butterfly with both outputs twiddled:
        (x0*s + x1*sw, x0*s - x1*sw) where s = m^-1 and sw = m^-1 * w.

        Folds the 1/m inverse scaling into the last layer exactly like the
        reference's two-twiddle butterfly / ``inverse_factor`` mechanism
        (reference modmul/sve/p-adic-64.hpp:180-223,
        layer/sve/radix-eight.hpp:445-478).
        """
        a = self.twiddle_mul(x0, s, sp)
        b = self.twiddle_mul(x1, sw, swp)
        return self.add(a, b), self.sub(a, b)
