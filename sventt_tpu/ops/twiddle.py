"""Twiddle-factor preparation: host tables + device-side table generation.

The analogue of the reference's prepare_forward/prepare_inverse aux
stream (reference include/sventt/wrapper.hpp:34-46 and every layer's
``prepare_*``): instead of a sequentially-consumed byte arena, twiddles are
plain device arrays owned by the NTT wrapper and passed to jitted kernels as
pytree operands (SURVEY.md section 4.6).

Conventions (identical to the reference's):

* stage twiddles are stored in **Montgomery form** with their precomputed
  Montgomery companions ``wp = w * N^-1 mod 2^64`` interleaved as a parallel
  array (reference layer/sve/radix-two.hpp:34-94);
* data stays in the plain domain -- the Montgomery factor cancels because
  every multiply has exactly one Montgomery-form operand (SURVEY.md 4.3);
* the forward stage order matches the golden DIF (l = m/2 ... 1) and the
  inverse order the golden DIT (l = 1 ... m/2), with the 1/m scaling folded
  into the *last* inverse stage (reference ``inverse_factor`` mechanism,
  layer/sve/radix-eight.hpp:445-478).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import numpy as np

from ..field.limb import U64, FieldConsts, u64_from_numpy
from ..field.modulus import Modulus


class MontPair(NamedTuple):
    """A Montgomery-form twiddle array and its companion array (w, wp)."""

    w: U64
    wp: U64


def montpair_map(f, tw: MontPair) -> MontPair:
    """Apply an array transform to every limb plane of a MontPair,
    preserving a missing (None) companion -- the one place for the
    reshape/pad/transpose/slice plumbing that round 5 grew four copies
    of."""
    w = U64(f(tw.w.hi), f(tw.w.lo))
    if tw.wp is None:
        return MontPair(w, None)
    return MontPair(w, U64(f(tw.wp.hi), f(tw.wp.lo)))


@dataclass(frozen=True)
class ForwardTables:
    """Per-stage DIF twiddles for a length-m leading-axis NTT.

    ``stages[s]`` covers butterfly half-width ``l = m >> (s+1)`` and holds
    ``l`` twiddles ``omega_{2l}^j`` (Montgomery form) plus companions.
    Registered as a pytree (m static) so tables pass through jit as
    arguments rather than baked-in constants.
    """

    m: int
    stages: tuple[MontPair, ...]


@dataclass(frozen=True)
class InverseTables:
    """Per-stage DIT twiddles; the final stage is pre-scaled.

    ``stages[s]`` covers ``l = 1 << s`` with ``omegainv_{2l}^j``.  The last
    entry holds ``sw[j] = m^-1 * omegainv_m^j`` and ``scale`` holds the
    broadcast pair for ``s = m^-1`` so the final butterflies produce
    fully-scaled outputs (fc.butterfly_inverse_scaled).
    """

    m: int
    stages: tuple[MontPair, ...]
    scale: MontPair


jax.tree_util.register_dataclass(
    ForwardTables, data_fields=["stages"], meta_fields=["m"]
)
jax.tree_util.register_dataclass(
    InverseTables, data_fields=["stages", "scale"], meta_fields=["m"]
)


def _mont_pair(mod: Modulus, values_plain: list[int]) -> MontPair:
    wm = np.array([mod.to_montgomery(v) for v in values_plain], dtype=np.uint64)
    wp = np.array(
        [mod.montgomery_precompute(int(v)) for v in wm], dtype=np.uint64
    )
    return MontPair(u64_from_numpy(wm), u64_from_numpy(wp))


def _twiddle_pair(mod: Modulus, values_plain: list[int], modmul: str) -> MontPair:
    """Twiddle + companion for the configured engine (FieldConsts.modmul).

    Montgomery: (w*R mod N, w*R*N^-1 mod 2^64); Shoup: (w canonical,
    floor(w * 2^64 / N)) (reference modmul/scalar/fixed-point-64.hpp:24-40).
    """
    if modmul == "montgomery":
        return _mont_pair(mod, values_plain)
    w = np.array([v % mod.modulus for v in values_plain], dtype=np.uint64)
    if modmul == "solinas":
        # Companion-FREE plain-domain twiddles: the direct fold reduction
        # needs no precompute (FieldConsts.solinas_mul) -- half the stage
        # table bytes of the companioned engines.
        return MontPair(u64_from_numpy(w), None)
    wp = np.array(
        [mod.shoup_precompute(int(v)) for v in w], dtype=np.uint64
    )
    return MontPair(u64_from_numpy(w), u64_from_numpy(wp))


def _powers(base: int, count: int, N: int) -> list[int]:
    out, x = [], 1
    for _ in range(count):
        out.append(x)
        x = x * base % N
    return out


def forward_tables(mod: Modulus, m: int, modmul: str = "montgomery") -> ForwardTables:
    """DIF stage tables for the golden forward recursion
    (reference tests/ntt-reference.hpp:43-61 twiddle schedule)."""
    if m & (m - 1) or m < 2:
        raise ValueError("m must be a power of two >= 2")
    N = mod.modulus
    log2m = m.bit_length() - 1
    omega_2l = mod.get_root_forward(m)
    stages = []
    for i in range(log2m - 1, -1, -1):
        l = 1 << i
        stages.append(_twiddle_pair(mod, _powers(omega_2l, l, N), modmul))
        omega_2l = omega_2l * omega_2l % N
    return ForwardTables(m, tuple(stages))


def inverse_tables(
    mod: Modulus, m: int, scale_extra: int = 1, modmul: str = "montgomery"
) -> InverseTables:
    """DIT stage tables with 1/m (times ``scale_extra``) folded into the last
    stage (reference tests/ntt-reference.hpp:63-83 schedule + the
    inverse_factor fold of layer/sve/radix-eight.hpp:445-478)."""
    if m & (m - 1) or m < 2:
        raise ValueError("m must be a power of two >= 2")
    N = mod.modulus
    log2m = m.bit_length() - 1
    omegainv_m = mod.invert(mod.get_root_forward(m))
    s = mod.invert(m) * (scale_extra % N) % N
    stages = []
    for i in range(log2m):
        l = 1 << i
        omegainv_2l = pow(omegainv_m, 1 << (log2m - i - 1), N)
        tw = _powers(omegainv_2l, l, N)
        if i == log2m - 1:
            tw = [t * s % N for t in tw]  # fold scaling into final stage
        stages.append(_twiddle_pair(mod, tw, modmul))
    scale = _twiddle_pair(mod, [s], modmul)
    return InverseTables(m, tuple(stages), scale)


def sixstep_row_twiddles(mod: Modulus, n0: int, n1: int) -> MontPair:
    """The n0 x n1 inter-step twiddle matrix W[p0, j1] = omega_n^(bitrev(p0)*j1).

    This is the twiddle pass between the column and row transforms of the
    four/six-step decomposition (reference layer/sve/generic.hpp:169-268
    ``twiddle_rows_forward`` with the bitreversed row indexing of
    layer/scalar/generic.hpp:36-38).  Host-side numpy; fine up to ~2^22
    elements.  Larger transforms use the on-device generator
    ``sixstep_row_twiddles_device``.
    """
    from ..field.golden import bitreverse_permutation

    N = mod.modulus
    n = n0 * n1
    omega = mod.get_root_forward(n)
    perm = bitreverse_permutation(n0)
    rows = []
    for p0 in range(n0):
        base = pow(omega, perm[p0], N)
        rows.append(_powers(base, n1, N))
    flat = [v for row in rows for v in row]
    wm = np.array([mod.to_montgomery(v) for v in flat], dtype=np.uint64).reshape(
        n0, n1
    )
    wp = (wm * np.uint64(mod.montgomery_inverse)).astype(np.uint64)  # mod 2^64 wrap
    return MontPair(u64_from_numpy(wm), u64_from_numpy(wp))


def sixstep_row_twiddles_inverse(mod: Modulus, n0: int, n1: int) -> MontPair:
    """Inverse inter-step twiddles W[p0, j1] = omega_n^(-bitrev(p0)*j1)."""
    from ..field.golden import bitreverse_permutation

    N = mod.modulus
    n = n0 * n1
    omegainv = mod.invert(mod.get_root_forward(n))
    perm = bitreverse_permutation(n0)
    rows = []
    for p0 in range(n0):
        base = pow(omegainv, perm[p0], N)
        rows.append(_powers(base, n1, N))
    flat = [v for row in rows for v in row]
    wm = np.array([mod.to_montgomery(v) for v in flat], dtype=np.uint64).reshape(
        n0, n1
    )
    wp = (wm * np.uint64(mod.montgomery_inverse)).astype(np.uint64)
    return MontPair(u64_from_numpy(wm), u64_from_numpy(wp))


def sixstep_row_twiddles_plain(
    mod: Modulus, n0: int, n1: int, *, inverse: bool = False
) -> MontPair:
    """Host-built inter-step twiddles in PLAIN canonical form, companion-
    free -- the solinas-engine counterpart of sixstep_row_twiddles[_inverse]."""
    from ..field.golden import bitreverse_permutation

    N = mod.modulus
    omega = mod.get_root_forward(n0 * n1)
    if inverse:
        omega = mod.invert(omega)
    perm = bitreverse_permutation(n0)
    flat = [v for p0 in range(n0) for v in _powers(pow(omega, perm[p0], N), n1, N)]
    w = np.array(flat, dtype=np.uint64).reshape(n0, n1)
    return MontPair(u64_from_numpy(w), None)


def montgomery_scalar(mod: Modulus, value: int) -> MontPair:
    """A single field constant as a broadcastable Montgomery (w, wp) pair."""
    return _mont_pair(mod, [value % mod.modulus])


def _mont_precompute_device(w: U64, mod: Modulus) -> U64:
    """wp = w * N^-1 mod 2^64, computed on device (u64_mullo)."""
    from ..field.limb import u64_const_like, u64_mullo

    return u64_mullo(w, u64_const_like(mod.montgomery_inverse, w))


def sixstep_row_twiddles_device(
    mod: Modulus, n0: int, n1: int, *, inverse: bool = False,
    with_companion: bool = True, modmul: str = "montgomery",
) -> "MontPair":
    """Device-built inter-step twiddle matrix for large transforms.

    Same values as ``sixstep_row_twiddles[_inverse]`` but the n0 x n1 matrix
    is generated on-device: the host computes only the n0 per-row bases
    ``omega_n^(+-bitrev(p0))``, then a ``lax.scan`` over the n1 columns
    carries a running product -- the analogue of the reference's
    on-the-fly omega^(j*cntd) recurrence
    (reference layer/sve/generic.hpp:183-267).  O(n0) host work instead of
    O(n0*n1); required for n >= ~2^22 where host Python-int tables are too
    slow.  Results are canonical mod N (normalized), so they match the host
    tables bit-for-bit.

    ``modmul="montgomery"``: Montgomery-form values (+ optional companion).
    ``modmul="solinas"``: PLAIN canonical values, always companion-free
    (the solinas engine multiplies directly).
    """
    import jax
    import jax.numpy as jnp

    from ..field.golden import bitreverse_permutation
    from ..field.limb import FieldConsts

    N = mod.modulus
    n = n0 * n1
    omega = mod.get_root_forward(n)
    if inverse:
        omega = mod.invert(omega)
    perm = bitreverse_permutation(n0)
    fc = FieldConsts.from_modulus(mod, lazy=False, modmul=modmul)
    if modmul == "solinas":
        bases = np.array([pow(omega, p, N) for p in perm], dtype=np.uint64)
        ones = np.ones(n0, dtype=np.uint64)
        mul = fc.solinas_mul
    else:
        # Host: n0 Montgomery-form bases (cheap); device: the recurrence.
        bases = np.array(
            [mod.to_montgomery(pow(omega, p, N)) for p in perm], dtype=np.uint64
        )
        ones = np.full(n0, mod.montgomery_r, dtype=np.uint64)
        mul = fc.mont_mul_full
    base = u64_from_numpy(bases)
    one = u64_from_numpy(ones)

    @jax.jit
    def build(one: U64, base: U64) -> MontPair:
        def step(carry: U64, _):
            # carry is omega^(bitrev(p0)*j) in engine form; emit, advance.
            return mul(carry, base), carry

        _, cols = jax.lax.scan(step, one, None, length=n1)
        # cols: (n1, n0) twiddles; transpose to the (n0, n1) layout
        w = U64(jnp.transpose(cols.hi), jnp.transpose(cols.lo))
        # with_companion=False halves twiddle memory for huge n: the
        # Montgomery companion is recomputed per multiply (mont_mul_full).
        wp = (
            _mont_precompute_device(w, mod)
            if with_companion and modmul == "montgomery"
            else None
        )
        return MontPair(w, wp)

    return build(one, base)
