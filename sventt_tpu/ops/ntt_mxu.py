"""Matrix-NTT engine: small-m NTTs as int8 limb-plane matmuls.

The second leaf engine (next to jnp): a length-m NTT (m <= MAX_MXU) is
evaluated as the dense matrix product

  forward:  X[p] = sum_j  M[p, j] * x[j],   M[p, j] = R64 * omega^(bitrev(p)*j)
  inverse:  x[k] = sum_p  Mi[k, p] * y[p],  Mi[k, p] = R64 * s * omega^(-k*bitrev(p))

(s = m^-1 * scale_extra; R64 = 2^64 mod N -- the Montgomery factor that
cancels the final REDC), which matches the golden DIF output order /
DIT input order exactly, so matrix leaves compose freely with every other
engine in the plan tree.

Mechanics -- two plane schemes, selected by ``scheme``:

* ``"s8"`` (default, round 5): the matrix entry M[p,j] is lifted to its
  minimal-magnitude residue r in (-N/2, N/2] and decomposed into EIGHT
  balanced base-256 digits d_a in [-128, 127] (8 digits represent exactly
  [-128*K, 127*K] with K = (2^64-1)/255, a range of width 2^64-1 >= N-1,
  so the minimal residue ALWAYS fits).  Each data element splits into
  eight offset-encoded byte planes s_b = byte_b - 128 in [-128, 127].
  8 int8 x int8 -> int32 dots (stacked (8m, m) matrix) produce 15 output
  planes P_t = sum_{a+b=t}; the identity
      sum_j r[p,j] * x_j = sum_t P_t * 2^(8t) + 128*K8*rowsum_p
  (K8 = 0x0101010101010101) folds ALL offset corrections into one
  precomputed per-row constant, which also absorbs the +m<<17 bias
  (the exact worst-case |P_t|) that makes each plane non-negative
  before the u32 word accumulation.
  Versus "u7": 64 vs 100 MAC plane-pairs, 15 vs 19 recombination planes,
  byte-aligned extraction (no bit-straddle shifts).

* ``"s8b"``: the s8 digits laid out as one block-banded (15m, 8m) matrix,
  so ONE int8 matmul against the stacked byte planes yields the 15 output
  planes directly: 120 instead of 64 m^2 MACs, but 15 instead of 64 int32
  product planes per point written by the matmul.

* ``"u7"``: NL = 10 unsigned seven-bit planes for both matrix and data;
  2*NL-1 = 19 int32 product planes recombine directly.  Kept as the A/B
  baseline.

Either way the product planes recombine elementwise into a 6-word 192-bit
value, the top 64 bits fold via 2^128 mod N, and one subtractive
Montgomery REDC (companion computed from the low 64 bits) lands in
canonical [0, N).

Exactness bounds (s8): |d_a * s_b| <= 2^14; each output plane sums over
j (m terms) and at most 8 (a,b) pairs: |P_t| <= 8 * m * 2^14 = m << 17
-- int32-safe after the m-dependent +m<<17 bias (2^27 at the MAX_MXU
m = 1024; u7: m * NL * 127^2 < 2^31).  The 6-word accumulator holds the
exact non-negative integer (< 2^142 at m = 1024); fold + REDC reduce
any value < 2^192 correctly (REDC needs T_hi < N after the fold -- see
the Barrett/conditional-subtract step).

Everything is plain XLA: the int8 x int8 -> int32 products are
``lax.dot_general`` calls, which XLA hands to the GPU's integer tensor-core
GEMM, and the recombination tail is elementwise code that XLA fuses.  The
six-step inter-step twiddle multiply is applied as plain ops right before
the matrix (forward) or right after it (inverse), where XLA fuses it into
the plane extraction or the recombination.

Reference role: the radix-R throughput kernel
(reference include/sventt/layer/sve/radix-eight.hpp:95-234) realized on
matrix units instead of vector registers.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..field.limb import (
    U64,
    FieldConsts,
    detect_sparse_modulus,
    mul32_wide,
    u64_add,
    u64_add_carry,
    u64_const_like,
    u64_lt,
    u64_mulhi,
    u64_mulhi_sparse,
    u64_mullo,
    u64_mullo_sparse,
    u64_select,
    u64_sub,
)
from ..field.modulus import Modulus
from .twiddle import montpair_map

#: 7-bit limb planes per u64 for the "u7" scheme (10 * 7 = 70 >= 64 bits).
NL = 10

#: Balanced-digit planes for the "s8" scheme: 8 signed base-256 matrix
#: digits x 8 offset-encoded data bytes -> 15 output planes.
NL_S8 = 8

#: Largest matrix-NTT length: the s8 int32 accumulator bound
#: (8 pairs * m * 2^14 < 2^31) allows up to m = 2048; 1024 keeps the
#: (8m, m) int8 matrix at 8 MB and gives 2^28 a 3-level plan
#: (1024*512*512) and 2^18-2^20 2-level plans.  The u7 scheme's bound
#: (m * NL * 127^2 < 2^31) also holds at 1024.
MAX_MXU = 1024

#: Plane scheme of the tables the planner builds (see the module docstring).
SCHEME = "s8b"


def max_m(scheme: str | None = None) -> int:
    """Largest transform length a scheme supports: the banded s8b matrix
    is 120*m^2 bytes, so it stops at 512 (31.5 MB)."""
    return 512 if (scheme or SCHEME) == "s8b" else MAX_MXU

#: Largest value representable by 8 balanced base-256 digits:
#: 127 * (256^8 - 1)/255.  Minimal-magnitude residues r = v or v - N
#: (whichever lands in [-128*K8, C8_PLUS]) always exist since the two
#: ranges jointly span 2^64 - 1 >= N - 1 values.
_K8 = (1 << 64) // 255  # 0x0101010101010101
C8_PLUS = 127 * _K8


def _balanced8(r: int) -> list[int]:
    """EXACT balanced base-256 digits of r in [-128*K8, C8_PLUS].

    Greedy round-to-nearest (ties toward -128) is complete on exactly
    that range: eight digits d_a in [-128, 127] with sum d_a*256^a = r.
    """
    ds = []
    for _ in range(8):
        b = ((r + 128) & 0xFF) - 128
        ds.append(b)
        r = (r - b) >> 8
    assert r == 0, "residue outside the 8-digit balanced range"
    return ds

def _mat_dims(scheme: str, m: int) -> tuple[int, int]:
    """(rows, cols) of the stacked matrix operand for one scheme."""
    if scheme == "s8b":
        return 15 * m, NL_S8 * m
    if scheme == "s8":
        return NL_S8 * m, m
    return NL * m, m


@dataclass(frozen=True)
class MxuDirection:
    """Prepared tables for one direction at one length.

    ``planes``: the stacked digit planes of the DFT matrix in
    Montgomery-lifted form: (NP*m, m) int8 with NP = 8 balanced signed
    digits for scheme "s8" and NL = 10 unsigned 7-bit planes for "u7";
    the (15m, 8m) banded layout for "s8b".  ``corr``: (m,) U64, the
    per-output-row offset-correction constant of the s8 schemes (None for
    u7).  ``c128`` / ``nprime`` / ``modulus``: per-modulus Python-int
    constants baked into the traced program as literals.
    """

    m: int
    inverse: bool
    planes: jnp.ndarray
    corr: U64 | None
    modulus: int
    c128: int  # 2^128 mod N
    nprime: int  # N^-1 mod 2^64
    scheme: str = "s8"


jax.tree_util.register_dataclass(
    MxuDirection,
    data_fields=["planes", "corr"],
    meta_fields=["m", "inverse", "modulus", "c128", "nprime", "scheme"],
)


def make_mxu_tables(
    mod: Modulus, m: int, *, inverse: bool, scale_extra: int = 1,
    scheme: str | None = None,
) -> MxuDirection:
    """Host-build the limb-plane matrix for one direction (``scheme``
    None = the module default ``SCHEME``)."""
    scheme = scheme or SCHEME
    from ..field.golden import bitreverse_permutation

    if scheme not in ("s8", "s8b", "u7"):
        raise ValueError(f"unknown mxu plane scheme {scheme!r}")
    if m < 2 or m & (m - 1) or m > max_m(scheme):
        raise ValueError(
            f"mxu scheme {scheme!r} supports power-of-two m in [2, {max_m(scheme)}]"
        )
    N = mod.modulus
    perm = bitreverse_permutation(m)
    r64 = (1 << 64) % N
    M = np.zeros((m, m), dtype=object)
    if not inverse:
        omega = mod.get_root_forward(m)
        for p in range(m):
            base = pow(omega, perm[p], N)
            v = r64
            for j in range(m):
                M[p, j] = v
                v = v * base % N
    else:
        omegainv = mod.invert(mod.get_root_forward(m))
        s = mod.invert(m) * (scale_extra % N) % N
        for k in range(m):
            base = pow(omegainv, k, N)
            for p in range(m):
                M[k, p] = pow(base, perm[p], N) * s % N * r64 % N
    corr = None
    if scheme in ("s8", "s8b"):
        # Minimal-magnitude residues, 8 balanced digits each; the per-row
        # constant folds the data-plane offset (+128 per byte) and the
        # output-plane bias (+2^26 per plane) into one mod-N value.
        R = np.where(M <= C8_PLUS, M, M - N)  # object; |r| <= 128*K8
        # digit 0 in exact object arithmetic (negative residues reach
        # -128*K8, just past int64 min); the quotient then fits int64
        d0 = ((R + 128) % 256) - 128
        digs = [d0.astype(np.int8)]
        r = np.array(
            [[int(v) for v in row] for row in (R - d0) // 256],
            dtype=np.int64,
        )
        for _ in range(1, NL_S8):
            d = ((r + 128) & 0xFF) - 128  # vectorized balanced digit
            digs.append(d.astype(np.int8))
            r = (r - d) >> 8  # exact: r - d divisible by 256
        assert not r.any(), "residue outside the 8-digit balanced range"
        if scheme == "s8b":
            # Block-banded (15m, 8m) matrix: output plane t's row block
            # holds digit plane d_{t-b} at data-plane column block b, so
            # ONE int8 matmul against the stacked (8m, B) byte planes
            # yields the 15 output planes directly -- the 49 per-point
            # plane-merge adds of the "s8" tail move into the matmul
            # (120 vs 64 m^2 MACs).
            G = np.zeros((15 * m, NL_S8 * m), dtype=np.int8)
            for tt in range(15):
                for b in range(NL_S8):
                    a = tt - b
                    if 0 <= a < NL_S8:
                        G[tt * m:(tt + 1) * m, b * m:(b + 1) * m] = digs[a]
            planes_np = G
        else:
            planes_np = np.concatenate(digs, axis=0)
        # per-plane bias m << 17 == the exact worst-case |P_t| (see
        # _mxu_body); must match the kernel's literal
        ofs_total = (m << 17) * sum(1 << (8 * t) for t in range(15))
        rowsums = R.sum(axis=1)  # object dtype: exact Python-int sums
        corr_vals = np.array(
            [(128 * _K8 * int(v) - ofs_total) % N for v in rowsums],
            dtype=object,
        )
        corr = U64(
            jnp.asarray([int(v) >> 32 for v in corr_vals], dtype=jnp.uint32),
            jnp.asarray(
                [int(v) & 0xFFFFFFFF for v in corr_vals], dtype=jnp.uint32
            ),
        )
    else:
        planes_np = np.concatenate(
            [((M >> (7 * i)) & 0x7F).astype(np.int8) for i in range(NL)],
            axis=0,
        )
    return MxuDirection(
        m, inverse, jnp.asarray(planes_np), corr, N, pow(2, 128, N),
        pow(N, -1, 1 << 64), scheme,
    )


def _mxu_body(t: MxuDirection, xh, xl, axis: int) -> U64:
    """u32 limb pair -> canonical U64: the length-m transform along ``axis``.

    The int8 products are ``lax.dot_general`` calls.  Their output is
    transform-major, (rows, rest...), unless the transform axis is the
    data's last axis: then the dot contracts that axis and its output
    (rest..., rows) is already in the data layout.  The elementwise
    recombination runs in whichever layout the dot produced, and the
    result moves back to ``axis`` at the end (a no-op for the leading and
    last axes).
    """
    m = t.m
    mm = t.planes
    nd = xh.ndim
    minor = nd > 1 and axis == nd - 1
    s8 = t.scheme in ("s8", "s8b")
    banded = t.scheme == "s8b"
    np_in = NL_S8 if s8 else NL  # input (data) planes
    n_out = 15 if s8 else 2 * NL - 1

    def dot(X):
        if minor:
            return jax.lax.dot_general(
                X, mm, (((nd - 1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )  # (rest..., rows)
        return jax.lax.dot_general(
            mm, X, (((1,), (axis,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (rows, rest...)

    def split(C, groups: int) -> list:
        if minor:
            Cr = C.reshape(C.shape[:-1] + (groups, m))
            return [Cr[..., k, :] for k in range(groups)]
        Cr = C.reshape((groups, m) + C.shape[1:])
        return [Cr[k] for k in range(groups)]

    xis = []
    for i in range(np_in):
        if s8:
            # byte-aligned offset-encoded planes: s = byte - 128, via the
            # bias-flip identity (byte ^ 0x80 reinterpreted as int8 ==
            # byte - 128 exactly) -- one XOR instead of widen/sub/narrow
            lo_bit = 8 * i
            src = xl if lo_bit < 32 else xh
            sh = lo_bit & 31
            v = ((src >> np.uint32(sh)) & np.uint32(0xFF)) ^ np.uint32(0x80)
        else:
            lo_bit = 7 * i
            if lo_bit + 7 <= 32:
                v = (xl >> np.uint32(lo_bit)) & np.uint32(0x7F)
            elif lo_bit >= 32:
                v = (xh >> np.uint32(lo_bit - 32)) & np.uint32(0x7F)
            else:
                v = (
                    (xl >> np.uint32(lo_bit)) | (xh << np.uint32(32 - lo_bit))
                ) & np.uint32(0x7F)
        xis.append(v.astype(jnp.int8))
    if banded:
        # ONE banded dot yields the 15 output planes -- no plane merges and
        # 15 instead of 64 int32 product planes per point
        planes = split(dot(jnp.concatenate(xis, axis=axis)), n_out)
    else:
        planes = [None] * n_out
        for i, Xi in enumerate(xis):
            for k, blk in enumerate(split(dot(Xi), np_in)):
                tt = i + k
                planes[tt] = blk if planes[tt] is None else planes[tt] + blk
    if s8:
        # per-output-row constant, indexed along the transform axis
        cshape = (m,) if minor else (m,) + (1,) * (nd - 1)
        corr = U64(t.corr.hi.reshape(cshape), t.corr.lo.reshape(cshape))
    z = jnp.zeros(planes[0].shape, jnp.uint32)
    # Carry-free pre-sums: each word's hi spills AND its unshifted
    # (sh == 0) plane sum in PLAIN u32 -- they cannot wrap: spills are
    # P >> (32-sh) <= 2^21 (s8, biased P <= 2m*2^17 <= 2^28, min shift
    # 8; <= 3 per word) / < 2^26.5 (u7, P < 2^27.4, min shift 1; <= 5
    # per word), and at most one unshifted plane (<= 2^28) joins a
    # word, so every small[w] stays < 2^29 (s8) / 2^29.1 (u7).  Only
    # the full-range SHIFTED lo parts need carried u64_adds: 11 of the
    # 26 s8 word-adds become u32 adds or the word's free init.
    small = [None] * 6  # u32 pre-sums (unshifted planes + hi spills)
    los = [[] for _ in range(6)]  # full-range shifted lo parts
    for tt in range(n_out):
        if s8:
            # bias the signed plane non-negative; the bias is pre-folded
            # into corr.  |P| <= 8 * m * 2^14 = m << 17 EXACTLY (8 (a,b)
            # pairs x m terms x 128*128) -- an m-independent 2^26 bias
            # silently wraps negative planes at m = 1024
            # (test_s8_bias_covers_worst_case)
            P = (planes[tt] + jnp.int32(m << 17)).astype(jnp.uint32)
            pos = 8 * tt
        else:
            P = planes[tt].astype(jnp.uint32)
            pos = 7 * tt
        w, sh = pos // 32, pos % 32
        if sh:
            los[w].append(P << np.uint32(sh))
            sp = P >> np.uint32(32 - sh)
            small[w + 1] = sp if small[w + 1] is None else small[w + 1] + sp
        else:
            small[w] = P if small[w] is None else small[w] + P
    A = []
    for w in range(6):
        acc = U64(z, small[w]) if small[w] is not None else U64(z, z)
        for lo in los[w]:
            acc = u64_add(acc, U64(z, lo))
        A.append(acc)
    if s8:
        zc = jnp.uint32(0)
        A[0] = u64_add(A[0], U64(zc, corr.lo))
        A[1] = u64_add(A[1], U64(zc, corr.hi))
    L = []
    carry = U64(z, z)
    for w in range(6):
        s = u64_add(A[w], carry)
        L.append(s.lo)
        carry = U64(z, s.hi)
    T_lo = U64(L[1], L[0])
    T_hi = U64(L[3], L[2])
    top = U64(L[5], L[4])
    # fold the top bits: value === top*2^128 + T_hi*2^64 + T_lo (mod N).
    # The accumulator value is < 2^140 (s8) / 2^154 (u7), so top < 2^32
    # (top.hi == 0): the 96-bit product top.lo * c128 takes two 32x32
    # wide multiplies instead of a full u64 mullo+mulhi pair.
    # A carry out of the T_hi limb is weight 2^128 === c128 (mod N) and is
    # folded back at weight 1 (cannot re-carry: after an overflow the
    # wrapped T_hi is tiny, and c128 < N keeps the weight-1 add bounded).
    p_lo = mul32_wide(top.lo, jnp.uint32(t.c128 & 0xFFFFFFFF))
    p_hi = mul32_wide(top.lo, jnp.uint32(t.c128 >> 32))
    e1 = p_lo.hi + p_hi.lo
    e1c = (e1 < p_lo.hi).astype(jnp.uint32)
    ext = U64(e1, p_lo.lo)
    ext_hi = U64(z, p_hi.hi + e1c)
    T_lo2, c0 = u64_add_carry(T_lo, ext)
    s1, c1 = u64_add_carry(T_hi, ext_hi)
    s2, c2 = u64_add_carry(s1, U64(z, c0))
    over = c1 | c2
    mask = jnp.zeros_like(over) - over
    add128 = U64(
        mask & jnp.uint32(t.c128 >> 32),
        mask & jnp.uint32(t.c128 & 0xFFFFFFFF),
    )
    T_lo2, c3 = u64_add_carry(T_lo2, add128)
    T_hi = u64_add(s2, U64(z, c3))
    # reduce T_hi below N.  Small counts ((2^64-1)//N <= 3, i.e. 62-bit+
    # moduli) unroll conditional subtracts; anything smaller takes ONE
    # Barrett step (q = hi64(T_hi * floor(2^64/N)) satisfies
    # floor(T_hi/N) - 1 <= q <= floor(T_hi/N), so T_hi - q*N < 2N) plus a
    # single conditional subtract -- bounded trace size for ANY modulus
    # (the old unrolled (2^64-1)//N loop attempted ~2.8e14 select ops for
    # the F4 prime 2^16+1: an effective trace-time hang).
    nn = u64_const_like(t.modulus, T_hi)
    form, n_c, n_s = detect_sparse_modulus(t.modulus)
    nsub = max(1, ((1 << 64) - 1) // t.modulus)
    if nsub > 3:
        mu = u64_const_like((1 << 64) // t.modulus, T_hi)
        qq = u64_mulhi(T_hi, mu)
        qn = (
            u64_mullo_sparse(qq, form, n_c, n_s)
            if form != "generic"
            else u64_mullo(qq, nn)
        )
        T_hi = u64_sub(T_hi, qn)
        nsub = 1
    for _ in range(nsub):
        cand = u64_sub(T_hi, nn)
        T_hi = u64_select(u64_lt(T_hi, nn), T_hi, cand)
    # subtractive Montgomery REDC of T_hi*2^64 + T_lo2 (R64 baked in M
    # cancels the R^-1): q = T_lo2 * N' mod 2^64; result = T_hi - hi(q*N),
    # with hi(q*N) via the sparse-modulus chain (~4 multiplies) when N is
    # a Proth/Solinas prime -- every shipped NTT modulus is
    q = u64_mullo(T_lo2, u64_const_like(t.nprime, T_lo2))
    qn1 = (
        u64_mulhi_sparse(q, form, n_c, n_s)
        if form != "generic"
        else u64_mulhi(q, nn)
    )
    d = u64_sub(T_hi, qn1)
    res = u64_select(u64_lt(T_hi, qn1), u64_add(d, nn), d)
    cand = u64_sub(res, nn)
    res = u64_select(u64_lt(res, nn), res, cand)
    if not minor and axis:
        res = U64(jnp.moveaxis(res.hi, 0, axis), jnp.moveaxis(res.lo, 0, axis))
    return res


def _tw_mul(fc: FieldConsts, x: U64, tw) -> U64:
    """Inter-step twiddle multiply via the engine the tables were prepared
    for (mirrors planner._mont_mul_bcast)."""
    if fc.modmul == "solinas":
        return fc.solinas_mul(x, tw.w)
    if tw.wp is None:
        return fc.mont_mul_full(x, tw.w)
    return fc.mont_mul(x, tw.w, tw.wp)


def _apply(x: U64, tables: MxuDirection, fc: FieldConsts, tw, axis: int) -> U64:
    """The matrix transform along ``axis`` with the optional inter-step
    twiddle ``tw`` (already broadcastable against ``x``) applied before it
    on the forward and after it on the inverse -- the reference's single
    fork-join twiddle fusion (reference include/sventt/kernel/recursive.hpp:
    61-75); XLA fuses it into the plane extraction or the recombination."""
    m = tables.m
    if x.lo.shape[axis] != m:
        raise ValueError(
            f"axis-{axis} length {x.lo.shape[axis]} != transform length {m}"
        )
    if tw is not None and not tables.inverse:
        x = _tw_mul(fc, x, tw)
    res = _mxu_body(tables, x.hi, x.lo, axis)
    if tw is not None and tables.inverse:
        res = _tw_mul(fc, res, tw)
    return res


def _trailing_ones(tw, ndim: int):
    """Reshape a twiddle MontPair to broadcast over ``ndim``-D data."""
    if tw is None:
        return None
    extra = ndim - tw.w.lo.ndim
    return montpair_map(lambda a: a.reshape(a.shape + (1,) * extra), tw)


def mxu_ntt(x: U64, tables: MxuDirection, fc: FieldConsts, tw=None) -> U64:
    """Length-m matrix NTT along the leading axis of (m, batch...).

    Bit-compatible (mod N) with the other engines; output canonical
    (lazy representatives when a lazy-mode inverse twiddle follows).
    ``tw``: optional inter-step MontPair laid out like the data's leading
    axes (trailing batch axes broadcast), multiplied in before the matrix
    on the forward and after it on the inverse.
    """
    return _apply(x, tables, fc, _trailing_ones(tw, x.lo.ndim), 0)


def mxu_ntt_mid(x: U64, tables: MxuDirection, fc: FieldConsts, tw=None) -> U64:
    """Length-m matrix NTT along AXIS 1 of (A, m, batch...): the six-step
    row step without transposes (with no batch axes, along the last axis
    of (A, m)).  ``tw``: optional (A, m) inter-step MontPair, broadcast
    over the batch axes."""
    return _apply(x, tables, fc, _trailing_ones(tw, x.lo.ndim), 1)
