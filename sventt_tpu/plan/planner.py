"""Recursive transform planner: compose fused leaves into arbitrary lengths.

The analogue of the reference's kernel-composition type
expressions (reference include/sventt/kernel/recursive.hpp composing layers
and inner kernels at compile time, README.md:36-68): a ``Plan`` is a static
tree built at config time; the executor traces it into one XLA program.

* ``Leaf(m)``  -- a full length-m NTT along the leading axis, run either by
  the butterfly engine (ops/ntt_jnp.py) or the int8 matrix engine
  (ops/ntt_mxu.py, m <= MAX_MXU).
* ``Split(m0, m1)`` -- the six-step decomposition m = m0*m1 (reference
  layer/sve/generic.hpp + kernel/recursive.hpp:61-75): column NTTs (recurse,
  length m0), inter-step twiddle multiply, transpose, row NTTs (recurse,
  length m1), transpose back.  Output is bit-reversed order exactly like a
  Leaf of the same length, so nodes compose freely -- bit-compatibility with
  the golden model is preserved inductively at every level.

A split level whose row child is a leaf runs that leaf along the middle or
last axis with the inter-step twiddle fused in, so it costs no transposes;
depth is minimized by splitting only while m > max_fused.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np

from ..field.limb import U64, FieldConsts
from ..field.modulus import Modulus
from ..ops import ntt_mxu
from ..ops.ntt_jnp import (
    ntt_forward,
    ntt_forward_mid,
    ntt_inverse,
    ntt_inverse_mid,
)
from ..ops.twiddle import (
    MontPair,
    forward_tables,
    inverse_tables,
    sixstep_row_twiddles,
    sixstep_row_twiddles_device,
    sixstep_row_twiddles_inverse,
)

#: Above this element count inter-step twiddle matrices are generated on
#: device (lax.scan Montgomery recurrence) instead of host Python ints.
DEVICE_TWIDDLE_THRESHOLD = 1 << 16

#: Above this element count the Montgomery companion array is dropped (the
#: multiply recomputes it on the fly), halving the inter-step tables' memory
#: and the bytes each split level reads from them.
W_ONLY_THRESHOLD = 1 << 26

#: Element count of one chunk of a jnp leaf level: leaves with larger
#: batches run in batch-axis chunks of this many elements, so that XLA can
#: keep a chunk's whole stage chain in fast memory and touch device memory
#: once per level rather than once per stage -- the analogue of the
#: reference's L1-blocked six-step slabs (reference
#: layer/sve/blocked-generic.hpp:138-154).  Not yet tuned on the GPU.
JNP_RESIDENT_ELEMS = 1 << 21


def row_twiddles(
    mod: Modulus, n0: int, n1: int, *, inverse: bool,
    w_only: bool | None = None, modmul: str = "montgomery",
) -> MontPair:
    """Inter-step twiddle matrix for one Split level.

    ``w_only`` drops the Montgomery companion array (the multiply recomputes
    it in flight) -- halves this level's table read; None applies the
    size heuristic W_ONLY_THRESHOLD.  Autotunable via
    ``NttConfig.split_w_only``.  ``modmul="solinas"`` builds PLAIN
    canonical values, always companion-free (multiplied by
    FieldConsts.solinas_mul in _mont_mul_bcast); every other engine's
    inter-step tables are Montgomery-form (the shoup engine applies to
    STAGE twiddles only -- _mont_mul_bcast always goes through the
    Montgomery multiply).
    """
    if modmul != "solinas":
        modmul = "montgomery"
    if w_only is None:
        w_only = n0 * n1 >= W_ONLY_THRESHOLD
    if n0 * n1 > DEVICE_TWIDDLE_THRESHOLD:
        return sixstep_row_twiddles_device(
            mod, n0, n1, inverse=inverse, with_companion=not w_only,
            modmul=modmul,
        )
    if modmul == "solinas":
        from ..ops.twiddle import sixstep_row_twiddles_plain

        tw = sixstep_row_twiddles_plain(mod, n0, n1, inverse=inverse)
    else:
        tw = (
            sixstep_row_twiddles_inverse(mod, n0, n1)
            if inverse
            else sixstep_row_twiddles(mod, n0, n1)
        )
        if w_only:
            tw = MontPair(tw.w, None)
    return tw


@dataclass(frozen=True)
class Leaf:
    m: int
    engine: str  # "jnp" | "mxu"


@dataclass(frozen=True)
class Split:
    m: int
    m0: int
    m1: int
    col: "Leaf | Split"
    row: "Leaf | Split"


def build_plan(n: int, engine: str, max_fused: int | None = None) -> "Leaf | Split":
    """Static plan tree for a length-n transform.

    ``engine`` "mxu" caps leaves at 512 by default (the matrix cost per
    point grows with m); "jnp" allows leaves up to 2^13 (huge single-level
    stage chains lose to decomposition).

    Every split level costs one twiddle pass plus two transposes over the
    whole vector, so depth is minimized: log2(n) is cut into the fewest
    near-equal factors each <= max_fused, e.g. with max_fused = 2^9:
    2^17 -> 2^8 x 2^9 (the reference flagship split, README.md:18-68),
    2^24 -> 2^8 x (2^8 x 2^8) -- the reference's blocked six-step idea one
    level deeper.
    """
    if max_fused is None:
        # mxu: the largest leaf the default scheme supports (ntt_mxu.max_m);
        # not yet tuned on the GPU.
        max_fused = ntt_mxu.max_m() if engine == "mxu" else 1 << 13
    if n <= max_fused:
        return Leaf(n, engine)
    log2n = n.bit_length() - 1
    log2f = max_fused.bit_length() - 1
    k = -(-log2n // log2f)  # number of near-equal factors
    # Left-deep: the ROW side is always a leaf, the column side recurses,
    # so every level's row step runs in place on the (m0, m1, batch...)
    # matrix -- no six-step transposes.
    log2n1 = -(-log2n // k)
    n1 = 1 << log2n1
    n0 = n // n1
    return Split(
        n, n0, n1, build_plan(n0, engine, max_fused), Leaf(n1, engine)
    )


def build_plan_spec(n: int, spec: str) -> "Leaf | Split":
    """Explicit MIXED-ENGINE plan tree from a compact spec string.

    ``spec`` is a comma list, top-down: every element but the last is
    ``engine:m1`` -- one Split level whose ROW leaf uses that engine at
    length m1 -- and the last is a bare engine name for the final column
    leaf (its length is whatever remains).  Engines may differ per level
    (the reference mixes layer types freely inside one kernel type
    expression, reference tests/ntt-tests/recursive-sve-radix248-two13.hpp);
    every node still emits bit-reversed order, so mixed trees stay
    bit-compatible with the golden model by the same induction as
    build_plan's uniform trees.

    Example: ``build_plan_spec(1 << 26, "mxu:512,mxu:512,jnp")``.
    """
    caps = {"jnp": 1 << 22, "mxu": ntt_mxu.max_m()}

    def leaf(m: int, engine: str) -> Leaf:
        if engine not in caps:
            raise ValueError(f"plan_spec: unknown engine {engine!r}")
        if m > caps[engine]:
            raise ValueError(
                f"plan_spec: leaf m={m} exceeds the {engine} cap {caps[engine]}"
            )
        return Leaf(m, engine)

    def rec(n: int, parts: list[str]):
        head, rest = parts[0], parts[1:]
        if not rest:
            if ":" in head:
                raise ValueError(
                    "plan_spec: the last element is the column LEAF -- a "
                    f"bare engine name, got {head!r}"
                )
            return leaf(n, head)
        if ":" not in head:
            raise ValueError(
                f"plan_spec: split levels need 'engine:m1', got {head!r}"
            )
        engine, m1s = head.split(":", 1)
        m1 = int(m1s)
        if m1 < 2 or m1 & (m1 - 1) or n % m1 or m1 >= n:
            raise ValueError(
                f"plan_spec: m1={m1} must be a power of two dividing n={n}"
            )
        return Split(n, n // m1, m1, rec(n // m1, rest), leaf(m1, engine))

    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError("plan_spec: empty spec")
    return rec(n, parts)


class PlanTables:
    """Device twiddle tables for every node of a plan, one direction.

    Registered as a pytree (the dict values are the data leaves) so a whole
    table set is passed to jitted transforms as an argument -- keeping the
    multi-hundred-MB tables of 2^24+ transforms out of the serialized HLO.
    """

    def __init__(
        self,
        plan,
        mod: Modulus,
        fc: FieldConsts,
        inverse: bool,
        chunk_elems: int | None = None,
        split_w_only: bool | None = None,
    ):
        self.plan = plan
        self.mod = mod
        self.fc = fc
        self.inverse = inverse
        #: tunable knobs (NttConfig.chunk_elems, NttConfig.split_w_only)
        self.chunk_elems = chunk_elems
        self.split_w_only = split_w_only
        self.leaf: dict[tuple[int, str], object] = {}
        #: (m0, m1) inter-step twiddle matrix of every Split level
        self.split_tw: dict[tuple[int, int], MontPair] = {}
        self._prepare(plan)

    @classmethod
    def _unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (obj.plan, obj.mod, obj.fc, obj.inverse, obj.chunk_elems,
         obj.split_w_only) = aux
        obj.leaf, obj.split_tw = children
        return obj

    def _prepare(self, node):
        if isinstance(node, Leaf):
            if (node.m, node.engine) in self.leaf:
                return
            if node.engine == "mxu":
                t = ntt_mxu.make_mxu_tables(self.mod, node.m, inverse=self.inverse)
            elif self.inverse:
                t = inverse_tables(self.mod, node.m, modmul=self.fc.modmul)
            else:
                t = forward_tables(self.mod, node.m, modmul=self.fc.modmul)
            self.leaf[(node.m, node.engine)] = t
            return
        key = (node.m0, node.m1)
        if key not in self.split_tw:
            self.split_tw[key] = row_twiddles(
                self.mod, node.m0, node.m1, inverse=self.inverse,
                w_only=self.split_w_only, modmul=self.fc.modmul,
            )
        self._prepare(node.col)
        self._prepare(node.row)


jax.tree_util.register_pytree_node(
    PlanTables,
    lambda t: (
        (t.leaf, t.split_tw),
        (t.plan, t.mod, t.fc, t.inverse, t.chunk_elems, t.split_w_only),
    ),
    PlanTables._unflatten,
)


def _transpose01(x: U64) -> U64:
    from ..ops.transpose import transpose01_u64

    return transpose01_u64(x)


def _mont_mul_bcast(fc: FieldConsts, x: U64, tw: MontPair, nb: int) -> U64:
    """Multiply (m0, m1, batch...) data by an (m0, m1) twiddle matrix.

    Montgomery engines: Montgomery-form twiddles; when the companion array
    was dropped (W_ONLY_THRESHOLD) the multiply recomputes it on the fly.
    Solinas engine: PLAIN twiddles, direct fold reduction (always
    companion-free).
    """
    shape = tw.w.lo.shape + (1,) * nb
    w = U64(tw.w.hi.reshape(shape), tw.w.lo.reshape(shape))
    if fc.modmul == "solinas":
        return fc.solinas_mul(x, w)
    if tw.wp is None:
        return fc.mont_mul_full(x, w)
    wp = U64(tw.wp.hi.reshape(shape), tw.wp.lo.reshape(shape))
    return fc.mont_mul(x, w, wp)


def _jnp_chunked(
    x: U64, t, fc: FieldConsts, fn, chunk_elems: int | None = None
) -> U64:
    """Apply a leading-axis jnp transform in batch-axis chunks.

    ``x``: (m, batch...).  Chunks are batch-axis slices of at most
    JNP_RESIDENT_ELEMS elements, so each chunk's full stage chain works on
    data small enough to stay in the GPU's L2 cache.  The chunks run under
    a fori_loop with dynamic slices: one compiled body.  (Unrolling them
    instead made the 2^24 program's GPU compile about 5x longer.)
    """
    resident = chunk_elems or JNP_RESIDENT_ELEMS
    m = x.lo.shape[0]
    batch_shape = x.lo.shape[1:]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    if m * b <= resident or b == 1:
        return fn(x, t, fc)
    chunk_b = max(1, resident // m)
    if b % chunk_b:  # power-of-two shapes always divide; fall back if not
        return fn(x, t, fc)
    xh = x.hi.reshape(m, b)
    xl = x.lo.reshape(m, b)

    def body(i, acc):
        oh, ol = acc
        start = i * chunk_b
        sh = jax.lax.dynamic_slice(xh, (0, start), (m, chunk_b))
        sl = jax.lax.dynamic_slice(xl, (0, start), (m, chunk_b))
        o = fn(U64(sh, sl), t, fc)
        return (
            jax.lax.dynamic_update_slice(oh, o.hi, (0, start)),
            jax.lax.dynamic_update_slice(ol, o.lo, (0, start)),
        )

    oh, ol = jax.lax.fori_loop(0, b // chunk_b, body, (xh, xl))
    return U64(oh.reshape((m,) + batch_shape), ol.reshape((m,) + batch_shape))


def _jnp_mid_chunked(
    x: U64, t, fc: FieldConsts, tw: MontPair | None, inverse: bool,
    chunk_elems: int | None = None,
) -> U64:
    """Six-step row step on (m0, m1, batch...) without transposes: the
    axis-1 jnp transform with the inter-step twiddle multiply FUSED into
    each chunk (rows of m0 per chunk, under a fori_loop as in
    ``_jnp_chunked``) -- forward multiplies
    before the row NTT, inverse after (mirror).  One HBM read + write per
    level instead of twiddle pass + two transposes + leaf pass.
    ``tw=None`` runs the bare axis-1 transform (the distributed schedule
    applies its twiddles under a different sharding).
    """
    m0, m1 = x.lo.shape[0], x.lo.shape[1]
    batch = x.lo.shape[2:]
    nb = len(batch)
    b = int(np.prod(batch)) if batch else 1
    fn = ntt_inverse_mid if inverse else ntt_forward_mid

    def run(v: U64, w: MontPair | None) -> U64:
        if w is None:
            return fn(v, t, fc)
        if not inverse:
            v = _mont_mul_bcast(fc, v, w, nb)
            return fn(v, t, fc)
        v = fn(v, t, fc)
        return _mont_mul_bcast(fc, v, w, nb)

    chunk_a = max(1, (chunk_elems or JNP_RESIDENT_ELEMS) // (m1 * b))
    if chunk_a >= m0 or m0 % chunk_a:
        return run(x, tw)
    n_chunks = m0 // chunk_a

    def tw_slice(take):
        if tw is None:
            return None
        w = take(tw.w.hi), take(tw.w.lo)
        if tw.wp is None:
            return MontPair(U64(*w), None)
        return MontPair(U64(*w), U64(take(tw.wp.hi), take(tw.wp.lo)))

    def body(i, acc):
        oh, ol = acc
        start = i * chunk_a
        zeros = (0,) * (nb + 1)

        def dslice(a):
            return jax.lax.dynamic_slice(
                a, (start,) + zeros, (chunk_a, m1) + batch
            )

        def dslice2(a):
            return jax.lax.dynamic_slice(a, (start, 0), (chunk_a, m1))

        o = run(U64(dslice(x.hi), dslice(x.lo)), tw_slice(dslice2))
        return (
            jax.lax.dynamic_update_slice(oh, o.hi, (start,) + zeros),
            jax.lax.dynamic_update_slice(ol, o.lo, (start,) + zeros),
        )

    oh, ol = jax.lax.fori_loop(0, n_chunks, body, (x.hi, x.lo))
    return U64(oh, ol)


def _jnp_row(node) -> bool:
    """Split nodes whose row child is a jnp leaf run it middle-axis with
    the inter-step twiddle fused into the chunks (no transposes)."""
    return (
        isinstance(node, Split)
        and isinstance(node.row, Leaf)
        and node.row.engine == "jnp"
    )


def _mxu_row(node) -> bool:
    """Split nodes whose row child is an mxu leaf run it in place along
    axis 1 of the (m0, m1, batch...) matrix -- the last axis when there is
    no batch -- with the inter-step twiddle fused; no transposes."""
    return (
        isinstance(node, Split)
        and isinstance(node.row, Leaf)
        and node.row.engine == "mxu"
    )


def run_forward(x: U64, node, tables: PlanTables) -> U64:
    """Length-m DIF NTT along the leading axis (bit-reversed output)."""
    fc = tables.fc
    if isinstance(node, Leaf):
        t = tables.leaf[(node.m, node.engine)]
        if node.engine == "mxu":
            return ntt_mxu.mxu_ntt(x, t, fc)
        return _jnp_chunked(x, t, fc, ntt_forward, tables.chunk_elems)
    m0, m1 = node.m0, node.m1
    key = (m0, m1)
    batch = x.lo.shape[1:]
    mat = U64(x.hi.reshape((m0, m1) + batch), x.lo.reshape((m0, m1) + batch))
    mat = run_forward(mat, node.col, tables)  # column NTTs, leading axis m0
    if _mxu_row(node):
        # mxu row leaf with the inter-step twiddle applied right before the
        # matrix (reference kernel/recursive.hpp:61-75)
        t = tables.leaf[(m1, "mxu")]
        mat = ntt_mxu.mxu_ntt_mid(mat, t, fc, tw=tables.split_tw[key])
    elif _jnp_row(node):
        # jnp middle-axis row leaf: twiddles fused into the chunks, no
        # transposes
        mat = _jnp_mid_chunked(
            mat, tables.leaf[(m1, "jnp")], fc, tables.split_tw[key],
            inverse=False, chunk_elems=tables.chunk_elems,
        )
    else:
        mat = _mont_mul_bcast(fc, mat, tables.split_tw[key], len(batch))
        mat = _transpose01(mat)  # (m1, m0, batch)
        mat = run_forward(mat, node.row, tables)  # row NTTs, leading axis m1
        mat = _transpose01(mat)  # (m0, m1, batch)
    return U64(
        mat.hi.reshape((node.m,) + batch), mat.lo.reshape((node.m,) + batch)
    )


def run_inverse(x: U64, node, tables: PlanTables) -> U64:
    """Mirror of run_forward (reference kernel/recursive.hpp:116-139)."""
    fc = tables.fc
    if isinstance(node, Leaf):
        t = tables.leaf[(node.m, node.engine)]
        if node.engine == "mxu":
            return ntt_mxu.mxu_ntt(x, t, fc)
        return _jnp_chunked(x, t, fc, ntt_inverse, tables.chunk_elems)
    m0, m1 = node.m0, node.m1
    key = (m0, m1)
    batch = x.lo.shape[1:]
    mat = U64(x.hi.reshape((m0, m1) + batch), x.lo.reshape((m0, m1) + batch))
    if _mxu_row(node):
        # undo row NTTs, then the inverse inter-step twiddle (mirror of the
        # forward)
        t = tables.leaf[(m1, "mxu")]
        mat = ntt_mxu.mxu_ntt_mid(mat, t, fc, tw=tables.split_tw[key])
    elif _jnp_row(node):
        # undo row NTTs along axis 1, inverse twiddles fused per chunk
        mat = _jnp_mid_chunked(
            mat, tables.leaf[(m1, "jnp")], fc, tables.split_tw[key],
            inverse=True, chunk_elems=tables.chunk_elems,
        )
    else:
        mat = _transpose01(mat)
        mat = run_inverse(mat, node.row, tables)  # undo row NTTs
        mat = _transpose01(mat)
        mat = _mont_mul_bcast(fc, mat, tables.split_tw[key], len(batch))
    mat = run_inverse(mat, node.col, tables)  # undo column NTTs
    return U64(
        mat.hi.reshape((node.m,) + batch), mat.lo.reshape((node.m,) + batch)
    )
