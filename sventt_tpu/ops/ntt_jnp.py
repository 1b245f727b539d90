"""Pure-jnp NTT engine: leading-axis butterflies, runs on any XLA backend.

This is the framework's butterfly compute path (L2/L3 of SURVEY.md
section 1).  Layout rule: the **transform axis is the leading axis**, all
trailing axes are batch, so every butterfly at every stage is a contiguous
slab operation -- the answer to the reference's in-register shuffle zoo
(reference include/sventt/transposition/sve/common.hpp): instead of
deinterleaving sub-vector strides in registers, strides live entirely in the
leading dimension.

The butterfly schedule is exactly the golden model's
(reference tests/ntt-reference.hpp:43-83), so composing these transforms is
bit-compatible (mod N) with the reference at every decomposition boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..field.limb import U64, FieldConsts
from .twiddle import ForwardTables, InverseTables, MontPair


def _stage_out(x: U64) -> U64:
    """Materialize a stage's output (an optimization barrier), so the
    compiler fuses one stage at a time.  Without it XLA's GPU fusion merged
    the stage chain into fusions that recompute earlier stages: the 2^20
    forward ran 65x slower (PERF.md, PR 1)."""
    return U64(*jax.lax.optimization_barrier((x.hi, x.lo)))


def _u64_bcast(x: U64, shape) -> U64:
    return U64(x.hi.reshape(shape), x.lo.reshape(shape))


def _stage_views(x: U64, m: int, l: int):
    """Split the leading length-m axis into butterfly operand pairs.

    Golden indexing: x0 = x[b*2l + j], x1 = x[b*2l + l + j] for blocks b and
    twiddle index j < l -- a (m/(2l), 2, l) reshape of the leading axis.
    """
    batch = x.lo.shape[1:]
    shape = (m // (2 * l), 2, l) + batch
    xr_hi = x.hi.reshape(shape)
    xr_lo = x.lo.reshape(shape)
    x0 = U64(xr_hi[:, 0], xr_lo[:, 0])
    x1 = U64(xr_hi[:, 1], xr_lo[:, 1])
    return x0, x1


def _stage_join(y0: U64, y1: U64, m: int):
    """Inverse of _stage_views: stack pairs back into the leading axis."""
    batch = y0.lo.shape[2:]
    hi = jnp.stack([y0.hi, y1.hi], axis=1).reshape((m,) + batch)
    lo = jnp.stack([y0.lo, y1.lo], axis=1).reshape((m,) + batch)
    return U64(hi, lo)


def _bcast_tw(pair: MontPair, l: int, ndim_batch: int) -> MontPair:
    """Reshape a length-l twiddle vector to broadcast as (1, l, *1s).
    ``wp`` may be None (companion-free solinas tables)."""
    shape = (1, l) + (1,) * ndim_batch
    wp = None if pair.wp is None else _u64_bcast(pair.wp, shape)
    return MontPair(_u64_bcast(pair.w, shape), wp)


def ntt_forward(x: U64, tables: ForwardTables, fc: FieldConsts) -> U64:
    """Length-m DIF NTT along the leading axis; output bit-reversed order.

    Bit-compatible (mod N) with GoldenNTT.forward, for every batch column.
    """
    m = tables.m
    if x.lo.shape[0] != m:
        raise ValueError(f"leading axis {x.lo.shape[0]} != transform length {m}")
    nb = x.lo.ndim - 1
    for pair in tables.stages:
        l = pair.w.lo.shape[0]
        x0, x1 = _stage_views(x, m, l)
        w = _bcast_tw(pair, l, nb)
        y0, y1 = fc.butterfly_forward(x0, x1, w.w, w.wp)
        x = _stage_out(_stage_join(y0, y1, m))
    return x


def ntt_inverse(x: U64, tables: InverseTables, fc: FieldConsts) -> U64:
    """Length-m DIT inverse along the leading axis; consumes bit-reversed
    order, returns natural order scaled by 1/m (times any extra factor folded
    into the tables).  Bit-compatible (mod N) with GoldenNTT.inverse.
    """
    m = tables.m
    if x.lo.shape[0] != m:
        raise ValueError(f"leading axis {x.lo.shape[0]} != transform length {m}")
    nb = x.lo.ndim - 1
    last = len(tables.stages) - 1
    for s, pair in enumerate(tables.stages):
        l = pair.w.lo.shape[0]
        x0, x1 = _stage_views(x, m, l)
        w = _bcast_tw(pair, l, nb)
        if s == last:
            # final stage: double-twiddle butterfly folds the 1/m scaling
            # (reference inverse_factor mechanism, layer/sve/radix-eight.hpp:445-478)
            sc = _bcast_tw(tables.scale, 1, nb)
            y0, y1 = fc.butterfly_inverse_scaled(x0, x1, sc.w, sc.wp, w.w, w.wp)
        else:
            y0, y1 = fc.butterfly_inverse(x0, x1, w.w, w.wp)
        x = _stage_out(_stage_join(y0, y1, m))
    return x


# -- middle-axis variants: transform along AXIS 1 of (A, m, batch...) --------
#
# The six-step row step applied in place on the (columns, rows, batch)
# layout: a Split node whose row child is a jnp leaf runs here instead of
# the transpose / leaf / transpose sandwich, eliminating both transposes per
# level (the reference fuses transposition into its blocked row layers the
# same way, reference layer/sve/blocked-generic.hpp:138-154).  XLA compiles
# the axis-1 reshape/stack patterns to the same code as the leading-axis
# ones.


def _mid_views(x: U64, m: int, l: int):
    a = x.lo.shape[0]
    batch = x.lo.shape[2:]
    shape = (a, m // (2 * l), 2, l) + batch
    xr_hi = x.hi.reshape(shape)
    xr_lo = x.lo.reshape(shape)
    return U64(xr_hi[:, :, 0], xr_lo[:, :, 0]), U64(xr_hi[:, :, 1], xr_lo[:, :, 1])


def _mid_join(y0: U64, y1: U64, m: int):
    a = y0.lo.shape[0]
    batch = y0.lo.shape[3:]
    hi = jnp.stack([y0.hi, y1.hi], axis=2).reshape((a, m) + batch)
    lo = jnp.stack([y0.lo, y1.lo], axis=2).reshape((a, m) + batch)
    return U64(hi, lo)


def _mid_tw(pair: MontPair, l: int, ndim_batch: int) -> MontPair:
    shape = (1, 1, l) + (1,) * ndim_batch
    wp = None if pair.wp is None else _u64_bcast(pair.wp, shape)
    return MontPair(_u64_bcast(pair.w, shape), wp)


def ntt_forward_mid(x: U64, tables: ForwardTables, fc: FieldConsts) -> U64:
    """Length-m DIF NTT along AXIS 1 of (A, m, batch...); bit-compatible
    (mod N) with ``ntt_forward`` applied to the transposed data."""
    m = tables.m
    if x.lo.shape[1] != m:
        raise ValueError(f"axis-1 length {x.lo.shape[1]} != transform length {m}")
    nb = x.lo.ndim - 2
    for pair in tables.stages:
        l = pair.w.lo.shape[0]
        x0, x1 = _mid_views(x, m, l)
        w = _mid_tw(pair, l, nb)
        y0, y1 = fc.butterfly_forward(x0, x1, w.w, w.wp)
        x = _stage_out(_mid_join(y0, y1, m))
    return x


def ntt_inverse_mid(x: U64, tables: InverseTables, fc: FieldConsts) -> U64:
    """Mirror of ntt_forward_mid (DIT inverse along axis 1, 1/m folded
    into the final double-twiddle stage)."""
    m = tables.m
    if x.lo.shape[1] != m:
        raise ValueError(f"axis-1 length {x.lo.shape[1]} != transform length {m}")
    nb = x.lo.ndim - 2
    last = len(tables.stages) - 1
    for s, pair in enumerate(tables.stages):
        l = pair.w.lo.shape[0]
        x0, x1 = _mid_views(x, m, l)
        w = _mid_tw(pair, l, nb)
        if s == last:
            sc = _mid_tw(tables.scale, 1, nb)
            y0, y1 = fc.butterfly_inverse_scaled(x0, x1, sc.w, sc.wp, w.w, w.wp)
        else:
            y0, y1 = fc.butterfly_inverse(x0, x1, w.w, w.wp)
        x = _stage_out(_mid_join(y0, y1, m))
    return x


def pointwise_mont_mul(a: U64, b: U64, fc: FieldConsts) -> U64:
    """Elementwise product where ``b`` is in the Montgomery domain.

    The convolution pointwise step (reference
    examples/magic-series/gaussian-polynomial.hpp:201-212 multiplies spectra
    after converting one side with to_montgomery).
    """
    return fc.mont_mul_full(a, b)


def twiddle_rows(x: U64, w: MontPair, fc: FieldConsts) -> U64:
    """Elementwise multiply by a prepared Montgomery twiddle matrix
    (the four/six-step inter-step twiddle pass,
    reference layer/sve/generic.hpp:169-268)."""
    return fc.mont_mul(x, w.w, w.wp)
