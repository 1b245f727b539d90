"""Distributed six-step NTT: row-sharded matrix, all-to-all transposes.

The reference's six-step transpose is "all-to-all in disguise" (SURVEY.md
section 2.5): element (i, j) -> (j, i) moved through L1-blocked SVE shuffles
inside one shared-memory node.  Here the n = n0*n1 coefficient vector is
**row-sharded** over a 1-D `jax.sharding.Mesh` and the two transposes of the
six-step schedule (reference include/sventt/kernel/recursive.hpp:61-75)
become `jax.lax.all_to_all` collectives (NCCL over NVLink on GPUs), with
all butterfly work purely local between them.

Data layout (forward):

  flat x: (n,) = row-major (n0, n1), sharded P('shard') = n0-rows sharded
  1. all-to-all   -> (n0, n1/D) column shards       [comm 1]
  2. column NTTs over the full local leading axis n0
  3. twiddle multiply W[p0, j1] = omega_n^(bitrev(p0)*j1) (column-sharded)
  4. all-to-all + local transpose -> (n1, n0/D)     [comm 2]
  5. row NTTs over the full local leading axis n1
  6. local transpose -> (n0/D, n1): the flat bit-reversed output, row-sharded

which reproduces the single-chip ``NTT`` wrapper's output bit-for-bit shard
by shard.  The inverse runs the mirror schedule (reference
kernel/recursive.hpp:116-139).
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..field.limb import U64, FieldConsts
from ..plan import planner
from ..plan.config import NttConfig
from ..plan.planner import PlanTables, row_twiddles
from ..plan.wrapper import _resolve_engine, _resolve_modmul
from .mesh import AXIS


def _u64_map(f, x: U64) -> U64:
    return U64(f(x.hi), f(x.lo))


def _all_to_all(x: U64, axis: str, split_axis: int, concat_axis: int) -> U64:
    return _u64_map(
        lambda a: jax.lax.all_to_all(
            a, axis, split_axis=split_axis, concat_axis=concat_axis, tiled=True
        ),
        x,
    )


def _transpose01(x: U64) -> U64:
    from ..ops.transpose import transpose01_u64

    return transpose01_u64(x)


class DistributedNTT:
    """Forward/inverse six-step NTT sharded over a device mesh.

    Input/output: flat U64 of global shape ``(n,)`` sharded ``P(axis)``
    (contiguous blocks).  Semantics match the single-chip ``plan.NTT``:
    forward emits bit-reversed order, inverse consumes it; residues mod N.
    Requires ``n0 % D == 0`` and ``n1 % D == 0`` for the all-to-all tiling.

    ``axis`` may be a tuple of mesh axis names for hierarchical meshes
    (e.g. ``("host", "gpu")`` across several hosts): the shard dimension
    is the combined axis and the collectives run over both tiers.  Order
    the faster tier LAST so neighboring shards live on the same host.

    ``comm`` selects the schedule: ``"xla"`` (one `lax.all_to_all` per
    transpose) or ``"overlap"`` (communication/compute overlap: the column
    step and [comm 2] are CHUNKED along the independent local column
    axis, so the collective for chunk c has no data dependency on the
    compute of chunk c+1 and XLA's async collectives + latency-hiding
    scheduler can run them concurrently -- the multi-device analogue of
    the reference's single fork-join twiddle fusion, reference
    kernel/recursive.hpp:61-75).  Both are bit-identical.
    ``overlap_chunks`` sets the pipeline depth (default 4; 1 degenerates
    to the "xla" schedule).

    Every table lives on the mesh from construction on: the inter-step
    twiddles column-sharded, the local sub-transform tables replicated.
    """

    def __init__(
        self,
        config: NttConfig,
        mesh: jax.sharding.Mesh,
        axis: str | tuple[str, ...] = AXIS,
        enable_forward: bool = True,
        enable_inverse: bool = True,
        comm: str = "xla",
        overlap_chunks: int = 4,
    ):
        n0, n1 = config.split
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        D = 1
        for a in axes:
            D *= mesh.shape[a]
        if n0 % D or n1 % D:
            raise ValueError(f"n0={n0}, n1={n1} must be divisible by mesh size {D}")
        if comm not in ("xla", "overlap"):
            raise ValueError(
                f"unknown comm {comm!r} (schedules: 'xla', 'overlap')"
            )
        if comm == "overlap":
            w2 = n1 // D
            while overlap_chunks > 1 and w2 % overlap_chunks:
                overlap_chunks -= 1
        self.overlap_chunks = overlap_chunks
        self.config = config
        self.mesh = mesh
        self.axes = axes
        self.comm = comm
        self.D = D
        self.n0, self.n1 = n0, n1
        mod = config.mod
        self.mod = mod  # API parity with the single-chip NTT wrapper:
        # apps (cyclic_convolve, chunked series division) duck-type over
        # either transform object
        self.fc = FieldConsts.from_modulus(
            mod, lazy=config.lazy, modmul=_resolve_modmul(config)
        )
        # Local sub-transforms run full plan trees, exactly like the
        # single-device wrapper's sub-NTTs.
        engine = _resolve_engine(config.engine, config.n)
        self._col_plan = planner.build_plan(n0, engine)
        self._row_plan = planner.build_plan(n1, engine)
        # Tables are built per enabled direction only (reference
        # wrapper.hpp's enable_forward/enable_inverse ctor flags): at 2^30
        # scale each direction's tables are GBs.
        self._forward = self._inverse = None
        flat = P(axes)
        tw = P(None, axes)
        rep = P()  # sub-transform tables are replicated on every device
        tw_sharding = NamedSharding(mesh, P(None, axes))
        rep_sharding = NamedSharding(mesh, rep)

        def local_tables(plan, inverse):
            return jax.device_put(
                PlanTables(plan, mod, self.fc, inverse=inverse),
                rep_sharding,
            )

        smap = dict(mesh=mesh, in_specs=(flat, tw, rep, rep), out_specs=flat)
        if enable_forward:
            self._fwd_col = local_tables(self._col_plan, False)
            self._fwd_row = local_tables(self._row_plan, False)
            # Inter-step twiddles live column-sharded on the device mesh.
            self._fwd_tw = jax.device_put(
                row_twiddles(
                    mod, n0, n1, inverse=False, w_only=config.split_w_only
                ),
                tw_sharding,
            )
            self._forward = jax.jit(
                jax.shard_map(self._forward_local, **smap)
            )
        if enable_inverse:
            self._inv_col = local_tables(self._col_plan, True)
            self._inv_row = local_tables(self._row_plan, True)
            self._inv_tw = jax.device_put(
                row_twiddles(
                    mod, n0, n1, inverse=True, w_only=config.split_w_only
                ),
                tw_sharding,
            )
            self._inverse = jax.jit(
                jax.shard_map(self._inverse_local, **smap)
            )

    # -- public API ---------------------------------------------------------

    def get_m(self) -> int:
        return self.config.n

    def sharding(self) -> NamedSharding:
        """The sharding transforms expect for the flat coefficient vector."""
        return NamedSharding(self.mesh, P(self.axes))

    def forward_step(self):
        """(step, tables) for chain timing (utils.truetime), API parity
        with the single-device wrapper."""
        if self._forward is None:
            raise RuntimeError("forward transform was not enabled")
        return self._forward, (self._fwd_tw, self._fwd_col, self._fwd_row)

    def inverse_step(self):
        if self._inverse is None:
            raise RuntimeError("inverse transform was not enabled")
        return self._inverse, (self._inv_tw, self._inv_row, self._inv_col)

    def compute_forward(self, x: U64) -> U64:
        if self._forward is None:
            raise RuntimeError("forward transform was not enabled")
        return self._forward(x, self._fwd_tw, self._fwd_col, self._fwd_row)

    def compute_inverse(self, x: U64) -> U64:
        if self._inverse is None:
            raise RuntimeError("inverse transform was not enabled")
        return self._inverse(x, self._inv_tw, self._inv_row, self._inv_col)

    def _tw_mul(self, mat: U64, w: U64, wp) -> U64:
        if wp is None:
            return self.fc.mont_mul_full(mat, w)
        return self.fc.mont_mul(mat, w, wp)

    def _all_to_all(self, x: U64, split_axis: int, concat_axis: int) -> U64:
        return _all_to_all(x, self.axes, split_axis, concat_axis)

    # -- comm/compute overlap (comm="overlap") ------------------------------
    #
    # The local column axis of the (n0, n1/D) block is embarrassingly
    # independent for the column NTT (transform axis 0) and the twiddle
    # multiply, so both pipelines chunk it K ways: the [comm 2] collective
    # of chunk c has no data dependency on chunk c+1's compute, and XLA's
    # async collective start/done pairs let its latency-hiding scheduler
    # run them concurrently ("send shard c while transforming shard c+1").
    # Total critical path becomes comm1 + max(colNTT+tw, comm2) + rowNTT
    # instead of their sum.

    def _tw_slice(self, tw, sl):
        from ..ops.twiddle import MontPair, montpair_map

        return tuple(montpair_map(lambda a: a[:, sl], MontPair(*tw)))

    def _overlap_fwd_col_comm2(self, mat: U64, tw, col_tables) -> U64:
        import jax.numpy as jnp

        D, K = self.D, self.overlap_chunks
        h, w2 = self.n0 // D, self.n1 // D
        wK = w2 // K
        parts = []
        for c in range(K):
            sl = slice(c * wK, (c + 1) * wK)
            sub = U64(mat.hi[:, sl], mat.lo[:, sl])
            sub = planner.run_forward(sub, self._col_plan, col_tables)
            sub = self._tw_mul(sub, *self._tw_slice(tw, sl))
            parts.append(
                self._all_to_all(sub, split_axis=0, concat_axis=1)
            )

        def reasm(arrs):
            # chunk c: (h, D*wK), columns grouped by source device o; the
            # full layout wants column o*w2 + c*wK + i  ->  (h, D, K, wK)
            s = jnp.stack(arrs, axis=0).reshape(K, h, D, wK)
            return s.transpose(1, 2, 0, 3).reshape(h, self.n1)

        return U64(reasm([p.hi for p in parts]), reasm([p.lo for p in parts]))

    def _overlap_inv_comm2_col(self, mat: U64, tw, col_tables) -> U64:
        import jax.numpy as jnp

        D, K = self.D, self.overlap_chunks
        h, w2 = self.n0 // D, self.n1 // D
        wK = w2 // K
        parts = []
        for c in range(K):

            def pick(a, c=c):
                return a.reshape(h, D, K, wK)[:, :, c, :].reshape(h, D * wK)

            sub = U64(pick(mat.hi), pick(mat.lo))
            sub = self._all_to_all(sub, split_axis=1, concat_axis=0)
            sl = slice(c * wK, (c + 1) * wK)
            sub = self._tw_mul(sub, *self._tw_slice(tw, sl))
            parts.append(
                planner.run_inverse(sub, self._col_plan, col_tables)
            )
        return U64(
            jnp.concatenate([p.hi for p in parts], axis=1),
            jnp.concatenate([p.lo for p in parts], axis=1),
        )

    # -- local (per-shard) schedules ---------------------------------------

    def _row_is_jnp_leaf(self) -> bool:
        return (
            isinstance(self._row_plan, planner.Leaf)
            and self._row_plan.engine == "jnp"
        )

    def _forward_local(self, x: U64, tw, col_tables, row_tables) -> U64:
        n0, n1 = self.n0, self.n1
        D = self.D
        w, wp = tw  # local (n0, n1/D) each
        mat = _u64_map(lambda a: a.reshape(n0 // D, n1), x)
        # [comm 1] row shards -> column shards: (n0/D, n1) -> (n0, n1/D)
        mat = self._all_to_all(mat, split_axis=1, concat_axis=0)
        if self.comm == "overlap":
            # column NTTs + twiddle + [comm 2], chunked for overlap
            mat = self._overlap_fwd_col_comm2(mat, (w, wp), col_tables)
        else:
            # column NTTs: full leading axis n0 is local
            mat = planner.run_forward(mat, self._col_plan, col_tables)
            mat = self._tw_mul(mat, w, wp)
            # [comm 2] column shards of (n0, n1) -> column shards of (n1, n0)
            mat = self._all_to_all(mat, split_axis=0, concat_axis=1)
        # row NTTs on the (n0/D, n1) shard: a jnp row leaf runs along
        # axis 1 in place (no local transposes -- planner._jnp_mid_chunked,
        # twiddles already applied under the column sharding above)
        if self._row_is_jnp_leaf():
            mat = planner._jnp_mid_chunked(
                mat, row_tables.leaf[(n1, "jnp")], self.fc, None, inverse=False
            )
        else:
            mat = _transpose01(mat)  # -> (n1, n0/D)
            mat = planner.run_forward(mat, self._row_plan, row_tables)
            mat = _transpose01(mat)  # -> (n0/D, n1)
        return _u64_map(lambda a: a.reshape(n0 // D * n1), mat)

    def _inverse_local(self, x: U64, tw, row_tables, col_tables) -> U64:
        n0, n1 = self.n0, self.n1
        D = self.D
        w, wp = tw
        mat = _u64_map(lambda a: a.reshape(n0 // D, n1), x)
        if self._row_is_jnp_leaf():
            mat = planner._jnp_mid_chunked(
                mat, row_tables.leaf[(n1, "jnp")], self.fc, None, inverse=True
            )
        else:
            mat = _transpose01(mat)  # (n1, n0/D)
            mat = planner.run_inverse(mat, self._row_plan, row_tables)
            mat = _transpose01(mat)  # (n0/D, n1)
        if self.comm == "overlap":
            # undo [comm 2] + twiddles + column NTTs, chunked for overlap
            mat = self._overlap_inv_comm2_col(mat, (w, wp), col_tables)
        else:
            # undo [comm 2]
            mat = self._all_to_all(mat, split_axis=1, concat_axis=0)
            mat = self._tw_mul(mat, w, wp)  # undo twiddles
            mat = planner.run_inverse(mat, self._col_plan, col_tables)
        # undo [comm 1]: column shards -> row shards
        mat = self._all_to_all(mat, split_axis=0, concat_axis=1)
        return _u64_map(lambda a: a.reshape(n0 // D * n1), mat)
