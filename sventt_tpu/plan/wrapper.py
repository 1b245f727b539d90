"""The public NTT wrapper: owns device twiddle tables, runs transforms.

JAX analogue of ``NTT<kernel_type>`` (reference
include/sventt/wrapper.hpp:13-83).  Where the reference dry-runs a
FakeByteVector to size a byte arena and then streams twiddles through an aux
cursor, here preparation materializes named device arrays (pytrees) once per
config via the plan tree (plan/planner.py) and closes jitted functions over
them -- XLA keeps them device-resident, and there is no cursor bookkeeping to
verify because the arrays are structured, not a byte stream (SURVEY.md
section 4.6).

Numerical contract (SURVEY.md section 4):

* ``compute_forward`` output is in bit-reversed order, residues mod N equal
  to GoldenNTT.forward;
* ``compute_inverse`` consumes bit-reversed order, returns natural order;
* values may be lazy representatives in [0, 2N) -- compare mod N (use
  ``normalize`` for canonical outputs);
* **input precondition**: values must already be reduced -- [0, N) always
  works, lazy mode also accepts [0, 2N).  Arbitrary u64 inputs are NOT
  reduced first (same contract as the reference, whose bench harness feeds
  iota values and compares ``dst[i] % N``, tests/bench-ntt.cpp:28-64).
"""

from __future__ import annotations

import jax
import numpy as np

from ..field.limb import FieldConsts, U64, u64_from_numpy, u64_to_numpy
from . import planner
from .config import NttConfig


#: 'auto' modmul picks Shoup from this n up (lazy-capable moduli only):
#: one fewer u64 product per butterfly.  Not yet tuned on the GPU.
SHOUP_MIN_N = 1 << 22


def _resolve_modmul(config: NttConfig) -> str:
    """'auto' -> Shoup at n >= SHOUP_MIN_N for lazy-capable moduli,
    Montgomery otherwise."""
    if config.modmul != "auto":
        return config.modmul
    lazy = config.lazy if config.lazy is not None else config.mod.bit_width <= 62
    if lazy and config.n >= SHOUP_MIN_N:
        return "shoup"
    return "montgomery"


#: 'auto' engine: the matrix engine for n in [MXU_MIN_N, MXU_MAX_N], the
#: butterfly engine elsewhere.  From the engine table in PERF.md (H100,
#: flagship modulus, forward and inverse at 2^17, 2^20, 2^24, 2^28): the
#: matrix engine won at 2^17 only.  Sizes between the measured ones are not
#: measured and stay on jnp.
MXU_MIN_N = 1 << 17
MXU_MAX_N = 1 << 17


def _resolve_engine(engine: str, n: int) -> str:
    """'auto' -> an engine chosen from the transform length alone, the same
    rule on every backend."""
    if engine != "auto":
        return engine
    return "mxu" if MXU_MIN_N <= n <= MXU_MAX_N else "jnp"


class NTT:
    """Forward/inverse NTT for one NttConfig (reference wrapper.hpp:13-83).

    Data format: U64 limb pairs of shape ``(n,)`` or ``(n, batch...)``.
    Convenience numpy entry points handle uint64 <-> limb conversion.
    """

    def __init__(
        self,
        config: NttConfig,
        enable_forward: bool = True,
        enable_inverse: bool = True,
        donate_input: bool = False,
    ):
        """``donate_input=True`` donates the input buffers to XLA (the
        caller's array is invalidated) -- halves peak HBM for huge
        transforms (2^28 single-chip needs it)."""
        if config.tune:
            from .autotune import tune

            config = tune(config)
        self.config = config
        self.mod = config.mod
        self.fc = FieldConsts.from_modulus(
            self.mod, lazy=config.lazy, modmul=_resolve_modmul(config)
        )
        self.engine = _resolve_engine(config.engine, config.n)
        self.plan = self._build_plan()
        self._fwd = self._inv = None
        plan = self.plan
        donate = (0,) if donate_input else ()
        cfg = self.config
        knobs = dict(
            chunk_elems=cfg.chunk_elems, split_w_only=cfg.split_w_only
        )
        if enable_forward:
            self._fwd_tables = planner.PlanTables(
                plan, self.mod, self.fc, inverse=False, **knobs
            )
            # Tables are jit ARGUMENTS (PlanTables is a pytree): closing over
            # them would bake hundreds of MB of twiddles into the HLO.
            self._fwd = jax.jit(
                lambda x, t: planner.run_forward(x, plan, t), donate_argnums=donate
            )
        if enable_inverse:
            self._inv_tables = planner.PlanTables(
                plan, self.mod, self.fc, inverse=True, **knobs
            )
            self._inv = jax.jit(
                lambda x, t: planner.run_inverse(x, plan, t), donate_argnums=donate
            )

    def _build_plan(self):
        cfg = self.config
        if cfg.plan_spec is not None:
            # explicit mixed-engine tree overrides strategy/engine/max_fused
            return planner.build_plan_spec(cfg.n, cfg.plan_spec)
        if cfg.strategy == "auto":
            # Planner picks the factorization (fewest near-equal levels).
            return planner.build_plan(cfg.n, self.engine, cfg.max_fused)
        if cfg.resolved_strategy == "iterative":
            return planner.Leaf(cfg.n, self.engine)
        n0, n1 = cfg.split
        return planner.Split(
            cfg.n,
            n0,
            n1,
            planner.build_plan(n0, self.engine, cfg.max_fused),
            planner.build_plan(n1, self.engine, cfg.max_fused),
        )

    # -- public API -----------------------------------------------------------

    def get_m(self) -> int:
        """Transform length (reference wrapper.hpp get_m)."""
        return self.config.n

    def describe(self, batched: bool = False) -> str:
        """Human-readable execution strategy per plan node.

        Shows which path each Split's row leaf takes -- in place along the
        matrix's second axis with the twiddle fused, or the
        transpose/leaf/transpose fallback -- so silent fallbacks are
        visible.  ``batched`` describes the schedule for inputs with
        trailing batch dims.
        """
        from . import planner as P

        lines = []

        def walk(node, depth, batch):
            pad = "  " * depth
            if isinstance(node, P.Leaf):
                lines.append(f"{pad}leaf m={node.m} engine={node.engine}")
                return
            if P._mxu_row(node):
                row = f"in-place mxu m1={node.m1} (fused twiddle, no transposes)"
            elif P._jnp_row(node):
                row = (
                    f"mid-axis jnp m1={node.m1} "
                    "(chunked, fused twiddle, no transposes)"
                )
            else:
                row = f"transposed row subtree m1={node.m1}"
            lines.append(f"{pad}split {node.m} = {node.m0} x {node.m1}: {row}")
            if not isinstance(node.row, P.Leaf):
                walk(node.row, depth + 1, True)
            walk(node.col, depth + 1, True)

        walk(self.plan, 0, batched)
        return "\n".join(lines)

    def forward_step(self):
        """(step, tables) for chain timing (utils.truetime).

        ``time_chained(step, x, tables)`` traces the step into one
        fori_loop program; the tables tuple keeps the twiddles as jit
        ARGUMENTS (closing over them would bake hundreds of MB into the
        chain program's HLO).
        """
        if self._fwd is None:
            raise RuntimeError("forward transform was not enabled")
        plan = self.plan
        return (
            lambda v, t: planner.run_forward(v, plan, t),
            (self._fwd_tables,),
        )

    def inverse_step(self):
        """Mirror of forward_step for the inverse transform."""
        if self._inv is None:
            raise RuntimeError("inverse transform was not enabled")
        plan = self.plan
        return (
            lambda v, t: planner.run_inverse(v, plan, t),
            (self._inv_tables,),
        )

    def compute_forward(self, x: U64) -> U64:
        if self._fwd is None:
            raise RuntimeError("forward transform was not enabled")
        return self._fwd(x, self._fwd_tables)

    def compute_inverse(self, x: U64) -> U64:
        if self._inv is None:
            raise RuntimeError("inverse transform was not enabled")
        return self._inv(x, self._inv_tables)

    def normalize(self, x: U64) -> U64:
        return self.fc.normalize(x)

    # numpy convenience (host <-> device)
    def forward_numpy(self, x: np.ndarray) -> np.ndarray:
        out = self.compute_forward(u64_from_numpy(x))
        return u64_to_numpy(self.fc.normalize(out))

    def inverse_numpy(self, x: np.ndarray) -> np.ndarray:
        out = self.compute_inverse(u64_from_numpy(x))
        return u64_to_numpy(self.fc.normalize(out))
