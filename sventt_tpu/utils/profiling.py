"""Profiling hooks: jax.profiler traces around transform workloads.

The reference's observability is Google Benchmark counters
(reference tests/bench-ntt.cpp:57-58); the equivalents here are the
benchmark harnesses' JSON rows (benchmarks/) plus this trace context for
inspecting kernel timelines in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed block.

    Usage::

        with trace("/tmp/ntt-trace"):
            jax.block_until_ready(ntt.compute_forward(x))
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def phase_breakdown(ntt, seconds: float = 1.0, seed: int = 0) -> dict[str, float]:
    """Per-level timing budget of a forward transform (chain timing).

    Walks the plan tree and times, as STANDALONE programs at the plan's
    own intermediate shapes: each split level's row step (the fused
    mid-axis chunk program, inter-step twiddle included, for jnp rows;
    the bare twiddle multiply otherwise) and the final column transform
    -- plus the whole transform for comparison.  Standalone phases can
    sum to more than the whole (XLA fuses across levels in the real
    program; the gap is the fusion win).  All timings use the
    single-dispatch chain method (utils/truetime.py: fori_loop chain +
    forced readback - overhead); tables are passed as jit ARGUMENTS
    (closing over them would bake hundreds of MB of twiddles into the
    HLO).  Returns {phase label: ms}.
    """
    import numpy as np

    from ..field.limb import U64
    from ..plan import planner
    from .truetime import time_chained

    cfg = ntt.config
    tabs = ntt._fwd_tables
    fc = ntt.fc

    def dev(shape):
        # Input generated ON DEVICE (iota < n <= N satisfies the reduced-
        # input precondition): no host-to-device copy of the full vector.
        import jax.numpy as jnp

        total = int(np.prod(shape))
        assert total < (1 << 32)
        return jax.jit(
            lambda: U64(
                jnp.zeros(shape, jnp.uint32),
                jnp.arange(total, dtype=jnp.uint32).reshape(shape),
            )
        )()

    def chain(f, x, *tables):
        return time_chained(f, x, tables, seconds=seconds, reps=1).ms

    out: dict[str, float] = {}
    plan = ntt.plan
    out["total"] = chain(
        lambda v, t: planner.run_forward(v, plan, t), dev((cfg.n,)), tabs
    )

    node, batch, level = ntt.plan, (), 0
    while isinstance(node, planner.Split):
        m0, m1 = node.m0, node.m1
        shape = (m0, m1) + batch
        tw = tabs.split_tw[(m0, m1)]
        if planner._jnp_row(node):
            f = lambda v, t, tw: planner._jnp_mid_chunked(  # noqa: E731
                v, t, fc, tw, inverse=False, chunk_elems=tabs.chunk_elems
            )
            out[f"level{level}.rows m1={m1} (+tw, fused chunks)"] = chain(
                f, dev(shape), tabs.leaf[(m1, "jnp")], tw
            )
        else:
            # mxu rows or the transposed fallback: time the inter-step
            # twiddle multiply alone (the row engines have their own
            # benchmarks in benchmarks/bench_ntt.py)
            f = lambda v, tw, nb=len(batch): planner._mont_mul_bcast(  # noqa: E731
                fc, v, tw, nb
            )
            out[f"level{level}.inter-step tw {m0}x{m1}"] = chain(
                f, dev(shape), tw
            )
        node, batch, level = node.col, (m1,) + batch, level + 1

    out[f"level{level}.col leaf m={node.m}"] = chain(
        lambda v, t: planner.run_forward(v, node, t), dev((node.m,) + batch), tabs
    )
    return out
