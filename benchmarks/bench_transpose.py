"""Transpose benchmark with built-in verification.

The analogue of the reference's bench-transpose corpus (reference
tests/bench-transpose.cpp:105-499: every shape, verified by the inverse
transpose after timing), for the one transpose the transform paths use:
XLA's own, on the U64 LIMB PAIR (two u32 planes).

Timing via utils/truetime (single-dispatch fori chains, forced readback):
each chain iteration is transpose -> barrier -> transpose back -> barrier,
with `optimization_barrier` keeping both transposes materialized (a fused
T(T(x)) would be optimized to identity).  Verification is a second pass.
Fails without a GPU.

Emits one JSON line per shape:
  {"rows", "cols", "ms", "gbps", "verified", "card"}
(gbps charges read+write of both 4-byte planes.)

Usage: python benchmarks/bench_transpose.py [--quick]
"""

from __future__ import annotations

import sys

sys.path.insert(0, ".")

import numpy as np

from benchmarks.common import emit
from sventt_tpu.field.limb import U64
from sventt_tpu.ops.transpose import transpose_xla
from sventt_tpu.utils.compile_cache import enable_compile_cache

#: Square, moderately skewed, and the 2^24 six-step row-matrix shapes.
SHAPES = [
    (1024, 1024), (4096, 4096), (256, 16384), (16384, 256),
    (256, 65536), (65536, 256),
]


def _alt_chain_ms(x: U64) -> float:
    """Per-transpose ms of the limb pair, two transposes per iteration,
    barrier-separated, so the carry keeps its shape."""
    import jax
    import jax.numpy as jnp

    from sventt_tpu.utils.truetime import time_chained

    def once(v: U64) -> U64:
        return U64(
            jax.lax.optimization_barrier(transpose_xla(v.hi) + jnp.uint32(1)),
            jax.lax.optimization_barrier(transpose_xla(v.lo) + jnp.uint32(1)),
        )

    return time_chained(lambda v: once(once(v)), x, seconds=1.0, reps=2).ms / 2


def main() -> None:
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from sventt_tpu.utils.device import gpu_card_info, require_gpu

    require_gpu()
    card = gpu_card_info().splitlines()[0]
    quick = "--quick" in sys.argv
    rng = np.random.default_rng(0)
    for r, c in SHAPES[:2] if quick else SHAPES:
        x = U64(
            *(
                jax.device_put(
                    jnp.asarray(rng.integers(0, 1 << 32, (r, c), dtype=np.uint32))
                )
                for _ in range(2)
            )
        )
        ms = _alt_chain_ms(x)
        ok = bool((np.asarray(jax.jit(transpose_xla)(x.hi)) == np.asarray(x.hi).T).all())
        gbps = r * c * 8 * 2 / (ms / 1e3) / 1e9
        emit({"rows": r, "cols": c, "ms": ms, "gbps": gbps, "verified": ok, "card": card})


if __name__ == "__main__":
    main()
