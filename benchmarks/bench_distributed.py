"""Distributed six-step benchmark: scaling harness for several GPUs.

Times DistributedNTT forward/inverse over the available mesh, for both
schedules (the XLA all-to-all collective and the chunked comm/compute
overlap pipeline), against the single-device transform of the same length
-- the measurement SURVEY.md section 2.5.5 asks for (">= 80% scaling
efficiency").  Fails without a GPU.

Emits one JSON row per (n, comm):
  {"n", "devices", "comm", "fwd_ms", "inv_ms", "single_ms",
   "scaling_efficiency"}

Usage: python benchmarks/bench_distributed.py [--n LOG2N] [--comm xla|overlap]
"""

from __future__ import annotations

import sys

sys.path.insert(0, ".")

import numpy as np

from benchmarks.common import chain_time_ms, emit
from sventt_tpu import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu.field.limb import u64_from_numpy
from sventt_tpu.utils.compile_cache import enable_compile_cache


def main() -> None:
    enable_compile_cache()
    import jax

    from sventt_tpu.parallel import DistributedNTT, make_ntt_mesh
    from sventt_tpu.plan import NTT, NttConfig
    from sventt_tpu.utils.device import gpu_card_info, require_gpu

    require_gpu()
    card = gpu_card_info().splitlines()[0]
    argv = sys.argv
    log2n = int(argv[argv.index("--n") + 1]) if "--n" in argv else 18
    comms = [argv[argv.index("--comm") + 1]] if "--comm" in argv else ["xla", "overlap"]
    n = 1 << log2n
    mesh = make_ntt_mesh()
    D = mesh.devices.size
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step")
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.modulus, n, dtype=np.uint64)

    sntt = NTT(cfg)
    xs = jax.device_put(u64_from_numpy(x))
    step_s, tabs_s = sntt.forward_step()
    single_ms = chain_time_ms(step_s, xs, tabs_s)
    del sntt

    for comm in comms:
        dntt = DistributedNTT(cfg, mesh, comm=comm)
        xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
        step_f, tabs_f = dntt.forward_step()
        step_i, tabs_i = dntt.inverse_step()
        fwd_ms = chain_time_ms(step_f, xd, tabs_f)
        fwd = dntt.compute_forward(xd)
        inv_ms = chain_time_ms(step_i, fwd, tabs_i)
        emit(
            {
                "n": n,
                "devices": D,
                "comm": comm,
                "fwd_ms": round(fwd_ms, 4),
                "inv_ms": round(inv_ms, 4),
                "single_ms": round(single_ms, 4),
                # ideal: fwd_ms == single_ms / D (perfect strong scaling)
                "scaling_efficiency": round(single_ms / (fwd_ms * D), 4),
                "card": card,
            }
        )
        del dntt


if __name__ == "__main__":
    main()
