"""NTT configuration-matrix benchmark with built-in verification.

The analogue of the reference's combined test+benchmark binaries
(reference tests/bench-ntt.cpp + tests/ntt-tests/*.hpp, SURVEY.md 2.2):
every configuration is timed AND verified in the same run -- bit-exactly
against the native golden oracle at every size (O(m log m) C++), plus the
forward/inverse round trip.  Each config runs in its own process, one after
another; the parent never opens the GPU.  A config that finds no GPU fails.

Emits one JSON line per config and direction:
  {"config", "n", "engine", "modmul", "direction", "ms", "gbutterfly_s",
   "verified", "card"}

Usage: python benchmarks/bench_ntt.py [--quick]
"""

from __future__ import annotations

import sys

sys.path.insert(0, ".")

import numpy as np

from benchmarks.common import chain_time_ms, emit, log
from sventt_tpu import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    native,
)
from sventt_tpu.field.limb import U64, u64_from_numpy, u64_to_numpy
from sventt_tpu.plan import NTT, NttConfig

#: (name, log2n, modulus, generator, engine, modmul) -- mirrors the
#: reference's test matrix (iterative 2^10..2^13, four/six-step 2^15/2^17,
#: blocked 2^24) on both the 62-bit test modulus and the 64-bit flagship.
CONFIGS = [
    ("iterative-2p10", 10, TEST_MODULUS, TEST_GENERATOR, "auto", "auto"),
    ("iterative-2p12", 12, TEST_MODULUS, TEST_GENERATOR, "auto", "auto"),
    ("sixstep-2p15", 15, TEST_MODULUS, TEST_GENERATOR, "auto", "auto"),
    ("sixstep-2p17-flagship", 17, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "auto", "auto"),
    ("sixstep-2p20-flagship", 20, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "auto", "auto"),
    ("sixstep-2p20-jnp", 20, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "jnp", "auto"),
    ("blocked-2p24-flagship", 24, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "auto", "auto"),
    ("blocked-2p24-shoup", 24, TEST_MODULUS, TEST_GENERATOR, "auto", "shoup"),
    ("huge-2p26-flagship", 26, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "auto", "auto"),
]

QUICK = {"iterative-2p10", "sixstep-2p17-flagship"}


def verify(ntt: NTT, x: np.ndarray, fwd_dev: U64) -> bool:
    n = ntt.get_m()
    N = ntt.config.modulus
    fwd = u64_to_numpy(ntt.fc.normalize(fwd_dev))
    # Full bit-exact check at EVERY size: the native oracle is O(m log m)
    # C++ with OpenMP (seconds at 2^24).
    want = native.golden_forward(x, N, ntt.config.generator)
    if want is None:
        raise RuntimeError("the native oracle is not available")
    if not (fwd == want).all():
        return False
    if ntt._inv is not None:
        back = ntt.inverse_numpy(fwd)
        return bool((back == x).all())
    return True


def run_config(name: str) -> None:
    """Time-then-verify one config (run in its own process, so device
    memory and compile state are per-config)."""
    from sventt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from sventt_tpu.utils.device import gpu_card_info, require_gpu

    require_gpu()
    card = gpu_card_info().splitlines()[0]
    rng = np.random.default_rng(0)
    [(name, log2n, N, g, engine, modmul)] = [c for c in CONFIGS if c[0] == name]
    n = 1 << log2n
    cfg = NttConfig(N, g, n, engine=engine, modmul=modmul)
    # Serve autotuned knobs when this (config, device) was tuned before;
    # never tune inside a bench (same policy as bench.py).
    from sventt_tpu.plan.autotune import tune

    cfg = tune(cfg, on_miss="skip")
    log(f"bench_ntt: {name} ...")
    ntt = NTT(cfg)
    x = rng.integers(0, N, n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x))

    fwd = ntt.compute_forward(xd)  # warm-up / compile

    step_f, tabs_f = ntt.forward_step()
    step_i, tabs_i = ntt.inverse_step()
    ms_f = chain_time_ms(step_f, xd, tabs_f)
    ms_i = chain_time_ms(step_i, fwd, tabs_i)
    ok = verify(ntt, x, fwd)
    bfly = n * log2n / 2
    for direction, ms in (("forward", ms_f), ("inverse", ms_i)):
        emit(
            {
                "config": name,
                "n": n,
                "engine": ntt.engine,
                "modmul": ntt.fc.modmul,
                "direction": direction,
                "ms": round(ms, 4),
                "gbutterfly_s": round(bfly / ms / 1e6, 3),
                "verified": ok,
                "card": card,
            }
        )


def main() -> None:
    if "--config" in sys.argv:
        run_config(sys.argv[sys.argv.index("--config") + 1])
        return
    import subprocess

    quick = "--quick" in sys.argv
    for name, *_ in CONFIGS:
        if quick and name not in QUICK:
            continue
        rc = subprocess.call(
            [sys.executable, __file__, "--config", name]
        )
        if rc:
            emit({"config": name, "error": f"exit {rc}"})


if __name__ == "__main__":
    main()
