"""Autotuner benchmark: tuned vs static-default configs on the bench matrix.

Runs the measure-and-cache tuner (plan/autotune.py) for each matrix config,
then times tuned vs default side by side and emits one JSON row per config:
  {"config", "n", "default_ms", "tuned_ms", "speedup", "knobs"}

The tuner's winners persist in autotune_cache.json (repo root; GPU timings
only), so later runs -- including NttConfig(tune=True) users and bench.py --
get them for free.  This is the analogue of the reference generating its
parameter headers from the Fugaku tuning corpus (reference
tests/bench-transpose.cpp:105-499, README.md:26-27).  Each config runs in
its own process, one after another; the parent never opens the GPU.

Usage: python benchmarks/bench_autotune.py [--quick] [--force]
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
)
from sventt_tpu.field.limb import u64_from_numpy
from sventt_tpu.plan import NTT, NttConfig
from sventt_tpu.plan.autotune import KNOB_FIELDS, tune

#: (name, log2n, modulus, generator, engine, modmul) -- the FULL
#: bench_ntt.py matrix (same names, same constraint pins, so the cache
#: keys written here are exactly the keys bench_ntt.py and bench.py look
#: up).  Constrained entries (pinned engine/modmul) search the reduced
#: candidate set under the same pin.
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
    ("huge-2p28-flagship", 28, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "auto", "auto"),
]

QUICK = {"sixstep-2p17-flagship"}


def run_config(name: str, force: bool) -> None:
    """Tune one config (in this process), then time tuned vs default."""
    from sventt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from sventt_tpu.utils.device import gpu_card_info, require_gpu

    require_gpu()
    card = gpu_card_info().splitlines()[0]
    rng = np.random.default_rng(0)
    [(name, log2n, N, g, engine, modmul)] = [c for c in CONFIGS if c[0] == name]
    n = 1 << log2n
    base = NttConfig(N, g, n, engine=engine, modmul=modmul)
    log(f"bench_autotune: tuning {name} ...")
    tuned_cfg = tune(base, force=force)

    x = jax.device_put(u64_from_numpy(rng.integers(0, N, n, dtype=np.uint64)))
    ntt_d = NTT(base, enable_inverse=False)
    step_d, tabs_d = ntt_d.forward_step()
    ms_d = chain_time_ms(step_d, x, tabs_d)
    del ntt_d
    ntt_t = NTT(tuned_cfg, enable_inverse=False)
    step_t, tabs_t = ntt_t.forward_step()
    ms_t = chain_time_ms(step_t, x, tabs_t)
    del ntt_t
    emit(
        {
            "config": name,
            "n": n,
            "default_ms": ms_d,
            "tuned_ms": ms_t,
            "speedup": ms_d / ms_t,
            "knobs": {k: getattr(tuned_cfg, k) for k in KNOB_FIELDS},
            "card": card,
        }
    )


def main() -> None:
    force = "--force" in sys.argv
    if "--config" in sys.argv:
        run_config(sys.argv[sys.argv.index("--config") + 1], force)
        return
    import subprocess

    quick = "--quick" in sys.argv
    for name, *_ in CONFIGS:
        if quick and name not in QUICK:
            continue
        args = [sys.executable, __file__, "--config", name]
        if force:
            args.append("--force")
        rc = subprocess.call(args)
        if rc:
            emit({"config": name, "error": f"exit {rc}"})


if __name__ == "__main__":
    main()
