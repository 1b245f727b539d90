"""Headline benchmark: the 2^24-point flagship forward NTT on one GPU.

Times the transform, then verifies it in full against the native C++ oracle
(every output value, not a checksum), and prints two JSON lines:

  {"metric": "ntt_2p24_forward_ms", "value", "unit", "device", "card"}
  {"verified": true|false, "method", "samples_ms", "chain_k", ...}

The input is a full-range splitmix64 fill generated on the device
(utils/fill.py), mirrored on the host for the oracle.  Timing is the
single-dispatch chain of utils/truetime.py: one jitted fori_loop of k
dependent transforms, completion forced by a readback, fixed overhead
subtracted.  Exits non-zero without a GPU, and when verification fails.

Env overrides: BENCH_N (log2 points, default 24), BENCH_SECONDS (target
device seconds per timed chain, default 2).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from sventt_tpu.utils.compile_cache import enable_compile_cache


def main() -> int:
    enable_compile_cache()
    import jax

    from sventt_tpu import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, native
    from sventt_tpu.field.limb import u64_to_numpy
    from sventt_tpu.plan import NTT, NttConfig
    from sventt_tpu.plan.autotune import tune
    from sventt_tpu.utils.device import gpu_card_info, require_gpu
    from sventt_tpu.utils.fill import device_fill, host_fill
    from sventt_tpu.utils.truetime import time_chained

    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    card = gpu_card_info().splitlines()[0]
    log2n = int(os.environ.get("BENCH_N", "24"))
    seconds = float(os.environ.get("BENCH_SECONDS", "2"))
    n = 1 << log2n

    # Serve autotuned knobs when this (config, device) was tuned before;
    # never tune inside a bench.
    cfg = tune(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n), on_miss="skip")
    ntt = NTT(cfg, enable_inverse=False)
    print(f"bench: n=2^{log2n} plan={ntt.plan} card={card}", file=sys.stderr)
    x = device_fill(n, cfg.modulus)
    step, tables = ntt.forward_step()
    t0 = time.perf_counter()
    res = time_chained(step, x, tables, seconds=seconds, reps=3)
    print(
        f"bench: compile+measure {time.perf_counter() - t0:.1f}s "
        f"(overhead {res.rtt_ms:.2f} ms, k={res.k}, samples {res.samples})",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": f"ntt_2p{log2n}_forward_ms",
        "value": res.ms,
        "unit": "ms",
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "card": card,
    }), flush=True)

    # Full verification through the already-compiled chain program (k=1).
    y = res.chain_fn(x, np.int32(1), *tables)
    got = u64_to_numpy(jax.jit(ntt.fc.normalize)(y))
    want = native.golden_forward(host_fill(n, cfg.modulus), cfg.modulus, cfg.generator)
    if want is None:
        print("bench: native oracle unavailable", file=sys.stderr)
        return 1
    bad = int(np.count_nonzero(got != want))
    print(json.dumps({
        "verified": bad == 0,
        "method": "every output value vs the native golden oracle",
        "mismatches": bad,
        "samples_ms": res.samples,
        "overhead_ms": res.rtt_ms,
        "chain_k": res.k,
    }), flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
