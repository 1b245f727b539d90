"""Engine table: the butterfly engine against the plain-XLA matrix engine.

For each variant, size and direction: the transform's median wall time over
several calls ended by ``block_until_ready`` (after one warm-up call), the
forward verified in full against the native oracle, and the compiled
program's temporary memory.  ``--hlo`` also reports how XLA compiled the
matrix engine's int8 dots (library GEMM call, Triton GEMM fusion, or a plain
loop emitter).  The output feeds the 'auto' engine rule in
sventt_tpu/plan/wrapper.py and the engine table in PERF.md.

Variants:
  jnp           radix-2 butterflies on u32 limb pairs (ops/ntt_jnp.py)
  mxu-s8        int8 matrix products, 8x8 digit planes (ops/ntt_mxu.py)
  mxu-s8b       the same digits as one banded matrix
  mxu-u7        seven-bit planes

Usage: python benchmarks/bench_engines.py [--sizes 17,20,24,28]
           [--variants jnp,mxu-s8,mxu-s8b] [--runs 7] [--hlo [--dump DIR]]
"""

from __future__ import annotations

import re
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, ".")

from sventt_tpu.utils.compile_cache import enable_compile_cache


def _arg(name: str, default: str) -> str:
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def dot_routes(hlo: str) -> dict:
    """How the optimized HLO carries out its dots: the library calls it
    makes, its fusion kinds, and the plain dot instructions left."""
    return {
        "custom_calls": sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo))),
        "fusion_kinds": sorted(set(re.findall(r"kind=(k\w+)", hlo))),
        "triton_gemm_fusions": len(re.findall(r"__triton_gemm", hlo)),
        "plain_dots": len(re.findall(r" dot\(", hlo)),
    }


def main() -> int:
    from benchmarks.common import emit, log

    cache_dir = enable_compile_cache()
    import jax

    from sventt_tpu import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, native
    from sventt_tpu.field.limb import u64_to_numpy
    from sventt_tpu.ops import ntt_mxu
    from sventt_tpu.plan import NTT, NttConfig
    from sventt_tpu.utils.device import gpu_card_info, require_gpu
    from sventt_tpu.utils.fill import device_fill, host_fill

    dev = require_gpu()
    card = gpu_card_info().splitlines()[0]
    log(f"bench_engines: {dev.device_kind}, card {card}, cache {cache_dir}")
    sizes = [int(s) for s in _arg("--sizes", "17,20,24,28").split(",")]
    variants = _arg("--variants", "jnp,mxu-s8,mxu-s8b").split(",")
    runs = int(_arg("--runs", "7"))
    N, g = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR
    default_scheme = ntt_mxu.SCHEME

    for log2n in sizes:
        n = 1 << log2n
        want = native.golden_forward(host_fill(n, N), N, g)
        for variant in variants:
            engine, _, scheme = variant.partition("-")
            ntt_mxu.SCHEME = scheme or default_scheme
            cfg = NttConfig(N, g, n, engine=engine)
            row = {"variant": variant, "n": n, "card": card}
            try:
                ntt = NTT(cfg)
                x = device_fill(n, N)
                for direction in ("forward", "inverse"):
                    step, tables = (
                        ntt.forward_step() if direction == "forward"
                        else ntt.inverse_step()
                    )
                    t0 = time.perf_counter()
                    compiled = jax.jit(step).lower(x, *tables).compile()
                    compile_s = time.perf_counter() - t0
                    mem = compiled.memory_analysis()
                    y = jax.block_until_ready(compiled(x, *tables))
                    ms = []
                    for _ in range(runs):
                        t0 = time.perf_counter()
                        jax.block_until_ready(compiled(x, *tables))
                        ms.append((time.perf_counter() - t0) * 1e3)
                    r = dict(row, direction=direction,
                             median_ms=statistics.median(ms),
                             min_ms=min(ms), max_ms=max(ms),
                             compile_s=round(compile_s, 2),
                             temp_gib=round(mem.temp_size_in_bytes / 2**30, 3))
                    if direction == "forward":
                        got = u64_to_numpy(jax.jit(ntt.fc.normalize)(y))
                        r["verified"] = bool((got == want).all())
                        if "--hlo" in sys.argv and engine == "mxu":
                            hlo = compiled.as_text()
                            r["dot_routes"] = dot_routes(hlo)
                            if "--dump" in sys.argv:
                                out = Path(_arg("--dump", "."))
                                out.mkdir(parents=True, exist_ok=True)
                                (out / f"{variant}-2p{log2n}.hlo.txt").write_text(hlo)
                    emit(r)
                    del y, compiled
                del ntt, x
            except Exception as e:  # report the variant, go on with the rest
                emit(dict(row, error=f"{type(e).__name__}: {str(e)[:300]}"))
            ntt_mxu.SCHEME = default_scheme
        del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
