"""Memory-system and interconnect characterization.

The analogue of the reference's bench-stream-cmg NUMA study (reference
tests/bench-stream-cmg.cpp: reduce/memset/memcpy between CMG pairs): here
device-memory copy/reduce bandwidth on one GPU, and all-to-all bandwidth
over the mesh (NVLink between GPUs) -- the transport the distributed
six-step transpose rides.  Fails without a GPU.

Emits one JSON line per point:
  {"kind": "stream_copy"|"stream_reduce"|"all_to_all", "regime": "l2"|"hbm", ...}

Usage: python benchmarks/bench_stream.py [--quick]
"""

from __future__ import annotations

import sys

sys.path.insert(0, ".")

from benchmarks.common import chain_time_ms, emit, log
from sventt_tpu.utils.compile_cache import enable_compile_cache

#: Bytes a chained loop over a buffer may keep in the GPU's L2 cache (an
#: H100 has 50 MB): a copy of at most this many bytes (read + write) can be
#: served from L2 rather than device memory.
L2_BYTES = 50 * 10**6


def _regime(nbytes: int) -> str:
    """Which memory tier a chained copy over this buffer streams."""
    if 2 * nbytes <= L2_BYTES:
        return "l2"
    if nbytes >= 4 * L2_BYTES:
        return "hbm"
    return "transitional"


def bench_hbm(quick: bool) -> None:
    import jax
    import jax.numpy as jnp

    sizes = [1 << 24, 1 << 26] if quick else [1 << 22, 1 << 24, 1 << 26, 1 << 28]
    for n in sizes:  # uint32 elements
        x = jax.device_put(jnp.ones((n,), jnp.uint32))

        copy = jax.jit(lambda a: a + jnp.uint32(1))
        ms = chain_time_ms(copy, x)
        emit(
            {
                "kind": "stream_copy",
                "regime": _regime(n * 4),
                "bytes": n * 4,
                "ms": round(ms, 4),
                "gbps": round(n * 4 * 2 / (ms / 1e3) / 1e9, 1),
            }
        )

        def reduce_step(a):
            s = jnp.sum(a, dtype=jnp.uint32)
            return a + s  # keep shape for chaining

        ms = chain_time_ms(jax.jit(reduce_step), x)
        emit(
            {
                "kind": "stream_reduce",
                "regime": _regime(n * 4),
                "bytes": n * 4,
                "ms": round(ms, 4),
                "gbps": round(n * 4 * 3 / (ms / 1e3) / 1e9, 1),
            }
        )


def bench_all_to_all(quick: bool) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    devices = jax.devices()
    if len(devices) < 2:
        log("bench_stream: single device, skipping all-to-all")
        return
    d = len(devices)
    mesh = jax.make_mesh((d,), ("x",))
    sizes = [1 << 22] if quick else [1 << 20, 1 << 22, 1 << 24]
    for n in sizes:
        rows = d * 8
        cols = n // rows
        x = jax.device_put(
            jnp.ones((rows, cols), jnp.uint32), NamedSharding(mesh, P("x"))
        )

        def a2a_local(block):
            y = jax.lax.all_to_all(block, "x", split_axis=1, concat_axis=0, tiled=True)
            return jax.lax.all_to_all(y, "x", split_axis=0, concat_axis=1, tiled=True)

        a2a = jax.jit(
            jax.shard_map(a2a_local, mesh=mesh, in_specs=P("x"), out_specs=P("x"))
        )

        ms = chain_time_ms(a2a, x) / 2  # two all-to-alls per step
        # each device's shard is per_dev bytes; it sends (d-1)/d of it.
        # egress/time is per-DEVICE bandwidth; the fleet-wide total over
        # time is AGGREGATE interconnect bandwidth (d concurrent senders),
        # not a per-link rate -- labeling matters for roofline calibration.
        per_dev = n // d * 4
        egress = per_dev * (d - 1) // d
        emit(
            {
                "kind": "all_to_all",
                "devices": d,
                "bytes_per_device": per_dev,
                "ms": round(ms, 4),
                "gbps_per_device": round(egress / (ms / 1e3) / 1e9, 2),
                "aggregate_gbps": round(d * egress / (ms / 1e3) / 1e9, 2),
            }
        )


def main() -> None:
    enable_compile_cache()
    from sventt_tpu.utils.device import gpu_card_info, require_gpu

    require_gpu()
    log(f"bench_stream: card {gpu_card_info()}")
    quick = "--quick" in sys.argv
    bench_hbm(quick)
    bench_all_to_all(quick)


if __name__ == "__main__":
    main()
