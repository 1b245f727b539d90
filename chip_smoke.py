"""Bring-up proof on NVIDIA GPUs: the NTT main path, bit-exact on the card.

Drives the library's entry points (``plan.NTT``, ``parallel.DistributedNTT``,
``apps.convolve``) at the sizes users of a 64-bit NTT run, and compares every
result in full against the native C++ oracle (``sventt_tpu.native``).  The
arithmetic is exact integer math, so the tolerance is zero.

    python chip_smoke.py           # one GPU: phases 1-8
    python chip_smoke.py --multi   # four GPUs: DistributedNTT at 2^30 only

Each phase prints its wall time.  The last line of standard output is one
JSON object, ``{"ok": true, "device": {"platform", "kind", "count"}}``; a
failed phase exits non-zero before it is printed.  Without a GPU the script
exits non-zero at the first phase, before any transform runs.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from contextlib import contextmanager
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from sventt_tpu import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    native,
)
from sventt_tpu.utils.compile_cache import enable_compile_cache

FLAGSHIP = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
TEST = (TEST_MODULUS, TEST_GENERATOR)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    """Print the phase's wall time; a failure propagates (never swallowed)."""
    log(f"== phase {name}")
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        log(f"== phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
        raise
    log(f"== phase {name}: ok in {time.perf_counter() - t0:.1f} s")


# -- comparison helpers --------------------------------------------------------


def _normalizer(fc):
    import jax

    return jax.jit(fc.normalize)


def _equal(a, b) -> bool:
    import jax
    import jax.numpy as jnp

    eq = jax.jit(
        lambda a, b: jnp.array_equal(a.hi, b.hi) & jnp.array_equal(a.lo, b.lo)
    )
    return bool(eq(a, b))


def assert_same(got: np.ndarray, want: np.ndarray, what: str) -> None:
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != oracle {want.shape}")
    bad = int(np.count_nonzero(got != want))
    if bad:
        first = int(np.flatnonzero(got != want)[0])
        raise AssertionError(
            f"{what}: {bad} of {got.size} values differ from the oracle "
            f"(first at {first}: {int(got[first])} != {int(want[first])})"
        )


def oracle_forward(x: np.ndarray, modulus: int, generator: int) -> np.ndarray:
    out = native.golden_forward(x, modulus, generator)
    if out is None:
        raise RuntimeError("the native oracle is not available")
    return out


def check_transform(cfg, *, donate: bool = False, label: str = "", timed=None):
    """Forward in full against the oracle, then the exact inverse round trip.

    ``timed``: a dict that receives the compile seconds of the forward
    (compiled ahead of time through ``NTT.forward_step``).  Returns the NTT.
    """
    import jax

    from sventt_tpu.field.limb import u64_to_numpy
    from sventt_tpu.plan import NTT
    from sventt_tpu.utils.fill import device_fill, host_fill

    n, N, g = cfg.n, cfg.modulus, cfg.generator
    ntt = NTT(cfg, donate_input=donate)
    norm = _normalizer(ntt.fc)
    t0 = time.perf_counter()
    want = oracle_forward(host_fill(n, N), N, g)
    t_oracle = time.perf_counter() - t0
    x = device_fill(n, N)
    t0 = time.perf_counter()
    if timed is not None:
        step, tables = ntt.forward_step()
        fwd = jax.jit(step).lower(x, *tables).compile()
        timed["compile_s"] = time.perf_counter() - t0
        y = fwd(x, *tables)
    else:
        y = ntt.compute_forward(x)
    y = norm(y)
    got = u64_to_numpy(y)
    t_dev = time.perf_counter() - t0
    assert_same(got, want, f"{label} forward")
    del got, want
    back = norm(ntt.compute_inverse(y))
    if not _equal(back, device_fill(n, N)):
        raise AssertionError(f"{label} inverse round trip is not exact")
    log(
        f"  {label}: n=2^{n.bit_length() - 1} N={N:#x} engine={ntt.engine} "
        f"modmul={ntt.fc.modmul} donate={donate}: forward == oracle on all "
        f"{n} values (oracle {t_oracle:.1f} s, device incl. compile "
        f"{t_dev:.1f} s); inverse round trip exact"
    )
    return ntt


# -- phases ------------------------------------------------------------------------


def phase_device(cache_dir: str):
    """The first JAX device must be a GPU; print what the run stands on."""
    import jax
    import jaxlib

    from sventt_tpu.utils.device import gpu_card_info, require_gpu

    try:
        dev = require_gpu()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: {e}; refusing to run on it") from None
    log(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log(f"  devices: {len(jax.devices())} x {dev.device_kind} ({dev.platform})")
    entries = sum(1 for _ in Path(cache_dir).glob("*")) if Path(cache_dir).is_dir() else 0
    log(f"  compile cache: {cache_dir} ({entries} entries at start)")
    log("  card (nvidia-smi name, power.limit):")
    card = gpu_card_info()
    for line in card.splitlines():
        log(line)
    return dev, card.splitlines()[0]


def phase_oracle() -> None:
    """The C++ oracle is built from the committed sources, and agrees with
    the Python golden model on a small input."""
    from sventt_tpu.field.golden import GoldenNTT
    from sventt_tpu.field.modulus import Modulus
    from sventt_tpu.utils.fill import host_fill

    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError(
            "native oracle unavailable: sventt_tpu/native/*.cc did not build"
        )
    log(f"  built/loaded in {time.perf_counter() - t0:.1f} s")
    m = 256
    x = host_fill(m, FLAGSHIP_MODULUS)
    got = oracle_forward(x, *FLAGSHIP)
    want = GoldenNTT(m, Modulus(*FLAGSHIP)).forward([int(v) for v in x])
    if [int(v) for v in got] != want:
        raise AssertionError("native oracle disagrees with the golden model")
    log("  oracle == Python golden model at m=256 (flagship modulus)")


def phase_flagship(log2n: int = 17) -> None:
    from sventt_tpu.plan import NttConfig

    check_transform(NttConfig(*FLAGSHIP, 1 << log2n), label="flagship")


def phase_blocked(log2n: int = 24, timed=None) -> None:
    """The flagship modulus, and the 62-bit test modulus with the shoup
    multiply that 'auto' picks at this size."""
    from sventt_tpu.plan import NttConfig
    from sventt_tpu.plan.wrapper import SHOUP_MIN_N

    check_transform(NttConfig(*FLAGSHIP, 1 << log2n), label="flagship", timed=timed)
    ntt = check_transform(NttConfig(*TEST, 1 << log2n), label="test-modulus")
    want = "shoup" if 1 << log2n >= SHOUP_MIN_N else "montgomery"
    if ntt.fc.modmul != want:
        raise AssertionError(f"auto modmul at 2^{log2n} is {ntt.fc.modmul}, not {want}")


def phase_large(log2n: int = 28) -> None:
    from sventt_tpu.plan import NttConfig

    check_transform(NttConfig(*FLAGSHIP, 1 << log2n), donate=True, label="flagship")


ENGINES = ("jnp", "mxu")


def phase_engines(log2n: int = 20) -> None:
    from sventt_tpu.plan import NttConfig

    for engine in ENGINES:
        check_transform(
            NttConfig(*FLAGSHIP, 1 << log2n, engine=engine), label=f"engine={engine}"
        )


def phase_app(log2n: int = 20) -> None:
    """One cyclic convolution through apps.convolve against the oracle's
    forward, pointwise product and inverse."""
    import jax

    from sventt_tpu.apps.convolve import cyclic_convolve, make_convolver
    from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
    from sventt_tpu.utils.fill import host_fill

    n = 1 << log2n
    N, g = FLAGSHIP
    both = host_fill(2 * n, N)
    a, b = both[:n], both[n:]
    spec = native.pointwise_mul(
        oracle_forward(a, N, g), oracle_forward(b, N, g), N
    )
    want = native.golden_inverse(spec, N, g)
    ntt = make_convolver(N, g, n)
    out = cyclic_convolve(
        ntt, jax.device_put(u64_from_numpy(a)), jax.device_put(u64_from_numpy(b))
    )
    got = u64_to_numpy(_normalizer(ntt.fc)(out))
    assert_same(got, want, "cyclic convolution")
    log(f"  cyclic convolution n=2^{log2n} engine={ntt.engine} == oracle on all {n} values")


def time_forward(ntt, x, runs: int) -> list[float]:
    """Milliseconds of ``runs`` forward calls after one warm-up, each ended
    by block_until_ready."""
    import jax

    jax.block_until_ready(ntt.compute_forward(x))
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(ntt.compute_forward(x))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_timings(card: str, sizes=(24, 28), runs: int = 7, cold=None) -> None:
    """Informational: forward ms per engine and size, and compile seconds."""
    import jax

    from sventt_tpu.plan import NTT, NttConfig
    from sventt_tpu.utils.fill import device_fill

    for log2n in sizes:
        for engine in ENGINES:
            cfg = NttConfig(*FLAGSHIP, 1 << log2n, engine=engine)
            ntt = NTT(cfg, enable_inverse=False)
            x = device_fill(cfg.n, cfg.modulus)
            ms = time_forward(ntt, x, runs)
            log(
                f"  forward 2^{log2n} engine={engine}: median "
                f"{statistics.median(ms):.3f} ms over {runs} runs "
                f"(min {min(ms):.3f}, max {max(ms):.3f}) [{card}]"
            )
            del ntt, x
    if cold is not None:
        # the same program again, after dropping every in-memory cache:
        # served from the persistent compilation cache
        jax.clear_caches()
        cfg = NttConfig(*FLAGSHIP, 1 << sizes[0])
        ntt = NTT(cfg, enable_inverse=False)
        x = device_fill(cfg.n, cfg.modulus)
        step, tables = ntt.forward_step()
        t0 = time.perf_counter()
        jax.jit(step).lower(x, *tables).compile()
        warm = time.perf_counter() - t0
        log(
            f"  compile 2^{sizes[0]} forward (default engine): first "
            f"{cold['compile_s']:.2f} s, again from the persistent cache "
            f"{warm:.2f} s [{card}]"
        )


def phase_multi(
    log2n: int = 30, devices: int = 4, hbm_bytes: int | None = None,
    overlap_chunks: int = 2,
) -> None:
    """DistributedNTT over a 1-D mesh of ``devices`` devices, for both
    schedules (the overlap one in ``overlap_chunks`` chunks): forward in
    full against the oracle, exact inverse round trip, and each device's
    memory use."""
    import jax

    from sventt_tpu.field.limb import u64_to_numpy
    from sventt_tpu.parallel import (
        DistributedNTT,
        device_bytes_limit,
        distributed_memory_budget,
        make_ntt_mesh,
    )
    from sventt_tpu.plan import NttConfig
    from sventt_tpu.utils.fill import device_fill, host_fill

    n = 1 << log2n
    N, g = FLAGSHIP
    mesh = make_ntt_mesh(devices)
    cfg = NttConfig(N, g, n, strategy="six_step")
    budget = distributed_memory_budget(cfg, devices)
    limit = hbm_bytes if hbm_bytes is not None else device_bytes_limit(
        list(mesh.devices.flat)
    )
    log(
        f"  budget per device (both directions, no donation): "
        f"{budget.total / 2**30:.2f} GiB of {limit / 2**30:.2f} GiB"
    )
    if not budget.fits(limit):
        raise AssertionError("the 2^30 plan does not fit the devices' memory")
    t0 = time.perf_counter()
    want = oracle_forward(host_fill(n, N), N, g)
    log(f"  oracle forward 2^{log2n}: {time.perf_counter() - t0:.1f} s")
    for comm in ("xla", "overlap"):
        t0 = time.perf_counter()
        dntt = DistributedNTT(cfg, mesh, comm=comm, overlap_chunks=overlap_chunks)
        norm = _normalizer(dntt.fc)
        x = device_fill(n, N, sharding=dntt.sharding())
        y = norm(dntt.compute_forward(x))
        y.hi.block_until_ready()
        t_dev = time.perf_counter() - t0
        assert_same(u64_to_numpy(y), want, f"distributed comm={comm} forward")
        back = norm(dntt.compute_inverse(y))
        if not _equal(back, x):
            raise AssertionError(f"distributed comm={comm} inverse round trip")
        log(
            f"  comm={comm}: n=2^{log2n} over {devices} devices, forward == "
            f"oracle on all {n} values (device incl. compile {t_dev:.1f} s); "
            "inverse round trip exact"
        )
        for d in mesh.devices.flat:
            st = d.memory_stats() or {}
            log(
                f"    {d}: in use {st.get('bytes_in_use', 0) / 2**30:.2f} GiB, "
                f"peak {st.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB"
            )
        del dntt, x, y, back


def main(argv: list[str]) -> int:
    multi = "--multi" in argv
    cache_dir = enable_compile_cache()
    import jax

    with phase("1 device"):
        dev, card = phase_device(cache_dir)
    with phase("2 oracle"):
        phase_oracle()
    if multi:
        with phase("multi: DistributedNTT 2^30 over 4 GPUs"):
            phase_multi()
    else:
        cold: dict = {}
        with phase("3 flagship 2^17"):
            phase_flagship()
        with phase("4 blocked 2^24"):
            phase_blocked(timed=cold)
        with phase("5 large 2^28 (donated input)"):
            phase_large()
        with phase("6 engines at 2^20"):
            phase_engines()
        with phase("7 app: cyclic convolution 2^20"):
            phase_app()
        with phase("8 timings (informational)"):
            phase_timings(card, cold=cold)
    devs = jax.devices()
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devs),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
