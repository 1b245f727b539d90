"""Benchmark-driven per-config autotuner: measure-and-cache knob selection.

The reference has no heuristics: every template parameter -- transpose
class, shuffle stages, padding, block_rows, store_precomputation -- is
chosen from a measured tuning corpus (reference
tests/bench-transpose.cpp:105-499; README.md:26-27 "parameters below were
obtained by benchmarking on Fugaku").  This module is the equivalent for
this framework's knobs:

* ``engine``            -- jnp (butterflies) vs mxu (int8 matrix products)
* ``modmul``            -- montgomery vs shoup vs solinas multiply
* ``max_fused``         -- plan-tree shape (largest leaf)
* ``plan_spec``         -- explicit mixed-engine level factorizations
* ``chunk_elems``       -- jnp engine chunk size
* ``split_w_only``      -- companion-free inter-step twiddle tables

``tune(config)`` runs a staged greedy search (engine x modmul first, then
each engine family's own knobs, then an interleaved playoff between
near-tied candidates), timing each candidate in this process with chained
dependent calls on the current backend (utils/truetime.py), verifies that
the winner is bit-identical to the untuned config, and persists it keyed
by (modulus, generator, n, backend, device kind) so later processes --
including ``NttConfig(..., tune=True)`` construction -- get the tuned knobs
for free.  The default cache file is ``autotune_cache.json`` at the repo
root and holds GPU timings only: a tune on any other backend is returned
but never written there.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from pathlib import Path

from .config import NttConfig

#: Environment override for the persistent cache location.
CACHE_ENV = "SVENTT_TUNE_CACHE"

_DEFAULT_CACHE = Path(__file__).resolve().parents[2] / "autotune_cache.json"

#: Tunable fields copied from a search winner into the returned config.
KNOB_FIELDS = (
    "engine", "modmul", "max_fused", "chunk_elems", "split_w_only",
    "plan_spec",
)


def _cache_path(explicit: str | os.PathLike | None = None) -> Path:
    if explicit is not None:
        return Path(explicit)
    return Path(os.environ.get(CACHE_ENV, _DEFAULT_CACHE))


def _load_cache(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_cache(path: Path, data: dict) -> None:
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _backend() -> str:
    import jax

    return jax.default_backend()


def _device_kind() -> str:
    import jax

    return jax.devices()[0].device_kind.replace(" ", "_")


#: Config fields that constrain the search space.  They are part of the
#: cache key: a search run under a pinned engine/modmul/knob explores a
#: different candidate set, so its winner must not be served to (or
#: clobbered by) an unconstrained tune of the same (N, g, n, device).
CONSTRAINT_FIELDS = (
    "strategy", "engine", "modmul", "n0", "n1", "lazy", "max_fused",
    "chunk_elems", "split_w_only", "plan_spec",
)


def cache_key(config: NttConfig) -> str:
    base = (
        f"{config.modulus}:{config.generator}:{config.n}"
        f":{_backend()}:{_device_kind()}"
    )
    pins = []
    for name in CONSTRAINT_FIELDS:
        v = getattr(config, name)
        if v is None or v == "auto":
            continue
        pins.append(f"{name}={v}")
    # Unconstrained configs keep the bare key.
    return base if not pins else f"{base}:{','.join(pins)}"


def _log(msg: str) -> None:
    print(f"autotune: {msg}", file=sys.stderr, flush=True)


#: Target device seconds per timed chain (utils/truetime.py).
CHAIN_SECONDS = 2.0


def _make_input(config: NttConfig):
    """Deterministic FULL-RANGE input generated ON DEVICE (splitmix64 mix
    of iota, masked below N): every data bit-plane, the high u32 limb
    included, is exercised, and no host-to-device copy is needed."""
    from ..utils.fill import device_fill

    return device_fill(config.n, config.modulus)


def _time_candidate(config: NttConfig, seconds: float, reps: int = 2) -> float:
    """Per-transform forward time of one candidate in this process (median
    of ``reps`` single-dispatch fori_loop chains of ~``seconds`` device
    time each; utils/truetime.py)."""
    from ..utils.truetime import time_chained
    from . import planner
    from .wrapper import NTT

    ntt = NTT(config, enable_inverse=False)
    x = _make_input(config)
    plan = ntt.plan
    r = time_chained(
        lambda v, t: planner.run_forward(v, plan, t),
        x,
        (ntt._fwd_tables,),
        seconds=seconds,
        reps=reps,
    )
    del ntt, x
    gc.collect()
    return r.ms


#: Finalists within this factor of the greedy winner enter the playoff.
PLAYOFF_MARGIN = 1.2

#: Playoff round-robin rounds (each candidate is timed this many times,
#: interleaved, so slow drift -- clocks, temperature -- hits every
#: candidate equally instead of biasing whichever ran last).  Each
#: measurement is already a median of 2 chains.
PLAYOFF_ROUNDS = 2


def _playoff(
    finalists: list[tuple[str, NttConfig]], seconds: float,
    timings: dict[str, float],
) -> tuple[NttConfig, float]:
    """Interleaved re-measurement of near-tied candidates.

    The staged greedy search times candidates SEQUENTIALLY, so any slow
    drift in device state biases the comparison.  The playoff re-times
    every finalist in alternating rounds, so slow drift hits every
    candidate equally, taking each candidate's median across rounds.
    """
    rounds: dict[str, list[float]] = {tag: [] for tag, _ in finalists}
    for _ in range(PLAYOFF_ROUNDS):
        for tag, cfg in finalists:
            try:
                rounds[tag].append(_time_candidate(cfg, seconds))
            except Exception as e:
                _log(f"playoff {tag}: FAILED ({type(e).__name__})")
    best: dict[str, float] = {}
    for tag, ms_list in rounds.items():
        # median across rounds, same rationale as the per-chain median
        ms_list.sort()
        best[tag] = ms_list[len(ms_list) // 2] if ms_list else float("inf")
        _log(f"playoff {tag}: {best[tag]:.3f} ms {ms_list}")
        timings[f"playoff:{tag}"] = best[tag]
    tag, cfg = min(finalists, key=lambda t: best[t[0]])
    return cfg, best[tag]


def _lazy_capable(config: NttConfig) -> bool:
    if config.lazy is False:
        return False
    return config.mod.bit_width <= 62


def _engine_candidates(config: NttConfig) -> list[str]:
    if config.engine != "auto":
        return [config.engine]
    return ["jnp", "mxu"]


def _modmul_candidates(config: NttConfig) -> list[str]:
    if config.modmul != "auto":
        return [config.modmul]
    out = ["montgomery"]
    if _lazy_capable(config):
        out.append("shoup")
    from ..field.limb import solinas_capable

    if solinas_capable(config.modulus):
        # companion-free direct reduction for sparse-high >= 63-bit moduli
        out.append("solinas")
    return out


#: jnp-engine knob grid (coordinate descent when the jnp engine wins).
JNP_KNOB_GRID = (
    ("chunk_elems", (1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22)),
)


def _plan_spec_candidates(n: int) -> tuple[str, ...]:
    """Mixed-engine plan shapes raced for the mxu family at huge n
    (NttConfig.plan_spec): alternative level factorizations and jnp
    column leaves over an mxu backbone."""
    log2n = n.bit_length() - 1
    if log2n == 26:
        return (
            "mxu:512,mxu:512,jnp",   # jnp 2^8 column leaf
            "mxu:512,jnp",           # 2-level: jnp 2^17 chunked col leaf
        )
    if log2n == 28:
        return (
            "mxu:512,mxu:512,jnp",      # 3-level, jnp 2^10 column leaf
            "mxu:256,mxu:256,mxu:256,mxu",  # 4-level, 2^4 leaf
        )
    if log2n == 24:
        return (
            "mxu:512,mxu:512,mxu",      # 2^6 leaf vs the default 2^8^3
        )
    return ()


def search(
    config: NttConfig, seconds: float | None = None
) -> tuple[NttConfig, float, dict[str, float]]:
    """Staged greedy search.

    Returns (winner, winner_ms, timings per candidate tag).  winner_ms is
    the WINNER'S own measurement (its playoff median when a playoff ran),
    never a min over unrelated candidates -- a single anomalously-fast
    measurement of a losing candidate must not be recorded as the
    entry's best_ms.
    """
    if seconds is None:
        seconds = CHAIN_SECONDS
    base = config.with_(tune=False)
    timings: dict[str, float] = {}
    candidates: dict[str, NttConfig] = {}

    def timed(cfg: NttConfig, tag: str) -> float:
        try:
            ms = _time_candidate(cfg, seconds)
        except Exception as e:  # candidate failed to build/compile
            _log(f"{tag}: FAILED ({type(e).__name__}: {e})")
            ms = float("inf")
        else:
            _log(f"{tag}: {ms:.3f} ms")
        timings[tag] = ms
        candidates[tag] = cfg
        return ms

    def finish(
        best: NttConfig, best_ms: float
    ) -> tuple[NttConfig, float, dict]:
        """Interleaved playoff between near-tied measured candidates."""
        finalists: list[tuple[str, NttConfig]] = []
        seen: list[NttConfig] = []
        for tag, ms in sorted(timings.items(), key=lambda kv: kv[1]):
            cfg = candidates[tag]
            if ms > best_ms * PLAYOFF_MARGIN or cfg in seen:
                continue
            finalists.append((tag, cfg))
            seen.append(cfg)
        # playoff-cost guard: each finalist costs PLAYOFF_ROUNDS more
        # measurements (huge transforms also pay table prep)
        limit = 2 if config.n >= (1 << 26) else 3
        finalists = finalists[:limit]
        if len(finalists) < 2:
            return best, best_ms, timings
        winner, winner_ms = _playoff(finalists, seconds, timings)
        return winner, winner_ms, timings

    # Stage A: engine x modmul on default knobs.  Track the best candidate
    # PER ENGINE FAMILY: both families get their knob descent below -- an
    # engine that loses stage A on default knobs can still win after its
    # knobs are tuned.
    best, best_ms = None, float("inf")
    family: dict[str, tuple[NttConfig, float]] = {}
    for eng in _engine_candidates(base):
        for mm in _modmul_candidates(base):
            if eng == "mxu" and base.modmul == "auto" and mm == "shoup":
                # shoup applies to STAGE twiddles only, which the matrix
                # engine replaces -- a pure duplicate of montgomery.
                # solinas is NOT skipped: the inter-step split twiddles
                # (fused into the mxu kernel) do use it, and its
                # companion-free tables halve the split-table read.
                continue
            cand = base.with_(engine=eng, modmul=mm)
            ms = timed(cand, f"{eng}/{mm}")
            if ms < best_ms:
                best, best_ms = cand, ms
            if ms < family.get(eng, (None, float("inf")))[1]:
                family[eng] = (cand, ms)
    if best is None:
        raise RuntimeError("autotune: every candidate failed")

    def descend_jnp(best: NttConfig, best_ms: float):
        # chunk size (only bites when the transform exceeds one chunk) +
        # companion-free inter-step tables.
        from .planner import JNP_RESIDENT_ELEMS, W_ONLY_THRESHOLD

        for name, grid in JNP_KNOB_GRID:
            if config.n <= min(grid):
                break
            current = getattr(best, name) or JNP_RESIDENT_ELEMS
            for val in grid:
                if val == current:
                    continue
                cand = best.with_(**{name: val})
                ms = timed(cand, f"{name}={val}")
                if ms < best_ms:
                    best, best_ms = cand, ms
        if best.split_w_only is None and config.n > config.ITERATIVE_MAX:
            default_w_only = config.n >= W_ONLY_THRESHOLD
            cand = best.with_(split_w_only=not default_w_only)
            ms = timed(cand, f"split_w_only={not default_w_only}")
            if ms < best_ms:
                best, best_ms = cand, ms
        return best, best_ms

    results = []
    if "jnp" in family:
        results.append(descend_jnp(*family["jnp"]))
    if "mxu" in family:
        best_m, best_m_ms = family["mxu"]
        # plan shape: level size trades matmul cost (~ m) against level
        # count (the recombination tail is per-point per-level); the
        # build_plan default is the scheme's largest leaf.  config.n == mf
        # is allowed: build_plan then returns the SINGLE Leaf(n, mxu) --
        # one matrix transform, no split levels.
        from ..ops.ntt_mxu import max_m

        for mf in (64, 128, 256, 512, 1024):
            if mf == (best_m.max_fused or max_m()) or config.n < mf or mf > max_m():
                continue
            cand = best_m.with_(max_fused=mf)
            ms = timed(cand, f"mxu/max_fused={mf}")
            if ms < best_m_ms:
                best_m, best_m_ms = cand, ms
        # mixed-engine plan trees (explicit level factorizations)
        if base.plan_spec is None:
            for spec in _plan_spec_candidates(config.n):
                cand = best_m.with_(plan_spec=spec, max_fused=None)
                ms = timed(cand, f"mxu/plan={spec}")
                if ms < best_m_ms:
                    best_m, best_m_ms = cand, ms
        # the split-table companion knob applies to every engine family
        if best_m.split_w_only is None and config.n > config.ITERATIVE_MAX:
            from .planner import W_ONLY_THRESHOLD

            default_w_only = config.n >= W_ONLY_THRESHOLD
            cand = best_m.with_(split_w_only=not default_w_only)
            ms = timed(cand, f"mxu/split_w_only={not default_w_only}")
            if ms < best_m_ms:
                best_m, best_m_ms = cand, ms
        results.append((best_m, best_m_ms))
    best, best_ms = min(results, key=lambda t: t[1])
    return finish(best, best_ms)


def tune(
    config: NttConfig,
    *,
    force: bool = False,
    seconds: float | None = None,
    cache_path: str | os.PathLike | None = None,
    on_miss: str = "search",
) -> NttConfig:
    """Resolve ``config``'s knobs via the persistent measure-and-cache tuner.

    Cache hit: returns immediately with the stored knobs.  Miss (or
    ``force=True``): runs the staged search on the current backend, stores
    the winner, returns it -- unless ``on_miss="skip"``, which returns the
    config untuned (for benchmark harnesses that must not spend minutes
    tuning on an unseen device).  The returned config has ``tune=False``
    so NTT construction does not recurse.
    """
    path = _cache_path(cache_path)
    key = cache_key(config)
    data = _load_cache(path)
    if not force and key in data:
        knobs = data[key]["knobs"]
        return config.with_(tune=False, **{k: knobs.get(k) for k in KNOB_FIELDS})
    if on_miss == "skip":
        return config.with_(tune=False)

    _log(f"tuning {key} (no cache entry)")
    t0 = time.perf_counter()
    best, best_ms, timings = search(config, seconds)
    _verify_winner(config, best)
    _log(f"winner {_tag(best)} in {time.perf_counter() - t0:.0f}s")
    # Re-read before writing: a search takes many minutes and writing the
    # stale snapshot back would clobber entries added/deleted meanwhile
    # (observed: a concurrent deletion of invalidated keys was undone by a
    # sibling process's end-of-search write).
    data = _load_cache(path)
    data[key] = {
        "knobs": {k: getattr(best, k) for k in KNOB_FIELDS},
        "timings": {
            k: (None if v == float("inf") else round(v, 4))
            for k, v in timings.items()
        },
        "best_ms": round(best_ms, 4),
    }
    if path == _DEFAULT_CACHE and _backend() != "gpu":
        # The default cache is a tuned-parameter corpus for the GPU (the
        # reference ships Fugaku-derived constants the same way); timings
        # from any other backend never go there.
        _log(f"{_backend()} backend: not persisting to the default cache")
        return best
    try:
        _save_cache(path, data)
    except OSError as e:
        _log(f"cache write failed ({e}); continuing untuned-cache")
    return best


def _verify_winner(config: NttConfig, best: NttConfig) -> None:
    """A tuned config must be bit-identical (mod N) to the untuned one.

    Both run on the same full-range device input, one after the other, so
    only one config's tables are resident at a time.
    """
    import jax.numpy as jnp

    from .wrapper import NTT

    base = config.with_(tune=False)
    if best == base:
        return
    x = _make_input(config)

    def forward(cfg: NttConfig):
        ntt = NTT(cfg, enable_inverse=False)
        y = ntt.fc.normalize(ntt.compute_forward(x))
        del ntt
        gc.collect()
        return y

    ref = forward(base)
    got = forward(best)
    same = bool(jnp.array_equal(ref.hi, got.hi) & jnp.array_equal(ref.lo, got.lo))
    del x, ref, got
    if not same:
        raise AssertionError(
            f"autotune winner {_tag(best)} is not bit-identical to the "
            "untuned config -- refusing to cache it"
        )


def _tag(cfg: NttConfig) -> str:
    knobs = " ".join(
        f"{k}={getattr(cfg, k)}"
        for k in KNOB_FIELDS[2:]
        if getattr(cfg, k) is not None
    )
    return f"{cfg.engine}/{cfg.modmul}" + (f" {knobs}" if knobs else "")
