"""Autotuner mechanics: knob plumbing, staged search, persistent cache.

The search's TIMING quality can only be judged on real hardware (the tuner
is exercised there by benchmarks/bench_autotune.py); these tests pin the
machinery: candidate enumeration, winner selection, cache round-trip, and
that tuned knobs actually reach the kernels and stay bit-exact.
"""

import json

import numpy as np
import pytest

from sventt_tpu import TEST_GENERATOR, TEST_MODULUS, GoldenNTT, Modulus
from sventt_tpu.plan import NTT, NttConfig, autotune


def _cfg(n=1 << 10, **kw):
    return NttConfig(TEST_MODULUS, TEST_GENERATOR, n, **kw)


def test_knob_fields_validate():
    _cfg(max_fused=128, chunk_elems=1 << 12, split_w_only=True)
    with pytest.raises(ValueError):
        _cfg(max_fused=100)
    with pytest.raises(ValueError):
        _cfg(chunk_elems=-8)
    # the removed Mosaic kernels' knobs and engine are refused outright
    for knob in ("block_b", "stages_per_call", "lane_rows", "max_r", "tw_layout"):
        with pytest.raises(TypeError, match=knob):
            _cfg(**{knob: 128})
    with pytest.raises(ValueError, match="pallas"):
        _cfg(engine="pallas")


def test_knobs_reach_kernels_bit_exact(rng):
    """Non-default knobs through the full NTT wrapper stay bit-exact."""
    n = 1 << 10
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    x = rng.integers(0, TEST_MODULUS, n, dtype=np.uint64)
    want = GoldenNTT(n, mod).forward(list(map(int, x)))
    for cfg in (
        _cfg(n, engine="jnp", max_fused=32, chunk_elems=1 << 6, split_w_only=True),
        _cfg(n, engine="mxu", max_fused=16, split_w_only=False),
    ):
        ntt = NTT(cfg)
        out = ntt.forward_numpy(x)
        assert list(map(int, out)) == want
        assert (ntt.inverse_numpy(out) == x).all()
        # knobs actually reached the plan and the prepared tables
        assert ntt.plan.m1 <= cfg.max_fused
        t = ntt._fwd_tables
        assert t.chunk_elems == cfg.chunk_elems
        tw = t.split_tw[(ntt.plan.m0, ntt.plan.m1)]
        assert (tw.wp is None) == cfg.split_w_only


def test_tune_cpu_picks_jnp_and_caches(tmp_path, monkeypatch):
    """The tuner races both engines on every backend; on a tie the first
    candidate (jnp) wins, and an explicit cache path persists it."""
    cache = tmp_path / "tune.json"
    monkeypatch.setattr(autotune, "_time_candidate", lambda cfg, iters, reps=2: 1.0)
    cfg = _cfg(1 << 10, tune=True)
    tuned = autotune.tune(cfg, cache_path=cache)
    assert tuned.tune is False
    assert tuned.engine == "jnp"
    assert tuned.modmul in ("montgomery", "shoup")
    data = json.loads(cache.read_text())
    [entry] = data.values()
    assert entry["knobs"]["engine"] == "jnp"

    # second call must hit the cache, never the search
    def boom(*a, **k):
        raise AssertionError("search ran on a cache hit")

    monkeypatch.setattr(autotune, "search", boom)
    tuned2 = autotune.tune(cfg, cache_path=cache)
    assert tuned2 == tuned


def test_staged_search_selects_measured_minimum(monkeypatch):
    """A synthetic cost model over both engine families: each family's
    descent walks its own knobs, and the search lands on the minimum."""
    monkeypatch.setattr(
        autotune, "_modmul_candidates", lambda cfg: ["montgomery", "shoup"]
    )

    def fake_time(cfg, iters, reps=2):
        cost = 10.0
        if cfg.engine == "mxu":
            cost -= 1.0
            if cfg.max_fused == 256:
                cost -= 0.5
            if cfg.split_w_only:
                cost -= 0.25
        if cfg.modmul == "shoup":
            cost -= 2.0  # never raced for mxu (a duplicate of montgomery)
        if cfg.chunk_elems == 1 << 19:
            cost -= 0.125
        return cost

    monkeypatch.setattr(autotune, "_time_candidate", fake_time)
    monkeypatch.setattr(autotune, "_verify_winner", lambda c, b: None)
    best, _, timings = autotune.search(_cfg(1 << 20))
    assert (best.engine, best.modmul) == ("jnp", "shoup")
    assert best.chunk_elems == 1 << 19
    assert "mxu/shoup" not in timings
    assert timings["mxu/max_fused=256"] < timings["mxu/montgomery"]
    assert "jnp/montgomery" in timings and "jnp/shoup" in timings


def test_search_survives_failing_candidates(monkeypatch):
    monkeypatch.setattr(
        autotune, "_modmul_candidates", lambda cfg: ["montgomery", "shoup"]
    )

    def flaky(cfg, iters, reps=2):
        if cfg.modmul == "shoup" or cfg.max_fused == 256:
            raise RuntimeError("compile blew up")
        return 5.0

    monkeypatch.setattr(autotune, "_time_candidate", flaky)
    best, _, timings = autotune.search(_cfg(1 << 12, engine="mxu"))
    assert best.modmul == "montgomery"
    assert best.max_fused != 256
    assert timings["mxu/max_fused=256"] == float("inf")
    # the race stays within the default scheme's largest leaf
    assert "mxu/max_fused=1024" not in timings


def test_tune_true_resolves_via_wrapper(tmp_path, monkeypatch):
    """NTT(NttConfig(..., tune=True)) transparently builds with tuned knobs."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "t.json"))
    monkeypatch.setattr(autotune, "_time_candidate", lambda cfg, iters, reps=2: 1.0)
    ntt = NTT(_cfg(1 << 10, tune=True))
    assert ntt.config.tune is False
    assert ntt.config.engine == "jnp"
    x = np.arange(1 << 10, dtype=np.uint64)
    out = ntt.forward_numpy(x)
    assert int(out[0]) == int(x.astype(object).sum() % TEST_MODULUS)
    assert (ntt.inverse_numpy(out) == x).all()


def test_playoff_finalist_selection(monkeypatch):
    """Near-tied candidates are re-raced interleaved; the playoff winner is
    returned even when the greedy pass ranked it second."""
    monkeypatch.setattr(autotune, "_engine_candidates", lambda cfg: ["jnp"])
    monkeypatch.setattr(
        autotune, "_modmul_candidates", lambda cfg: ["montgomery", "shoup"]
    )
    # greedy pass: shoup barely wins; montgomery within the 1.2x margin
    costs = {"montgomery": 1.05, "shoup": 1.0}
    monkeypatch.setattr(
        autotune, "_time_candidate",
        lambda cfg, iters, reps=2: costs[cfg.modmul],
    )
    seen = {}

    def fake_playoff(finalists, iters, timings):
        seen["tags"] = [tag for tag, _ in finalists]
        # interleaved re-race flips the ranking
        winner = next(cfg for tag, cfg in finalists if cfg.modmul == "montgomery")
        return winner, 0.9

    monkeypatch.setattr(autotune, "_playoff", fake_playoff)
    best, _, _ = autotune.search(_cfg(1 << 10))
    assert best.modmul == "montgomery"
    assert seen["tags"] == ["jnp/shoup", "jnp/montgomery"]


def test_playoff_skipped_when_clear_winner(monkeypatch):
    """No playoff when the runner-up is outside the margin."""
    monkeypatch.setattr(autotune, "_engine_candidates", lambda cfg: ["jnp"])
    monkeypatch.setattr(
        autotune, "_modmul_candidates", lambda cfg: ["montgomery", "shoup"]
    )
    costs = {"montgomery": 2.0, "shoup": 1.0}
    monkeypatch.setattr(
        autotune, "_time_candidate",
        lambda cfg, iters, reps=2: costs[cfg.modmul],
    )

    def boom(*a, **k):
        raise AssertionError("playoff ran with a clear winner")

    monkeypatch.setattr(autotune, "_playoff", boom)
    best, _, _ = autotune.search(_cfg(1 << 10))
    assert best.modmul == "shoup"


def test_inprocess_timer():
    """Candidates are timed in this process (one process per device), on a
    real transform, with a sane median."""
    ms = autotune._time_candidate(_cfg(1 << 8), seconds=0.05, reps=2)
    assert 0 < ms < 60_000


@pytest.mark.parametrize("engine", ["jnp", "mxu"])
def test_verify_winner_inprocess(engine):
    """Winner verification compares base vs tuned configs bit-exactly in
    this process, on every backend."""
    base = _cfg(1 << 8, tune=True)
    # identical math, different engine/knob -> must pass
    autotune._verify_winner(base, base.with_(tune=False, engine=engine, modmul="shoup"))
    # a different generator is a different transform -> must fail
    bad = NttConfig(TEST_MODULUS, 11, 1 << 8, tune=False, engine=engine)
    with pytest.raises(AssertionError):
        autotune._verify_winner(base, bad)


def test_engine_candidates_same_on_every_backend(monkeypatch):
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(autotune, "_backend", lambda b=backend: b)
        assert autotune._engine_candidates(_cfg()) == ["jnp", "mxu"]
        assert autotune._engine_candidates(_cfg(engine="mxu")) == ["mxu"]


def test_cache_key_pins_constraints():
    """A search constrained by pinned engine/modmul/knobs explores a
    different candidate set, so its cache entry must not collide with the
    unconstrained tune of the same (N, g, n, device)."""
    free = autotune.cache_key(_cfg(1 << 10))
    pinned = autotune.cache_key(_cfg(1 << 10, engine="mxu"))
    assert free != pinned
    assert "engine=mxu" in pinned
    # unconstrained keys keep the bare format
    assert free.count(":") == 4
    assert autotune.cache_key(_cfg(1 << 10, modmul="shoup")) != pinned


def test_cpu_tune_does_not_write_repo_cache(tmp_path, monkeypatch):
    """Only GPU timings may go to the default cache: tune() on the CPU
    returns its winner but never writes there."""
    fake_default = tmp_path / "repo_cache.json"
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", fake_default)
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.setattr(autotune, "_time_candidate", lambda cfg, iters, reps=2: 1.0)
    tuned = autotune.tune(_cfg(1 << 10, tune=True))
    assert tuned.engine == "jnp"  # search still ran and resolved knobs
    assert not fake_default.exists()
    # an explicit cache path still persists (test/bench isolation)
    explicit = tmp_path / "explicit.json"
    autotune.tune(_cfg(1 << 10, tune=True), cache_path=explicit)
    assert explicit.exists()


def test_gpu_tune_writes_default_cache(tmp_path, monkeypatch):
    """On a GPU backend the winner persists to the default cache."""
    fake_default = tmp_path / "repo_cache.json"
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", fake_default)
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.setattr(autotune, "_backend", lambda: "gpu")
    monkeypatch.setattr(autotune, "_device_kind", lambda: "NVIDIA_H100")
    monkeypatch.setattr(autotune, "_time_candidate", lambda cfg, iters, reps=2: 1.0)
    tuned = autotune.tune(_cfg(1 << 10, tune=True))
    data = json.loads(fake_default.read_text())
    [(key, entry)] = data.items()
    assert ":gpu:NVIDIA_H100" in key
    assert entry["knobs"]["engine"] == tuned.engine
