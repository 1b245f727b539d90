"""Bring-up checks: the program needs no Pallas kernel, and the GPU scripts
hold their contract.

The engine rule depends on n alone; every module imports with Pallas and
Mosaic blocked; the compile cache lives where the environment says or
at one fixed path; removed knobs, engines and schedules are refused; and
``chip_smoke.py``'s phases pass at small sizes here, while the script itself
refuses to run without a GPU.
"""

import importlib.util
import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import sventt_tpu
from sventt_tpu import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, native
from sventt_tpu.plan import NTT, NttConfig, wrapper
from sventt_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_auto_engine_depends_only_on_n(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(wrapper, "MXU_MIN_N", 1 << 18)
    monkeypatch.setattr(wrapper, "MXU_MAX_N", 1 << 24)
    got = {k: wrapper._resolve_engine("auto", 1 << k) for k in (10, 17, 18, 20, 24, 25, 28)}
    assert got == {
        10: "jnp", 17: "jnp", 18: "mxu", 20: "mxu", 24: "mxu", 25: "jnp", 28: "jnp"
    }
    assert wrapper._resolve_engine("jnp", 1 << 20) == "jnp"
    assert wrapper._resolve_engine("mxu", 1 << 10) == "mxu"


def test_auto_engine_reaches_the_plan(monkeypatch):
    monkeypatch.setattr(wrapper, "MXU_MIN_N", 1 << 12)
    monkeypatch.setattr(wrapper, "MXU_MAX_N", 1 << 12)
    assert NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12)).engine == "mxu"
    assert NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 10)).engine == "jnp"


_BLOCKER = """
import importlib.abc, pkgutil, sys
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import sventt_tpu
names = [
    m.name for m in pkgutil.walk_packages(sventt_tpu.__path__, "sventt_tpu.")
    if not m.name.endswith("libsventt_host")  # the native oracle's ctypes library
]
for name in names:
    __import__(name)
print(len(names))
"""


@pytest.mark.parametrize(
    "blocked",
    [
        ("jax.experimental.pallas",),
        ("jax.experimental.pallas", "jax._src.pallas", "jax.experimental.mosaic"),
    ],
)
def test_every_module_imports_without_pallas(blocked):
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKER.format(blocked=blocked)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    expected = sum(
        1 for m in pkgutil.walk_packages(sventt_tpu.__path__, "sventt_tpu.")
        if not m.name.endswith("libsventt_host")
    )
    assert int(r.stdout.split()[-1]) == expected >= 20


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else is set


def test_compile_cache_default_is_repo_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize(
    "knob", ["block_b", "stages_per_call", "lane_rows", "max_r", "tw_layout", "transpose"]
)
def test_removed_knobs_are_refused(knob):
    with pytest.raises(TypeError, match=knob):
        NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 10, **{knob: 256})


def test_pallas_engine_is_refused():
    with pytest.raises(ValueError, match="pallas"):
        NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 10, engine="pallas")


def test_ring_comm_is_refused():
    from sventt_tpu.parallel import DistributedNTT, make_ntt_mesh

    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12, strategy="six_step")
    with pytest.raises(ValueError, match="ring"):
        DistributedNTT(cfg, make_ntt_mesh(4), comm="ring")


# -- chip_smoke.py ---------------------------------------------------------------


@pytest.mark.skipif(not native.available(), reason="no host compiler for the oracle")
@pytest.mark.parametrize(
    "phase,kwargs",
    [
        ("phase_oracle", {}),
        ("phase_flagship", {"log2n": 12}),
        ("phase_blocked", {"log2n": 14, "timed": {}}),
        ("phase_large", {"log2n": 13}),
        ("phase_engines", {"log2n": 12}),
        ("phase_app", {"log2n": 11}),
        ("phase_timings", {"card": "cpu", "sizes": (12,), "runs": 2,
                           "cold": {"compile_s": 0.0}}),
        ("phase_multi", {"log2n": 12, "devices": 4, "hbm_bytes": 1 << 30,
                         "overlap_chunks": 2}),
    ],
)
def test_chip_smoke_phases_pass_small(phase, kwargs, capsys):
    getattr(_chip_smoke(), phase)(**kwargs)
    out = capsys.readouterr().out
    if phase not in ("phase_oracle", "phase_timings"):
        assert "oracle" in out and "FAILED" not in out


def test_chip_smoke_compare_reports_mismatch():
    import numpy as np

    cs = _chip_smoke()
    a = np.arange(8, dtype=np.uint64)
    cs.assert_same(a, a.copy(), "same")
    b = a.copy()
    b[5] += 1
    with pytest.raises(AssertionError, match="1 of 8 values differ"):
        cs.assert_same(b, a, "off by one")


def test_chip_smoke_phase_failure_propagates(capsys):
    cs = _chip_smoke()
    with pytest.raises(RuntimeError):
        with cs.phase("x"):
            raise RuntimeError("boom")
    assert "phase x: FAILED" in capsys.readouterr().out


def test_chip_smoke_refuses_cpu():
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout
    assert "round trip" not in r.stdout  # no phase ran past the device check


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert r.returncode != 0
    last = r.stdout.strip().splitlines()[-1:] or [""]
    with pytest.raises(ValueError):
        json.loads(last[0])
