"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices so the multi-device
(shard_map / all-to-all) paths are exercised without GPUs (SURVEY.md
section 5, "multi-node without a cluster").  Everything under test is plain
XLA, so the CPU compiles the same programs the GPU does; only timings and
the GPU compiler's own limits need the card (``python chip_smoke.py``).

The env mutation must happen before the first ``import jax`` anywhere in the
test process, which conftest.py guarantees during pytest startup.
"""

import os

# Force a deterministic 8-device CPU platform.  If jax was already imported
# (latching JAX_PLATFORMS), env mutation alone is not enough: update the
# live jax config too.  The XLA_FLAGS mutation still works because the CPU
# backend is created lazily, after conftest import.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x5EED)
