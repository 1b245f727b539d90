"""Chain-timing harness (utils/truetime.py) on the CPU backend.

A CPU run gives no device time, so these tests only pin the mechanics:
the fori_loop chain really applies the step k times, pytree
carries and table arguments flow through, and the stream calibrator
returns something positive and finite.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sventt_tpu.field.limb import U64
from sventt_tpu.utils.truetime import time_chained


def test_time_chained_mechanics():
    x = jax.device_put(jnp.zeros((128,), jnp.uint32))
    r = time_chained(lambda a: a + jnp.uint32(1), x, seconds=0.02, reps=2)
    assert r.ms >= 0 and r.k >= 4 and len(r.samples) == 2
    assert r.samples == sorted(r.samples)


def test_time_chained_pytree_and_tables():
    x = U64(jnp.zeros((8,), jnp.uint32), jnp.zeros((8,), jnp.uint32))
    t = jnp.full((8,), 2, jnp.uint32)

    seen = []

    def step(v, tt):
        seen.append(1)  # traced once per compile, not per iteration
        return U64(v.hi + tt, v.lo + jnp.uint32(1))

    r = time_chained(step, x, (t,), seconds=0.01, reps=1)
    assert r.ms >= 0
    # the chain body traced a bounded number of times (jit + fori, not k)
    assert len(seen) <= 4


def test_chain_applies_step_k_times():
    """Cross-check the fori chain against an explicit loop."""

    @jax.jit
    def chain_k(v, k):
        return jax.lax.fori_loop(0, k, lambda i, w: w * 2 + 1, v)

    out = chain_k(jnp.uint32(0), np.int32(5))
    assert int(out) == 31  # 0 -> 1 -> 3 -> 7 -> 15 -> 31
