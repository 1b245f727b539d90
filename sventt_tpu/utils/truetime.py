"""Chain timing: the per-op device time of a jitted step.

``time_chained`` runs ``step`` k times inside ONE jitted ``lax.fori_loop``
program with a DYNAMIC trip count -- one compile and one dispatch for any
k, so host dispatch cost is paid once per chain, not once per step, and
each step depends on the previous one, so steps cannot overlap.  It then:

* forces completion by a jitted one-element reduction of the result and a
  4-byte readback (works for sharded arrays too);
* subtracts the fixed overhead (dispatch + reduction + readback), measured
  by a ZERO-iteration run of the same chain program -- the calibration
  path is byte-for-byte the measurement path;
* sizes k from a short probe chain so one full chain takes ``seconds``,
  and reports the MEDIAN of ``reps`` full chains.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

_extract_fn = None


def _read_one(y) -> None:
    """Force completion: jitted scalar reduction of the first array leaf of
    ``y`` (sharding-agnostic -- reductions over sharded axes lower to
    collectives where element slicing does not), then a 4-8 B readback.
    The reduction costs one pass over the final value, but the same pass
    is paid by the zero-iteration calibration run, so it cancels out of
    the per-op time."""
    global _extract_fn
    import jax
    import jax.numpy as jnp

    if _extract_fn is None:
        _extract_fn = jax.jit(lambda a: jnp.min(a))
    leaf = jax.tree_util.tree_leaves(y)[0]
    np.asarray(_extract_fn(leaf))


@dataclass
class ChainResult:
    ms: float  # median per-op milliseconds
    rtt_ms: float  # measured fixed per-chain overhead
    k: int  # chain length of the full chains
    samples: list  # per-chain per-op ms, sorted
    #: The compiled chain program ``chain_fn(x, np.int32(k), *tables)``.
    #: ``chain_fn(x, 1, *tables)`` is one application of ``step`` through the
    #: ALREADY-COMPILED program -- callers verifying the timed computation
    #: can use it instead of compiling ``step`` a second time.
    chain_fn: object = None


def time_chained(
    step,
    x,
    tables=(),
    *,
    seconds: float = 2.0,
    reps: int = 3,
    max_k: int = 4096,
    probe_k: int = 4,
) -> ChainResult:
    """Per-op time of ``step`` (ms).

    ``step(v, *tables) -> v`` must preserve the pytree structure of ``x``
    (transforms whose output feeds the next call).  ``tables`` are passed
    as jit arguments -- closing over hundreds of MB of twiddles would bake
    them into the serialized HLO.  The chain is one jitted fori_loop with
    a dynamic trip count: one compile, one dispatch, any k.
    """
    import jax

    @jax.jit
    def chain_k(v, k, *ts):
        return jax.lax.fori_loop(0, k, lambda i, w: step(w, *ts), v)

    def run(k: int) -> float:
        t0 = time.perf_counter()
        y = chain_k(x, np.int32(k), *tables)
        _read_one(y)
        return time.perf_counter() - t0

    # Warm-up: compile both programs + one completed run.
    run(1)
    # Fixed overhead: the SAME dispatch+extract+readback path with zero
    # chain iterations.
    rtt = min(run(0) for _ in range(3))
    # Size k from the MIN of 3 probe chains: a single transient stall
    # during one probe would otherwise mis-size every measurement chain
    # (k collapses toward probe_k and the result drowns in overhead
    # noise).  min is the robust choice -- stalls only ever inflate.
    per = max(min(run(probe_k) for _ in range(3)) - rtt, 1e-7) / probe_k
    k = max(probe_k, min(max_k, int(seconds / per)))
    samples = sorted(max(run(k) - rtt, 0.0) / k * 1e3 for _ in range(reps))
    return ChainResult(
        ms=_median_sorted(samples),
        rtt_ms=rtt * 1e3,
        k=k,
        samples=samples,
        chain_fn=chain_k,
    )


def _median_sorted(samples: list) -> float:
    """True median of an already-sorted list (averages the middle pair for
    even counts -- ``samples[len//2]`` would return the MAX of a 2-sample
    list, high-biasing every reps=2 harness)."""
    n = len(samples)
    mid = n // 2
    if n % 2:
        return samples[mid]
    return (samples[mid - 1] + samples[mid]) / 2.0
