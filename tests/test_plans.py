"""Plan trees and their execution paths, bit-exact against the native oracle.

Deep plans (a small ``max_fused`` forces several split levels), batched and
unbatched; both chunk loops of the butterfly engine (unrolled and
``fori_loop``); the matrix engine at every level; mixed
``plan_spec`` trees; and the distributed six-step with either engine under
either communication schedule.
"""

import jax
import numpy as np
import pytest

from sventt_tpu import native
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
)
from sventt_tpu.parallel import DistributedNTT, make_ntt_mesh
from sventt_tpu.plan import NTT, NttConfig, planner

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no host compiler for the native oracle"
)


def _check(ntt: NTT, x: np.ndarray) -> None:
    """Forward == oracle per column, inverse round trip exact."""
    cfg = ntt.config
    fwd = ntt.compute_forward(u64_from_numpy(x))
    got = u64_to_numpy(ntt.fc.normalize(fwd))
    cols = got.reshape(cfg.n, -1)
    xs = x.reshape(cfg.n, -1)
    for c in range(cols.shape[1]):
        want = native.golden_forward(xs[:, c], cfg.modulus, cfg.generator)
        np.testing.assert_array_equal(cols[:, c], want)
    back = u64_to_numpy(ntt.fc.normalize(ntt.compute_inverse(fwd)))
    np.testing.assert_array_equal(back, x)


def _depth(node) -> int:
    return 0 if isinstance(node, planner.Leaf) else 1 + max(
        _depth(node.col), _depth(node.row)
    )


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize(
    "engine,max_fused",
    [("jnp", 4), ("jnp", 16), ("mxu", 4), ("mxu", 8), ("mxu", 32)],
)
def test_deep_plans(rng, engine, max_fused, batched):
    n = 1 << 10
    cfg = NttConfig(
        FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, engine=engine, max_fused=max_fused
    )
    ntt = NTT(cfg)
    assert _depth(ntt.plan) >= (2 if max_fused <= 16 else 1)
    shape = (n, 3) if batched else (n,)
    _check(ntt, rng.integers(0, cfg.modulus, shape, dtype=np.uint64))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize(
    "chunk_elems", [1 << 6, 1 << 9, None], ids=["many", "few", "whole"]
)
def test_jnp_chunk_paths(rng, chunk_elems, batched):
    """``chunk_elems`` = 2^6 makes 64 chunks per level, 2^9 eight (both
    the fori_loop of _jnp_chunked / _jnp_mid_chunked), None one chunk."""
    n = 1 << 12
    cfg = NttConfig(
        TEST_MODULUS, TEST_GENERATOR, n, engine="jnp", chunk_elems=chunk_elems,
        max_fused=1 << 6,
    )
    ntt = NTT(cfg)
    shape = (n, 2) if batched else (n,)
    _check(ntt, rng.integers(0, cfg.modulus, shape, dtype=np.uint64))


@pytest.mark.parametrize("chunk_elems,loops", [(1 << 6, True), (1 << 9, True), (None, False)])
def test_chunk_counts_cover_both_loops(chunk_elems, loops):
    """Chunked levels compile to one loop body; an unchunked one has none."""
    cfg = NttConfig(
        TEST_MODULUS, TEST_GENERATOR, 1 << 12, engine="jnp",
        chunk_elems=chunk_elems, max_fused=1 << 6,
    )
    ntt = NTT(cfg, enable_inverse=False)
    step, tables = ntt.forward_step()
    x = u64_from_numpy(np.zeros(cfg.n, np.uint64))
    jaxpr = str(jax.make_jaxpr(step)(x, *tables))
    # a fori_loop with static bounds traces to a scan
    assert ("scan" in jaxpr or "while" in jaxpr) == loops


@pytest.mark.parametrize(
    "spec", ["mxu:64,jnp", "jnp:64,mxu", "mxu:16,mxu:16,jnp", "jnp:16,jnp:16,mxu"]
)
def test_mixed_plan_spec(rng, spec):
    n = 1 << 10
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, n, plan_spec=spec)
    ntt = NTT(cfg)
    engines = set()

    def walk(node):
        if isinstance(node, planner.Leaf):
            engines.add(node.engine)
        else:
            walk(node.col)
            walk(node.row)

    walk(ntt.plan)
    assert engines == {"jnp", "mxu"}
    _check(ntt, rng.integers(0, cfg.modulus, n, dtype=np.uint64))


@pytest.mark.parametrize("comm", ["xla", "overlap"])
@pytest.mark.parametrize("engine", ["jnp", "mxu"])
def test_distributed_engine_comm(rng, engine, comm):
    mesh = make_ntt_mesh(4)
    n = 1 << 12
    cfg = NttConfig(
        FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, strategy="six_step", engine=engine
    )
    dntt = DistributedNTT(cfg, mesh, comm=comm, overlap_chunks=2)
    x = rng.integers(0, cfg.modulus, n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd = dntt.compute_forward(xd)
    got = u64_to_numpy(dntt.fc.normalize(fwd))
    np.testing.assert_array_equal(
        got, native.golden_forward(x, cfg.modulus, cfg.generator)
    )
    back = u64_to_numpy(dntt.fc.normalize(dntt.compute_inverse(fwd)))
    np.testing.assert_array_equal(back, x)
