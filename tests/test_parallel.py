"""Multi-chip six-step NTT on the 8-device CPU mesh.

The distributed path must match the single-chip wrapper bit-for-bit shard by
shard (SURVEY.md section 8 step 6: "bit-exactness across shard boundaries
with bit-reversed ordering").
"""

import jax
import numpy as np
import pytest

from sventt_tpu import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.parallel import DistributedNTT, make_ntt_mesh
from sventt_tpu.plan import NTT, NttConfig


@pytest.fixture(scope="module")
def mesh():
    return make_ntt_mesh(8)


@pytest.mark.parametrize("n,n0", [(1 << 12, None), (1 << 13, 1 << 6)])
def test_distributed_matches_single_chip(mesh, rng, n, n0):
    cfg = NttConfig(
        TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step", n0=n0,
        n1=None if n0 is None else n // n0,
    )
    dntt = DistributedNTT(cfg, mesh)
    sntt = NTT(cfg)
    x = rng.integers(0, cfg.modulus, n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())

    fwd_d = u64_to_numpy(dntt.fc.normalize(dntt.compute_forward(xd)))
    fwd_s = u64_to_numpy(sntt.fc.normalize(sntt.compute_forward(u64_from_numpy(x))))
    np.testing.assert_array_equal(fwd_d, fwd_s)


def test_distributed_row_split_plan(mesh, rng):
    """Shard-local row plan is itself a Split (n1 above the jnp leaf cap):
    the production 2^24+ composition shape -- exercises the transposed
    fallback with a NESTED plan inside shard_map, plus roundtrip (round-1
    VERDICT weak item 6)."""
    from sventt_tpu.plan import planner

    n = 1 << 18
    cfg = NttConfig(
        TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step",
        n0=1 << 4, n1=1 << 14,
    )
    dntt = DistributedNTT(cfg, mesh)
    assert isinstance(dntt._row_plan, planner.Split)  # the shape under test
    x = rng.integers(0, cfg.modulus, n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd_d = dntt.compute_forward(xd)
    fwd_s = NTT(cfg, enable_inverse=False).compute_forward(u64_from_numpy(x))
    np.testing.assert_array_equal(
        u64_to_numpy(dntt.fc.normalize(fwd_d)),
        u64_to_numpy(dntt.fc.normalize(fwd_s)),
    )
    back = dntt.compute_inverse(fwd_d)
    np.testing.assert_array_equal(u64_to_numpy(dntt.fc.normalize(back)), x)


def test_distributed_roundtrip(mesh, rng):
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, strategy="six_step")
    dntt = DistributedNTT(cfg, mesh)
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    back = dntt.compute_inverse(dntt.compute_forward(xd))
    np.testing.assert_array_equal(u64_to_numpy(dntt.fc.normalize(back)), x)


@pytest.mark.parametrize("chunks", [2, 4])
def test_distributed_overlap_schedule(mesh, rng, chunks):
    """comm='overlap' (chunked column/[comm 2] pipeline for comm/compute
    overlap, round-4 VERDICT task 5): bit-identical to the monolithic
    schedule and to the single-chip wrapper, forward AND inverse."""
    n = 1 << 13
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step")
    dntt = DistributedNTT(cfg, mesh, comm="overlap", overlap_chunks=chunks)
    assert dntt.overlap_chunks == chunks  # divisibility kept the request
    sntt = NTT(cfg)
    x = rng.integers(0, cfg.modulus, n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd_d = dntt.compute_forward(xd)
    fwd_s = sntt.compute_forward(u64_from_numpy(x))
    np.testing.assert_array_equal(
        u64_to_numpy(dntt.fc.normalize(fwd_d)),
        u64_to_numpy(sntt.fc.normalize(fwd_s)),
    )
    back = dntt.compute_inverse(fwd_d)
    np.testing.assert_array_equal(u64_to_numpy(dntt.fc.normalize(back)), x)


def test_distributed_mxu_engine(mesh, rng):
    """Matrix-engine leaves inside shard_map on the CPU mesh: forward
    matches the single-device wrapper + roundtrip."""
    cfg = NttConfig(
        TEST_MODULUS, TEST_GENERATOR, 1 << 12, strategy="six_step",
        engine="mxu",
    )
    dntt = DistributedNTT(cfg, mesh)
    sntt = NTT(cfg)
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd_d = dntt.compute_forward(xd)
    np.testing.assert_array_equal(
        u64_to_numpy(dntt.fc.normalize(fwd_d)),
        u64_to_numpy(sntt.fc.normalize(sntt.compute_forward(u64_from_numpy(x)))),
    )
    back = dntt.compute_inverse(fwd_d)
    np.testing.assert_array_equal(u64_to_numpy(dntt.fc.normalize(back)), x)


def test_distributed_solinas_engine(mesh, rng):
    """Solinas stage tables under shard_map (64-bit flagship modulus):
    the mesh transform must match the single-chip wrapper bit-for-bit."""
    from sventt_tpu import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS

    cfg = NttConfig(
        FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12, strategy="six_step",
        modmul="solinas",
    )
    dntt = DistributedNTT(cfg, mesh)
    sntt = NTT(cfg)
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd_d = u64_to_numpy(dntt.fc.normalize(dntt.compute_forward(xd)))
    fwd_s = u64_to_numpy(sntt.fc.normalize(sntt.compute_forward(u64_from_numpy(x))))
    np.testing.assert_array_equal(fwd_d, fwd_s)
    back = dntt.compute_inverse(dntt.compute_forward(xd))
    np.testing.assert_array_equal(u64_to_numpy(dntt.fc.normalize(back)), x)


def test_distributed_cyclic_convolution(mesh, rng):
    """apps.cyclic_convolve duck-types over DistributedNTT: the whole
    forward -> Montgomery pointwise product -> inverse pipeline runs
    row-sharded on the mesh and matches the single-chip convolver."""
    from sventt_tpu.apps.convolve import cyclic_convolve, make_convolver

    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, strategy="six_step")
    dntt = DistributedNTT(cfg, mesh)
    a = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    b = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    ad = jax.device_put(u64_from_numpy(a), dntt.sharding())
    bd = jax.device_put(u64_from_numpy(b), dntt.sharding())
    got = u64_to_numpy(dntt.fc.normalize(cyclic_convolve(dntt, ad, bd)))

    sntt = make_convolver(TEST_MODULUS, TEST_GENERATOR, cfg.n)
    want = u64_to_numpy(
        sntt.fc.normalize(
            cyclic_convolve(sntt, u64_from_numpy(a), u64_from_numpy(b))
        )
    )
    np.testing.assert_array_equal(got, want)


def test_distributed_magic_series(mesh):
    """The reference's end-to-end model (magic-series count via chunked
    power-series division) with every NTT convolution running on the
    mesh: apps inject a DistributedNTT, result must be the exact M(6)."""
    from sventt_tpu.apps.series import magic_series_count

    dntt = DistributedNTT(
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 256, strategy="six_step"),
        mesh,
    )
    assert magic_series_count(6, TEST_MODULUS, TEST_GENERATOR, ntt=dntt) == 32134


def test_output_stays_sharded(mesh, rng):
    """Forward output must remain row-sharded (no implicit gather)."""
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, strategy="six_step")
    dntt = DistributedNTT(cfg, mesh)
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    out = dntt.compute_forward(xd)
    assert out.lo.sharding.is_equivalent_to(dntt.sharding(), out.lo.ndim)


def test_multislice_mesh_axes(rng):
    """Hierarchical (dcn, ici) mesh: combined-axis all-to-all matches the
    single-chip wrapper (the multi-slice tier of SURVEY.md section 2.5)."""
    mesh2 = jax.make_mesh((2, 4), ("dcn", "ici"))
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, strategy="six_step")
    dntt = DistributedNTT(cfg, mesh2, axis=("dcn", "ici"))
    sntt = NTT(cfg)
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd_d = u64_to_numpy(dntt.fc.normalize(dntt.compute_forward(xd)))
    fwd_s = u64_to_numpy(sntt.fc.normalize(sntt.compute_forward(u64_from_numpy(x))))
    np.testing.assert_array_equal(fwd_d, fwd_s)
    back = dntt.compute_inverse(dntt.compute_forward(xd))
    np.testing.assert_array_equal(u64_to_numpy(dntt.fc.normalize(back)), x)
