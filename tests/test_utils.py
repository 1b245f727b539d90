"""Instance cache and batch-shape coverage."""

import numpy as np

from sventt_tpu import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu.field.golden import GoldenNTT
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.plan import NTT, NttConfig
from sventt_tpu.utils import cached_ntt, clear_ntt_cache


def test_cached_ntt_reuses_instance():
    clear_ntt_cache()
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 64)
    a = cached_ntt(cfg)
    b = cached_ntt(cfg)
    assert a is b
    c = cached_ntt(cfg.with_(n=128))
    assert c is not a
    clear_ntt_cache()


def test_batched_transform_matches_per_column(rng):
    """(n, batch) inputs transform every column independently."""
    n, batch = 256, 5
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, n)
    ntt = NTT(cfg)
    x = rng.integers(0, TEST_MODULUS, (n, batch), dtype=np.uint64)
    out = u64_to_numpy(ntt.fc.normalize(ntt.compute_forward(u64_from_numpy(x))))
    golden = GoldenNTT(n, cfg.mod)
    for c in range(batch):
        assert [int(v) for v in out[:, c]] == golden.forward(
            [int(v) for v in x[:, c]]
        )
    back = ntt.compute_inverse(u64_from_numpy(out))
    np.testing.assert_array_equal(u64_to_numpy(ntt.fc.normalize(back)), x)


def test_batched_sixstep(rng):
    n, batch = 1 << 12, 3
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step")
    ntt = NTT(cfg)
    x = rng.integers(0, TEST_MODULUS, (n, batch), dtype=np.uint64)
    out = u64_to_numpy(ntt.fc.normalize(ntt.compute_forward(u64_from_numpy(x))))
    # column 0 vs flat single-batch path
    flat = ntt.forward_numpy(x[:, 0])
    np.testing.assert_array_equal(out[:, 0], flat)


def test_phase_breakdown_walks_the_plan():
    """phase_breakdown reports one row phase per split level plus the
    final column leaf and the whole transform, at the plan's own shapes
    (the '2^24 phase split' methodology, packaged)."""
    from sventt_tpu.plan import NTT, NttConfig
    from sventt_tpu.utils import phase_breakdown

    ntt = NTT(
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 15),
        enable_inverse=False,
    )
    bd = phase_breakdown(ntt, seconds=0.05)
    assert "total" in bd
    assert any(k.startswith("level0.rows") for k in bd)
    assert any("col leaf" in k for k in bd)
    assert all(v > 0 for v in bd.values())

    # non-jnp rows fall back to timing the inter-step twiddle multiply
    ntt_p = NTT(
        NttConfig(
            TEST_MODULUS, TEST_GENERATOR, 1 << 10, engine="mxu",
            strategy="six_step", n0=1 << 5, n1=1 << 5,
        ),
        enable_inverse=False,
    )
    bd_p = phase_breakdown(ntt_p, seconds=0.05)
    assert any("inter-step tw" in k for k in bd_p)


def test_fill_device_matches_host():
    """utils/fill: the on-device splitmix64 fill is bit-identical to the
    numpy host mirror, stays below N, and actually exercises the high u32
    limb (the round-4 advisor finding against iota inputs)."""
    import numpy as np

    from sventt_tpu import FLAGSHIP_MODULUS, TEST_MODULUS
    from sventt_tpu.field.limb import u64_to_numpy
    from sventt_tpu.utils.fill import device_fill, host_fill

    for N in (FLAGSHIP_MODULUS, TEST_MODULUS, 65537):
        n = 4096
        dev = u64_to_numpy(device_fill(n, N))
        host = host_fill(n, N)
        np.testing.assert_array_equal(dev, host)
        assert int(host.max()) < N
        if N.bit_length() > 33:
            # the high limb must not be identically zero
            assert (host >> np.uint64(32)).any()
            # every bit below the mask width is exercised somewhere
            orall = int(np.bitwise_or.reduce(host))
            assert orall == (1 << (N.bit_length() - 1)) - 1
