"""Native C++ host oracle vs the Python golden model."""

import numpy as np
import pytest

from sventt_tpu import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu.field.golden import GoldenNTT
from sventt_tpu.field.modulus import Modulus
from sventt_tpu import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="no host compiler for the native library"
)


def test_native_matches_python_golden(rng):
    m = 256
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    golden = GoldenNTT(m, mod)
    x = rng.integers(0, TEST_MODULUS, m, dtype=np.uint64)
    nat = native.golden_forward(x, TEST_MODULUS, TEST_GENERATOR)
    want = golden.forward([int(v) for v in x])
    assert [int(v) for v in nat] == want

    back = native.golden_inverse(nat, TEST_MODULUS, TEST_GENERATOR)
    np.testing.assert_array_equal(back, x)


def test_native_large_roundtrip(rng):
    """Sizes the Python oracle cannot reach in test time (2^16)."""
    m = 1 << 16
    x = rng.integers(0, TEST_MODULUS, m, dtype=np.uint64)
    fwd = native.golden_forward(x, TEST_MODULUS, TEST_GENERATOR)
    back = native.golden_inverse(fwd, TEST_MODULUS, TEST_GENERATOR)
    np.testing.assert_array_equal(back, x)
    # DFT definition spot check
    assert int(fwd[0]) == int(x.astype(object).sum() % TEST_MODULUS)


@pytest.mark.parametrize(
    "modulus,generator",
    [
        (0xFFFF_FC6E_8000_0001, 3),  # flagship, bit_width == 64
        (0xFFFF_FFFF_0000_0001, 7),  # Goldilocks, bit_width == 64
    ],
)
def test_native_64bit_modulus(rng, modulus, generator):
    """Regression: butterfly adds overflowed u64 for 64-bit moduli.

    ``x0 + x1`` and ``x0 + N - x1`` exceed 2^64 when bit_width(N) == 64 (the
    reference handles this with dedicated carry-aware paths, e.g.
    modmul/sve/p-adic-64.hpp:44-49); the oracle must use 128-bit sums.
    """
    m = 256
    mod = Modulus(modulus, generator)
    golden = GoldenNTT(m, mod)
    x = rng.integers(0, modulus, m, dtype=np.uint64)
    nat = native.golden_forward(x, modulus, generator)
    want = golden.forward([int(v) for v in x])
    assert [int(v) for v in nat] == want
    assert int(nat[0]) == int(x.astype(object).sum() % modulus)
    back = native.golden_inverse(nat, modulus, generator)
    np.testing.assert_array_equal(back, x)


def test_native_helpers():
    lib = native._load()
    N = TEST_MODULUS
    assert lib.sventt_powmod(3, 5, N) == pow(3, 5, N)
    assert lib.sventt_invmod(12345, N) == pow(12345, N - 2, N)
    mod = Modulus(N, TEST_GENERATOR)
    assert lib.sventt_montgomery_inverse(N) == mod.montgomery_inverse
    assert lib.sventt_shoup_precompute(98765, N) == mod.shoup_precompute(98765)


@pytest.mark.parametrize("log2m", [1, 6, 15])
@pytest.mark.parametrize(
    "modulus,generator",
    [
        (TEST_MODULUS, TEST_GENERATOR),
        (0xFFFF_FC6E_8000_0001, 3),  # flagship
        (0xFFFF_FFFF_0000_0001, 7),  # Goldilocks
        ((1 << 16) + 1, 3),  # F4: a small modulus, Montgomery still exact
    ],
)
def test_native_stage_major_matches_golden(rng, modulus, generator, log2m):
    """The stage-major Montgomery oracle equals the Python golden model in
    both directions; 2^15 crosses the size from which its loops run in
    parallel threads."""
    m = 1 << log2m
    mod = Modulus(modulus, generator)
    golden = GoldenNTT(m, mod)
    x = rng.integers(0, modulus, m, dtype=np.uint64)
    nat = native.golden_forward(x, modulus, generator)
    assert [int(v) for v in nat] == golden.forward([int(v) for v in x])
    back = native.golden_inverse(nat, modulus, generator)
    assert [int(v) for v in back] == golden.inverse([int(v) for v in nat])
    np.testing.assert_array_equal(back, x)


def test_native_pointwise_mul(rng):
    for N in (TEST_MODULUS, 0xFFFF_FC6E_8000_0001, (1 << 16) + 1):
        a = rng.integers(0, N, 1 << 16, dtype=np.uint64)
        b = rng.integers(0, N, 1 << 16, dtype=np.uint64)
        got = native.pointwise_mul(a, b, N)
        want = [int(u) * int(v) % N for u, v in zip(a, b)]
        assert [int(v) for v in got] == want
    with pytest.raises(ValueError):
        native.pointwise_mul(a, b[:5], N)
