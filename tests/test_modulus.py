"""Field-constant property tests.

Mirrors reference tests/test-modulus.cpp:12-47 (sum-of-roots annihilation over
many orders) plus checks of the Montgomery/Shoup constants the device kernels
consume.
"""

import pytest

from sventt_tpu.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
    find_generator,
    find_ntt_prime,
    is_probable_prime,
)

MODULI = [
    Modulus(GOLDILOCKS_MODULUS, 7),
    Modulus(TEST_MODULUS, TEST_GENERATOR),
    Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR),
]


@pytest.mark.parametrize("mod", MODULI, ids=lambda m: hex(m.modulus))
def test_roots_sum_to_zero(mod):
    # sum_{i<order} root^i == 0 for every nontrivial order dividing N-1
    # (reference tests/test-modulus.cpp:12-47).
    for log2_order in range(1, 17):
        order = 1 << log2_order
        if (mod.modulus - 1) % order:
            continue
        for root in (mod.get_root_forward(order), mod.get_root_inverse(order)):
            assert pow(root, order, mod.modulus) == 1
            assert pow(root, order // 2, mod.modulus) == mod.modulus - 1
            acc, x = 0, 1
            for _ in range(order if order <= 1 << 10 else 0):
                acc = (acc + x) % mod.modulus
                x = x * root % mod.modulus
            if order <= 1 << 10:
                assert acc == 0


@pytest.mark.parametrize("mod", MODULI, ids=lambda m: hex(m.modulus))
def test_montgomery_constants(mod):
    N = mod.modulus
    assert N * mod.montgomery_inverse % (1 << 64) == 1
    assert (mod.montgomery_inverse + mod.neg_montgomery_inverse) % (1 << 64) == 0
    assert mod.montgomery_r == (1 << 64) % N
    assert mod.montgomery_r2 == pow(2, 128, N)
    # shoup: floor(2^128/N)
    assert mod.shoup_inverse == ((1 << 128) - 1) // N


@pytest.mark.parametrize("mod", MODULI, ids=lambda m: hex(m.modulus))
def test_montgomery_multiply_model(mod):
    # host model of the device Montgomery multiply: residue and range checks
    # (reference modmul/scalar/p-adic-64.hpp:35-45 contract).
    N = mod.modulus
    vals = [1, 2, N - 1, 0x1234_5678_9ABC_DEF0 % N, N // 2, N // 3]
    for a in vals:
        for b in vals:
            bm = mod.to_montgomery(b)
            c = mod.montgomery_multiply(a, bm)
            assert c % N == a * b % N
            if mod.bit_width <= 62:
                assert 0 <= c < 2 * N  # lazy range contract
            else:
                # 63- and 64-bit moduli run the canonical device path
                # (FieldConsts lazy gate is bit_width <= 62)
                assert 0 <= c < N
            # explicit representative selection mirrors both device paths
            assert mod.montgomery_multiply(a, bm, lazy=False) < N
            if mod.bit_width <= 63:  # lazy (0, 2N) must fit in 64 bits
                lz = mod.montgomery_multiply(a, bm, lazy=True)
                assert lz % N == a * b % N and lz < 2 * N


@pytest.mark.parametrize("mod", MODULI, ids=lambda m: hex(m.modulus))
def test_shoup_multiply_model(mod):
    if mod.bit_width > 63:
        pytest.skip("Shoup engine requires bit_width(N) <= 63")
    N = mod.modulus
    vals = [1, 2, N - 1, 0xDEAD_BEEF_CAFE_F00D % N]
    for a in vals:
        for b in vals:
            bp = mod.shoup_precompute(b)
            c = mod.shoup_multiply(a, b, bp)
            assert c % N == a * b % N
            assert 0 <= c < 2 * N


def test_field_basics():
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    N = mod.modulus
    assert mod.add(N - 1, 2) == 1
    assert mod.subtract(1, 2) == N - 1
    assert mod.negate(5) == N - 5
    assert mod.multiply(mod.invert(12345), 12345) == 1
    assert mod.divide(10, 5) == mod.multiply(10, mod.invert(5))
    assert mod.power(3, 0) == 1


def test_root_order_validation():
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    with pytest.raises(ValueError):
        mod.get_root_forward(3)  # 3 does not divide N-1 for this modulus
    assert mod.two_adicity == 57
    flag = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    assert flag.two_adicity >= 31  # supports 2^31-point transforms (README.md:18-19)


def test_prime_search():
    # analogue of reference generate-parameters.py
    assert is_probable_prime(GOLDILOCKS_MODULUS)
    assert is_probable_prime(FLAGSHIP_MODULUS)
    assert not is_probable_prime((1 << 63) - 1)
    n, g = find_ntt_prime(62, 40)
    assert is_probable_prime(n)
    assert (n - 1) % (1 << 40) == 0
    assert pow(g, (n - 1) // 2, n) == n - 1  # g is a non-residue
    assert find_generator(GOLDILOCKS_MODULUS) == 7


def test_montgomery_model_63bit_matches_device_representative():
    """Exactly-63-bit moduli run the canonical device path (the FieldConsts
    lazy gate is bit_width <= 62); the host model must return the same
    REPRESENTATIVE as fc.mont_mul_full, not just the same residue
    (round-2 review finding: the model used a <= 63 lazy gate)."""
    import numpy as np

    from sventt_tpu.field.limb import FieldConsts, u64_from_numpy, u64_to_numpy
    from sventt_tpu.field.modulus import find_ntt_prime

    N, g = find_ntt_prime(63, 8)
    mod = Modulus(N, g)
    assert mod.bit_width == 63
    fc = FieldConsts.from_modulus(mod)
    assert fc.lazy is False
    rng = np.random.default_rng(0)
    a = rng.integers(0, N, 64, dtype=np.uint64)
    b = rng.integers(0, N, 64, dtype=np.uint64)
    got = u64_to_numpy(fc.mont_mul_full(u64_from_numpy(a), u64_from_numpy(b)))
    for i in range(64):
        want = mod.montgomery_multiply(
            int(a[i]), int(b[i]), bp=mod.montgomery_precompute(int(b[i]))
        )
        assert int(got[i]) == want
        assert want < N  # canonical representative
