"""Public NTT wrapper: iterative and six-step strategies vs the golden model.

The config-matrix role of reference tests/ntt-tests/*.hpp + bench-ntt.cpp:
each config is validated bit-exactly (mod N) against the golden model.
"""

import numpy as np
import pytest

from sventt_tpu.field.golden import GoldenNTT
from sventt_tpu.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu.plan import NTT, NttConfig

TEST_MOD = Modulus(TEST_MODULUS, TEST_GENERATOR)


def _check_forward_inverse(cfg: NttConfig, rng, golden_n_max=1 << 12):
    mod = cfg.mod
    N = mod.modulus
    ntt = NTT(cfg)
    x = rng.integers(0, N, size=cfg.n, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    if cfg.n <= golden_n_max:
        golden = GoldenNTT(cfg.n, mod)
        want = golden.forward([int(v) for v in x])
        assert [int(v) % N for v in fwd] == want
    back = ntt.inverse_numpy(fwd)
    # compare as Python-int lists: numpy object-array comparisons of uint64
    # scalars against >2^63 Python ints are unreliable
    assert [int(v) % N for v in back] == [int(v) for v in x]


# mirrors the reference kernel test sizes (tests/ntt-tests/: 2^10..2^13
# iterative, 2^13+ recursive/four-step)
@pytest.mark.parametrize("log2n", [4, 10])
def test_iterative(rng, log2n):
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << log2n, strategy="iterative")
    _check_forward_inverse(cfg, rng)


@pytest.mark.parametrize("split", [(4, 8), (8, 4), (16, 16), (8, 64)])
def test_six_step_splits(rng, split):
    n0, n1 = split
    cfg = NttConfig(
        TEST_MODULUS, TEST_GENERATOR, n0 * n1, strategy="six_step", n0=n0, n1=n1
    )
    _check_forward_inverse(cfg, rng)


def test_six_step_matches_iterative(rng):
    # same transform, two strategies: residues must agree elementwise
    n = 1 << 10
    x = rng.integers(0, TEST_MODULUS, size=n, dtype=np.uint64)
    it = NTT(NttConfig(TEST_MODULUS, TEST_GENERATOR, n, strategy="iterative"))
    ss = NTT(NttConfig(TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step"))
    assert (it.forward_numpy(x) == ss.forward_numpy(x)).all()


def test_flagship_modulus_six_step(rng):
    # the 64-bit flagship modulus on the canonical (non-lazy) path
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 10, strategy="six_step")
    _check_forward_inverse(cfg, rng)


def test_flagship_config_2e17_roundtrip(rng):
    # BASELINE.md config 3: six-step 2^17 = 2^8 x 2^9 (README.md flagship).
    # Bit-exact against the native C++ oracle when a compiler is available
    # (the usual case); DFT-definition spot checks otherwise.
    from sventt_tpu import native

    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 17)
    assert cfg.resolved_strategy == "six_step"
    assert cfg.split == (1 << 8, 1 << 9)
    ntt = NTT(cfg)
    N = cfg.modulus
    x = rng.integers(0, N, size=cfg.n, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    if native.available():
        want = native.golden_forward(x, N, cfg.generator)
        assert (fwd == want).all()
    else:
        # spot check against the DFT definition: position 0 = sum, 1 = alt sum
        assert int(fwd[0]) == sum(int(v) for v in x) % N
        alt = sum(int(v) if i % 2 == 0 else -int(v) for i, v in enumerate(x)) % N
        assert int(fwd[1]) == alt
    back = ntt.inverse_numpy(fwd)
    assert (back == x).all()


def test_batched(rng):
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 256, strategy="six_step")
    ntt = NTT(cfg)
    N = cfg.modulus
    x = rng.integers(0, N, size=(256, 3), dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    golden = GoldenNTT(256, cfg.mod)
    for c in range(3):
        want = golden.forward([int(v) for v in x[:, c]])
        assert [int(v) % N for v in fwd[:, c]] == want


def test_config_validation():
    with pytest.raises(ValueError):
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 100)  # not a power of two
    with pytest.raises(ValueError):
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 58)  # exceeds 2-adicity
    with pytest.raises(ValueError):
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 64, strategy="six_step", n0=4, n1=8)
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 17)
    assert cfg.split == (256, 512)


def test_forward_only_wrapper(rng):
    ntt = NTT(
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 64), enable_inverse=False
    )
    x = rng.integers(0, TEST_MODULUS, size=64, dtype=np.uint64)
    ntt.forward_numpy(x)
    with pytest.raises(RuntimeError):
        ntt.inverse_numpy(x)


def test_shoup_engine_matches_golden(rng):
    """Explicit FixedPoint64/Shoup twiddle engine, bit-compatible mod N
    (reference modmul/scalar/fixed-point-64.hpp semantics)."""
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 512, modmul="shoup")
    ntt = NTT(cfg)
    N = cfg.modulus
    x = rng.integers(0, N, size=512, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    golden = GoldenNTT(512, cfg.mod)
    assert [int(v) for v in fwd] == golden.forward([int(v) for v in x])
    assert (ntt.inverse_numpy(fwd) == x).all()


def test_shoup_requires_small_modulus():
    from sventt_tpu import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS

    with pytest.raises(ValueError):
        NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 64, modmul="shoup"))


def test_solinas_engine_matches_golden(rng):
    """Companion-free Solinas engine on the 64-bit flagship modulus (the
    Shoup analogue for sparse-high moduli where Shoup is impossible):
    bit-compatible mod N, both directions, iterative AND six-step."""
    from sventt_tpu import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS

    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 512, modmul="solinas")
    ntt = NTT(cfg)
    N = cfg.modulus
    x = rng.integers(0, N, size=512, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    golden = GoldenNTT(512, cfg.mod)
    assert [int(v) for v in fwd] == golden.forward([int(v) for v in x])
    assert (ntt.inverse_numpy(fwd) == x).all()
    # six-step composition (split twiddles stay Montgomery; stage twiddles
    # are companion-free plain values)
    cfg6 = NttConfig(
        FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 15, modmul="solinas"
    )
    ntt6 = NTT(cfg6)
    x6 = rng.integers(0, N, size=cfg6.n, dtype=np.uint64)
    ref = NTT(cfg6.with_(modmul="montgomery"))
    np.testing.assert_array_equal(ntt6.forward_numpy(x6), ref.forward_numpy(x6))
    assert (ntt6.inverse_numpy(ntt6.forward_numpy(x6)) == x6).all()


def test_solinas_requires_sparse_high():
    with pytest.raises(ValueError):
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 64, modmul="solinas")


def test_describe_shows_execution_paths():
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 20, engine="mxu")
    d = NTT(cfg, enable_inverse=False).describe()
    assert d.count("in-place mxu") == 2  # every level: axis 1, no transposes
    assert "transposed" not in d
    db = NTT(cfg, enable_inverse=False).describe(batched=True)
    assert db == d
    dj = NTT(cfg.with_(engine="jnp"), enable_inverse=False).describe()
    assert "mid-axis jnp" in dj


def test_describe_descends_into_split_row():
    """A Split whose row child is itself a Split takes the transposed
    fallback; describe() must surface the nested row schedule instead of
    mislabeling it a leaf (its whole purpose is fallback visibility)."""
    from sventt_tpu.plan import planner as P

    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12)
    ntt = NTT(cfg, enable_inverse=False)
    inner = P.Split(1 << 8, 1 << 4, 1 << 4, P.Leaf(1 << 4, "jnp"),
                    P.Leaf(1 << 4, "jnp"))
    ntt.plan = P.Split(1 << 12, 1 << 4, 1 << 8, P.Leaf(1 << 4, "jnp"), inner)
    d = ntt.describe()
    assert "transposed row subtree m1=256" in d
    assert "mid-axis jnp m1=16" in d  # the nested row split is walked


def test_batched_transforms_match_loop(rng):
    """Serving-style batched input (n, B): every column must equal the
    corresponding single transform (round-1 VERDICT task 7's batched
    amortization path)."""
    n, B = 1 << 10, 5
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, n)
    ntt = NTT(cfg)
    x = rng.integers(0, cfg.modulus, (n, B), dtype=np.uint64)
    from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy

    out = u64_to_numpy(ntt.fc.normalize(ntt.compute_forward(u64_from_numpy(x))))
    for j in range(B):
        single = ntt.forward_numpy(x[:, j])
        np.testing.assert_array_equal(out[:, j], single)
    back = u64_to_numpy(
        ntt.fc.normalize(ntt.compute_inverse(u64_from_numpy(out)))
    )
    np.testing.assert_array_equal(back, x)


def test_random_prime_width_matrix(rng):
    """Modulus genericity sweep: for each width 60..64 draw a fresh NTT
    prime (seeded search) and check the full wrapper against the golden
    model plus roundtrip -- the role of the reference's random 60-64-bit
    prime matrix (reference test-magic-series.cpp:22-39) applied to the
    transform itself."""
    from sventt_tpu.field.golden import GoldenNTT
    from sventt_tpu.field.modulus import Modulus, find_ntt_prime

    n = 1 << 8
    for bits in (60, 61, 62, 63, 64):
        # deterministic but width-dependent starting point inside the range
        start = (1 << bits) - 1 - (bits * 12345 << 20)
        N, g = find_ntt_prime(bits, n.bit_length() - 1, start=start)
        mod = Modulus(N, g)
        assert mod.bit_width == bits
        cfg = NttConfig(N, g, n)
        ntt = NTT(cfg)
        x = rng.integers(0, N, n, dtype=np.uint64)
        out = ntt.forward_numpy(x)
        want = GoldenNTT(n, mod).forward([int(v) for v in x])
        assert [int(v) for v in out] == [w % N for w in want], hex(N)
        assert (ntt.inverse_numpy(out) == x).all(), hex(N)


@pytest.mark.parametrize("w_only", [True, False])
def test_split_w_only_knob(rng, w_only):
    """Companion-free inter-step tables are bit-identical to paired ones
    (the store_precomputation=false analogue, NttConfig.split_w_only)."""
    n = 1 << 10
    base = NttConfig(
        TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step", n0=32, n1=32
    )
    _check_forward_inverse(base.with_(split_w_only=w_only), rng)
    x = rng.integers(0, TEST_MODULUS, size=n, dtype=np.uint64)
    got = NTT(base.with_(split_w_only=w_only)).forward_numpy(x)
    want = NTT(base).forward_numpy(x)
    assert (got == want).all()


def test_step_helpers_match_compute(rng):
    """forward_step/inverse_step (the truthful-timing entry points) must be
    bit-identical to compute_forward/compute_inverse -- they are the same
    planner programs with tables passed explicitly."""
    import jax

    from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy

    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 11)
    ntt = NTT(cfg)
    x = jax.device_put(
        u64_from_numpy(rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64))
    )
    step_f, tabs_f = ntt.forward_step()
    got = u64_to_numpy(ntt.fc.normalize(step_f(x, *tabs_f)))
    want = u64_to_numpy(ntt.fc.normalize(ntt.compute_forward(x)))
    np.testing.assert_array_equal(got, want)
    step_i, tabs_i = ntt.inverse_step()
    fwd = ntt.compute_forward(x)
    got_i = u64_to_numpy(ntt.fc.normalize(step_i(fwd, *tabs_i)))
    want_i = u64_to_numpy(ntt.fc.normalize(ntt.compute_inverse(fwd)))
    np.testing.assert_array_equal(got_i, want_i)
