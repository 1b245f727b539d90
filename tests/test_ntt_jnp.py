"""Pure-jnp NTT engine vs the golden model: bit-exactness mod N.

The role of reference tests/bench-ntt.cpp:60-64 (``dst[i] % N == ref[i]``)
for the portable engine, over the same kind of config matrix as
reference tests/ntt-tests/*.hpp.
"""

import numpy as np
import pytest

import jax

from sventt_tpu.field.golden import GoldenNTT
from sventt_tpu.field.limb import FieldConsts, u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu.ops import forward_tables, inverse_tables, ntt_forward, ntt_inverse

MODS = [
    Modulus(TEST_MODULUS, TEST_GENERATOR),
    Modulus(GOLDILOCKS_MODULUS, 7),
    Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR),
]


def _residues(x, N):
    return np.array([int(v) % N for v in x], dtype=object)


@pytest.mark.parametrize("mod", MODS, ids=lambda m: hex(m.modulus))
@pytest.mark.parametrize("log2m", [1, 3, 6])
def test_forward_matches_golden(rng, mod, log2m):
    m = 1 << log2m
    N = mod.modulus
    fc = FieldConsts.from_modulus(mod)
    golden = GoldenNTT(m, mod)
    tables = forward_tables(mod, m)
    x = rng.integers(0, N, size=m, dtype=np.uint64)
    got = u64_to_numpy(
        jax.jit(lambda v: ntt_forward(v, tables, fc))(u64_from_numpy(x[:, None]))
    )[:, 0]
    want = golden.forward([int(v) for v in x])
    assert (_residues(got, N) == np.array(want, dtype=object)).all()


@pytest.mark.parametrize("mod", MODS, ids=lambda m: hex(m.modulus))
@pytest.mark.parametrize("log2m", [1, 4])
def test_inverse_matches_golden(rng, mod, log2m):
    m = 1 << log2m
    N = mod.modulus
    fc = FieldConsts.from_modulus(mod)
    golden = GoldenNTT(m, mod)
    tables = inverse_tables(mod, m)
    x = rng.integers(0, N, size=m, dtype=np.uint64)
    got = u64_to_numpy(
        jax.jit(lambda v: ntt_inverse(v, tables, fc))(u64_from_numpy(x[:, None]))
    )[:, 0]
    want = golden.inverse([int(v) for v in x])
    assert (_residues(got, N) == np.array(want, dtype=object)).all()


def test_roundtrip_batched(rng):
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    N = mod.modulus
    fc = FieldConsts.from_modulus(mod)
    m, batch = 64, 16
    fwd, inv = forward_tables(mod, m), inverse_tables(mod, m)
    x = rng.integers(0, N, size=(m, batch), dtype=np.uint64)

    @jax.jit
    def roundtrip(v):
        return ntt_inverse(ntt_forward(v, fwd, fc), inv, fc)

    got = u64_to_numpy(roundtrip(u64_from_numpy(x)))
    assert (got % np.uint64(N) == x).all()


def test_batch_columns_independent(rng):
    # each batch column transforms independently and identically
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    N = mod.modulus
    fc = FieldConsts.from_modulus(mod)
    m = 32
    tables = forward_tables(mod, m)
    x = rng.integers(0, N, size=(m, 4), dtype=np.uint64)
    full = u64_to_numpy(jax.jit(lambda v: ntt_forward(v, tables, fc))(u64_from_numpy(x)))
    for c in range(4):
        one = u64_to_numpy(
            jax.jit(lambda v: ntt_forward(v, tables, fc))(u64_from_numpy(x[:, c : c + 1]))
        )
        assert (full[:, c] % np.uint64(N) == one[:, 0] % np.uint64(N)).all()


def test_scale_extra_folding(rng):
    # inverse_tables(scale_extra=k) multiplies every output by k
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    N = mod.modulus
    fc = FieldConsts.from_modulus(mod)
    m, k = 16, 12345
    fwd = forward_tables(mod, m)
    inv_k = inverse_tables(mod, m, scale_extra=k)
    x = rng.integers(0, N, size=(m, 1), dtype=np.uint64)
    y = ntt_forward(u64_from_numpy(x), fwd, fc)
    got = u64_to_numpy(ntt_inverse(y, inv_k, fc))[:, 0]
    want = (x[:, 0].astype(object) * k) % N
    assert ((got.astype(object) % N) == want).all()


def test_chunked_leaf_paths_bit_exact(rng, monkeypatch):
    """The chunk executor (planner._jnp_chunked / _jnp_mid_chunked) must
    match the golden model with few and with many chunks per level
    (the chunk size scaled down so both trigger at test sizes)."""
    import sventt_tpu.plan.planner as P
    from sventt_tpu import GoldenNTT, Modulus, TEST_GENERATOR, TEST_MODULUS
    from sventt_tpu.plan import NTT, NttConfig

    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    for resident in (1 << 10, 1 << 7):  # 4 chunks per level, then 32
        monkeypatch.setattr(P, "JNP_RESIDENT_ELEMS", resident)
        cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, engine="jnp")
        ntt = NTT(cfg)
        x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
        fwd = ntt.forward_numpy(x)
        want = GoldenNTT(cfg.n, mod).forward(list(map(int, x)))
        assert list(map(int, fwd)) == want
        assert (ntt.inverse_numpy(fwd) == x).all()


def test_mid_axis_engine_matches_transposed(rng):
    """ntt_forward_mid / ntt_inverse_mid (axis-1 transform) must be
    bit-identical to the leading-axis engine applied to the transposed
    data, for 2-D and batched 3-D shapes."""
    import jax.numpy as jnp

    from sventt_tpu import TEST_GENERATOR, TEST_MODULUS, Modulus
    from sventt_tpu.field.limb import (
        FieldConsts,
        U64,
        u64_from_numpy,
        u64_to_numpy,
    )
    from sventt_tpu.ops.ntt_jnp import (
        ntt_forward,
        ntt_forward_mid,
        ntt_inverse,
        ntt_inverse_mid,
    )
    from sventt_tpu.ops.twiddle import forward_tables, inverse_tables

    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    m = 32
    ft = forward_tables(mod, m)
    it = inverse_tables(mod, m)
    for shape in [(4, m), (4, m, 3)]:
        x = rng.integers(0, mod.modulus, shape, dtype=np.uint64)
        xd = u64_from_numpy(x)
        got = u64_to_numpy(fc.normalize(ntt_forward_mid(xd, ft, fc)))
        perm = (1, 0) + tuple(range(2, len(shape)))
        xt = U64(jnp.transpose(xd.hi, perm), jnp.transpose(xd.lo, perm))
        want = u64_to_numpy(fc.normalize(ntt_forward(xt, ft, fc)))
        np.testing.assert_array_equal(got, want.swapaxes(0, 1))
        # inverse roundtrip through the mid-axis pair
        back = u64_to_numpy(
            fc.normalize(ntt_inverse_mid(u64_from_numpy(got), it, fc))
        )
        np.testing.assert_array_equal(back, x)
