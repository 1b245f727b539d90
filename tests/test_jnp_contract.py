"""The butterfly engine's numerical contract, case by case, vs GoldenNTT.

Every (modulus, modmul) pair the library supports, at m in {2, 16, 256}:
the leading-axis forward on batched columns, the middle-axis forward and
inverse on (A, m, B) blocks, and the inverse with an extra scale folded into
its last stage.  Outputs are compared as residues mod N (lazy engines may
return representatives in [0, 2N)).
"""

import jax
import numpy as np
import pytest

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
from sventt_tpu.ops.ntt_jnp import (
    ntt_forward,
    ntt_forward_mid,
    ntt_inverse,
    ntt_inverse_mid,
)
from sventt_tpu.ops.twiddle import forward_tables, inverse_tables

#: (modulus, generator, modmul): shoup needs a lazy (<= 62-bit) modulus,
#: solinas a sparse-high one.
ENGINES = [
    pytest.param(TEST_MODULUS, TEST_GENERATOR, "montgomery", id="62bit-mont"),
    pytest.param(TEST_MODULUS, TEST_GENERATOR, "shoup", id="62bit-shoup"),
    pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "montgomery", id="flagship-mont"),
    pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "solinas", id="flagship-solinas"),
    pytest.param(GOLDILOCKS_MODULUS, 7, "montgomery", id="goldilocks-mont"),
    pytest.param(GOLDILOCKS_MODULUS, 7, "solinas", id="goldilocks-solinas"),
]
SIZES = [2, 16, 256]


def _setup(N, g, modmul):
    mod = Modulus(N, g)
    return mod, FieldConsts.from_modulus(mod, modmul=modmul)


def _res(a, N):
    return [int(v) % N for v in np.asarray(a).reshape(-1)]


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("N,g,modmul", ENGINES)
def test_forward_batched_matches_golden(rng, N, g, modmul, m):
    mod, fc = _setup(N, g, modmul)
    t = forward_tables(mod, m, modmul=modmul)
    x = rng.integers(0, N, (m, 3), dtype=np.uint64)
    got = u64_to_numpy(jax.jit(lambda v: ntt_forward(v, t, fc))(u64_from_numpy(x)))
    golden = GoldenNTT(m, mod)
    for c in range(3):
        assert _res(got[:, c], N) == golden.forward([int(v) for v in x[:, c]])


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("N,g,modmul", ENGINES)
def test_mid_axis_matches_golden_and_roundtrips(rng, N, g, modmul, m):
    mod, fc = _setup(N, g, modmul)
    ft = forward_tables(mod, m, modmul=modmul)
    it = inverse_tables(mod, m, modmul=modmul)
    x = rng.integers(0, N, (2, m, 2), dtype=np.uint64)
    fwd = jax.jit(lambda v: ntt_forward_mid(v, ft, fc))(u64_from_numpy(x))
    got = u64_to_numpy(fwd)
    golden = GoldenNTT(m, mod)
    for a in range(2):
        for b in range(2):
            want = golden.forward([int(v) for v in x[a, :, b]])
            assert _res(got[a, :, b], N) == want
    back = u64_to_numpy(
        jax.jit(lambda v: fc.normalize(ntt_inverse_mid(v, it, fc)))(fwd)
    )
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("N,g,modmul", ENGINES)
def test_inverse_scale_extra_matches_golden(rng, N, g, modmul, m):
    """The inverse with ``scale_extra`` folded into its final stage equals
    the golden inverse times that scale (the convolution pipelines fold
    their pointwise constants this way)."""
    mod, fc = _setup(N, g, modmul)
    scale = 0x1234_5678_9ABC % N
    t = inverse_tables(mod, m, scale_extra=scale, modmul=modmul)
    x = rng.integers(0, N, (m, 2), dtype=np.uint64)
    got = u64_to_numpy(jax.jit(lambda v: ntt_inverse(v, t, fc))(u64_from_numpy(x)))
    golden = GoldenNTT(m, mod)
    for c in range(2):
        want = [v * scale % N for v in golden.inverse([int(v) for v in x[:, c]])]
        assert _res(got[:, c], N) == want
