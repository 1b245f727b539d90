"""Transposes: XLA's transpose on both limb planes, any batch dims."""

import jax.numpy as jnp
import numpy as np
import pytest

from sventt_tpu.field.limb import U64
from sventt_tpu.ops.transpose import transpose01_u64, transpose_xla


def test_xla_transpose_with_batch(rng):
    x = jnp.asarray(rng.integers(0, 1 << 32, (8, 16, 3), dtype=np.uint32))
    got = transpose_xla(x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(x).transpose(1, 0, 2))


def test_transpose01_u64_strategy_dispatch(rng):
    """transpose01_u64 (the transform paths' entry point) swaps the two
    leading axes of both planes, 2-D, 3-D and odd shapes alike."""
    hi = jnp.asarray(rng.integers(0, 1 << 32, (256, 512), dtype=np.uint32))
    lo = jnp.asarray(rng.integers(0, 1 << 32, (256, 512), dtype=np.uint32))
    got = transpose01_u64(U64(hi, lo))
    np.testing.assert_array_equal(np.asarray(got.hi), np.asarray(hi).T)
    np.testing.assert_array_equal(np.asarray(got.lo), np.asarray(lo).T)
    hi3 = hi.reshape(256, 256, 2)
    got = transpose01_u64(U64(hi3, hi3))
    np.testing.assert_array_equal(
        np.asarray(got.hi), np.asarray(hi3).transpose(1, 0, 2)
    )
    got = transpose01_u64(U64(hi[:100], lo[:100]))
    np.testing.assert_array_equal(np.asarray(got.hi), np.asarray(hi).T[:, :100])


def test_transpose_pallas_demoted_from_config():
    """XLA's transpose is the only one: the public config has no transpose
    knob any more, and an old call site fails loudly."""
    from sventt_tpu.field.modulus import TEST_GENERATOR, TEST_MODULUS
    from sventt_tpu.plan import NttConfig

    with pytest.raises(TypeError, match="transpose"):
        NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 10, transpose="pallas")


@pytest.mark.parametrize("shape", [(4, 8), (8, 4, 3), (2, 16, 2, 2)])
def test_transpose01_is_an_involution(rng, shape):
    hi = jnp.asarray(rng.integers(0, 1 << 32, shape, dtype=np.uint32))
    x = U64(hi, hi ^ jnp.uint32(0xFFFF))
    y = transpose01_u64(transpose01_u64(x))
    np.testing.assert_array_equal(np.asarray(y.hi), np.asarray(x.hi))
    np.testing.assert_array_equal(np.asarray(y.lo), np.asarray(x.lo))
