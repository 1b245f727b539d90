"""The plain-XLA matrix engine in every orientation, scheme and twiddle mode.

``ntt_mxu`` runs the length-m DFT as int8 x int8 -> int32 ``dot_general``
calls plus an elementwise recombination.  Each case checks one orientation
(leading axis, middle axis of a batched block, last axis of an unbatched
one) x plane scheme (s8, s8b, u7) x fused
inter-step twiddle (none, Montgomery pair, companion-free, solinas plain)
against GoldenNTT: forward y = NTT(x * w) and inverse y = INTT(x) * w.
"""

import jax
import numpy as np
import pytest

from sventt_tpu.field.golden import GoldenNTT
from sventt_tpu.field.limb import FieldConsts, u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu.ops import ntt_mxu
from sventt_tpu.ops.twiddle import MontPair, _mont_pair, _twiddle_pair, montpair_map

ORIENTATIONS = ["lead", "mid", "lane"]
SCHEMES = ["s8", "s8b", "u7"]
TWIDDLES = ["none", "pair", "w", "solinas"]


def _twiddles(mod, mode, plain, shape):
    flat = [int(v) for v in plain.reshape(-1)]
    if mode == "solinas":
        tw = _twiddle_pair(mod, flat, "solinas")
    else:
        tw = _mont_pair(mod, flat)
        if mode == "w":
            tw = MontPair(tw.w, None)
    return montpair_map(lambda a: a.reshape(shape), tw)


def _layout(x, orientation):
    """(columns, m) host data -> the orientation's device layout (A=2)."""
    cols, m = x.shape
    if orientation == "lead":
        return x.T  # (m, cols)
    if orientation == "mid":
        return x.reshape(2, cols // 2, m).transpose(0, 2, 1)  # (2, m, cols/2)
    return x  # lane: (cols, m)


def _unlayout(y, orientation, cols, m):
    if orientation == "lead":
        return y.T
    if orientation == "mid":
        return y.transpose(0, 2, 1).reshape(cols, m)
    return y


@pytest.mark.parametrize("tw_mode", TWIDDLES)
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("orientation", ORIENTATIONS)
def test_orientation_scheme_twiddle(rng, orientation, scheme, tw_mode):
    N, g = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR) if tw_mode == "solinas" else (
        TEST_MODULUS, TEST_GENERATOR
    )
    mod = Modulus(N, g)
    fc = FieldConsts.from_modulus(
        mod, modmul="solinas" if tw_mode == "solinas" else "montgomery"
    )
    m, cols = 16, 4
    golden = GoldenNTT(m, mod)
    x = rng.integers(0, N, (cols, m), dtype=np.uint64)
    w = rng.integers(1, N, (cols, m), dtype=np.uint64)
    xd = u64_from_numpy(_layout(x, orientation))
    tw = None
    if tw_mode != "none":
        if orientation == "mid":
            # an (A, m) table broadcast over the batch axis: row a applies
            # to host columns 2a and 2a+1
            w = np.repeat(w[::2], 2, axis=0)
            wl = w[::2]
        else:
            wl = _layout(w, orientation)
        tw = _twiddles(mod, tw_mode, wl, wl.shape)
    fn = {
        "lead": ntt_mxu.mxu_ntt,
        "mid": ntt_mxu.mxu_ntt_mid,
        "lane": ntt_mxu.mxu_ntt_mid,  # 2-D (rows, m): the last axis
    }[orientation]
    norm = jax.jit(fc.normalize)
    for inverse in (False, True):
        t = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, scheme=scheme)
        got = _unlayout(
            u64_to_numpy(norm(jax.jit(lambda v, tw: fn(v, t, fc, tw=tw))(xd, tw))),
            orientation, cols, m,
        )
        for c in range(cols):
            xs = [int(v) for v in x[c]]
            ws = [1] * m if tw_mode == "none" else [int(v) for v in w[c]]
            if inverse:
                want = [a * b % N for a, b in zip(golden.inverse(xs), ws)]
            else:
                want = golden.forward([a * b % N for a, b in zip(xs, ws)])
            assert [int(v) for v in got[c]] == want, (inverse, c)


@pytest.mark.parametrize(
    "scheme,m", [("s8", 1024), ("u7", 1024), ("s8b", 512), ("s8", 2)]
)
def test_leading_axis_extreme_lengths(rng, scheme, m):
    """The largest matrix each scheme supports (and the smallest), forward
    and inverse, on the 64-bit flagship modulus."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    golden = GoldenNTT(m, mod)
    x = rng.integers(0, mod.modulus, (m, 2), dtype=np.uint64)
    for inverse in (False, True):
        t = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, scheme=scheme)
        got = u64_to_numpy(jax.jit(lambda v: ntt_mxu.mxu_ntt(v, t, fc))(u64_from_numpy(x)))
        for c in range(2):
            xs = [int(v) for v in x[:, c]]
            want = golden.inverse(xs) if inverse else golden.forward(xs)
            assert [int(v) for v in got[:, c]] == want


def test_scheme_default_and_validation():
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    assert ntt_mxu.make_mxu_tables(mod, 8, inverse=False).scheme == ntt_mxu.SCHEME
    with pytest.raises(ValueError, match="s8b"):
        ntt_mxu.make_mxu_tables(mod, 1024, inverse=False, scheme="s8b")
    assert ntt_mxu.max_m("s8b") == 512 and ntt_mxu.max_m("s8") == 1024
    with pytest.raises(ValueError, match="scheme"):
        ntt_mxu.make_mxu_tables(mod, 8, inverse=False, scheme="s4")
    t = ntt_mxu.make_mxu_tables(mod, 8, inverse=False)
    with pytest.raises(ValueError, match="transform length"):
        ntt_mxu.mxu_ntt_mid(u64_from_numpy(np.zeros((8, 4), np.uint64)), t,
                             FieldConsts.from_modulus(mod))
