"""Matrix-NTT engine vs the golden model (plain XLA, compiled on the CPU).

The int8 limb-plane matmul engine (ops/ntt_mxu.py) must be bit-exact
against GoldenNTT in every orientation (leading / middle / lane axis),
both directions, including adversarial maximal-carry inputs, and compose
through the planner into multi-level six-step plans.
"""

import numpy as np
import pytest

from sventt_tpu import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
)
from sventt_tpu.field.golden import GoldenNTT
from sventt_tpu.field.limb import FieldConsts, u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus
from sventt_tpu.ops import ntt_mxu
from sventt_tpu.plan import NTT, NttConfig

MODULI = [
    pytest.param(TEST_MODULUS, TEST_GENERATOR, id="62bit"),
    pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, id="flagship-64bit"),
]


@pytest.mark.parametrize("m", [8, 64, 256])
@pytest.mark.parametrize("N,g", MODULI)
def test_mxu_forward_inverse_golden(rng, N, g, m):
    mod = Modulus(N, g)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    golden = GoldenNTT(m, mod)
    ft = ntt_mxu.make_mxu_tables(mod, m, inverse=False)
    it = ntt_mxu.make_mxu_tables(mod, m, inverse=True)
    x = rng.integers(0, N, (m, 3), dtype=np.uint64)
    x[:, 1] = N - 1  # maximal-carry column (2^128-overflow fold path)
    out = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(x), ft, fc))
    for c in range(x.shape[1]):
        assert [int(v) for v in out[:, c]] == golden.forward(
            [int(v) for v in x[:, c]]
        )
    back = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(out), it, fc))
    np.testing.assert_array_equal(back, x)


def test_mxu_mid_and_lane_match_lead(rng):
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    m = 32
    ft = ntt_mxu.make_mxu_tables(mod, m, inverse=False)
    xm = rng.integers(0, mod.modulus, (4, m, 2), dtype=np.uint64)
    want = np.stack(
        [
            u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(xm[a]), ft, fc))
            for a in range(xm.shape[0])
        ]
    )
    got_mid = u64_to_numpy(ntt_mxu.mxu_ntt_mid(u64_from_numpy(xm), ft, fc))
    np.testing.assert_array_equal(got_mid, want)
    # no batch axes: the transform runs along the last axis of (rows, m)
    rows = xm.transpose(0, 2, 1).reshape(-1, m)
    got_lane = u64_to_numpy(
        ntt_mxu.mxu_ntt_mid(u64_from_numpy(rows), ft, fc)
    ).reshape(4, 2, m).transpose(0, 2, 1)
    np.testing.assert_array_equal(got_lane, want)


@pytest.mark.parametrize("log2n", [10, 12])
def test_mxu_engine_through_planner(rng, log2n):
    """engine='mxu' plans (lane row at the top level, mid rows inside)
    match the jnp engine bit-for-bit and roundtrip."""
    cfg = NttConfig(
        FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << log2n, engine="mxu"
    )
    ntt = NTT(cfg)
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    ref = NTT(cfg.with_(engine="jnp"), enable_inverse=False)
    np.testing.assert_array_equal(fwd, ref.forward_numpy(x))
    assert (ntt.inverse_numpy(fwd) == x).all()


def test_mxu_three_level_plan(rng):
    """The 2^24-shaped composition at reduced scale: a 3-level left-deep
    mxu plan (Split(Split(leaf, leaf-mid), leaf-lane))."""
    from sventt_tpu.plan import planner

    cfg = NttConfig(
        FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 14, engine="mxu",
        max_fused=32,
    )
    ntt = NTT(cfg, enable_inverse=False)
    assert isinstance(ntt.plan.col, planner.Split)  # 3 levels
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    ref = NTT(cfg.with_(engine="jnp", max_fused=None), enable_inverse=False)
    np.testing.assert_array_equal(ntt.forward_numpy(x), ref.forward_numpy(x))


def test_mxu_512_leaf(rng):
    """MAX_MXU=512 leaves: bit-exact + roundtrip (int32 bound holds at
    512 * NL * 127^2 < 2^27)."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    m = 512
    golden = GoldenNTT(m, mod)
    ft = ntt_mxu.make_mxu_tables(mod, m, inverse=False)
    it = ntt_mxu.make_mxu_tables(mod, m, inverse=True)
    x = rng.integers(0, mod.modulus, (m, 2), dtype=np.uint64)
    x[:, 1] = mod.modulus - 1
    out = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(x), ft, fc))
    for c in range(2):
        assert [int(v) for v in out[:, c]] == golden.forward(
            [int(v) for v in x[:, c]]
        )
    back = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(out), it, fc))
    np.testing.assert_array_equal(back, x)


def test_mixed_engine_plan_spec(rng):
    """Explicit mixed-engine trees (NttConfig.plan_spec): mxu rows over a
    jnp column leaf, and a same-size jnp/mxu leaf pair in one tree, match
    the uniform jnp engine bit-for-bit and roundtrip (round-4 VERDICT
    task 3)."""
    n = 1 << 14
    ref = NTT(
        NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, engine="jnp"),
        enable_inverse=False,
    )
    x = rng.integers(0, FLAGSHIP_MODULUS, n, dtype=np.uint64)
    want = ref.forward_numpy(x)
    # "mxu:128,jnp": row leaf 128-mxu + column leaf 128-jnp -- same size,
    # different engines, exercising the (m, engine) table keying
    for spec in ("mxu:64,mxu:64,jnp", "jnp:64,mxu", "mxu:128,jnp"):
        cfg = NttConfig(
            FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, plan_spec=spec
        )
        ntt = NTT(cfg)
        np.testing.assert_array_equal(ntt.forward_numpy(x), want, err_msg=spec)
        assert (ntt.inverse_numpy(want) == x).all(), spec


def test_plan_spec_validation():
    from sventt_tpu.plan.planner import build_plan_spec

    for bad in ("mxu:64", "jnp:3,mxu", "mxu:16384,jnp", "nope", ""):
        with pytest.raises(ValueError):
            build_plan_spec(1 << 14, bad)
            raise AssertionError(f"accepted {bad!r}")


def test_mxu_rejects_oversize():
    mod = Modulus(TEST_MODULUS, TEST_GENERATOR)
    with pytest.raises(ValueError):
        ntt_mxu.make_mxu_tables(mod, 2 * ntt_mxu.MAX_MXU, inverse=False)


def test_s8_bias_covers_worst_case():
    """The per-plane bias (m << 17) must cover the most-negative output
    plane reachable from the REAL table digits with legal byte planes
    (round-5 review: a fixed 2^26 bias silently wrapped at m = 1024)."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    for m in (512, 1024):
        t = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="s8")
        planes = np.asarray(t.planes).astype(np.int64)  # (8m, m)
        D = planes.reshape(ntt_mxu.NL_S8, m, m)
        # per (a, p): the minimal sum_j D*s over s in [-128, 127]
        min_a = np.where(D > 0, -128 * D, 127 * D).sum(axis=2)  # (8, m)
        worst = np.zeros((15, m), dtype=np.int64)
        for a in range(8):
            for b in range(8):
                worst[a + b] += min_a[a]
        assert int(worst.min()) >= -(m << 17), (m, int(worst.min()))
        if m == 1024:
            # the round-4 constant bias really was insufficient here
            assert int(worst.min()) < -(1 << 26)


def test_mxu_1024_adversarial_plane_minimizer():
    """m = 1024 with an input crafted to drive output plane t = 7 of row 0
    maximally negative (each byte sign-opposes the matching matrix digit)
    -- the exact wrap scenario of the round-5 review finding.  The engine
    accepts any u64 bit pattern (planes decompose raw bits; the result is
    congruent to the reduced input's transform), so compare mod N against
    the golden model of x mod N."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    m = 1024
    t = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="s8")
    D = np.asarray(t.planes).astype(np.int64).reshape(ntt_mxu.NL_S8, m, m)
    # choose the (row, plane) with the most negative reachable sum: for a
    # fixed target plane t*, byte b of x_j pairs with the unique digit
    # a = t* - b, so the per-(j, b) minimizing choices are independent
    min_a = np.where(D > 0, -128 * D, 127 * D).sum(axis=2)  # (8, m)
    worst = np.zeros((15, m), dtype=np.int64)
    for a in range(8):
        for b in range(8):
            worst[a + b] += min_a[a]
    tstar, pstar = np.unravel_index(np.argmin(worst), worst.shape)
    x = np.zeros(m, dtype=np.uint64)
    reach = 0
    for j in range(m):
        v = 0
        for b in range(8):
            a = tstar - b
            if 0 <= a < 8:
                d = D[a, pstar, j]
                s = -128 if d > 0 else (127 if d < 0 else -128)
                reach += int(d) * s
            else:
                s = -128
            v |= (s + 128) << (8 * b)
        x[j] = v
    assert reach < -(1 << 26)  # the crafted input crosses the old bias
    out = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(x.reshape(m, 1)), t, fc))
    golden = GoldenNTT(m, mod)
    want = golden.forward([int(v) % mod.modulus for v in x])
    assert [int(v) for v in out[:, 0]] == want


def test_balanced8_digits_exact():
    """The scalar balanced-digit reference (_balanced8) is exact across
    its completeness range [-128K, 127K] (K = (2^64-1)/255), including
    both endpoints and the minimal residues of every shipped modulus --
    the property the vectorized table builder relies on."""
    K = ntt_mxu._K8
    # note: (1 << 63) - 1 > C8_PLUS = 127K -- positive capacity ends
    # BELOW 2^63, which is exactly why minimal residues near +N/2 of
    # 64-bit moduli must take the negative representative
    cases = [0, 1, -1, 127 * K, -128 * K, 127 * K - 1, -128 * K + 1,
             -(1 << 63), 12345678901234567]
    for N, _ in [(TEST_MODULUS, None), (FLAGSHIP_MODULUS, None)]:
        for v in (N - 1, N // 2, (N + 1) // 2):
            r = v if v <= ntt_mxu.C8_PLUS else v - N
            cases.append(r)
    for r in cases:
        ds = ntt_mxu._balanced8(r)
        assert len(ds) == 8 and all(-128 <= d <= 127 for d in ds)
        assert sum(d << (8 * a) for a, d in enumerate(ds)) == r
    for bad in (127 * K + 1, -128 * K - 1):
        with pytest.raises(AssertionError):
            ntt_mxu._balanced8(bad)


def test_vectorized_digits_match_scalar_reference():
    """make_mxu_tables' vectorized digit extraction equals the scalar
    _balanced8 on a real table (both directions, 64-bit modulus)."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    t = ntt_mxu.make_mxu_tables(mod, 16, inverse=True, scheme="s8")
    planes = np.asarray(t.planes)  # (8*16, 16) int8
    # reconstruct each matrix entry from its digit planes and check the
    # scalar decomposition of that value round-trips to the same digits
    for p in range(16):
        for j in range(16):
            ds = [int(planes[a * 16 + p, j]) for a in range(8)]
            r = sum(d << (8 * a) for a, d in enumerate(ds))
            assert ntt_mxu._balanced8(r) == ds


@pytest.mark.parametrize("N,g", MODULI)
def test_mxu_schemes_agree(rng, N, g):
    """The s8 balanced-digit scheme and the u7 legacy scheme are
    interchangeable bit-for-bit (same Montgomery-lifted matrix, different
    plane decomposition)."""
    mod = Modulus(N, g)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    m = 128
    ts = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="s8")
    tu = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="u7")
    assert ts.planes.shape == (ntt_mxu.NL_S8 * m, m)
    assert tu.planes.shape == (ntt_mxu.NL * m, m)
    x = rng.integers(0, N, (m, 4), dtype=np.uint64)
    x[:, 0] = N - 1  # maximal magnitudes through the signed planes
    got_s8 = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(x), ts, fc))
    got_u7 = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(x), tu, fc))
    np.testing.assert_array_equal(got_s8, got_u7)
    # banded variant: the same digits as one block-banded matmul
    tb = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="s8b")
    assert tb.planes.shape == (15 * m, ntt_mxu.NL_S8 * m)
    got_b = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(x), tb, fc))
    np.testing.assert_array_equal(got_b, got_s8)


def test_mxu_small_modulus_f4(rng):
    """The F4 prime 2^16+1: the canonicalization step must stay bounded
    (the round-4 unrolled (2^64-1)//N subtract chain attempted ~2.8e14
    trace-time ops here -- an effective hang; now a single Barrett step)
    and remain bit-exact."""
    mod = Modulus(65537, 3)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    m = 64
    golden = GoldenNTT(m, mod)
    ft = ntt_mxu.make_mxu_tables(mod, m, inverse=False)
    it = ntt_mxu.make_mxu_tables(mod, m, inverse=True)
    x = rng.integers(0, mod.modulus, (m, 3), dtype=np.uint64)
    x[:, 1] = mod.modulus - 1
    out = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(x), ft, fc))
    for c in range(x.shape[1]):
        assert [int(v) for v in out[:, c]] == golden.forward(
            [int(v) for v in x[:, c]]
        )
    back = u64_to_numpy(ntt_mxu.mxu_ntt(u64_from_numpy(out), it, fc))
    np.testing.assert_array_equal(back, x)
