"""Application-layer tests: q-series, magic series, Kinnaes cross-check.

Mirrors the reference's example test strategy (SURVEY.md section 5): unit
tests of each polynomial generator against independently computed
coefficients, end-to-end counts against exact ground truth, and the Kinnaes
closed form as an algorithmically independent cross-check of the NTT
convolution pipeline.
"""

import numpy as np
import pytest

from sventt_tpu import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu.apps import (
    kinnaes_magic_series_count,
    kinnaes_parameters,
    magic_series_count,
    poly_multiply,
    q_pochhammer_coeffs,
    restricted_partition_series,
)
from sventt_tpu.apps.kinnaes import kinnaes_magic_series_count_host
from sventt_tpu.apps.series import gaussian_binomial_coefficient, magic_series_count_exact

N, G = TEST_MODULUS, TEST_GENERATOR

#: OEIS A052456 (number of magic series of order m).
MAGIC_SERIES = {1: 1, 2: 2, 3: 8, 4: 86, 5: 1394}


def _poly_mul_exact(a, b, N):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + int(x) * int(y)) % N
    return out


def test_q_pochhammer_small():
    # (q;q)_3 = (1-q)(1-q^2)(1-q^3) = 1 - q - q^2 + q^4 + q^5 - q^6
    got = [int(v) for v in q_pochhammer_coeffs(3, 6, N)]
    want = [1, N - 1, N - 1, 0, 1, 1, N - 1]
    assert got == want


def test_restricted_partition_counts():
    # p(n | parts <= 3) for n = 0..8: 1,1,2,3,4,5,7,8,10
    got = [int(v) for v in restricted_partition_series(3, 8, N)]
    assert got == [1, 1, 2, 3, 4, 5, 7, 8, 10]


def test_pochhammer_times_inverse_is_one():
    d = 40
    poch = q_pochhammer_coeffs(6, d, N)
    inv = restricted_partition_series(6, d, N)
    prod = _poly_mul_exact(poch, inv, N)[: d + 1]
    assert prod == [1] + [0] * d


def test_poly_multiply_matches_exact(rng):
    a = rng.integers(0, N, 37, dtype=np.uint64)
    b = rng.integers(0, N, 23, dtype=np.uint64)
    got = [int(v) for v in poly_multiply(a, b, N, G)]
    assert got == _poly_mul_exact(a, b, N)


@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_magic_series_via_ntt(m):
    assert magic_series_count(m, N, G) == MAGIC_SERIES[m]


def test_magic_series_exact_oracle():
    for m, v in MAGIC_SERIES.items():
        assert magic_series_count_exact(m) == v


def test_magic_series_chunked_matches_direct():
    m = 5
    assert magic_series_count(m, N, G, chunk=16) == MAGIC_SERIES[m]


def test_magic_series_via_mxu_engine():
    """The end-to-end convolution pipeline over the int8 matrix engine
    (``engine="mxu"``): forward -> Montgomery pointwise ->
    inverse must still reproduce the exact count."""
    from sventt_tpu.apps.convolve import make_convolver

    ntt = make_convolver(N, G, 256, engine="mxu")
    assert magic_series_count(5, N, G, ntt=ntt) == MAGIC_SERIES[5]


def test_gaussian_binomial_limit_is_binomial():
    # [q^0] qbinom(n, k) = 1; sum over r of coefficients = C(n, k) checked
    # via a single interior coefficient against exact integer arithmetic.
    poch_k = q_pochhammer_coeffs(2, 12, N)  # not used; cheap sanity anchor
    assert int(poch_k[0]) == 1
    # qbinom(4, 2) = 1 + q + 2q^2 + q^3 + q^4
    got = [gaussian_binomial_coefficient(4, 2, r, N, G) for r in range(5)]
    assert got == [1, 1, 2, 1, 1]


#: The reference exercises its pipeline over 8 moduli spanning widths and
#: structures (test-magic-series.cpp:22-39); the equivalent matrix here:
#: Goldilocks with two generators, the 64-bit flagship, independently
#: generated 63/61/60-bit NTT primes, the 62-bit test modulus, and the
#: Fermat prime F4 = 2^16 + 1 (whose tiny width stresses the generic
#: width handling).
MODULI_MATRIX = [
    (0xFFFF_FFFF_0000_0001, 7),  # Goldilocks, smallest generator
    (0xFFFF_FFFF_0000_0001, 823543),  # Goldilocks, non-smallest generator
    (0xFFFF_FC6E_8000_0001, 3),  # 64-bit flagship
    (0x7FFF_FFFF_FEF0_0001, 10),  # generated 63-bit
    (0x3A00_0000_0000_0001, 3),  # 62-bit test modulus
    (0x1FFF_FFFF_FFE0_0001, 37),  # generated 61-bit
    (0x0FFF_FFFF_FE40_0001, 17),  # generated 60-bit
    (0x0000_0000_0001_0001, 3),  # Fermat prime F4
]


@pytest.mark.parametrize("Nm,g", MODULI_MATRIX)
def test_magic_series_moduli_matrix(Nm, g):
    """M(5) and M(6) through the full NTT pipeline on every matrix modulus
    (counts fit even F4, so every result is exact)."""
    assert magic_series_count(5, Nm, g) == MAGIC_SERIES[5]
    assert magic_series_count(6, Nm, g) == 32134  # OEIS A052456


@pytest.mark.parametrize("m", [3, 4])
def test_kinnaes_host_and_device(m):
    Np, g, n = kinnaes_parameters(m, bits=61)
    assert kinnaes_magic_series_count_host(m, Np, g, n) == MAGIC_SERIES[m]
    assert kinnaes_magic_series_count(m, Np, g, n) == MAGIC_SERIES[m]


def test_kinnaes_device_mid_scale():
    """m = 12 (r = 792, n/2 = 397 lanes): the device path at a scale where
    the lane layout, powering, and reduction tree all have real depth;
    checked against the independent host closed form AND the NTT pipeline
    count (M(12) ~ 1.6e12 fits a 61-bit modulus exactly)."""
    m = 12
    Np, g, n = kinnaes_parameters(m, bits=61)
    dev = kinnaes_magic_series_count(m, Np, g, n)
    assert dev == kinnaes_magic_series_count_host(m, Np, g, n)
    assert dev == magic_series_count(m, N, G)  # exact: M(12) < both moduli


@pytest.mark.parametrize("skip", [0, 1])
def test_kinnaes_parameters_skip(skip):
    Np, g, n = kinnaes_parameters(6, bits=61, skip=skip)
    assert (Np - 1) % n == 0 and n == 91
    if skip:
        N0, _, _ = kinnaes_parameters(6, bits=61, skip=0)
        assert Np < N0


@pytest.mark.parametrize("m", [6, 8])
def test_three_way_cross_check(m):
    """Exact DP vs NTT convolution vs Kinnaes closed form -- three
    algorithmically independent counters must agree (the reference's
    cross-check strategy, SURVEY.md section 5)."""
    exact = magic_series_count_exact(m)
    assert magic_series_count(m, N, G) == exact % N
    Np, g, n = kinnaes_parameters(m, bits=61)
    assert kinnaes_magic_series_count_host(m, Np, g, n) == exact % Np


#: Exact magic-series counts at the reference's test scale, computed and
#: verified by examples/magic_series_reference_scale.py (2026-08-17):
#: NTT-pipeline residues CRT-combined over 17 independently
#: generated 62-bit NTT primes, checked against 2 held-out moduli, then
#: confirmed by the device Kinnaes closed form over an 8-config
#: (width 64..61 x 2 primes) matrix per order -- the reference validates
#: the same orders (test-magic-series-kinnaes.cpp:20-98).
M100 = int(
    "9043007368088944265747933022406939112612349423987481545280521717243052"
    "7904558345986101135781355626074636685064666906216989017828082488599537"
    "5485156399921958991796250954308603011799192842071430359668946052264146"
    "938445899732873114858199920"
)
M101 = int(
    "6517428685211505994232177388427365631933896727256173046091895410609480"
    "7534843021101708794185168653839829071357636233748162115685478414828310"
    "4866179994202618028615736621185423913319338987817995082551755913561634"
    "157004344784632798600635226832"
)


@pytest.mark.parametrize("m,exact", [(100, M100), (101, M101)])
def test_kinnaes_reference_scale(m, exact):
    """Device Kinnaes at the reference's m = 100/101 scale (n/2 ~ 250k
    lanes, m-deep product loop) against the independently reconstructed
    exact counts."""
    Np, g, n = kinnaes_parameters(m, bits=62)
    assert kinnaes_magic_series_count(m, Np, g, n) == exact % Np


def test_pipeline_reference_scale_m100():
    """The NTT convolution pipeline at m = 100 (r = 495,000 -> 2^20-point
    convolution) against the reconstructed exact count."""
    assert magic_series_count(100, N, G) == M100 % N
