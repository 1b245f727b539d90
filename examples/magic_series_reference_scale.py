"""Reference-scale magic-series cross-check: M(100) and M(101), exactly.

The reference validates its Kinnaes closed form at m = 100/101 against the
exact big-integer counts (reference
examples/magic-series-kinnaes/test-magic-series-kinnaes.cpp:20-98).  This
script derives those exact counts INDEPENDENTLY with this framework:

1. run the NTT convolution pipeline (apps/series.py) for M(m) mod K
   independently generated 62-bit NTT primes;
2. CRT-reconstruct the exact integer (K chosen so the modulus product
   exceeds the ~1230-bit count);
3. verify the reconstruction against held-out pipeline moduli it was NOT
   built from;
4. verify the device Kinnaes closed form (apps/kinnaes.py) against the
   reconstructed integer over a generated matrix of (N, g, n) configs --
   the analogue of the reference's 12-config typed test matrix.

Two algorithmically independent counters agreeing across dozens of moduli
at reference scale is the strongest end-to-end proof the framework offers.

Usage: python examples/magic_series_reference_scale.py [m ...]
  (default: 100 101; m = 100 takes a few minutes host-side per modulus
   on CPU, much less with a GPU convolver)
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

from sventt_tpu.apps.kinnaes import kinnaes_magic_series_count, kinnaes_parameters
from sventt_tpu.apps.series import magic_series_count
from sventt_tpu.field.modulus import find_ntt_prime


def crt_pair(r1: int, n1: int, r2: int, n2: int) -> tuple[int, int]:
    """Combine x = r1 (mod n1), x = r2 (mod n2) for coprime moduli."""
    inv = pow(n1, -1, n2)
    x = r1 + n1 * ((r2 - r1) * inv % n2)
    return x % (n1 * n2), n1 * n2


def exact_magic_series(m: int, margin_bits: int = 80, holdout: int = 2) -> int:
    """Exact M(m) via CRT over independently generated NTT primes."""
    r = m * m * (m - 1) // 2
    need_two_adicity = (2 * r + 1 - 1).bit_length()  # linear conv length
    # Upper bound on bits of M(m): M(m) < C(m^2, m) < (e*m)^m.
    import math

    bound_bits = int(m * math.log2(math.e * m)) + margin_bits
    primes: list[tuple[int, int]] = []
    start = 1 << 62
    while sum(p.bit_length() for p, _ in primes) < bound_bits + 64 * holdout:
        N, g = find_ntt_prime(62, need_two_adicity, start=start)
        primes.append((N, g))
        start = N - 2  # next search strictly below this prime
    residues = []
    for i, (N, g) in enumerate(primes):
        t0 = time.perf_counter()
        residues.append(magic_series_count(m, N, g))
        print(
            f"  pipeline M({m}) mod prime {i + 1}/{len(primes)} "
            f"({time.perf_counter() - t0:.1f}s)",
            file=sys.stderr,
        )
    # Reconstruct from all but the hold-outs; verify against the hold-outs.
    x, mod = residues[0] % primes[0][0], primes[0][0]
    for (N, _), res in list(zip(primes, residues))[1 : len(primes) - holdout]:
        x, mod = crt_pair(x, mod, res, N)
    # x < mod is true by construction (crt_pair reduces); the guard that
    # can actually fire is the modulus product covering the value bound.
    assert mod.bit_length() > bound_bits, (
        "CRT modulus product too small for the M(m) bit bound"
    )
    for (N, _), res in list(zip(primes, residues))[len(primes) - holdout :]:
        assert x % N == res, f"hold-out modulus {N:#x} disagrees"
    return x


def kinnaes_matrix(m: int, exact: int, widths=(64, 63, 62, 61), per_width=2):
    """Device Kinnaes over a generated (N, g, n) matrix vs the exact count
    (the reference's 12-config matrix, test-magic-series-kinnaes.cpp)."""
    for bits in widths:
        for skip in range(per_width):
            N, g, n = kinnaes_parameters(m, bits=bits, skip=skip)
            t0 = time.perf_counter()
            got = kinnaes_magic_series_count(m, N, g, n)
            ok = got == exact % N
            print(
                f"  kinnaes m={m} N={N:#x} g={g} n={n}: "
                f"{'OK' if ok else 'MISMATCH'} ({time.perf_counter() - t0:.1f}s)"
            )
            assert ok, (m, N, g, n, got, exact % N)


def main() -> None:
    ms = [int(a) for a in sys.argv[1:]] or [100, 101]
    for m in ms:
        t0 = time.perf_counter()
        exact = exact_magic_series(m)
        print(f"M({m}) = {exact}")
        print(
            f"  ({len(str(exact))} digits, reconstructed+verified in "
            f"{time.perf_counter() - t0:.1f}s)",
            file=sys.stderr,
        )
        kinnaes_matrix(m, exact)


if __name__ == "__main__":
    main()
