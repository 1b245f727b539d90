"""Deterministic full-range test inputs, generated on device AND on host.

``device_fill`` is a jitted splitmix64 mix of iota, so a large input costs no
host-to-device transfer; ``host_fill`` reproduces the identical values in
numpy uint64 for the oracle side of a comparison.  Unlike a plain iota, the
values cover the full [0, 2^(bit_width(N)-1)) range: every data bit-plane
below the modulus width -- including the high u32 limb -- holds both 0s and
1s.

The mask ``2^(bit_width(N)-1) - 1`` guarantees values < N (the reduced-
input precondition) without a device-side mod: N has its top bit set, so
2^(bit_width-1) <= N.
"""

from __future__ import annotations

import numpy as np

_C1 = 0x9E3779B97F4A7C15
_C2 = 0xBF58476D1CE4E5B9
_C3 = 0x94D049BB133111EB
_M64 = (1 << 64) - 1


def _mask(modulus: int) -> int:
    return (1 << (modulus.bit_length() - 1)) - 1


def host_fill(n: int, modulus: int) -> np.ndarray:
    """The splitmix64 fill as numpy uint64 (bit-identical to device_fill)."""
    old = np.seterr(over="ignore")
    try:
        z = (np.arange(1, n + 1, dtype=np.uint64)) * np.uint64(_C1)
        z ^= z >> np.uint64(30)
        z *= np.uint64(_C2)
        z ^= z >> np.uint64(27)
        z *= np.uint64(_C3)
        z ^= z >> np.uint64(31)
        return z & np.uint64(_mask(modulus))
    finally:
        np.seterr(**old)


def device_fill(n: int, modulus: int, sharding=None):
    """U64 limb pair of ``host_fill``'s values, generated ON DEVICE (no
    host-to-device transfer).  ``sharding``: where the result lives (e.g.
    ``DistributedNTT.sharding()``, so each device makes its own shard);
    None = the default device."""
    import jax
    import jax.numpy as jnp

    from ..field.limb import (
        U64,
        u64_const_like,
        u64_mullo,
    )

    assert n < (1 << 32)
    mask = _mask(modulus)

    def _xorshr(z: U64, k: int) -> U64:
        s = U64(z.hi >> np.uint32(k), (z.lo >> np.uint32(k)) | (z.hi << np.uint32(32 - k)))
        return U64(z.hi ^ s.hi, z.lo ^ s.lo)

    def build() -> U64:
        i = U64(jnp.zeros((n,), jnp.uint32), jnp.arange(1, n + 1, dtype=jnp.uint32))
        # i runs 1..n <= 2^32: the +1 keeps index 0 off the all-zero mix
        z = u64_mullo(i, u64_const_like(_C1, i))
        z = _xorshr(z, 30)
        z = u64_mullo(z, u64_const_like(_C2, z))
        z = _xorshr(z, 27)
        z = u64_mullo(z, u64_const_like(_C3, z))
        z = _xorshr(z, 31)
        return U64(
            z.hi & np.uint32(mask >> 32), z.lo & np.uint32(mask & 0xFFFFFFFF)
        )

    kw = {} if sharding is None else {"out_shardings": sharding}
    return jax.jit(build, **kw)()
