"""Transposes for the six-step decomposition.

The reference maintains a 14-class zoo of SVE transposes (in-register
shuffles, gathers, explicit L1 blocking -- reference
include/sventt/transposition/, SURVEY.md 2.1 #27-37) selected by benchmark.
Here XLA's own tiled transpose plays that role; the default six-step
schedules are transpose-free, so these run only on fallback paths (deep row
subtrees, non-jnp distributed row plans, the unbatched mxu root).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..field.limb import U64


def transpose_xla(x: jnp.ndarray) -> jnp.ndarray:
    """Swap the two leading axes via XLA (any trailing batch dims)."""
    perm = (1, 0) + tuple(range(2, x.ndim))
    return jnp.transpose(x, perm)


def transpose01_u64(x: U64) -> U64:
    """Swap the two leading axes of both limb planes."""
    return U64(transpose_xla(x.hi), transpose_xla(x.lo))
