"""Compute ops: butterfly stages, NTT engines (jnp + int8 matrix), transposes."""

from .ntt_jnp import ntt_forward, ntt_inverse, pointwise_mont_mul, twiddle_rows
from .twiddle import (
    ForwardTables,
    InverseTables,
    MontPair,
    forward_tables,
    inverse_tables,
    montgomery_scalar,
    sixstep_row_twiddles,
    sixstep_row_twiddles_inverse,
)

__all__ = [
    "ntt_forward",
    "ntt_inverse",
    "pointwise_mont_mul",
    "twiddle_rows",
    "ForwardTables",
    "InverseTables",
    "MontPair",
    "forward_tables",
    "inverse_tables",
    "montgomery_scalar",
    "sixstep_row_twiddles",
    "sixstep_row_twiddles_inverse",
]
