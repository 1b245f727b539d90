"""Shared benchmark utilities.

Chain timings use ``sventt_tpu.utils.truetime``: one jitted fori_loop chain
per measurement, completion forced by a one-element device-to-host
readback, fixed overhead subtracted.
"""

from __future__ import annotations

import json
import sys


def chain_time_ms(
    step,
    state,
    tables=(),
    seconds: float = 2.0,
    reps: int = 2,
) -> float:
    """Per-step milliseconds (median of ``reps`` chains).

    ``step(state, *tables) -> state``.  Pass twiddle tables and other large
    operands via ``tables`` -- the chain program traces ``step``, so
    anything closed over is baked into its HLO (hundreds of MB for 2^24
    tables).
    """
    from sventt_tpu.utils.truetime import time_chained

    return time_chained(
        step, state, tables, seconds=seconds, reps=reps
    ).ms


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
