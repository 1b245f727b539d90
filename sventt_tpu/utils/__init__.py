"""Utilities: instance caching, compile cache, profiling hooks, chain timing."""

from .cache import cached_ntt, clear_ntt_cache
from .compile_cache import enable_compile_cache
from .profiling import phase_breakdown, trace
from .truetime import time_chained

__all__ = [
    "cached_ntt",
    "clear_ntt_cache",
    "enable_compile_cache",
    "phase_breakdown",
    "time_chained",
    "trace",
]
