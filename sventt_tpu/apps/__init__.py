"""L5 applications: NTT convolution pipelines and the magic-series counters.

Equivalents of the reference's examples/ tree (SURVEY.md
section 2.3): the q-series generators and chunked power-series division of
examples/magic-series/gaussian-polynomial.hpp, and the NTT-free Kinnaes
closed form of examples/magic-series-kinnaes/kinnaes.hpp, which serves as an
algorithmically independent cross-check of the same counts.
"""

from .convolve import cyclic_convolve, poly_multiply
from .kinnaes import kinnaes_magic_series_count, kinnaes_parameters
from .series import (
    gaussian_binomial_coefficient,
    magic_series_count,
    q_pochhammer_coeffs,
    restricted_partition_series,
)

__all__ = [
    "cyclic_convolve",
    "poly_multiply",
    "q_pochhammer_coeffs",
    "restricted_partition_series",
    "gaussian_binomial_coefficient",
    "magic_series_count",
    "kinnaes_magic_series_count",
    "kinnaes_parameters",
]
