"""Multi-chip layer: meshes, shard_map six-step NTT, all-to-all transpose.

This subsystem has no reference equivalent -- the reference is a single-node
OpenMP library (SURVEY.md section 2.5: "Distributed communication backend:
ABSENT").  Per the mandate it is a first-class component here: the length-n
coefficient vector is row-sharded over a `jax.sharding.Mesh` and the six-step
transposes are `jax.lax.all_to_all` collectives.
"""

from .budget import (
    MemoryBudget,
    device_bytes_limit,
    distributed_memory_budget,
    validate_2p30,
)
from .mesh import make_ntt_mesh
from .sixstep import DistributedNTT

__all__ = [
    "make_ntt_mesh",
    "DistributedNTT",
    "MemoryBudget",
    "device_bytes_limit",
    "distributed_memory_budget",
    "validate_2p30",
]
