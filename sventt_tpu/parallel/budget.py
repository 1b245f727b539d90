"""Memory budgeting and plan validation for huge distributed transforms.

BASELINE.md config 5 is the row-sharded 2^30 transform: 8 GB of limb
coefficients (8 B/point) plus twiddle tables spread over a device mesh.
At that scale table/transient choices decide whether the plan fits at all
-- the single-device analogues are ``donate_input`` (halves transient
memory) and
the companion-free inter-step tables (halves twiddle bytes,
plan/planner.py W_ONLY_THRESHOLD).  This module computes the per-device
byte budget of a DistributedNTT WITHOUT building it, so 2^30-class plans
can be validated cheaply anywhere (the CPU mesh, a front-end host), the
way the reference dry-runs a FakeByteVector through its wrapper to size
the aux arena before allocating (reference include/sventt/wrapper.hpp:34-46,
memory/fake.hpp).

The byte limit comes from the device itself (``memory_stats()``'s
``bytes_limit``: what the JAX allocator may use) or from the caller; there
is no assumed size for a device that reports none.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..plan import planner
from ..plan.config import NttConfig
from ..plan.planner import W_ONLY_THRESHOLD
from ..plan.wrapper import _resolve_engine

#: Bytes per coefficient: u64 as two u32 limb planes.
BYTES_PER_POINT = 8


def device_bytes_limit(devices=None) -> int:
    """The smallest ``bytes_limit`` that the given devices (default: all of
    JAX's devices) report in ``memory_stats()``.  Raises ValueError for a
    device that reports none (the CPU backend): pass ``hbm_bytes``
    explicitly there."""
    import jax

    limits = []
    for d in devices if devices is not None else jax.devices():
        stats = d.memory_stats() or {}
        if "bytes_limit" not in stats:
            raise ValueError(
                f"device {d} ({d.platform}) reports no memory limit; pass "
                "hbm_bytes explicitly"
            )
        limits.append(int(stats["bytes_limit"]))
    return min(limits)


def _leaf_table_bytes(plan) -> int:
    """Bytes of the per-leaf stage tables (replicated on every device)."""
    total = 0
    seen = set()

    def walk(node):
        nonlocal total
        if isinstance(node, planner.Leaf):
            if (node.m, node.engine) in seen:
                return
            seen.add((node.m, node.engine))
            stages = node.m.bit_length() - 1
            if node.engine == "mxu":
                # the scheme's int8 digit-plane matrix and the (m,) U64
                # correction row (ops/ntt_mxu.py MxuDirection)
                from ..ops import ntt_mxu

                rows, cols = ntt_mxu._mat_dims(ntt_mxu.SCHEME, node.m)
                total += rows * cols + 8 * node.m
            else:
                total += stages * 4 * node.m * 4
        else:
            walk(node.col)
            walk(node.row)

    walk(plan)
    return total


@dataclass(frozen=True)
class MemoryBudget:
    """Per-device byte budget of one DistributedNTT configuration."""

    n: int
    devices: int
    coefficients: int  # input/output shard
    transient: int  # non-donated second buffer + all-to-all staging
    inter_step_twiddles: int  # sharded (n0, n1) matrix, per direction
    leaf_tables: int  # replicated, per direction
    directions: int

    @property
    def total(self) -> int:
        return (
            self.coefficients
            + self.transient
            + self.directions * (self.inter_step_twiddles + self.leaf_tables)
        )

    def fits(self, hbm_bytes: int | None = None) -> bool:
        """Whether the budget fits ``hbm_bytes`` per device (default: the
        limit JAX's devices report, see ``device_bytes_limit``)."""
        if hbm_bytes is None:
            hbm_bytes = device_bytes_limit()
        return self.total <= hbm_bytes


def distributed_memory_budget(
    config: NttConfig,
    devices: int,
    *,
    enable_forward: bool = True,
    enable_inverse: bool = True,
    donate_input: bool = False,
) -> MemoryBudget:
    """Per-device budget of ``DistributedNTT(config, mesh)`` with
    ``devices`` devices, without constructing anything."""
    n0, n1 = config.split
    if n0 % devices or n1 % devices:
        raise ValueError(
            f"n0={n0}, n1={n1} must be divisible by mesh size {devices}"
        )
    n = config.n
    shard = n // devices * BYTES_PER_POINT
    # inter-step twiddle matrix is (n0, n1) sharded over the mesh; above
    # W_ONLY_THRESHOLD the Montgomery companion is dropped (half the bytes)
    tw = n // devices * BYTES_PER_POINT
    if n < W_ONLY_THRESHOLD:
        # planner.row_twiddles keeps the Montgomery companion below the
        # W-only threshold on BOTH the host path (n <= device threshold)
        # and the device-built path
        tw *= 2  # with companion
    engine = _resolve_engine(config.engine, n)
    leaf = _leaf_table_bytes(planner.build_plan(n0, engine)) + _leaf_table_bytes(
        planner.build_plan(n1, engine)
    )
    directions = int(enable_forward) + int(enable_inverse)
    # transient: the all-to-all writes a fresh shard (always), plus the
    # un-donated input copy when the caller keeps their buffer
    transient = shard if donate_input else 2 * shard
    return MemoryBudget(
        n=n,
        devices=devices,
        coefficients=shard,
        transient=transient,
        inter_step_twiddles=tw,
        leaf_tables=leaf,
        directions=directions,
    )


def validate_2p30(devices: int = 4, hbm_bytes: int | None = None) -> MemoryBudget:
    """BASELINE config 5 feasibility: row-sharded 2^30 over ``devices``
    devices must fit each device's memory one direction at a time with
    donation.  ``hbm_bytes``: bytes per device (default: what the devices
    report, ``device_bytes_limit``).  Returns the budget (also raises via
    NttConfig if the plan is invalid).
    """
    from ..field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS

    cfg = NttConfig(
        FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 30, strategy="six_step"
    )
    budget = distributed_memory_budget(
        cfg, devices, enable_inverse=False, donate_input=True
    )
    if hbm_bytes is None:
        hbm_bytes = device_bytes_limit()
    if not budget.fits(hbm_bytes):
        raise ValueError(
            f"2^30 over {devices} devices needs {budget.total / 2**30:.1f} "
            f"GiB per device (> {hbm_bytes / 2**30:.1f} GiB)"
        )
    return budget
