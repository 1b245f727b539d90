"""Mesh construction helpers for distributed transforms.

The NTT's communication pattern is a single all-to-all over one axis, so the
natural mesh is 1-D; on GPUs joined all to all (NVLink) the device order does
not matter.  For CPU simulation set
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.
"""

from __future__ import annotations

import jax

AXIS = "shard"


def make_ntt_mesh(n_devices: int | None = None, axis: str = AXIS) -> jax.sharding.Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    return jax.make_mesh((n_devices,), (axis,), devices=devices[:n_devices])
