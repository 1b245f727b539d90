"""The accelerator a measurement runs on: a GPU check and the card's identity.

Timings and on-card checks must never fall back to the CPU, and every number
they print carries the card's name and power limit (a card set below its
maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """The first JAX device if it is a GPU; RuntimeError otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev.device_kind})"
        )
    return dev


def gpu_card_info() -> str:
    """``name, power.limit`` of each card, one per line, as nvidia-smi
    reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return r.stdout.strip()
