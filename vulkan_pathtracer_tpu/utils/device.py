"""Which accelerator a measurement ran on.

Every measurement names its device: JAX's platform, device kind and
device count, plus the card's name and power limit as ``nvidia-smi``
reports them (a card below its maximum power limit runs slower under
load).  Measurement paths call ``require_gpu`` and fail on any other
platform instead of falling back to the CPU.
"""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def require_gpu() -> dict:
    """``device_info()``; raises RuntimeError unless JAX runs on a GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {info['platform']} ({info['kind']})")
    return info


def nvidia_smi_power() -> str:
    """``name, power.limit`` of each card, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
