"""The accelerator a measurement runs on.

Every number this repository reports on device speed names the card it came
from: JAX's view of the device and the card's name and power limit from
`nvidia-smi` (a card set below its maximum power limit runs slower under
load). A measurement path that finds no GPU stops; it never falls back to
the CPU.
"""
from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    """JAX's first device is not a GPU."""


def require_gpu():
    """→ jax.devices(), or NoGPUError when the first device is no GPU."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoGPUError(f"no GPU: JAX's first device is "
                         f"{devices[0].platform} ({devices[0].device_kind})")
    return devices


def device_record(devices=None) -> dict:
    """{"platform", "kind", "count"} of the devices as JAX reports them."""
    import jax
    devices = devices if devices is not None else jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def card_line() -> str:
    """Name and power limit of the cards, one line per card joined by '; ',
    as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
