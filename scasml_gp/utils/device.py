"""What the measurement scripts need to know about the card they run on.

A measurement that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import List, Optional, Sequence

import jax


def require_gpu(devices: Optional[Sequence] = None) -> list:
    """JAX's devices, or RuntimeError unless the first one is a GPU."""
    devices = list(jax.devices() if devices is None else devices)
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "nothing"
        raise RuntimeError(f"needs a GPU, but JAX's first device is {found}")
    return devices


def device_record(devices: Sequence) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def card_lines() -> List[str]:
    """One ``<name>, <power limit>`` line per card, as nvidia-smi gives
    them; a card may be set below its maximum power and then runs slower, so
    every number kept is written beside these."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
