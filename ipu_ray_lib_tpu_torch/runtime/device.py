"""Device selection for the port (the device half of the JAX package's
``runtime/config.py``).

The port keeps no global device: callers pass a ``torch.device`` to the
scene builder, and everything downstream follows the tensors.
"""

from __future__ import annotations

import subprocess

import torch


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when no card is usable.

    A measurement or a kernel check that finds no card must fail, never
    fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present")
    return torch.device("cuda", index)


def gpu_identity() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
    the card's name and power limit, one line per card. Every number a
    measurement keeps is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
