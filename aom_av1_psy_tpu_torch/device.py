"""Device selection: explicit, never auto-detected."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(d="cuda") -> torch.device:
    """``d`` (str or torch.device) -> torch.device.

    Raises RuntimeError when a CUDA device is asked for and PyTorch sees
    none: the port never silently runs on the CPU in place of the card."""
    dev = torch.device(d)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(dev):
    """A context that makes CUDA device ``dev`` the current device (the
    kernels launch on the current device's stream and refuse tensors of
    another card); for a CPU device it does nothing."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
