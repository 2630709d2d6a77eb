"""Device selection: explicit, never auto-detected."""
from __future__ import annotations

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
