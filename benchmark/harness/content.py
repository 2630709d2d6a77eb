"""The benchmark's traffic: a traffic file (``benchmark/traffic/<name>.json``)
names a ``kind`` and its parameters, and the generator of that kind
(``benchmark/generators/<kind>.py``, found by name) makes the frames from
the seed on the device, in a few large calls, then hands them to the
program as host planes (the program's input type).

Every seed gets the same recipe, the same sizes and the same amounts of
motion and noise: the seed moves phases, noise and the order of a pool,
so the work of a window does not depend on it."""
from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1000003 + salt) % (1 << 63))
    return g


def u8(x: torch.Tensor) -> np.ndarray:
    return x.clamp(0, 255).to(torch.uint8).cpu().numpy()


def make(t: dict, seed: int, device, frame_type):
    """The traffic file ``t``'s content for ``seed``: (pool, order)."""
    from . import spec
    return spec.generator(t["kind"]).make(t, seed, device, frame_type)
