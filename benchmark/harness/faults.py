"""Faults planted under the timed path, for the tests and the readings
that show the check catches them. Each driver's ``plant(run, name)``
wraps what its window calls (``run.program``), so the window, the check
and the metrics run as in a real run, on broken output:

- ``stale``: the step returns its state unchanged: every coded frame
  hands back, as its reconstruction, the state it started from (the
  previous frame's reconstruction, or its reference), with its own
  packet;
- ``half``: half of each frame left out: the encoder is given frames
  whose lower half is the mean of the upper half;
- ``token``: one byte of every coded packet altered where it is produced.

A one-chip cell has no exchange between chips to leave out. This module
holds what the drivers' faults share."""
from __future__ import annotations

import numpy as np

FAULTS = ("stale", "half", "token")


def known(name: str) -> str:
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    return name


def half(frame):
    """``frame`` with the lower half of each plane the upper half's mean."""
    planes = []
    for p in frame.planes():
        p = np.array(p, copy=True)
        h = p.shape[0] // 2
        p[h:] = int(p[:h].mean())
        planes.append(p)
    return type(frame)(*planes)


def token(pkt: bytes) -> bytes:
    """``pkt`` with one byte of its payload altered."""
    if len(pkt) < 16:                  # a show-existing header: no payload
        return pkt
    b = bytearray(pkt)
    b[len(b) * 2 // 3] ^= 0x55
    return bytes(b)
