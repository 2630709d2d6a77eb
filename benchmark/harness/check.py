"""The comparisons that decide ``correct``, on what the window produced.

A coded frame's packet is decoded by the frozen reference decoder
(``benchmark/reference/av1``), and the decoded planes are compared pixel
for pixel with the program's in-loop reconstruction (the planes the
program keeps as the next frame's reference, after the loop filter and
CDEF): ``recon_mismatch_px``, limit 0. The decoded luma is compared with
the source the user gave (``luma_mse``), which a stale or truncated encode
fails. A packet the decoder refuses counts in ``decode_errors``. The
control puts the reference in the program's place one precision below
the stream's 8 bits: the decoded planes with their lowest bit cleared.
"""
from __future__ import annotations

import numpy as np


def crop(planes, w: int, h: int) -> list:
    """The program's recon planes (tensors or arrays, padded) as uint8
    numpy planes of the frame's visible size (4:2:0)."""
    out = []
    for i, p in enumerate(planes):
        a = p.cpu().numpy() if hasattr(p, "cpu") else np.asarray(p)
        ph, pw = (h, w) if i == 0 else ((h + 1) // 2, (w + 1) // 2)
        out.append(a[:ph, :pw].astype(np.int64))
    return out


def seven_bit(planes) -> list:
    """The control's recon: the planes with their lowest bit cleared."""
    return [np.asarray(p, np.int64) & ~1 for p in planes]


def mismatch(decoded, recon) -> int:
    return int(sum(int((np.asarray(a, np.int64) != b).sum())
                   for a, b in zip(decoded, recon)))


def luma_mse(decoded, source) -> float:
    d = np.asarray(decoded[0], np.float64) - np.asarray(source[0],
                                                        np.float64)
    return float((d * d).mean())


class Numbers:
    """The compared numbers of a run: name -> (value, limit); a number
    passes when it is at most its limit."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values = {}

    def add(self, name: str, value) -> None:
        """Count (an int) or worst reading (a float) of ``name``."""
        old = self.values.get(name)
        if old is None:
            self.values[name] = value
        elif isinstance(value, int):
            self.values[name] = old + value
        else:
            self.values[name] = max(old, value)

    def ok(self) -> bool:
        return all(v <= self.limits[k] for k, v in self.values.items())

    def lines(self) -> list:
        return [f"check {k} {v!r} limit {self.limits[k]!r} "
                f"{'ok' if v <= self.limits[k] else 'FAIL'}"
                for k, v in self.values.items()]

    def as_dict(self) -> dict:
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in self.values.items()}


def decode(dec, packet: bytes, numbers: Numbers):
    """Decode one packet: the frames it shows; a refused packet counts in
    ``decode_errors`` and gives None."""
    try:
        out = dec.decode_packet(packet)
    except Exception:                   # noqa: BLE001 - any refusal counts
        numbers.add("decode_errors", 1)
        return None
    numbers.add("decode_errors", 0)
    return out
