"""Frame buffers — the YV12_BUFFER_CONFIG equivalent.

The reference keeps bordered, aligned planar YUV buffers
(``aom_scale/yv12config.h:123``, ``aom_realloc_frame_buffer`` :161). On TPU
the natural analogue is a pytree of padded ``jnp``/``np`` arrays whose padding
doubles as the prediction border, with static shapes so everything jits.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def align_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


@dataclasses.dataclass
class Frame:
    """A planar YUV frame. Planes are stored unpadded; ops pad as needed.

    y: (h, w) uint8/uint16;  u, v: (h >> ss_y, w >> ss_x) or None (monochrome).
    """

    y: np.ndarray
    u: np.ndarray | None
    v: np.ndarray | None
    bit_depth: int = 8
    subsampling_x: int = 1
    subsampling_y: int = 1

    @property
    def width(self) -> int:
        return int(self.y.shape[1])

    @property
    def height(self) -> int:
        return int(self.y.shape[0])

    @property
    def monochrome(self) -> bool:
        return self.u is None

    def planes(self):
        out = [self.y]
        if self.u is not None:
            out += [self.u, self.v]
        return out

    @staticmethod
    def blank(width: int, height: int, bit_depth: int = 8, monochrome: bool = False,
              subsampling_x: int = 1, subsampling_y: int = 1) -> "Frame":
        dt = np.uint8 if bit_depth == 8 else np.uint16
        y = np.zeros((height, width), dtype=dt)
        if monochrome:
            return Frame(y, None, None, bit_depth, subsampling_x, subsampling_y)
        cw = (width + subsampling_x) >> subsampling_x
        ch = (height + subsampling_y) >> subsampling_y
        u = np.zeros((ch, cw), dtype=dt)
        v = np.zeros((ch, cw), dtype=dt)
        return Frame(y, u, v, bit_depth, subsampling_x, subsampling_y)

    def copy(self) -> "Frame":
        return Frame(
            self.y.copy(),
            None if self.u is None else self.u.copy(),
            None if self.v is None else self.v.copy(),
            self.bit_depth, self.subsampling_x, self.subsampling_y,
        )
