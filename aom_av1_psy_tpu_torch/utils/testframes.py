"""Synthetic test content, the same arrays as the repository's ``bench.py``
(``make_frame`` / ``make_gop``) makes, as the port's own ``Frame``: so the
port's measurements and smoke test need nothing outside the package and
stay comparable with every number taken on ``bench``'s frames."""
from __future__ import annotations

import numpy as np

from .frame import Frame


def make_frame(w: int, h: int, seed: int = 0) -> Frame:
    """Deterministic, moderately textured frame: smooth gradients +
    sinusoidal detail + mild noise (random noise alone is a pathological
    coding target; this keeps pack time representative)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (96 + 60 * np.sin(xx / 97.0) * np.cos(yy / 53.0)
            + 40 * (xx / w) + 20 * (yy / h))
    y = np.clip(base + rng.normal(0, 4.0, (h, w)), 0, 255).astype(np.uint8)
    u = np.clip(128 + 30 * np.sin(xx[::2, ::2] / 131.0)
                + rng.normal(0, 2.0, (h // 2, w // 2)), 0, 255)
    v = np.clip(128 - 25 * np.cos(yy[::2, ::2] / 89.0)
                + rng.normal(0, 2.0, (h // 2, w // 2)), 0, 255)
    return Frame(y, u.astype(np.uint8), v.astype(np.uint8))


def make_gop(w: int, h: int, n: int, seed: int = 1) -> list:
    """Busy inter content: global pan + a moving object + per-frame noise
    (many coded blocks for the host symbol-script build)."""
    rng = np.random.default_rng(seed)
    pad = 4 * n + 32
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.0)[None, :]
          * np.cos(np.arange(h + pad) / 29.0)[:, None]
          + rng.normal(0, 5, (h + pad, w + pad))).astype(np.float32)
    frames = []
    for i in range(n):
        y = np.clip(bg[2 * i : 2 * i + h, 3 * i : 3 * i + w].copy(), 0, 255)
        y[200 : 440, 300 + 8 * i : 540 + 8 * i] = 205 - 3 * i
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 135, np.uint8)
        frames.append(Frame(y.astype(np.uint8), u, v))
    return frames


def panning_frames(w: int, h: int, n: int, seed: int = 3) -> list:
    """Textured scene panning 2 px/frame horizontally, 1 px vertically: the
    arrays of the reference's inter-encoder tests
    (``tests/test_inter_encode.py``), which its closed loops run."""
    rng = np.random.default_rng(seed)
    pad = 4 * n
    base = rng.integers(0, 256, (h + pad, w + pad)).astype(np.float32)
    # low-pass so motion search has gradients to lock onto
    k = np.ones(7) / 7
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = base.clip(0, 255).astype(np.uint8)
    out = []
    for i in range(n):
        y = base[i : i + h, 2 * i : 2 * i + w].copy()
        cw, ch = (w + 1) // 2, (h + 1) // 2
        u = np.full((ch, cw), 90 + i, np.uint8)
        v = np.full((ch, cw), 150 - i, np.uint8)
        out.append(Frame(y, u, v))
    return out
