"""Traffic kind ``stills``: ``pool`` distinct textured stills of
``width`` x ``height`` (4:2:0, 8 bits): the recipe of ``bench.py``'s
``make_frame`` (a smooth sinusoid product, horizontal and vertical
gradients, Gaussian luma and chroma noise) with the sinusoids' phases
drawn from the seed. Returns the pool and a cycling order."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness.content import generator, u8


def make(t: dict, seed: int, device, frame_type):
    """``t['pool']`` stills and the order in which the window cycles
    them."""
    w, h, n = t["width"], t["height"], t["pool"]
    g = generator(seed, 1, device)
    f32 = dict(dtype=torch.float32, device=device)
    yy = torch.arange(h, **f32)[:, None]
    xx = torch.arange(w, **f32)[None, :]
    ph = torch.rand((n, 3), generator=g, **f32) * (2 * math.pi)
    ly = torch.randn((n, h, w), generator=g, **f32) * t["luma_noise"]
    lc = torch.randn((n, 2, h // 2, w // 2), generator=g,
                     **f32) * t["chroma_noise"]
    y2, x2 = yy[::2, :1], xx[:1, ::2]
    out = []
    for i in range(n):
        base = (96 + 60 * torch.sin(xx / 97.0 + ph[i, 0])
                * torch.cos(yy / 53.0 + ph[i, 1])
                + 40 * (xx / w) + 20 * (yy / h))
        u = 128 + 30 * torch.sin(x2 / 131.0 + ph[i, 2]) + lc[i, 0]
        v = 128 - 25 * torch.cos(y2 / 89.0 + ph[i, 2]) + lc[i, 1]
        out.append(frame_type(u8(base + ly[i]), u8(u.expand(h // 2, -1)),
                              u8(v.expand(-1, w // 2))))
    order = np.random.default_rng(seed % (1 << 63)).permutation(n)
    return out, [int(i) for i in order]
