"""Traffic kind ``scene_chunks``: ``pool`` scenes of ``frames`` frames
each: a textured background (a sum of sinusoids at the listed periods and
amplitudes) panned ``pan`` pixels a frame,
evaluated at the panned coordinates (sub-pixel motion resampled exactly),
a textured square object moving ``object.speed`` pixels a frame, and
fresh luma noise each frame; smooth panned chroma. Every scene of every
seed has the same texture, object and motion (their phases come from the
traffic file's ``scene_seed``); the seed draws the noise and the order,
so a window's work does not depend on it."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness.content import generator, u8


def make(t: dict, seed: int, device, frame_type):
    """``t['pool']`` scenes of ``t['frames']`` frames and the order in
    which the window runs them."""
    w, h, n, T = t["width"], t["height"], t["pool"], t["frames"]
    g = generator(seed, 2, device)
    gs = generator(t["scene_seed"], 3, device)
    f64 = dict(dtype=torch.float64, device=device)
    yy = torch.arange(h, **f64)[:, None]
    xx = torch.arange(w, **f64)[None, :]
    comps = t["texture"]             # [[amplitude, period_x, period_y], ...]
    ph = (torch.rand((1, len(comps) + 2), generator=gs, **f64)
          * (2 * math.pi)).expand(n, -1)
    noise = torch.randn((n, T, h, w), generator=g, dtype=torch.float32,
                        device=device) * t["luma_noise"]
    px, py = t["pan"]
    obj = t["object"]
    s, speed = obj["size"], obj["speed"]
    x0, y0 = obj["start"]
    chunks = []
    for i in range(n):
        frames = []
        for f in range(T):
            xs, ys = xx + px * f, yy + py * f
            bg = torch.full((h, w), t["level"], **f64)
            for k, (a, tx, ty) in enumerate(comps):
                arg = ph[i, k]
                if tx:
                    arg = arg + 2 * math.pi * xs / tx
                if ty:
                    arg = arg + 2 * math.pi * ys / ty
                bg = bg + a * torch.sin(arg)
            ox = x0 + speed * f
            oy, ow = y0, min(s, w - ox)
            if ow > 0:
                oxx = torch.arange(ow, **f64)[None, :]
                oyy = torch.arange(s, **f64)[:, None]
                bg[oy:oy + s, ox:ox + ow] = (
                    obj["level"] + obj["amplitude"]
                    * torch.sin(2 * math.pi * oxx / obj["period"] + ph[i, -2])
                    * torch.cos(2 * math.pi * oyy / obj["period"]))
            # chroma: smooth fields on the half-size grid, panned alike
            arg_u = 2 * math.pi * xs[:, ::2] / t["chroma_period"] + ph[i, -1]
            arg_v = 2 * math.pi * ys[::2, :] / t["chroma_period"] + ph[i, -1]
            cu = t["level_u"] + t["chroma_amplitude"] * torch.sin(arg_u)
            cv = t["level_v"] - t["chroma_amplitude"] * torch.cos(arg_v)
            frames.append(frame_type(
                u8(bg.to(torch.float32) + noise[i, f]),
                u8(cu.expand(h // 2, w // 2).to(torch.float32)),
                u8(cv.expand(h // 2, w // 2).to(torch.float32))))
        chunks.append(frames)
    order = np.random.default_rng(seed % (1 << 63)).permutation(n)
    return chunks, [int(i) for i in order]
