"""A small random-access chunk for the port's CPU tests, made as the
benchmark's psy random-access deployment makes its own: the encoder
settings and GOP of ``benchmark/configs/ra-psy-q110.json`` and a scene of
the benchmark's ``scene_chunks`` traffic at a small size (its object cut
to fit). Imports no jax.

    frames = scene(128, 96, 9, seed=3)
    packets, encs = encode_video_arf(frames, config(q=110), **gop(group=4))
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, "benchmark", "configs", "ra-psy-q110.json")
TRAFFIC = os.path.join(ROOT, "benchmark", "traffic", "scene-chunks-720p.json")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config(q: int | None = None):
    """The deployment's ``EncoderConfig`` (``base_q_idx`` ``q`` if given)."""
    from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
    cfg = EncoderConfig(**_json(CONFIG)["encoder"])
    return cfg if q is None else dataclasses.replace(cfg, base_q_idx=q)


def gop(group: int | None = None, device="cpu") -> dict:
    """``encode_video_arf``'s keyword arguments of the deployment: its KEY
    and ARF q offsets and filter strength, star groups of ``group``
    frames (the deployment's 16 if not given)."""
    g = _json(CONFIG)["gop"]
    return dict(group=g["group"] if group is None else group,
                kf_q_offset=g["kf_q_offset"], arf_q_offset=g["arf_q_offset"],
                tf_strength=g["tf_strength"], device=device)


def scene(w: int, h: int, frames: int, seed: int) -> list:
    """One scene of ``frames`` frames of the deployment's traffic at
    ``w`` x ``h``: its panned texture and luma noise, its object a quarter
    of the height, starting inside the frame."""
    from aom_av1_psy_tpu_torch.utils.frame import Frame
    from benchmark.harness import content
    t = _json(TRAFFIC)
    size = h // 4
    t.update(width=w, height=h, frames=frames, pool=1,
             object={**t["object"], "size": size, "start": [w // 8, h // 4]})
    pool, _ = content.make(t, seed, "cpu", Frame)
    return pool[0]
