"""The frozen reference decoder decodes every golden stream to aomdec's
MD5s (aomdec is the witness for every table the reference reads), and
the reference temporal filter equals the program's plain one."""
import hashlib
import json
import os
import sys

import numpy as np
import pytest

from _tiny import ROOT

sys.path.insert(0, ROOT)
GOLDEN = os.path.join(ROOT, "tests", "golden", "streams")


with open(os.path.join(GOLDEN, "expected.json")) as _f:
    STREAMS = sorted(json.load(_f))


def test_every_golden_stream_is_held():
    assert len(STREAMS) == 32
    assert sorted(f[:-4] for f in os.listdir(GOLDEN)
                  if f.endswith(".ivf")) == STREAMS


@pytest.mark.parametrize("name", STREAMS)
def test_golden_md5(name):
    from benchmark.reference.av1.decoder.obu import decode_ivf
    want = json.load(open(os.path.join(GOLDEN, "expected.json")))[name]
    got = [hashlib.md5(b"".join(p.tobytes() for p in f.planes()))
           .hexdigest() for f in decode_ivf(os.path.join(GOLDEN,
                                                         name + ".ivf"))]
    assert got == want["md5"]


def _frames(n, w=96, h=64):
    from aom_av1_psy_tpu_torch.utils.frame import Frame
    rng = np.random.default_rng(5)
    bg = 110 + 45 * np.sin(np.arange(w + 64) / 7.0)[None, :] \
        * np.cos(np.arange(h + 64) / 5.0)[:, None] \
        + rng.normal(0, 9, (h + 64, w + 64))
    out = []
    for i in range(n):
        y = bg[3 * i:3 * i + h, 5 * i:5 * i + w] + rng.normal(0, 3, (h, w))
        y[10:40, 20 + 8 * i:50 + 8 * i] = 200
        c = [np.clip(128 + rng.normal(0, 3, (h // 2, w // 2)), 0, 255)
             .astype(np.uint8) for _ in range(2)]
        out.append(Frame(np.clip(y, 0, 255).astype(np.uint8), *c))
    return out


def test_temporal_filter_equals_the_program():
    import torch
    torch.set_num_threads(1)
    from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
    from aom_av1_psy_tpu_torch.normative import tables
    from benchmark.reference import temporal_filter as RTF
    frames = _frames(5)
    planes = [list(f.planes()) for f in frames]
    got = TF.filter_key_frame(frames, 0, 50, device="cpu").planes()
    for a, b in zip(got, RTF.filter_key(planes, 50, "cpu")):
        assert np.array_equal(np.asarray(a), b)
    up = TF.upload([f.planes() for f in frames], "cpu")
    noise = [max(TF.estimate_noise_level(p, device="cpu"), 0.0)
             for p in up[2]]
    assert noise == [max(RTF.noise_level(p), 0.0) for p in planes[2]]
    y, u, v = TF.temporal_filter_frames(
        up, 2, max(1, tables.ac_quant(110) // 4), 2,
        noise_levels=tuple(noise), device="cpu")
    for a, b in zip((y, u, v), RTF.filter_arf(planes, 2, 110, 2, "cpu")):
        assert np.array_equal(np.asarray(a), b)
