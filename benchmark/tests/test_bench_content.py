"""The traffic generator is deterministic per seed, differs across seeds,
and gives every seed the same recipe and sizes."""
import json
import os
import sys

import numpy as np
import pytest

from _tiny import ROOT

sys.path.insert(0, ROOT)


def _traffic(name, **small):
    t = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                    name + ".json")))
    t.update(small)
    return t


class _Frame:
    def __init__(self, y, u, v):
        self.y, self.u, self.v = y, u, v

    def planes(self):
        return self.y, self.u, self.v


def _flat(pool):
    if isinstance(pool[0], list):
        pool = [f for chunk in pool for f in chunk]
    return np.concatenate([p.ravel() for f in pool for p in f.planes()])


@pytest.mark.parametrize("name,small", [
    ("stills-720p", {"width": 96, "height": 64, "pool": 3}),
    ("scene-chunks-720p", {"width": 96, "height": 64, "pool": 2,
                           "frames": 5}),
])
def test_seeded(name, small):
    from benchmark.harness import content
    t = _traffic(name, **small)
    a, oa = content.make(t, 2**31 + 99, "cpu", _Frame)
    b, ob = content.make(t, 2**31 + 99, "cpu", _Frame)
    c, _ = content.make(t, 12345, "cpu", _Frame)
    assert oa == ob and sorted(oa) == list(range(small["pool"]))
    assert np.array_equal(_flat(a), _flat(b))
    assert not np.array_equal(_flat(a), _flat(c))
    f = a[0][0] if isinstance(a[0], list) else a[0]
    assert f.planes()[0].shape == (64, 96) and f.planes()[1].shape == (32, 48)
    assert all(p.dtype == np.uint8 for p in f.planes())


def test_scene_moves_between_frames():
    from benchmark.harness import content
    t = _traffic("scene-chunks-720p", width=96, height=64, pool=1, frames=3)
    (chunk,), _ = content.make(t, 3, "cpu", _Frame)
    d = [np.abs(chunk[i].y.astype(int) - chunk[i + 1].y.astype(int)).mean()
         for i in range(2)]
    assert all(x > 1.0 for x in d)
