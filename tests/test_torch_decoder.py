"""The port's copy of the decoder against the committed aomenc corpus
(``tests/golden/streams``, the reference decoder's per-frame MD5s in
``expected.json``): every stream, loop restoration, superres, warped
motion and non-translational global motion included, decodes to the
reference decoder's MD5s.
Tolerance: exact equality (MD5 of the y, u, v planes)."""
import hashlib
import json
import os

import numpy as np
import pytest

from aom_av1_psy_tpu_torch.decoder.obu import decode_ivf
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.join(os.path.dirname(__file__), "golden", "streams")

with open(os.path.join(HERE, "expected.json")) as f:
    EXPECTED = json.load(f)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_port_decoder_on_the_corpus(name):
    frames = decode_ivf(os.path.join(HERE, f"{name}.ivf"))
    want = EXPECTED[name]["md5"]
    assert len(frames) == len(want)
    for i, f in enumerate(frames):
        m = hashlib.md5()
        for p in (f.y, f.u, f.v):
            m.update(np.ascontiguousarray(p).tobytes())
        assert m.hexdigest() == want[i], f"{name} frame {i}"
