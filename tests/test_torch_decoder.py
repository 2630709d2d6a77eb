"""The port's copy of the decoder against the committed aomenc corpus
(``tests/golden/streams``, the reference decoder's per-frame MD5s in
``expected.json``). The copy reads what the port writes and leaves out
loop restoration, superres and warped motion: a stream with one of those
raises ``Av1UnsupportedBitstreamError`` naming the tool; every other stream
decodes to the reference decoder's MD5s.
Tolerance: exact equality (MD5 of the y, u, v planes)."""
import hashlib
import json
import os

import numpy as np
import pytest

from aom_av1_psy_tpu_torch.decoder.obu import decode_ivf
from aom_av1_psy_tpu_torch.errors import Av1UnsupportedBitstreamError
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.join(os.path.dirname(__file__), "golden", "streams")

with open(os.path.join(HERE, "expected.json")) as f:
    EXPECTED = json.load(f)

# the first left-out tool that each such stream reaches
LEFT_OUT = {
    "inter_2pass_cpu1_190x142": "loop restoration",
    "inter_2pass_cpu6_190x142": "warped motion",
    "inter_cpu0_q30_178x130": "loop restoration",
    "inter_gm_cpu4_190x142": "loop restoration",
    "inter_lag_cpu3_190x142": "loop restoration",
    "inter_sb128_cpu2_190x142": "loop restoration",
    "lr_sgr_cpu2_q140_64x64": "loop restoration",
    "lr_wiener_cpu3_q100_178x130": "loop restoration",
    "qm_lr_cdef_q72_178x130": "loop restoration",
    "qm_swlr_cdef_q72_178x130": "loop restoration",
    "qm_txsel_q180_150x98": "loop restoration",
    "qm_wiener_d203_178x130": "loop restoration",
    "resize_d12": "warped motion",
    "resize_d16": "warped motion",
    "superres13_lr_178x130": "loop restoration",
    "superres16_178x130": "superres",
    "swlr_sgr_nocdef_q72_178x130": "loop restoration",
    "txsel_q108_150x98": "loop restoration",
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_port_decoder_on_the_corpus(name):
    path = os.path.join(HERE, f"{name}.ivf")
    if name in LEFT_OUT:
        with pytest.raises(Av1UnsupportedBitstreamError,
                           match=f"^{LEFT_OUT[name]}: "):
            decode_ivf(path)
        return
    frames = decode_ivf(path)
    want = EXPECTED[name]["md5"]
    assert len(frames) == len(want)
    for i, f in enumerate(frames):
        m = hashlib.md5()
        for p in (f.y, f.u, f.v):
            m.update(np.ascontiguousarray(p).tobytes())
        assert m.hexdigest() == want[i], f"{name} frame {i}"
