"""Port parity of the inter plan on the fast-pan content of
test_tpu_inter.py::test_two_stage_search_fast_pan (176x144, a 24 px/frame
pan beyond the fine stage's +/-16 px: the half-resolution stage and the
dominant-MV vote must find it). The plan equals the reference's key for
key from the same JAX KEY frame, and the GOP's packets are byte-identical.
Tolerance: exact equality."""
import numpy as np

from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.utils.frame import Frame
from test_torch_gop import (assert_decodes_to_chain, assert_same_frames,
                            assert_same_plan, encode_both,
                            plans_from_jax_key)
from torch_threads import one_torch_thread  # noqa: F401


def fast_pan():
    rng = np.random.default_rng(4)
    w, h, n = 176, 144, 3
    pad = 30 * n + 32
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.0)[None, :]
          * np.cos(np.arange(h + pad) / 29.0)[:, None]
          + rng.normal(0, 5, (h + pad, w + pad))).astype(np.float32)
    frames = []
    for i in range(n):
        y = np.clip(bg[6 * i:6 * i + h, 24 * i:24 * i + w], 0,
                    255).astype(np.uint8)
        frames.append(Frame(y, np.full((h // 2, w // 2), 120, np.uint8),
                            np.full((h // 2, w // 2), 135, np.uint8)))
    return frames


def test_fast_pan_plan_and_gop_match_jax():
    frames = fast_pan()
    want, got = plans_from_jax_key(frames, 96)
    assert_same_plan(want, got)
    # the +/-48 px range: most MVs sit at the (48, 192) 1/8-pel pan
    mv = got["mv8"].reshape(-1, 2)
    assert ((np.abs(mv - np.array([48, 192])) <= 8).all(1)).mean() > 0.6
    pj, ej, pt, et = encode_both(frames, EncoderConfig(base_q_idx=96))
    assert pt == pj
    assert_same_frames(ej, et)
    assert_decodes_to_chain(pt, et)
