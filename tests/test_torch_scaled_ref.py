"""Port parity of the host inter encoder against a reference frame of
another size (a scaled reference): ``encode_video`` of
``aom_av1_psy_tpu_torch.encoder.interframe`` (its motion search on CPU
tensors) on a KEY frame followed by a smaller P-frame, against the JAX
package's ``encode_video``, at two ratios (128x128 -> 64x64 and
96x96 -> 64x64); and ``InterFrameEncoder`` on another 64x64 frame against
the 128x128 KEY frame's recon (a 2x reference slot), against the
reference's. Every motion-search candidate is then predicted through the
decoder's scaled prediction, as the reference predicts it.
Tolerance: exact equality (bytes and uint8 planes)."""
import functools

import numpy as np
import pytest

import bench
from aom_av1_psy_tpu.encoder import interframe as RIF
from aom_av1_psy_tpu.encoder.frame import EncoderConfig as RefConfig
from aom_av1_psy_tpu.encoder.frame import FrameEncoder as RefFrameEncoder
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder import interframe as IF
from torch_threads import one_torch_thread  # noqa: F401

CFG = RefConfig(base_q_idx=120)


@functools.cache
def _encodes(s):
    """(port packets, port recons, reference packets, reference recons) of
    a KEY frame of s x s and a 64x64 P-frame."""
    frames = [bench.make_frame(s, s, seed=1), bench.make_frame(64, 64, seed=2)]
    ref = RIF.encode_video(frames, CFG)
    port = IF.encode_video([convert.from_jax(f) for f in frames],
                           convert.from_jax(CFG), device="cpu")
    return (*port, *ref)


@pytest.fixture(scope="module", params=[128, 96], ids=lambda s: f"{s}to64")
def gop(request):
    return _encodes(request.param)


def test_packets_equal_reference(gop):
    pk, _, ref_pk, _ = gop
    assert len(pk) == 2 and pk == ref_pk


def test_recons_equal_reference(gop):
    _, rec, _, ref_rec = gop
    for a, b in zip(rec, ref_rec, strict=True):
        for p, q in zip(a, b, strict=True):
            np.testing.assert_array_equal(p, q)


def _slot(planes, w, h):
    return {"planes": [p.copy() for p in planes], "upscaled_width": w,
            "height": h, "order_hint": 0, "frame_type": 0, "showable": True}


def test_inter_frame_encoder_on_a_2x_slot_equals_reference():
    ref_rec = _encodes(128)[3]
    frame = bench.make_frame(64, 64, seed=7)
    # the sequence header of the 128x128 KEY frame, as encode_video's
    seq = RefFrameEncoder(bench.make_frame(128, 128, seed=1),
                          CFG).make_headers()[0]
    ref = RIF.InterFrameEncoder(frame, CFG, seq,
                                _slot(ref_rec[0], 128, 128))
    want = ref.encode(include_seq=False)
    enc = IF.InterFrameEncoder(convert.from_jax(frame), convert.from_jax(CFG),
                               convert.from_jax(seq),
                               _slot(ref_rec[0], 128, 128),
                               device="cpu")
    assert enc.encode(include_seq=False) == want
    for p, q in zip(enc.planes, ref.planes, strict=True):
        np.testing.assert_array_equal(p, q)
