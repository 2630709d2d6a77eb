"""Port parity of ``tune_vmaf=True`` through the GOP loop:
``encode_video(device="cpu")`` gives the packets of the JAX
``encode_video_tpu`` on a 3-frame 64x64 smooth pan (the KEY frame temporally
filtered first, then unsharpened; each P-frame unsharpened), with the same
per-frame amounts, plans and reference chains, and every frame decodes to
the port's chain. Tolerance: exact bytes, plans and planes; the amounts
within 1e-5."""
import numpy as np
import pytest

from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.utils.frame import Frame
from test_torch_gop import assert_decodes_to_chain, assert_same_frames, \
    encode_both
from torch_threads import one_torch_thread  # noqa: F401


def smooth_pan(n):
    """A 64x64 window panning 2 px right and 1 down per frame over a
    sinusoid with mild noise: content the reference sharpens (amounts
    ~0.21)."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:72, 0:72].astype(np.float32)
    y = np.clip(110 + 60 * np.sin(xx / 9) * np.cos(yy / 7.2)
                + rng.normal(0, 3, (72, 72)), 0, 255).astype(np.uint8)
    u = np.full((32, 32), 120, np.uint8)
    return [Frame(y[i:i + 64, 2 * i:2 * i + 64].copy(), u, u + 15)
            for i in range(n)]


def test_tune_vmaf_gop_64x64_matches_jax():
    frames = smooth_pan(3)
    pj, ej, pt, et = encode_both(frames, EncoderConfig(base_q_idx=100,
                                                       tune_vmaf=True))
    for a, b in zip(ej, et):
        assert b.vmaf_unsharp_amount == pytest.approx(
            a.vmaf_unsharp_amount, abs=1e-5)
        assert (b.src.planes()[0] == a.src.planes()[0]).all()
    assert all(e.vmaf_unsharp_amount > 0 for e in et)
    assert pt == pj
    assert_same_frames(ej, et)
    assert_decodes_to_chain(pt, et)
