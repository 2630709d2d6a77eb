"""Port parity of the uniform-grid KEY frame end to end:
``GpuFrameEncoder(device="cpu")`` on frames whose mi dims are 2 mod 8
(``plan_part_supported`` false) or with ``block_size`` = BLOCK_8X8 gives the
byte-identical stream of the JAX ``TpuFrameEncoder`` (the bs-8 grid, chroma
coded at 4x4), and the in-repo decoder's output equals the plan recon after
the host deblocker (the uniform path runs no device loop filter; the
reference chain is the pre-LPF plan recon). Also: a GOP at such a size stops
at its first P-frame with the reference's ``AssertionError``.
Tolerance: exact equality."""
import dataclasses

import numpy as np
import pytest

from aom_av1_psy_tpu.decoder.obu import Av1Decoder
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_interframe import encode_video_tpu
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (_ref_chain_planes,
                                                          encode_video)
from test_tpu_encoder import make_frame
from test_tpu_inter import panning
from test_torch_encoder import encode_both


def assert_decodes_to_host_lpf(data, enc):
    """Decoder output == the plan recon through the host deblocker."""
    dec = Av1Decoder().decode_packet(data)[0]
    planes = enc._host_lpf_planes(enc.fh, search=False)
    for name, d, r in zip("yuv", dec.planes(), planes):
        np.testing.assert_array_equal(r[: d.shape[0], : d.shape[1]],
                                      d.astype(np.int32), err_msg=name)


def check_uniform(f, cfg, bs=8):
    ref, want, enc, got = encode_both(f, cfg)
    assert not ref.use_part and not enc.use_part
    assert ref.bs == enc.bs == bs
    assert got == want
    assert not hasattr(enc, "ref_planes_dev")
    np.testing.assert_array_equal(enc.mi_skip, ref.mi_skip)
    for a, b in zip(_ref_chain_planes(enc), ref.plan["recon_dev"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (enc.fh.lf.filter_level, enc.fh.lf.filter_level_u,
            enc.fh.lf.filter_level_v) == (ref.fh.lf.filter_level,
                                          ref.fh.lf.filter_level_u,
                                          ref.fh.lf.filter_level_v)
    assert_decodes_to_host_lpf(got, enc)
    return enc


@pytest.mark.parametrize("q", [60, 160])
def test_178x130_default_matches_jax(q):
    check_uniform(make_frame(178, 130, seed=q), EncoderConfig(base_q_idx=q))


def test_64x64_block8x8_matches_jax():
    enc = check_uniform(make_frame(64, 64, seed=5),
                        EncoderConfig(base_q_idx=100, block_size=3))
    assert enc.plan["y_levels"].shape == (8, 8, 64)


def test_monochrome_uniform_matches_jax():
    f = make_frame(178, 130, seed=11)
    enc = check_uniform(Frame(f.planes()[0], None, None),
                        EncoderConfig(base_q_idx=90))
    assert enc.nplanes == 1


@pytest.mark.parametrize("tune", ["tune_psy", "tune_butteraugli"])
def test_tuned_bs8_grid_matches_jax(tune):
    enc = check_uniform(make_frame(178, 130, seed=13),
                        EncoderConfig(base_q_idx=80, **{tune: True}))
    assert enc.rdmult.shape == (enc.R, enc.C) and np.std(enc.rdmult) > 0


def test_uniform_gop_fails_like_jax():
    """The inter plan needs the partition geometry: both packages stop at
    the first P-frame of a GOP whose mi rows are 2 mod 8."""
    frames = panning(96, 72, 3)
    cfg = EncoderConfig(base_q_idx=100)
    with pytest.raises(AssertionError):
        encode_video_tpu(frames, cfg)
    with pytest.raises(AssertionError):
        encode_video(frames, cfg, device="cpu")
    # the KEY frame alone codes, like the reference's
    one = dataclasses.replace(cfg, base_q_idx=120)
    pj, _ = encode_video_tpu(frames[:1], one)
    pt, et = encode_video(frames[:1], one, device="cpu")
    assert pt == pj and not et[0].use_part
