"""Port parity end to end: ``GpuFrameEncoder(device="cpu").encode()`` of
``aom_av1_psy_tpu_torch`` gives the byte-identical stream of the JAX
``TpuFrameEncoder.encode()``, and the in-repo decoder reconstructs the
port's post-loop-filter planes from it. The port gets only its own
objects (``convert.from_jax`` of the reference's frame and config). This
file holds the 96x64 shape
(one JAX compile): the q60 case of test_tpu_encoder.py and a smooth frame
on which both encoders pick the 64x64 fallback; test_torch_encoder_cells.py
holds the other part-path shapes, test_torch_tiles*.py,
test_torch_uniform*.py and test_torch_search_cdef.py the tile-column,
uniform-grid and CDEF-search configurations, test_torch_tune_vmaf*.py
the tune_vmaf path (test_torch_standalone.py checks that a port encode
loads nothing of jax or of the reference package). Also: lossless,
outside the port, raises."""
import dataclasses

import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.decoder.obu import Av1Decoder
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.device import resolve_device
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from test_tpu_encoder import make_frame
from torch_threads import one_torch_thread  # noqa: F401


def encode_both(f, cfg):
    ref = TpuFrameEncoder(f, cfg)
    want = ref.encode()
    enc = GpuFrameEncoder(convert.from_jax(f),
                          convert.from_jax(cfg), device="cpu")
    got = enc.encode()
    return ref, want, enc, got


def assert_decodes_to_recon(data, enc):
    dec = Av1Decoder().decode_packet(data)[0]
    for name, d, r in zip("yuv", dec.planes(), enc.ref_planes_dev):
        assert r.dtype == torch.int32
        np.testing.assert_array_equal(
            r.numpy()[: d.shape[0], : d.shape[1]], d.astype(np.int32),
            err_msg=name)


def smooth_frame(w, h):
    yy, xx = np.mgrid[0:h, 0:w]
    y = (90 + 0.3 * xx + 0.2 * yy).clip(0, 255).astype(np.uint8)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = (128 + 0.1 * xx[::2, ::2]).astype(np.uint8)
    return Frame(y, u, v)


@pytest.fixture(scope="module")
def case_96x64():
    return encode_both(make_frame(96, 64, seed=156),
                       EncoderConfig(base_q_idx=60))


def test_stream_96x64_q60_matches_jax(case_96x64):
    ref, want, enc, got = case_96x64
    assert got == want
    assert not enc.picked_smooth64
    assert enc.fh.lf.filter_level == ref.fh.lf.filter_level
    assert_decodes_to_recon(got, enc)
    for a, b in zip(enc.ref_planes_dev, ref.ref_planes_dev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(enc.timings) == {"plan_s", "plan_inputs_s", "plan_submit_s",
                                "plan_fetch_s", "plan_launches",
                                "plan_graph", "pack_s", "lpf_s", "syncs",
                                "gc_n", "gc_s"}
    assert enc.timings["plan_graph"] == 0        # CPU tensors walk eagerly
    # end-of-frame entropy state equals the reference's
    for field in ("kf_y_cdf", "partition_cdf", "txb_skip_cdf"):
        np.testing.assert_array_equal(getattr(enc.saved_fc, field),
                                      getattr(ref.saved_fc, field))


def test_planes_from_jax_feed_the_port_lpf(case_96x64):
    """The JAX encoder's plan and reference planes (as numpy), converted by
    planes_from_jax, start the port's loop filter from the reference's
    recon: same picked levels, same post-LPF planes."""
    ref = case_96x64[0]
    port = convert.planes_from_jax(
        {"recon_dev": [np.asarray(r) for r in ref.plan["recon_dev"]],
         "ref_planes_dev": [np.asarray(r) for r in ref.ref_planes_dev],
         "split32": ref.plan["split32"]}, "cpu")
    assert all(p.dtype == torch.int32 for p in port["recon_dev"])
    enc = GpuFrameEncoder(convert.from_jax(ref.src),
                          convert.from_jax(ref.cfg), device="cpu")
    enc.plan = port
    _, fh = enc.make_headers()
    enc._lpf_device(fh)
    assert (fh.lf.filter_level, fh.lf.filter_level_u,
            fh.lf.filter_level_v) == (ref.fh.lf.filter_level,
                                      ref.fh.lf.filter_level_u,
                                      ref.fh.lf.filter_level_v)
    for a, b in zip(enc.ref_planes_dev, port["ref_planes_dev"]):
        assert torch.equal(a, b)


def test_smooth_frame_picks_smooth64_like_jax():
    ref, want, enc, got = encode_both(smooth_frame(96, 64),
                                      EncoderConfig(base_q_idx=100))
    assert ref.picked_smooth64 and enc.picked_smooth64
    assert got == want
    assert_decodes_to_recon(got, enc)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        GpuFrameEncoder(convert.from_jax(make_frame(64, 64)),
                        convert.from_jax(EncoderConfig()),
                        device="cuda")


@pytest.mark.parametrize("w,h,change", [
    (64, 64, dict(lossless=True)),
])
def test_outside_the_slice_raises(w, h, change):
    cfg = dataclasses.replace(EncoderConfig(base_q_idx=60), **change)
    with pytest.raises(NotImplementedError):
        GpuFrameEncoder(convert.from_jax(make_frame(w, h)),
                        convert.from_jax(cfg), device="cpu")
