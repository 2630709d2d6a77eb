"""Port parity of ``tune_vmaf=True`` on the KEY frame:
``GpuFrameEncoder(device="cpu")`` unsharpens the source luma (the plain
versions of KG and KH) and gives the byte-identical stream of the JAX
``TpuFrameEncoder`` at 96x64 (``bench``'s textured gradient, which the
reference sharpens), in colour and monochrome, and through a
smooth frame on which both pick the 64x64 fallback (coded from the
sharpened source); each stream decodes to the port's post-LPF recon.
Tolerance: exact bytes and planes; the unsharp amount within 1e-5."""
import dataclasses

import pytest

from bench import make_frame
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.utils.frame import Frame
from test_torch_encoder import assert_decodes_to_recon, encode_both, \
    smooth_frame
from torch_threads import one_torch_thread  # noqa: F401

CFG = EncoderConfig(base_q_idx=100, tune_vmaf=True)


def check(f, cfg=CFG):
    ref, want, enc, got = encode_both(f, cfg)
    assert enc.vmaf_unsharp_amount == pytest.approx(
        ref.vmaf_unsharp_amount, abs=1e-5)
    assert (enc.src.planes()[0] == ref.src.planes()[0]).all()
    assert got == want
    return ref, enc, got


def test_tune_vmaf_96x64_matches_jax():
    ref, enc, got = check(make_frame(96, 64, seed=7))
    assert enc.vmaf_unsharp_amount > 0
    assert_decodes_to_recon(got, enc)


def test_tune_vmaf_monochrome_matches_jax():
    f = make_frame(96, 64, seed=8)
    ref, enc, got = check(Frame(f.planes()[0], None, None),
                          dataclasses.replace(CFG, base_q_idx=140))
    assert enc.nplanes == 1
    assert_decodes_to_recon(got, enc)


def test_tune_vmaf_smooth_frame_matches_jax():
    ref, enc, got = check(smooth_frame(96, 64))
    assert ref.picked_smooth64 and enc.picked_smooth64
    assert enc.vmaf_unsharp_amount > 0
    assert_decodes_to_recon(got, enc)
