"""Kernels KG / KH / KI of ``aom_av1_psy_tpu_torch`` (``csrc/tune_vmaf.cu``)
against their plain PyTorch versions on a CUDA device, at the 1080p
preprocessing and VIF shapes and at odd sizes, and ``tune_vmaf`` encodes on
the card against the CPU plain path. Tolerances: KG (blur and moments), KH
and ``vif_down2`` exact; KI's two sums relative 1e-4 (float32 sums in
another order, CUDA's ``log2f``).

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax
or of the reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_tune_vmaf_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.encoder import tune_vmaf as TT
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video
from aom_av1_psy_tpu_torch.utils.testframes import make_frame, make_gop
from tune_vmaf_cases import fma_cases

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _luma(h, w, seed=0):
    """Gradient + detail + noise, any size, with a saturated corner."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(96 + 60 * np.sin(xx / 31.0) * np.cos(yy / 17.0)
                + rng.normal(0, 4.0, (h, w)), 0, 255).astype(np.uint8)
    y[: h // 4, : w // 4] = 255
    return y


@pytest.mark.parametrize("h,w", [(1080, 1920), (37, 53), (1, 5), (64, 33)])
def test_blur_kernel_matches_plain(dev, h, w):
    y = _luma(h, w, seed=h)
    for t in (torch.as_tensor(y, device=dev),
              torch.as_tensor(y.astype(np.int32), device=dev)):
        want = TT.gaussian_blur_plain(t)
        assert torch.equal(TT.gaussian_blur(t), want)
        got, mom = TT.gaussian_blur(t, moments=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(mom, TT.blur_moments_plain(t, want))


def test_unsharp_kernel_matches_plain(dev):
    y = torch.as_tensor(_luma(1080, 1920), device=dev)
    b = TT.gaussian_blur_plain(y)
    for a in (0.04742, 0.15279, 0.18498, 0.3):
        assert torch.equal(TT.unsharp(y, b, a), TT.unsharp_plain(y, b, a))
    hits = fma_cases()
    for a, s, d, sep, _ in hits:
        src = torch.tensor([[s]], dtype=torch.uint8, device=dev)
        blur = torch.tensor([[s - d]], dtype=torch.int32, device=dev)
        assert int(TT.unsharp(src, blur, a)[0, 0]) == sep, (a, s, d)


def test_vif_kernels_match_plain(dev):
    r = torch.as_tensor(_luma(1080, 1920, seed=3), device=dev)
    d = TT.gaussian_blur_plain(r).to(torch.float32)
    r = r.to(torch.float32)
    for _ in range(4):
        got, want = TT.vif_scale_sums(r, d), TT.vif_scale_plain(r, d)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
        nr = TT.down2(r)
        assert torch.equal(nr, TT.down2_plain(r))
        r, d = nr, TT.down2(d)


def test_tune_vmaf_key_frame_on_card_equals_cpu(dev):
    f = make_frame(352, 288)
    cfg = EncoderConfig(base_q_idx=100, tune_vmaf=True)
    gpu = GpuFrameEncoder(f, cfg, device=dev)
    cpu = GpuFrameEncoder(f, cfg, device="cpu")
    assert gpu.encode() == cpu.encode()
    assert gpu.vmaf_unsharp_amount == cpu.vmaf_unsharp_amount > 0


def test_tune_vmaf_gop_on_card_equals_cpu(dev):
    frames = make_gop(128, 64, 3)
    cfg = EncoderConfig(base_q_idx=100, tune_vmaf=True)
    pk, encs = encode_video(frames, cfg, device=dev)
    cpu, cencs = encode_video(frames, cfg, device="cpu")
    assert pk == cpu
    assert [e.vmaf_unsharp_amount for e in encs] == \
        [e.vmaf_unsharp_amount for e in cencs]


def test_tune_vmaf_monochrome_on_card_equals_cpu(dev):
    f = make_frame(96, 64, seed=8)
    mono = dataclasses.replace(f, u=None, v=None)
    cfg = EncoderConfig(base_q_idx=140, tune_vmaf=True)
    assert GpuFrameEncoder(mono, cfg, device=dev).encode() == \
        GpuFrameEncoder(mono, cfg, device="cpu").encode()
