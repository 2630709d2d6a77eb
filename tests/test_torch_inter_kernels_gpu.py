"""Kernels KD / KE / KF of ``aom_av1_psy_tpu_torch`` against their plain
PyTorch versions on a CUDA device (KE also at the clamped borders, on ties,
on 10-bit samples and at each launch shape), and the P-frame path on CUDA
against the CPU plain path. Tolerance: exact equality (integer outputs
only).

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax
or of the reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_inter_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.encoder import tpu_inter as TI
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video
from aom_av1_psy_tpu_torch.ops import cdef_torch as CT
from aom_av1_psy_tpu_torch.ops import convolve as CONV
from aom_av1_psy_tpu_torch.ops import fullpel as FP
from aom_av1_psy_tpu_torch.ops import mc as MC
from aom_av1_psy_tpu_torch.ops.cdef import find_dir_blocks
from aom_av1_psy_tpu_torch.utils.frame import Frame
from test_torch_kernels_gpu import _sync_count

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev):
    def c(a):
        return torch.as_tensor(np.asarray(a), device=dev)
    return c


def _pan(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    bg = (110 + 45 * np.sin(np.arange(w + 64) / 37.0)[None, :]
          * np.cos(np.arange(h + 64) / 29.0)[:, None]
          + rng.normal(0, 6, (h + 64, w + 64))).clip(0, 255).astype(np.uint8)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    return [Frame(bg[2 * i:2 * i + h, 3 * i:3 * i + w].copy(), u, 255 - u)
            for i in range(n)]


@pytest.mark.parametrize("K", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("bw", [8, 16, 32])
def test_mc_kernel_matches_plain(dev, bw, K):
    """KD at every K the P-frame plan uses, at bw 8 / 16 / 32 (B = 61: a
    CTA past the last pair), with and without ``src`` and ``pred``."""
    c = _on(dev)
    rng = np.random.default_rng(bw + K)
    H, W, B = 96, 160, 61
    ref = c(rng.integers(0, 256, (H, W)).astype(np.int32))
    by = c((bw * rng.integers(0, H // bw, B)).astype(np.int32))
    bx = c((bw * rng.integers(0, W // bw, B)).astype(np.int32))
    qr = c(rng.integers(-60 * 16, 60 * 16, (K, B)).astype(np.int32))
    qc = c(rng.integers(-60 * 16, 60 * 16, (K, B)).astype(np.int32))
    kern = c(np.stack([CONV.filter_kernels(k % 3, 16) for k in range(K)])
             .astype(np.int32))
    src = c(rng.integers(0, 256, (B, bw, bw)).astype(np.int32))
    a = (ref, by, bx, qr, qc, bw, 90, 150, kern)
    n0 = MC.KD.launches
    want = MC.mc_8tap_plain(*a, src=src)
    for g, w in zip(MC.mc_8tap(*a, src=src), want):
        assert torch.equal(g, w)
    pred, sad, sse = MC.mc_8tap(*a, src=src, want_pred=False)
    assert pred is None
    assert torch.equal(sad, want[1]) and torch.equal(sse, want[2])
    pred, sad, sse = MC.mc_8tap(*a)
    assert sad is None and sse is None and torch.equal(pred, want[0])
    # a tap table 4 bytes off a 16-byte boundary (KD reads int4 taps)
    flat = torch.zeros(kern.numel() + 1, dtype=torch.int32, device=dev)
    flat[1:] = kern.reshape(-1)
    odd = flat[1:].view(kern.shape)
    assert odd.data_ptr() % 16
    for g, w in zip(MC.mc_8tap(*a[:-1], odd, src=src), want):
        assert torch.equal(g, w)
    assert MC.KD.launches == n0 + 4


@pytest.mark.parametrize("bw,centres", [(8, False), (16, True)])
def test_fullpel_kernel_matches_plain(dev, bw, centres):
    c = _on(dev)
    rng = np.random.default_rng(bw + 1)
    plane = rng.integers(0, 256, (128, 192)).astype(np.int32)
    plane[:48, :64] = 40                                  # ties
    B = (128 // bw) * (192 // bw)
    by, bx = TI._origins(B, 192 // bw, bw, str(dev))
    src = TI._blocks(c(np.roll(plane, (2, -3), (0, 1))), bw).contiguous()
    kw = {}
    if centres:
        kw = dict(cy=c(rng.integers(-32, 33, B).astype(np.int32)),
                  cx=c(rng.integers(-32, 33, B).astype(np.int32)))
    a = (src, c(plane), by, bx, 120, 180, bw)
    for g, w in zip(FP.fullpel_search(*a, **kw),
                    FP.fullpel_search_plain(*a, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("centres", [False, True])
@pytest.mark.parametrize("bw", [8, 16])
def test_fullpel_kernel_edges_match_plain(dev, bw, centres, bits):
    """KE with blocks over the whole plane, past a crop smaller than it,
    with centres up to +-48, so the windows clamp at all four borders; a flat patch where every offset
    ties; 10-bit samples (up to 1023) take the 32-bit strips, 8-bit the
    words. One launch per call, counted under its block width."""
    c = _on(dev)
    rng = np.random.default_rng(300 + 10 * bw + 2 * int(centres) + bits)
    H, W, top = 96, 160, (1 << bits) - 1
    plane = rng.integers(0, top + 1, (H, W)).astype(np.int32)
    plane[:40, :56] = 40                                  # ties
    plane[56:, 120:] = top                                # the largest SSD
    B = (H // bw) * (W // bw)
    by, bx = TI._origins(B, W // bw, bw, str(dev))
    src = np.clip(np.roll(plane, (1, -2), (0, 1))
                  + rng.integers(-2, 3, (H, W)), 0, top).astype(np.int32)
    src = TI._blocks(c(src), bw).contiguous()
    src[:2] = 40                                          # flat on flat
    kw = {}
    if centres:
        kw = dict(cy=c(rng.integers(-48, 49, B).astype(np.int32)),
                  cx=c(rng.integers(-48, 49, B).astype(np.int32)))
    a = (src, c(plane), by, bx, 88, 150, bw)
    want = FP.fullpel_search_plain(*a, **kw)
    n0, v0 = FP.KE.launches, FP.KE.variants[f"bw{bw}"]
    for got, w in zip(FP.fullpel_search(*a, **kw), want):
        assert torch.equal(got, w)
    assert FP.KE.launches == n0 + 1
    assert FP.KE.variants[f"bw{bw}"] == v0 + 1


@pytest.mark.parametrize("pri,sec", [(4, 2), (0, 2), (6, 0), (0, 0)])
def test_cdef_kernel_matches_plain(dev, pri, sec):
    c = _on(dev)
    rng = np.random.default_rng(pri * 10 + sec)
    h, w = 144, 176
    y = rng.integers(0, 256, (h + 16, w + 16)).astype(np.int32)
    uv = rng.integers(0, 256, (h // 2 + 8, w // 2 + 8)).astype(np.int32)
    yb = y[:h, :w].reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    dirs, var = find_dir_blocks(yb, 0)
    touched = c(rng.random(dirs.shape[0]) < .7)
    dirs, var = c(dirs.astype(np.int32)), c(var.astype(np.int32))
    for plane, ph, pw, bs, v in ((y, h, w, 8, var),
                                 (uv, h // 2, w // 2, 4, None)):
        a = (c(plane), ph, pw, bs, touched, dirs, v, pri, sec, 5)
        assert torch.equal(CT.cdef_filter(*a), CT.cdef_filter_plain(*a))


@pytest.mark.parametrize("w,h,q", [(96, 64, 80), (176, 144, 160)])
def test_gop_on_cuda_matches_cpu_plain_path(dev, w, h, q):
    frames = _pan(w, h, 3, seed=w)
    cfg = EncoderConfig(base_q_idx=q)
    pk, encs = encode_video(frames, cfg, device=dev)
    assert pk == encode_video(frames, cfg, device="cpu")[0]
    assert encs[-1].ref_planes_out[0].is_cuda


def test_inter_plan_waits_for_the_device_once(dev):
    """The plan makes the same number of synchronizing calls (its single
    device->host copy) whatever the frame size."""
    counts = []
    for w, h in ((96, 64), (256, 192)):
        frames = _pan(w, h, 2)                # sizes need no padding
        srcp = [np.asarray(p, np.int32) for p in frames[1].planes()]
        refs = [torch.as_tensor(np.asarray(p, np.int32), device=dev)
                for p in srcp]
        run = lambda: TI.plan_inter_frame(srcp, refs, 100, 30000.0, h // 4,
                                          w // 4, w, h, device=dev)
        run()
        counts.append(_sync_count(run))
    assert counts[0] == counts[1], counts
