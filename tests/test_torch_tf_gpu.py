"""Kernels KJ (``fullpel_sad``, both entries: the caller's windows and the
windows read where they lie in a plane) and KK (``tf_span_filter``, one
pass per span, and its weight) of ``aom_av1_psy_tpu_torch`` against their
plain PyTorch versions on a CUDA device (KK also against the plain version
on CPU tensors, on the spans of ``tests/tf_span_cases.py`` and on 1080p
spans of 3 and 5 frames), and the temporal filter and the ARF GOP on CUDA
against the CPU plain path.
Tolerance: exact equality (integer outputs; KK's float64 weights are
truncated to integers, so a difference would be a flip, not noise).

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax
or of the reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_tf_gpu.py
"""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video_arf
from aom_av1_psy_tpu_torch.ops import mvsearch as MV
from aom_av1_psy_tpu_torch.utils import testframes
from tf_span_cases import CASES, SIZES, case_id, panning

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _windows(h, w, radius, B, seed, stride=1, hi=256):
    rng = np.random.default_rng(seed)
    wh, ww = h + 2 * radius * stride, w + 2 * radius * stride
    win = rng.integers(0, hi, (B, wh, ww))
    src = rng.integers(0, hi, (B, h, w))
    for b in range(B // 2):
        dy, dx = rng.integers(0, 2 * radius + 1, 2) * stride
        src[b] = win[b, dy:dy + h, dx:dx + w]
    win[-2:] = 128                                  # flat: every offset ties
    src[-2:] = 128
    return (torch.as_tensor(src.astype(np.int32)),
            torch.as_tensor(win.astype(np.int32)))


# KJ's strip tiling (kR = 12 offsets per strip, G = 2 row groups): m = 33
# (three strips, 3 phantom offsets), 13 (two strips), 5 and 11 (one short
# strip) and 41 (four strips, 7 phantom offsets); B = 1; the host inter
# encoder's largest block at radius 16 (64x64: 36 KB of window), narrow and
# non-square blocks; flat-block ties in every case (the last two blocks)
@pytest.mark.parametrize("h,w,radius,spb,B", [
    (32, 32, 16, 0, 40), (24, 32, 16, 0, 40), (16, 16, 6, 4, 40),
    (8, 8, 2, 0, 40), (32, 24, 16, 4, 40), (24, 24, 16, 0, 40),
    (16, 8, 5, 0, 40), (8, 16, 20, 4, 20), (4, 4, 16, 0, 40),
    (16, 64, 16, 0, 3), (64, 64, 16, 0, 1), (64, 64, 16, 4, 3),
    (32, 32, 16, 0, 1)])
def test_kj_matches_plain(dev, h, w, radius, spb, B):
    src, win = _windows(h, w, radius, B, seed=h + radius)
    want = MV.full_pel_grid_search(src, win, radius, spb)
    n0 = MV.KJ.launches
    got = MV.full_pel_grid_search(src.to(dev), win.to(dev), radius, spb)
    torch.cuda.synchronize()
    assert MV.KJ.launches == n0 + 1
    for g, w_ in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w_)
    for g, w_ in zip(MV.full_pel_grid_search_plain(src.to(dev), win.to(dev),
                                                   radius, spb), want):
        assert torch.equal(g.cpu(), w_)


@pytest.mark.parametrize("h,w,radius,spb,hi", [
    (16, 30, 16, 0, 256), (24, 10, 3, 4, 256), (32, 32, 16, 4, 1024),
    (8, 12, 5, 0, 1024)])
def test_kj_32bit_matches_plain(dev, h, w, radius, spb, hi):
    """KJ's 32-bit strips at stride 1: a width not a multiple of 4, or
    values past 255 (10-bit), where the CTA cannot pack 8-bit words."""
    src, win = _windows(h, w, radius, 40, seed=h + w + hi, hi=hi)
    want = MV.full_pel_grid_search(src, win, radius, spb)
    got = MV.full_pel_grid_search(src.to(dev), win.to(dev), radius, spb)
    for g, w_ in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w_)


@pytest.mark.parametrize("h,w,m,B", [(32, 32, 9, 40), (24, 32, 9, 1),
                                     (16, 16, 13, 40)])
def test_kj_coarse_matches_plain(dev, h, w, m, B):
    """The stride-4 coarse level of ``full_pel_hierarchical`` (m = 9 at
    radius 16), and m = 13, directly at ``sad_argmin``."""
    src, win = _windows(h, w, (m - 1) // 2, B, seed=m + B, stride=4)
    want = MV.sad_argmin_plain(src, win, m, 4)
    n0 = MV.KJ.variants["coarse"]
    got = MV.sad_argmin(src.to(dev), win.to(dev), m, 4)
    assert MV.KJ.variants["coarse"] == n0 + 1
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_.to(g.dtype))


@pytest.mark.parametrize("h,w,spb,B", [(32, 32, 0, 60), (24, 32, 4, 60),
                                       (32, 24, 0, 60), (24, 24, 0, 1),
                                       (64, 64, 0, 2)])
def test_kj_plane_matches_plain(dev, h, w, spb, B):
    """KJ's plane entry on a frame padded with 128 (blocks at every border,
    flat blocks that tie with the fill and with a flat patch) against its
    plain version (``cut`` + ``sad_argmin_plain``) and the (src, win)
    entry on the cut windows."""
    rng = np.random.default_rng(h + w + B)
    H, W, rad = 96, 160, 16
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    y[:40, :40] = 60
    grid = TF.SpanGrid([torch.as_tensor(y)] * 3)
    padded = grid.padded(torch.as_tensor(y))
    oy = torch.as_tensor(rng.integers(0, H - h + 1, B))
    ox = torch.as_tensor(rng.integers(0, W - w + 1, B))
    oy[:1], ox[:1] = 0, 0
    src = torch.as_tensor(rng.integers(0, 256, (B, h, w)).astype(np.int32))
    src[-1:] = 128
    if B > 2:
        src[1] = 60
    want = MV.full_pel_plane_search_plain(src, padded, oy, ox, rad, spb)
    win = MV.cut(padded, oy, ox, h + 2 * rad, w + 2 * rad)
    for g, w_ in zip(MV.full_pel_grid_search(src, win, rad, spb), want):
        assert torch.equal(g, w_)
    n0 = MV.KJ.variants["plane"]
    got = MV.full_pel_plane_search(src.to(dev), padded.to(dev), oy.to(dev),
                                   ox.to(dev), rad, spb)
    torch.cuda.synchronize()
    assert MV.KJ.variants["plane"] == n0 + 1
    for g, w_ in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w_)


@pytest.mark.parametrize("h,w", [(32, 32), (24, 32)])
def test_kj_hierarchical_matches_plain(dev, h, w):
    src, win = _windows(h, w, 16, 40, seed=w)
    want = MV.full_pel_hierarchical(src, win, 16, step=4)
    got = MV.full_pel_hierarchical(src.to(dev), win.to(dev), 16, step=4)
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)


def _span(planes, center, strength, q, noise=(2.2, 0.7, 1.4)):
    """The span's MVs (the search on the planes' device) and params."""
    grid = TF.SpanGrid(planes[center])
    mvs = torch.zeros((len(planes), grid.B, 2), dtype=torch.int32,
                      device=grid.by.device)
    for fi, f in enumerate(planes):
        if fi != center:
            mvs[fi] = grid.motion_inputs(f)
    return mvs, TF.filter_params(q, strength, noise)


def _span_pass_exact(planes, center, strength, q, cpu_too=True):
    """KK's span pass on the card against its plain version on the card
    (and on CPU tensors): exact, one launch."""
    mvs, params = _span(planes, center, strength, q)
    n0 = TF.KK.launches
    got = TF.tf_span_filter(center, planes, mvs, params)
    torch.cuda.synchronize()
    assert TF.KK.launches == n0 + 1
    want = TF.tf_span_filter_plain(center, planes, mvs, params)
    for g, w in zip(got, want, strict=True):
        assert g.is_cuda and g.dtype == torch.uint8 and torch.equal(g, w)
    if cpu_too:
        cpu = TF.tf_span_filter(center, [[p.cpu() for p in f]
                                         for f in planes], mvs.cpu(), params)
        for g, w in zip(got, cpu):
            assert torch.equal(g.cpu(), w)
    return got


@pytest.mark.parametrize("n,center,strength,q,size", CASES,
                         ids=[case_id(c) for c in CASES])
def test_span_pass_matches_plain(dev, n, center, strength, q, size):
    w, h = SIZES[size]
    planes = TF.upload(panning(n, w, h, seed=n * 10 + center), dev)
    _span_pass_exact(planes, center, strength, q)


@pytest.mark.parametrize("n,center,strength,q", [(3, 0, 1, 11),
                                                 (5, 2, 2, 28)])
def test_span_pass_matches_plain_1080p(dev, n, center, strength, q):
    """The 1080p KEY span (3 frames, centre first, strength 1, the q factor
    of base_q_idx 40) and a 5-frame ARF span (centre 2, strength 2, the q
    factor of base_q_idx 100) of ``make_gop(1920, 1080, ...)``."""
    frames = testframes.make_gop(1920, 1080, n, seed=3)
    planes = TF.upload([f.planes() for f in frames], dev)
    _span_pass_exact(planes, center, strength, q, cpu_too=False)
    # and with weights near 1000 (q factor 30000), where every frame counts
    got = _span_pass_exact(planes, center, strength, 30000, cpu_too=False)
    assert not torch.equal(got[0], planes[center][0].to(torch.uint8))


def test_filter_frames_on_card_match_cpu(dev):
    frames = [f.planes() for f in testframes.make_gop(112, 80, 5, seed=4)]
    kw = dict(noise_levels=(2.0, 1.0, 1.0))
    n0 = (MV.KJ.launches, TF.KK.launches)
    got = TF.temporal_filter_frames(frames, 2, 250, 2, device=dev, **kw)
    # 4 reference frames x 4 block shapes (32/16 wide, 32/16 tall); KK
    # once for the span
    assert (MV.KJ.launches - n0[0], TF.KK.launches - n0[1]) == (16, 1)
    want = TF.temporal_filter_frames(frames, 2, 250, 2, device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    y = frames[0][0]
    assert TF.estimate_noise_level(y, device=dev) == \
        TF.estimate_noise_level(y, device="cpu")


def test_arf_gop_on_card_matches_cpu(dev):
    frames = testframes.make_gop(112, 80, 6, seed=2)
    cfg = EncoderConfig(base_q_idx=100)
    pk, encs = encode_video_arf(frames, cfg, group=4, device=dev)
    assert pk == encode_video_arf(frames, cfg, group=4, device="cpu")[0]
    assert [e is None for e in encs].count(True) == 2


def test_kk_weight_equals_numpy_at_every_boundary(dev):
    """KK's weight against ``np.exp`` at the 101 float64 values within 50
    ulp of each of the 1000 truncation boundaries, and at 0 and 7."""
    s = TF.weight_boundary_values()
    assert s.size == 1000 * 101 + 2
    want = (np.exp(-s) * TF.TF_WEIGHT_SCALE).astype(np.int64)
    n0 = TF.KK.launches
    got = TF.tf_weight(torch.as_tensor(s, device=dev)).cpu().numpy()
    assert TF.KK.launches == n0 + 1
    flips = np.nonzero(got != want)[0]
    assert flips.size == 0, [(repr(s[i]), int(got[i]), int(want[i]))
                             for i in flips[:10]]


@pytest.mark.parametrize("n", [25, 26, 27, 29])
def test_span_divide_equals_numpy_at_every_total(dev, n):
    """KK's total / n (a product corrected by its exact residual) against
    numpy's IEEE quotient at every window total 0..29 * 255^2, for the
    luma's 25 and each chroma subsampling's 25 + (1 << (ss_x + ss_y))."""
    want = np.arange(TF.MAX_TOTAL + 1, dtype=np.float64) / n
    n0 = TF.KK.launches
    got = TF.divide_totals(n, dev).cpu().numpy()
    assert TF.KK.launches == n0 + 1
    flips = np.nonzero(got != want)[0]
    assert flips.size == 0, flips[:10].tolist()
