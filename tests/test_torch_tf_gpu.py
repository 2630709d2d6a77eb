"""Kernels KJ (``fullpel_sad``) and KK (``tf_weight_accum``) of
``aom_av1_psy_tpu_torch`` against their plain PyTorch versions on a CUDA
device (KK also against the plain version on CPU tensors), and the
temporal filter and the ARF GOP on CUDA against the CPU plain path.
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

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _windows(h, w, radius, B, seed):
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 256, (B, h + 2 * radius, w + 2 * radius))
    src = rng.integers(0, 256, (B, h, w))
    for b in range(B // 2):
        dy, dx = rng.integers(0, 2 * radius + 1, 2)
        src[b] = win[b, dy:dy + h, dx:dx + w]
    win[-2:] = 128                                  # flat: every offset ties
    src[-2:] = 128
    return (torch.as_tensor(src.astype(np.int32)),
            torch.as_tensor(win.astype(np.int32)))


@pytest.mark.parametrize("h,w,radius,spb", [(32, 32, 16, 0), (24, 32, 16, 0),
                                            (16, 16, 6, 4), (8, 8, 2, 0)])
def test_kj_matches_plain(dev, h, w, radius, spb):
    src, win = _windows(h, w, radius, 40, seed=h + radius)
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


@pytest.mark.parametrize("h,w", [(32, 32), (24, 32)])
def test_kj_hierarchical_matches_plain(dev, h, w):
    src, win = _windows(h, w, 16, 40, seed=w)
    want = MV.full_pel_hierarchical(src, win, 16, step=4)
    got = MV.full_pel_hierarchical(src.to(dev), win.to(dev), 16, step=4)
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)


def _kk_case(seed, H=80, W=112):
    rng = np.random.default_rng(seed)
    ref = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    pred = [np.clip(r + rng.integers(-6, 7, r.shape), 0, 255).astype(np.int32)
            for r in ref]
    nby, nbx = -(-H // 32), -(-W // 32)
    B = nby * nbx
    org = np.zeros((B, 3, 2), np.int32)
    for b in range(B):
        by, bx = (b // nbx) * 32, (b % nbx) * 32
        h, w = min(32, H - by), min(32, W - bx)
        d = rng.integers(-2, 3, 2) if b % 2 else (0, 0)
        for p, s in enumerate((0, 1, 1)):
            # the block's own position (odd blocks moved by up to 2 px)
            ph, pw = ref[p].shape
            org[b, p] = (np.clip((by >> s) + d[0], 0, ph - (h >> s)),
                         np.clip((bx >> s) + d[1], 0, pw - (w >> s)))
    mvs = rng.integers(-40, 41, (B, 4, 2))
    dfac = np.array([[TF.d_factor(r, c, W, H) for r, c in m] for m in mvs])
    return (ref, pred, org, rng.integers(0, 60, (B, 4)), dfac,
            TF.filter_params(250, 2, (1.5, 0.6, 2.2)))


def _kk_run(case, device):
    ref, pred, org, mses, dfac, params = case
    t = lambda a, dt=torch.int32: torch.as_tensor(a).to(device, dt)
    accum = [torch.zeros(r.shape, dtype=torch.int64, device=device)
             for r in ref]
    count = [torch.zeros_like(a) for a in accum]
    TF.tf_weight_accum([t(r) for r in ref], [t(p) for p in pred], t(org),
                       t(mses, torch.int64), t(dfac, torch.float64), params,
                       1, 1, 32, accum, count)
    return [x.cpu() for x in accum + count]


@pytest.mark.parametrize("seed", [0, 1])
def test_kk_matches_plain_on_card_and_cpu(dev, seed):
    case = _kk_case(seed)
    n0 = TF.KK.launches
    got = _kk_run(case, dev)
    assert TF.KK.launches == n0 + 1
    want_cpu = _kk_run(case, "cpu")
    ref, pred, org, mses, dfac, params = case
    t = lambda a, dt=torch.int32: torch.as_tensor(a).to(dev, dt)
    accum = [torch.zeros(r.shape, dtype=torch.int64, device=dev) for r in ref]
    count = [torch.zeros_like(a) for a in accum]
    TF.tf_weight_accum_plain([t(r) for r in ref], [t(p) for p in pred],
                             t(org), t(mses, torch.int64),
                             t(dfac, torch.float64), params, 1, 1, 32, accum,
                             count)
    for g, c, d in zip(got, want_cpu, [x.cpu() for x in accum + count]):
        assert torch.equal(g, c) and torch.equal(g, d)
    assert got[3].max() > 0


def test_filter_frames_on_card_match_cpu(dev):
    frames = [f.planes() for f in testframes.make_gop(112, 80, 5, seed=4)]
    kw = dict(noise_levels=(2.0, 1.0, 1.0))
    n0 = (MV.KJ.launches, TF.KK.launches)
    got = TF.temporal_filter_frames(frames, 2, 250, 2, device=dev, **kw)
    # 4 reference frames x 4 block shapes (32/16 wide, 32/16 tall); KK
    # once per frame of the span
    assert (MV.KJ.launches - n0[0], TF.KK.launches - n0[1]) == (16, 5)
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
