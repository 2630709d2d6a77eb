"""Kernels KL (``subpel_predict``), KM (``subpel_refine49``), KN
(``block_reduce``) and KO (``satd8x8``) of ``aom_av1_psy_tpu_torch``
against their plain PyTorch versions on a CUDA device, and the host inter
encoder on the card against its CPU plain path. Tolerance: exact equality
(integer outputs).

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax
or of the reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_k13b_gpu.py
"""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder import interframe as IF
from aom_av1_psy_tpu_torch.ops import convolve as C
from aom_av1_psy_tpu_torch.ops import metrics as M
from aom_av1_psy_tpu_torch.ops import mvsearch as MV
from aom_av1_psy_tpu_torch.utils import testframes

pytestmark = pytest.mark.gpu

SIZES = (4, 8, 16, 32, 64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a)).to(dev, dtype)


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
@pytest.mark.parametrize("w,h", [(s, s) for s in SIZES] + [(8, 4), (16, 64)])
def test_kl_matches_plain_at_every_phase(dev, w, h, interp):
    rng = np.random.default_rng(w * 7 + h + interp)
    B = 256
    reg = rng.integers(0, 256, (B, h + 7, w + 7))
    reg[:8] = rng.choice([0, 255], (8, h + 7, w + 7))   # clip at both ends
    ph = np.arange(B)
    n0 = C.KL.launches
    got = C.subpel_predict(_t(reg, dev), w, h, _t(ph // 16, dev),
                           _t(ph % 16, dev), interp, interp)
    assert C.KL.launches == n0 + 1
    want = C.subpel_predict_plain(_t(reg, "cpu"), w, h,
                                  torch.as_tensor(ph // 16),
                                  torch.as_tensor(ph % 16), interp, interp)
    assert torch.equal(got.cpu(), want)
    one = C.predict_subpel(_t(reg[:3], dev), w, h, 6, 10, interp, interp)
    assert torch.equal(one.cpu(), C.predict_subpel_plain(
        _t(reg[:3], "cpu"), w, h, 6, 10, interp, interp))


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (64, 64)])
def test_km_matches_plain(dev, w, h):
    rng = np.random.default_rng(w + 100)
    B = 64
    win = rng.integers(0, 256, (B, h + 9, w + 9))
    src = rng.integers(0, 256, (B, h, w))
    win[-4:] = 90                                        # flat: every tie
    src[-4:] = 90
    for b in range(B // 2):                              # planted phases
        k = b % 49
        r8, c8 = 8 + 2 * (k // 7 - 3), 8 + 2 * (k % 7 - 3)
        src[b] = C.predict_subpel_plain(
            _t(win[b, r8 >> 3:(r8 >> 3) + h + 7, c8 >> 3:(c8 >> 3) + w + 7],
               "cpu"), w, h, (c8 & 7) << 1, (r8 & 7) << 1).numpy()
    mv = rng.integers(-20, 21, (B, 2))
    n0 = MV.KM.launches
    got = MV.batched_subpel_refine(_t(src, dev), _t(win, dev), _t(mv, dev))
    assert MV.KM.launches == n0 + 1
    want = MV.batched_subpel_refine(_t(src, "cpu"), _t(win, "cpu"),
                                    _t(mv, "cpu"))
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)
    assert (want[1][:B // 2] == 0).all()


def test_subpel_refine_on_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    h = w = 16
    big = rng.integers(0, 256, (h + 32, w + 32))
    for src in (rng.integers(0, 256, (h, w)), big[13:13 + h, 11:11 + w],
                np.full((h, w), 7)):
        pad = big[12:12 + h + 9, 12:12 + w + 9]
        n0 = C.KL.launches
        got = MV.subpel_refine(_t(src, dev), _t(pad, dev), (3, -2))
        assert C.KL.launches == n0 + 3
        assert got == MV.subpel_refine(_t(src, "cpu"), _t(pad, "cpu"),
                                       (3, -2))


def _pair(rng, shape, lo=0, hi=256):
    return rng.integers(lo, hi, shape), rng.integers(lo, hi, shape)


@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16), (64, 64)])
def test_kn_matches_plain(dev, h, w):
    rng = np.random.default_rng(h * 3 + w)
    B = 40
    a, b = _pair(rng, (B, h, w))
    n0 = M.KN.launches
    cases = [
        ("sad", (a, b)), ("sse", (a, b)), ("variance", (a, b)),
        ("sad_x4", (a, rng.integers(0, 256, (B, 4, h, w)))),
        ("block_error", (rng.integers(-3000, 3000, (B, 4, h * w)),
                         rng.integers(-3000, 3000, (B, 4, h * w)))),
        ("obmc_sad", (a, rng.integers(0, 255 * 4096, (B, h, w)),
                      rng.integers(0, 4097, (B, h, w)))),
        ("obmc_variance", (a, rng.integers(0, 255 * 4096, (B, h, w)),
                           rng.integers(0, 4097, (B, h, w)))),
        ("masked_sad", (a, b, rng.integers(0, 256, (B, h, w)),
                        rng.integers(0, 65, (B, h, w)))),
    ]
    for name, args in cases:
        fn = getattr(M, name)
        got = fn(*(_t(x, dev) for x in args))
        want = getattr(M, name + "_plain")(*(_t(x, "cpu") for x in args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w_ in zip(got, want, strict=True):
            assert torch.equal(g.cpu(), w_), name
    inv = M.masked_sad(*(_t(x, dev) for x in cases[-1][1]), invert=True)
    src, pa, pb, m = (_t(x, "cpu") for x in cases[-1][1])
    assert torch.equal(inv.cpu(), M.masked_sad_plain(src, pb, pa, m))
    ext = rng.integers(0, 256, (B, h + 1, w + 1))
    sec = rng.integers(0, 256, (B, h, w))
    for xo, yo in ((0, 0), (3, 5), (7, 1)):
        assert torch.equal(
            M.subpel_project(_t(ext, dev), w, h, xo, yo).cpu(),
            M.subpel_project_plain(_t(ext, "cpu"), w, h, xo, yo))
        for g, w_ in zip(M.sub_pixel_variance(_t(ext, dev), _t(b, dev), xo,
                                              yo),
                         M.sub_pixel_variance_plain(_t(ext, "cpu"),
                                                    _t(b, "cpu"), xo, yo)):
            assert torch.equal(g.cpu(), w_)
        for g, w_ in zip(M.sub_pixel_avg_variance(
                _t(ext, dev), _t(b, dev), xo, yo, _t(sec, dev)),
                M.sub_pixel_avg_variance_plain(
                    _t(ext, "cpu"), _t(b, "cpu"), xo, yo, _t(sec, "cpu"))):
            assert torch.equal(g.cpu(), w_)
    assert M.KN.launches == n0 + len(cases) + 1 + 3 * 3


def test_ko_matches_plain(dev):
    rng = np.random.default_rng(11)
    x = rng.integers(-255, 256, (3, 700, 8, 8))
    x[0, 0] = np.iinfo(np.int32).max                    # int32 wrap
    n0 = M.KO.launches
    assert torch.equal(M.hadamard8x8(_t(x, dev)).cpu(),
                       M.hadamard8x8_plain(_t(x, "cpu")))
    assert torch.equal(M.satd(_t(x, dev)).cpu(), M.satd_plain(_t(x, "cpu")))
    assert M.KO.launches == n0 + 2


def test_interframe_on_card_matches_cpu(dev):
    frames = testframes.panning_frames(64, 64, 2)
    cfg = EncoderConfig(base_q_idx=100)
    n0 = (MV.KJ.launches, C.KL.launches)
    pk, rec = IF.encode_video(frames, cfg, device=dev)
    assert MV.KJ.launches > n0[0] and \
        C.KL.launches - n0[1] == 3 * (MV.KJ.launches - n0[0])
    pk_cpu, rec_cpu = IF.encode_video(frames, cfg, device="cpu")
    assert pk == pk_cpu
    for a, b in zip(rec, rec_cpu):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("w,h", [(8, 8), (16, 4), (64, 32)])
def test_convolve_paths_on_card_match_plain(dev, w, h):
    """``convolve_2d_sr`` / ``_x_sr`` / ``_y_sr`` on CUDA tensors run KL
    with the caller's kernels (one launch each)."""
    rng = np.random.default_rng(w * h)
    reg = rng.integers(0, 256, (2, 3, h + 7, w + 7))
    kx = C.filter_kernels(2, w)[7]
    ky = C.filter_kernels(1, h)[3]
    n0 = C.KL.launches
    for name, src, args in (
            ("convolve_2d_sr", reg, (kx, ky)),
            ("convolve_x_sr", reg[..., 3:3 + h, :], (kx,)),
            ("convolve_y_sr", reg[..., :, 3:3 + w], (ky,))):
        fn = getattr(C, name)
        got = fn(_t(src, dev), w, h, *args)
        assert got.shape == (2, 3, h, w)
        assert torch.equal(got.cpu(), fn(_t(src, "cpu"), w, h, *args)), name
    assert C.KL.launches == n0 + 3


def _same_cpu(got, want):
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w.cpu())


def test_kn_reads_narrow_types_as_they_are(dev):
    """KN's wrapper hands uint8 / int16 inputs to the kernel as they are,
    mixed types as int32, a transposed input copied, a broadcast
    expanded."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (300, 16, 16))
    b = rng.integers(0, 256, (300, 16, 16))
    for dt in (torch.uint8, torch.int16, torch.int32):
        ta, tb = (torch.as_tensor(x).to(dt) for x in (a, b))
        for name in ("sad", "sse", "variance"):
            got = getattr(M, name)(ta.to(dev), tb.to(dev))
            want = getattr(M, name + "_plain")(ta, tb)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            _same_cpu(got, want)
    # mixed types, a transposed (non-contiguous) input and a broadcast
    ta = torch.as_tensor(a).to(torch.uint8)
    tb = torch.as_tensor(b).to(torch.int32).transpose(-1, -2)
    _same_cpu((M.sad(ta.to(dev), tb.to(dev)),), (M.sad_plain(ta, tb),))
    _same_cpu((M.sse(ta.to(dev), ta[:1].to(dev)),),
              (M.sse_plain(ta, ta[:1]),))
    x = torch.as_tensor(rng.integers(-255, 256, (40, 8, 8))).to(torch.int16)
    _same_cpu((M.satd(x.to(dev)),), (M.satd_plain(x),))
