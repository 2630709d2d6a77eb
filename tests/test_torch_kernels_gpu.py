"""Kernels KA / KB / KC of ``aom_av1_psy_tpu_torch`` against their plain
PyTorch versions on a CUDA device, at the shapes of one 1080p anti-diagonal
step (KA and KB at 4x4 too, and KB with the skip decision off, as the
uniform grid runs them), and whole KEY frames on the card against the CPU
plain path. Tolerance: exact equality (integer outputs; the float32
skip-RD outputs are computed in the same order).

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax
or of the reference package, so on the card it runs without the
repository's JAX test configuration::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py
"""
import warnings

import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.ec.context import FrameContext
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.ops import deblock_torch as DT
from aom_av1_psy_tpu_torch.ops import intra_pred as IP
from aom_av1_psy_tpu_torch.ops import txq as TQ
from aom_av1_psy_tpu_torch.utils.frame import Frame

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


@pytest.mark.parametrize("bs,K", [(32, 61), (16, 61), (16, 7), (8, 7),
                                  (4, 7)])
def test_intra_pred_kernel_matches_plain(dev, bs, K):
    c = _on(dev)
    rng = np.random.default_rng(bs + K)
    n = 34
    edge = lambda: c(rng.integers(0, 256, (n, bs)).astype(np.int32))
    flag = lambda p: c(rng.random(n) < p)
    args = [edge(), edge(), c(rng.integers(0, 256, n).astype(np.int32)),
            flag(.8), flag(.8)]
    ext = {}
    if K == 61:
        ext = dict(trreal=flag(.5), blreal=flag(.5), abext=edge(),
                   lfext=edge(), ef=flag(.5))
    src = c(rng.integers(0, 256, (n, bs, bs)).astype(np.int32))
    assert torch.equal(IP.intra_pred_sse(*args, src, K, **ext),
                       IP.intra_pred_sse_plain(*args, src, K, **ext))
    cand = c(rng.integers(0, K, n).astype(np.int32))
    assert torch.equal(IP.intra_pred_one(*args, cand, K, **ext),
                       IP.intra_pred_one_plain(*args, cand, K, **ext))


@pytest.mark.parametrize("bs,key,adst", [(32, "y32", False),
                                         (16, "y16", False),
                                         (16, "uv16", True),
                                         (8, "uv8", True)])
def test_txq_kernel_matches_plain(dev, bs, key, adst):
    c = _on(dev)
    rng = np.random.default_rng(bs)
    n = 34
    src = rng.integers(0, 256, (n, bs, bs)).astype(np.int32)
    pred = np.clip(src + rng.integers(-60, 61, src.shape), 0,
                   255).astype(np.int32)
    pred[:8] = rng.integers(0, 256, (8, bs, bs))
    lvl, eobt = TTI._rate_tables(FrameContext(100))[key]
    flags = {}
    if adst:
        flags = dict(vadst=c(rng.random(n) < .5), hadst=c(rng.random(n) < .5))
    a = (c(src), c(pred), tables.dc_quant(100), tables.ac_quant(100),
         c(tables.scan_table(TTI.BS_TO_TX[bs], 0).astype(np.int32)),
         c(rng.uniform(2e3, 8e4, n).astype(np.float32)), c(lvl), c(eobt))
    for g, w in zip(TQ.txq_recon_skip(*a, **flags),
                    TQ.txq_recon_skip_plain(*a, **flags)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bs,adst", [(4, True), (4, False), (8, False),
                                     (8, True), (16, False), (32, False)])
def test_txq_no_skip_kernel_matches_plain(dev, bs, adst):
    """KB with the skip decision off (the uniform grid's ``txq_recon``),
    4x4 with the sinpi ADST4 included."""
    c = _on(dev)
    rng = np.random.default_rng(40 + bs)
    n = 135
    src = rng.integers(0, 256, (n, bs, bs)).astype(np.int32)
    pred = np.clip(src + rng.integers(-60, 61, src.shape), 0,
                   255).astype(np.int32)
    pred[:20] = rng.integers(0, 256, (20, bs, bs))
    flags = {}
    if adst:
        flags = dict(vadst=c(rng.random(n) < .5), hadst=c(rng.random(n) < .5))
    a = (c(src), c(pred), tables.dc_quant(60), tables.ac_quant(60),
         c(tables.scan_table(TTI.BS_TO_TX[bs], 0).astype(np.int32)))
    got = TQ.txq_recon(*a, **flags)
    want = TQ.tq_recon(*a, **flags)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("luma", [True, False])
def test_lpf_ladder_kernel_matches_plain(dev, luma):
    c = _on(dev)
    rng = np.random.default_rng(int(luma))
    hb, wb = (288, 352) if luma else (144, 176)
    buf = (rng.integers(0, 256, (hb, wb)) // 6 * 6).astype(np.int32)
    src = rng.integers(0, 256, (hb, wb)).astype(np.int32)
    split16 = rng.random((18, 22)) < .5
    cands = np.array([0, 7, 12, 14, 16, 28], np.int32)
    a = (c(buf), c(split16), c(cands), c(src), wb - 4, hb - 8,
         16 if luma else 8, luma)
    for g, w in zip(DT.lpf_ladder(*a), DT.lpf_ladder_plain(*a)):
        assert torch.equal(g, w)
    before = DT.KC.launches
    DT.lpf_ladder(*a)
    assert DT.KC.launches == before + 1


def test_lpf_apply_kernel_matches_plain(dev):
    """The no-search path: KC without the error reduction."""
    c = _on(dev)
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, s).astype(np.int32) // 4 * 4
              for s in ((160, 192), (80, 96), (80, 96))]
    split16 = rng.random((10, 12)) < .5
    levels = np.array([20, 9, 33], np.int32)
    got = DT.lpf_apply(tuple(c(p) for p in planes), c(split16), c(levels),
                       w=176, h=144, nplanes=3)
    want = DT.lpf_apply(tuple(torch.as_tensor(p) for p in planes),
                        torch.as_tensor(split16), torch.as_tensor(levels),
                        w=176, h=144, nplanes=3)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("w,h,q,kw", [(96, 64, 60, {}),
                                      (176, 144, 200, {}),
                                      (128, 88, 80, {"tune_psy": True})])
def test_encode_on_cuda_matches_cpu_plain_path(dev, w, h, q, kw):
    check_cuda_equals_cpu(dev, w, h, q, kw)


@pytest.mark.parametrize("w,h,q,kw", [(256, 128, 90, {"tile_cols_log2": 1}),
                                      (178, 130, 60, {}),
                                      (64, 64, 100, {"block_size": 3}),
                                      (96, 64, 160, {"search_cdef": True})])
def test_new_configs_on_cuda_match_cpu_plain_path(dev, w, h, q, kw):
    """Tile columns, the uniform grid (mi = 2 mod 8; BLOCK_8X8) and the
    CDEF search on the card."""
    check_cuda_equals_cpu(dev, w, h, q, kw)


def check_cuda_equals_cpu(dev, w, h, q, kw):
    rng = np.random.default_rng(w + q)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 13) * np.cos(yy / 9)
         + rng.normal(0, 8, (h, w))).clip(0, 255).astype(np.uint8)
    u = (128 + 40 * np.sin(xx[::2, ::2] / 7)).clip(0, 255).astype(np.uint8)
    v = (100 + rng.normal(0, 6, (h // 2, w // 2))).clip(0, 255) \
        .astype(np.uint8)
    f, cfg = Frame(y, u, v), EncoderConfig(base_q_idx=q, **kw)
    gpu = GpuFrameEncoder(f, cfg, device=dev)
    assert gpu.encode() == GpuFrameEncoder(f, cfg, device="cpu").encode()
    assert gpu.plan["recon_dev"][0].is_cuda


def _sync_count(fn):
    """Number of synchronizing CUDA calls fn makes (sync debug mode)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def test_wavefront_loop_never_waits_for_the_device(dev):
    """The host loop over the anti-diagonals makes no synchronizing call:
    the count stays the same (set-up uploads only) when the grid, and so
    the number of diagonal steps, grows."""
    rng = np.random.default_rng(0)
    counts = []
    for R, C in ((2, 3), (5, 6)):
        d = TTI.part_inputs(R, C, 100, FrameContext(100), 30000.0, 8 * R,
                            8 * C)
        y = rng.integers(0, 256, (32 * R, 32 * C)).astype(np.int32)
        uv = [rng.integers(0, 256, (16 * R, 16 * C)).astype(np.int32)
              for _ in range(2)]

        d = TTI.stack_tiles(d, [d])

        def run():
            t = convert.inputs_from_numpy(d, dev)
            out = TTI._luma_wavefront_part(convert.plane(y, dev)[None], t)
            TTI._chroma_wavefront_part(convert.plane(uv[0], dev)[None],
                                       convert.plane(uv[1], dev)[None], t,
                                       out[0], out[1], out[5])
        run()                                   # warm the table caches
        counts.append(_sync_count(run))
    assert counts[0] == counts[1], counts
