"""Port parity of the uniform-grid fallback plan: ``plan_frame`` of
``aom_av1_psy_tpu_torch`` (the 7 plain modes, TX = block size, no skip
decision; kernels KA and KB with the skip off, chroma at bs/2 with the
mode-derived ADST/DCT) against the JAX ``plan_frame`` at bs 8, 16 and 32
and on a monochrome frame: modes, levels, eobs and recon, key for key. Also
the bs-8 / 16 / 32 branches of ``GpuFrameEncoder._rdmult_grid`` by a
direct call. Tolerance: exact equality."""
import numpy as np
import pytest

from aom_av1_psy_tpu.ec.context import FrameContext
from aom_av1_psy_tpu.encoder import psy
from aom_av1_psy_tpu.encoder import tpu_intra as JTI
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.ec.context import FrameContext as TFC
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder, \
    _pad_plane
from test_tpu_encoder import make_frame
from test_torch_wavefront import assert_plans_equal
from torch_threads import one_torch_thread  # noqa: F401


def padded(f, h, w):
    """Source planes edge-padded to (h, w) luma, as the encoder pads."""
    out = [_pad_plane(f.planes()[0].astype(np.int32), h, w)]
    if not f.monochrome:
        out += [_pad_plane(p.astype(np.int32), h // 2, w // 2)
                for p in f.planes()[1:]]
    return out


def plans(srcp, q, bs, rdmult):
    pj = JTI.plan_frame(srcp, q, bs, FrameContext(q), rdmult,
                        fetch_recon=True)
    pt = TTI.plan_frame(srcp, q, bs, TFC(q), rdmult, device="cpu",
                        fetch_recon=True)
    assert pj.pop("bs") == pt.pop("bs") == bs
    return pj, pt


@pytest.mark.parametrize("w,h,bs,q", [(178, 130, 8, 60), (96, 64, 16, 100),
                                      (128, 64, 32, 30)])
def test_plan_frame_matches_jax(w, h, bs, q):
    f = make_frame(w, h, seed=w + bs)
    ph, pw = (h + 7) // 8 * 8, (w + 7) // 8 * 8
    srcp = padded(f, ph, pw)
    rd = np.float32(12000.0 + 300 * bs)
    pj, pt = plans(srcp, q, bs, rd)
    assert pt["y_levels"].shape[-1] == bs * bs
    assert pt["uv_levels"].shape[-1] == bs * bs // 4
    assert_plans_equal(pj, pt)
    # several plain modes win, and some chroma blocks are coded
    assert len(np.unique(pt["y_mode"])) > 3 and pt["uv_eob"].any()


def test_plan_frame_monochrome_psy_grid_matches_jax():
    f = make_frame(178, 130, seed=9)
    mono = Frame(f.planes()[0], None, None)
    srcp = padded(mono, 136, 184)
    grid = (20000 * psy.ssim_rdmult_scaling_factors(mono.planes()[0])
            .repeat(2, 0).repeat(2, 1)[:17, :23]).astype(np.float32)
    pj, pt = plans(srcp, 80, 8, grid)
    assert "uv_mode" not in pt and len(pt["recon"]) == 1
    assert_plans_equal(pj, pt)


@pytest.mark.parametrize("bs,fshape", [(8, (9, 12)), (16, (9, 12)),
                                       (32, (9, 11)), (32, (4, 6))])
def test_rdmult_grid_matches_jax(bs, fshape):
    """Each block-size branch against the reference's, by a direct call
    (the encoder reaches only bs 8 on the uniform grid and bs 16 on the
    partition path)."""
    f = make_frame(178, 130, seed=2)
    cfg = EncoderConfig(base_q_idx=80, block_size=3)
    ref = TpuFrameEncoder(f, cfg)
    enc = GpuFrameEncoder(convert.from_jax(f),
                          convert.from_jax(cfg), device="cpu")
    R, C = (136 + bs - 1) // bs, (184 + bs - 1) // bs
    for e in (ref, enc):
        e.bs, e.R, e.C = bs, R, C
    rng = np.random.default_rng(bs)
    factors = rng.uniform(0.5, 2.0, fshape)
    got = enc._rdmult_grid(15000, factors)
    assert got.shape == (R, C) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref._rdmult_grid(15000, factors))
