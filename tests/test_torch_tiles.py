"""Port parity of tile columns: ``GpuFrameEncoder(device="cpu")`` with
``tile_cols_log2 > 0`` gives the byte-identical stream of the JAX
``TpuFrameEncoder``, each tile's plan equals the reference's
``tile_plans[t]`` key for key, the batched tile run
(``parallel/mesh.tile_plans_batched``: one wavefront over the stacked
slabs) equals the port's own per-tile ``plan_frame_part`` loop, and the
stream decodes through the in-repo decoder to the port's post-LPF planes.

This file holds the 256x128 frame of ``tests/test_multichip.py`` with two
and four tiles, and with two tiles a tune_psy lambda grid, a monochrome
frame and the CDEF search (the post-LPF recon and the CDEF apply on the
stitched frame); test_torch_tiles_cells.py holds the other shapes.
Tolerance: exact equality."""
import numpy as np
import pytest

from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch.ec.context import FrameContext
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from aom_av1_psy_tpu_torch.parallel.mesh import tile_plans_batched
from test_multichip import _frame
from test_torch_encoder import assert_decodes_to_recon, encode_both
from test_torch_wavefront import assert_plans_equal
from torch_threads import one_torch_thread  # noqa: F401


def assert_same_tile_plans(want, got):
    """Two lists of per-tile plans, recon included."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = dict(a, recon=[np.asarray(r) for r in a["recon_dev"]])
        b = dict(b, recon=[r.numpy() for r in b["recon_dev"]])
        assert_plans_equal(a, b)


def port_tile_loop(enc):
    """The port's per-tile loop: ``plan_frame_part`` on each slab alone."""
    q = enc.cfg.base_q_idx
    plans = []
    for sl in enc._tile_slabs():
        srcp = [sl["y"]] + ([sl["u"], sl["v"]] if "u" in sl else [])
        plans.append(TTI.plan_frame_part(
            srcp, q, FrameContext(q), sl["rd"], enc.mi_rows,
            sl["mi_cols_eff"], device="cpu", tile_mi_w=sl["tile_mi_w"],
            vis_mi_w=sl["vis_mi_w"]))
    return plans


def check_tiled(f, cfg, tiles):
    ref, want, enc, got = encode_both(f, cfg)
    assert ref.tile_T == enc.tile_T == tiles
    assert got == want
    assert enc.fh.tiles.tile_cols == tiles
    assert_same_tile_plans(ref.tile_plans, enc.tile_plans)
    batched = tile_plans_batched(enc._tile_slabs(), cfg.base_q_idx,
                                 enc.mi_rows, device="cpu")
    assert_same_tile_plans(port_tile_loop(enc), batched)
    np.testing.assert_array_equal(enc.mi_skip, ref.mi_skip)
    for a, b in zip(enc.ref_planes_dev, ref.ref_planes_dev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_decodes_to_recon(got, enc)
    return enc


@pytest.mark.parametrize("lg", [1, 2])
def test_tiled_256x128_matches_jax(lg):
    enc = check_tiled(_frame(256, 128, seed=lg),
                      EncoderConfig(base_q_idx=90, tile_cols_log2=lg), 1 << lg)
    assert enc.tile_pw * enc.tile_T == enc.srcp[0].shape[1]


def test_tiled_tune_psy_matches_jax():
    enc = check_tiled(_frame(256, 128, seed=7),
                      EncoderConfig(base_q_idx=60, tile_cols_log2=1,
                                    tune_psy=True), 2)
    assert np.ndim(enc.rdmult) == 2 and np.std(enc.rdmult) > 0


def test_tiled_monochrome_matches_jax():
    f = _frame(256, 128, seed=8)
    enc = check_tiled(Frame(f.planes()[0], None, None),
                      EncoderConfig(base_q_idx=90, tile_cols_log2=1), 2)
    assert enc.nplanes == 1 and len(enc.tile_plans[1]["recon_dev"]) == 1


def test_tiled_search_cdef_matches_jax():
    enc = check_tiled(_frame(256, 128, seed=9),
                      EncoderConfig(base_q_idx=200, tile_cols_log2=1,
                                    search_cdef=True), 2)
    c = enc.fh.cdef
    assert enc.seq.enable_cdef and c.y_pri[0] + c.y_sec[0] > 0
