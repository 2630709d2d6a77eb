"""Port parity: the two-level partition plan (``plan_frame_part``: luma and
chroma wavefronts, one host copy of the plan) of ``aom_av1_psy_tpu_torch``
against the JAX reference, key for key and recon included, on the
part-path cases of test_tpu_encoder.py. Tolerance: exact equality.

The JAX plan compiles once per frame shape (~20 s on the CPU), so this file
holds the 96x64 shape (plain and tune_psy lambda grids) and the 176x144
high-q shape whose right and bottom edge cells are decoder-forced splits;
test_torch_wavefront_cells.py holds the others."""
import numpy as np
import pytest

from aom_av1_psy_tpu.ec.context import FrameContext
from aom_av1_psy_tpu.encoder import tpu_intra as JTI
from aom_av1_psy_tpu.encoder import tpu_intra_dir as JDIR
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.ec.context import FrameContext as TFC
from aom_av1_psy_tpu_torch.encoder import plan_inputs as PI
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from test_tpu_encoder import make_frame
from torch_threads import one_torch_thread  # noqa: F401


def plans(w, h, q, bsz, **cfg_kw):
    """(jax plan, port plan, port encoder) on identical host inputs."""
    f = make_frame(w, h, seed=w + q)
    cfg = EncoderConfig(base_q_idx=q, block_size=bsz, **cfg_kw)
    ref = TpuFrameEncoder(f, cfg)
    enc = GpuFrameEncoder(convert.from_jax(f),
                          convert.from_jax(cfg), device="cpu")
    assert ref.use_part
    for a, b in zip(ref.srcp, enc.srcp):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(ref.rdmult),
                                  np.asarray(enc.rdmult))
    args = (enc.rdmult, enc.mi_rows, enc.mi_cols)
    pj = JTI.plan_frame_part(enc.srcp, q, FrameContext(q), *args,
                             fetch_recon=True)
    pt = TTI.plan_frame_part(enc.srcp, q, TFC(q), *args, device="cpu",
                             fetch_recon=True)
    return pj, pt, enc


def assert_plans_equal(pj, pt):
    assert set(pj) == set(pt)
    for k, v in pj.items():
        if k == "recon_dev":
            continue
        if k == "recon":
            for i, (a, b) in enumerate(zip(v, pt[k])):
                np.testing.assert_array_equal(b, np.asarray(a),
                                              err_msg=f"recon {i}")
            continue
        if k == "part":
            assert pt[k] is True
            continue
        a = np.asarray(v)
        assert pt[k].dtype == a.dtype, k
        np.testing.assert_array_equal(pt[k], a, err_msg=k)


@pytest.fixture(scope="module")
def case_96x64():
    return plans(96, 64, 60, 6)


@pytest.fixture(scope="module")
def case_176x144():
    return plans(176, 144, 200, 6)


def test_plan_96x64_q60(case_96x64):
    pj, pt, _ = case_96x64
    assert_plans_equal(pj, pt)
    # the luma plan exercises split cells and angle-delta candidates
    assert pt["split32"].any()
    assert (pt["y_delta16"] != 0).any()


def test_plan_96x64_tune_psy_grid():
    pj, pt, enc = plans(96, 64, 60, 6, tune_psy=True)
    grid = np.asarray(enc.rdmult)
    assert grid.ndim == 2 and grid.std() > 0, "rdmult grid must vary"
    assert_plans_equal(pj, pt)


def test_plan_176x144_q200_forced_edges(case_176x144):
    pj, pt, enc = case_176x144
    forced, _ = PI.edge_cell_masks(enc.R // 2, enc.C // 2, enc.mi_rows,
                                   enc.mi_cols)
    assert forced.any(), "edge cells must be decoder-forced splits"
    assert pt["split32"][forced].all()
    assert_plans_equal(pj, pt)


@pytest.mark.parametrize("q,rd", [pytest.param(60, 30000.0, id="60"),
                                  pytest.param(200, 30000.0, id="200"),
                                  pytest.param(110, "grid", id="110-grid")])
def test_part_inputs_carried_over(q, rd):
    """The host tables the port carries over equal the reference's, the
    lambda grids are the reference's (a scalar, or a non-uniform 16-px
    grid and its 32-px geometric mean), and plan_inputs.upload moves them
    without change."""
    fc = FrameContext(q)
    R, C, mi_rows, mi_cols = 5, 6, 36, 44
    if rd == "grid":
        rd = np.random.default_rng(q).uniform(
            2e4, 6e4, (2 * R, 2 * C)).astype(np.float32)
    slab = {"y": np.zeros((32 * R, 32 * C), np.int32), "rd": rd,
            "mi_cols_eff": mi_cols}
    d = PI.slab_inputs(PI.shared_inputs([slab], q, convert.from_jax(fc)),
                       [slab], mi_rows)
    assert (d["R"], d["C"]) == (R, C)
    for got, want in zip((d["kf_cost"], d["angle_cost"], d["uv_cost"]),
                         JTI._plan_cost_tables2(fc)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(PI.plan_cost_tables(convert.from_jax(fc)),
                         JTI._plan_cost_tables(fc)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for k, v in JDIR.position_masks(mi_rows, mi_cols, mi_cols, R,
                                    C).items():
        np.testing.assert_array_equal(d["masks"][k][0], v, err_msg=k)
    for k, (lvl, eob) in JTI._rate_tables(fc).items():
        np.testing.assert_array_equal(d["rt"][k][0], np.asarray(lvl))
        np.testing.assert_array_equal(d["rt"][k][1], np.asarray(eob))
    assert (d["pr_none"], d["pr_split"]) == JTI._part_rate_scalars(fc)
    # the lambdas as the reference's plan_frame_part makes them
    rd16 = np.asarray(rd, np.float32)
    if rd16.ndim == 0:
        rd16 = np.full((2 * R, 2 * C), float(rd), np.float32)
    rd32 = np.exp(np.log(rd16).reshape(R, 2, C, 2).mean((1, 3))) \
        .astype(np.float32)
    got16, got32 = PI.lambda_grids(rd, R, C)
    assert got16.dtype == got32.dtype == np.float32
    np.testing.assert_array_equal(got16, rd16)
    np.testing.assert_array_equal(got32, rd32)
    np.testing.assert_array_equal(d["rd16"], rd16[None])
    np.testing.assert_array_equal(d["rd32"], rd32[None])
    t = PI.upload(d, "cpu")
    for k in ("kf_cost", "rd16", "rd32", "forced", "no_split"):
        np.testing.assert_array_equal(t[k].numpy(), d[k], err_msg=k)
    np.testing.assert_array_equal(t["masks"]["trreal_16"].numpy(),
                                  d["masks"]["trreal_16"])
    np.testing.assert_array_equal(t["rt"]["y32"][0].numpy(), d["rt"]["y32"][0])
    assert t["dc_q"] == d["dc_q"] and t["pr_split"] == d["pr_split"]
