"""Port parity of ``plan_frame_part`` (see test_torch_wavefront.py) on two
more frame shapes: the 128x128 BLOCK_32X32 case of test_tpu_encoder.py,
and a 128x88 frame whose bottom cells must NOT split (a visited 16 would be
partial). Tolerance: exact equality."""
import pytest

from aom_av1_psy_tpu_torch.ec.context import FrameContext
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from test_torch_wavefront import assert_plans_equal, plans
from torch_threads import one_torch_thread  # noqa: F401


def test_plan_128x128_q100_bs32():
    pj, pt, _ = plans(128, 128, 100, 9)
    assert_plans_equal(pj, pt)


def test_plan_128x88_q80_no_split_edges():
    pj, pt, enc = plans(128, 88, 80, 6)
    d = TTI.part_inputs(enc.R // 2, enc.C // 2, 80, FrameContext(80),
                        enc.rdmult, enc.mi_rows, enc.mi_cols)
    assert d["no_split"].any(), "bottom cells must be no-split cells"
    assert not pt["split32"][d["no_split"]].any()
    assert_plans_equal(pj, pt)


@pytest.mark.parametrize("mi_rows,mi_cols,ok", [(34, 24, False),
                                                 (16, 42, False),
                                                 (36, 44, True),
                                                 (22, 32, True)])
def test_part_supported_rule_carried_over(mi_rows, mi_cols, ok):
    from aom_av1_psy_tpu.encoder import tpu_intra as JTI
    assert TTI.plan_part_supported(mi_rows, mi_cols) is ok
    assert JTI.plan_part_supported(mi_rows, mi_cols) is ok
