"""Port parity of the device mesh on the CPU, the other frames of
``tests/test_torch_mesh.py``: the 256x128 frame of
``tests/test_multichip.py`` with four tile columns (a mesh of 4), and a
2-tile 208x128 frame whose width is not a whole number of superblocks
(the last tile's visible width, 20 mi, is short of its 32-mi slab): the
port's mesh encode gives the bytes of the reference's sharded encode and
of the port's batched encode, and its ``tile_plans_sharded`` returns the
reference's plans on the same slabs. Tolerance: exact equality."""
import pytest

from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from test_multichip import _frame
from test_torch_mesh import check_sharded
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("w,lg", [(256, 2), (208, 1)])
def test_sharded_tiles_match_jax(monkeypatch, w, lg):
    enc = check_sharded(monkeypatch, _frame(w, 128, seed=lg),
                        EncoderConfig(base_q_idx=90, tile_cols_log2=lg),
                        1 << lg)
    last = enc._tile_slabs()[-1]
    assert (last["vis_mi_w"] < last["tile_mi_w"]) == (w % 64 != 0)
