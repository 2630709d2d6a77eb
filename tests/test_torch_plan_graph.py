"""The KEY plan's partition wavefronts as one CUDA graph per key
(``aom_av1_psy_tpu_torch/encoder/tpu_intra.py``: ``graph_key``,
``PlanGraph``, ``PlanGraphs``), on the CPU.

The key is built from exactly what a captured launch bakes in: the grid
R, C, the tile count T, whether chroma is planned, the device, the
scalars dc_q, ac_q, pr_none, pr_split and the inputs' shapes; new values
in the same shapes keep it. The cache keeps the GRAPHS_PER_DEVICE most
recently used keys. A key's first plan runs eagerly, its second takes
(clones) static inputs, a plan of a busy key runs eagerly, and later
plans copy into the same static tensors. CPU tensors never take the graph
path (``plan_graph`` 0, no cache entry), and the fetch returns no view of
the wavefronts' tensors. ``tests/test_torch_plan_graph_gpu.py`` holds the
capture and the replays on the card. Tolerance: exact."""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.ec.context import FrameContext
from aom_av1_psy_tpu_torch.encoder import plan_inputs as PI
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TI
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.utils import trace
from aom_av1_psy_tpu_torch.utils.testframes import make_frame
from torch_threads import one_torch_thread  # noqa: F401


def _inputs(w=128, h=64, q=110, tiles=1, chroma=True, rd=300.0, seed=7):
    """(srcs, t) of a plan as ``start_tiles_part`` makes them, on the
    CPU."""
    rng = np.random.default_rng(seed)
    slabs = [{"y": np.zeros((h, w // tiles), np.int32), "rd": rd,
              "mi_cols_eff": w // 4 // tiles}] * tiles
    t = PI.upload(PI.slab_inputs(PI.shared_inputs(slabs, q, FrameContext(q)),
                                 slabs, h // 4), "cpu")
    shapes = [(tiles, h, w // tiles)]
    if chroma:
        shapes += [(tiles, h // 2, w // tiles // 2)] * 2
    srcs = [torch.tensor(rng.integers(0, 256, s, dtype=np.int32))
            for s in shapes]
    return srcs, t


def test_graph_key_holds_exactly_the_baked_values():
    srcs, t = _inputs()
    key = TI.graph_key(srcs, t)
    assert key[:9] == (2, 4, 1, True, srcs[0].get_device(), t["dc_q"],
                       t["ac_q"], t["pr_none"], t["pr_split"])
    leaves = TI._leaves(srcs, t)
    assert key[9] == tuple((tuple(x.shape), x.dtype) for x in leaves)
    assert len(key) == 10
    # every tensor a launch reads through a pointer is a leaf: the three
    # planes, the cost tables, the 4 x 2 rate tables, the lambda grids,
    # the edge-cell masks and every position mask
    n = 3 + 3 + 8 + 4 + len(t["masks"])
    assert len(leaves) == n
    assert all(isinstance(x, torch.Tensor) for x in leaves)


@pytest.mark.parametrize("change,same", [
    ("values", True),
    ("rdmult", True),
    ("q", False),
    ("shape", False),
    ("tiles", False),
    ("mono", False),
    ("pr_none", False),
    ("pr_split", False),
])
def test_graph_key_misses_on_what_is_baked_in(change, same):
    srcs, t = _inputs()
    key = TI.graph_key(srcs, t)
    if change == "values":
        srcs2, t2 = _inputs(seed=8)
    elif change == "rdmult":
        srcs2, t2 = _inputs(rd=450.0)
    elif change == "q":
        srcs2, t2 = _inputs(q=90)
    elif change == "shape":
        srcs2, t2 = _inputs(w=160)
    elif change == "tiles":
        srcs2, t2 = _inputs(w=256, tiles=2)
    elif change == "mono":
        srcs2, t2 = _inputs(chroma=False)
    else:
        srcs2, t2 = _inputs()
        t2[change] = t2[change] + 1.0
    assert (TI.graph_key(srcs2, t2) == key) == same


def test_cache_keeps_the_most_recently_used_keys():
    cache = TI.PlanGraphs()
    assert TI.GRAPHS_PER_DEVICE == 4
    got = {k: cache.get(k) for k in range(6)}
    assert list(cache.entries) == [2, 3, 4, 5]
    assert cache.get(2) is got[2]           # a hit returns its own entry
    cache.get(6)
    assert list(cache.entries) == [4, 5, 2, 6]
    assert cache.get(3) is not got[3]       # an evicted key starts over
    assert len(cache.entries) == 4


def test_first_plan_eager_second_clones_later_copy():
    srcs, t = _inputs()
    pg = TI.PlanGraph()
    assert not pg.load(srcs, t) and pg.srcs is None     # eager
    assert pg.load(srcs, t) and pg.busy                 # capture: clones
    static = TI._leaves(pg.srcs, pg.t)
    for a, b in zip(static, TI._leaves(srcs, t)):
        assert a is not b and torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != \
            b.untyped_storage().data_ptr()
    assert not pg.load(srcs, t)                         # busy: eager
    pg.busy = False
    pg.graph = object()                                 # captured
    srcs2, t2 = _inputs(seed=9, rd=200.0)
    assert pg.load(srcs2, t2)                           # copies in place
    after = TI._leaves(pg.srcs, pg.t)
    assert all(a is b for a, b in zip(after, static))
    for a, b in zip(after, TI._leaves(srcs2, t2)):
        assert torch.equal(a, b)
    assert pg.plans == 4


@pytest.mark.parametrize("box", [list, tuple, dict])
def test_leaves_walk_every_container_the_capture_clones(box):
    # a tensor the capture clones is a leaf: a replay copies into it and
    # the key holds its shape
    srcs, t = _inputs()
    extra = [torch.arange(3), torch.ones(2, 2)]
    t["extra"] = box(enumerate(extra)) if box is dict else box(extra)
    pg = TI.PlanGraph()
    pg.load(srcs, t)
    pg.load(srcs, t)                                    # capture: clones
    pg.busy, pg.graph = False, object()
    t2 = dict(t)
    t2["extra"] = (box(enumerate(x + 1 for x in extra)) if box is dict
                   else box(x + 1 for x in extra))
    assert TI.graph_key(srcs, t2) == TI.graph_key(srcs, t)
    assert pg.load(srcs, t2)                            # copies in place
    assert len(TI._leaves(pg.srcs, pg.t)) == len(TI._leaves(srcs, t2))
    for a, b in zip(TI._leaves(pg.srcs, pg.t), TI._leaves(srcs, t2)):
        assert torch.equal(a, b)
    t2["extra"] = box(enumerate(extra[:1])) if box is dict \
        else box(extra[:1])
    assert TI.graph_key(srcs, t2) != TI.graph_key(srcs, t)


def test_cpu_encodes_never_take_the_graph():
    before = dict(TI._PLAN_GRAPHS)
    cfg = EncoderConfig(base_q_idx=110)
    for seed in (1, 2, 1):
        enc = GpuFrameEncoder(make_frame(128, 64, seed=seed), cfg,
                              device="cpu")
        enc.encode()
        assert enc.timings["plan_graph"] == 0
        assert enc.timings["plan_launches"] == 0
    assert TI._PLAN_GRAPHS == before


def test_fetch_returns_no_view_of_the_wavefronts():
    enc = GpuFrameEncoder(make_frame(256, 64, seed=3),
                          EncoderConfig(base_q_idx=110, tile_cols_log2=1),
                          device="cpu")
    slabs = enc._tile_slabs()
    shared = PI.shared_inputs(slabs, 110, FrameContext(110))
    with trace.frame() as rec:
        started = TI.start_tiles_part(slabs, shared, enc.mi_rows, "cpu")
        plans = TI.fetch_tiles_part(started)
    assert rec.values["plan_graph"] == 0 and started["graph"] is None
    assert len(plans) == 2
    theirs = {r.untyped_storage().data_ptr() for r in started["recons"]}
    for i, plan in enumerate(plans):
        for mine, r in zip(plan["recon_dev"], started["recons"]):
            assert mine.is_contiguous()
            assert mine.untyped_storage().data_ptr() not in theirs
            assert torch.equal(mine, r[i])
