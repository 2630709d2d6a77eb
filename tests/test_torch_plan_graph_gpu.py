"""The KEY plan's partition wavefronts replayed as one CUDA graph
(``aom_av1_psy_tpu_torch/encoder/tpu_intra.PlanGraph``) on the card.

A replayed plan equals the eager plan of the same still: every plan array,
all three ``recon_dev`` planes and the packet, on three 720p stills at two
q values and on a frame of two tile columns. A plan's arrays and planes are
unchanged after the next frame replays the graph (the fetch returns no
view of the graph's memory). Four frames of one key read ``plan_graph`` 0,
0, 1, 1 (eager, capture, replay, replay) and make 1240, 1240, 0, 0
launches in the submit; another q or another shape misses the key and the
first key still replays after it. Under ``torch.profiler`` the replay's
kernels are reported by name. Tolerance: exact equality.

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax or
of the reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_plan_graph_gpu.py
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aom_av1_psy_tpu_torch.encoder import tpu_intra as TI
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.utils.testframes import make_frame

pytestmark = pytest.mark.gpu

W, H = 1280, 720


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    TI._PLAN_GRAPHS.clear()
    yield torch.device("cuda", 0)
    TI._PLAN_GRAPHS.clear()


def _encode(dev, seed, q=110, w=W, h=H, **kw):
    enc = GpuFrameEncoder(make_frame(w, h, seed=seed),
                          EncoderConfig(base_q_idx=q, **kw), device=dev)
    pkt = enc.encode()
    return enc, pkt


def _plans(enc):
    return enc.tile_plans if enc.tile_T > 1 else [enc.plan]


def _snapshot(enc, pkt):
    """Host copies of every plan array and recon plane, and the packet."""
    return pkt, [{k: (np.array(v) if k != "recon_dev"
                      else [r.cpu().numpy() for r in v])
                  for k, v in p.items()} for p in _plans(enc)]


def _assert_same(want, plans):
    """``plans`` (live plan dicts, recon planes on the card) equal the
    snapshot ``want``'s plans."""
    assert len(want) == len(plans)
    for a, b in zip(want, plans):
        assert set(a) == set(b)
        for k in a:
            if k == "recon_dev":
                assert len(a[k]) == len(b[k]) == 3
                for x, y in zip(a[k], b[k]):
                    np.testing.assert_array_equal(x, y.cpu().numpy())
            else:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]),
                                              err_msg=k)


def _eager(dev, seed, **kw):
    """The still's packet and plans from an eager plan (a fresh cache)."""
    TI._PLAN_GRAPHS.clear()
    enc, pkt = _encode(dev, seed, **kw)
    assert enc.timings["plan_graph"] == 0
    return _snapshot(enc, pkt)


@pytest.mark.parametrize("q", [110, 60])
def test_replayed_plans_equal_eager_plans(dev, q):
    seeds = (1, 2, 3)
    want = {s: _eager(dev, s, q=q) for s in seeds}
    TI._PLAN_GRAPHS.clear()
    held = []
    for n, s in enumerate((1, 2, 3, 2, 1, 3)):
        enc, pkt = _encode(dev, s, q=q)
        assert enc.timings["plan_graph"] == int(n >= 2), n
        assert pkt == want[s][0], (n, s)
        _assert_same(want[s][1], _plans(enc))
        # every plan fetched so far is untouched by the replays after it
        for s0, plans in held:
            _assert_same(want[s0][1], plans)
        held.append((s, _plans(enc)))
    pg, = TI._PLAN_GRAPHS[0].entries.values()
    graph_mem = {r.untyped_storage().data_ptr() for r in pg.recons}
    for _, plans in held:
        for p in plans:
            for r in p["recon_dev"]:
                assert r.untyped_storage().data_ptr() not in graph_mem


def test_replayed_tiled_plans_equal_eager_plans(dev):
    want = {s: _eager(dev, s, tile_cols_log2=1) for s in (4, 5)}
    TI._PLAN_GRAPHS.clear()
    for n, s in enumerate((4, 5, 4, 5)):
        enc, pkt = _encode(dev, s, tile_cols_log2=1)
        assert enc.tile_T == 2
        assert enc.timings["plan_graph"] == int(n >= 2), n
        assert pkt == want[s][0], (n, s)
        _assert_same(want[s][1], _plans(enc))


def test_four_frames_of_one_key_and_misses(dev):
    got = []
    for s in (1, 2, 3, 4):
        enc, _ = _encode(dev, s)
        got.append((enc.timings["plan_graph"], enc.timings["plan_launches"]))
    assert got == [(0, 1240), (0, 1240), (1, 0), (1, 0)]
    # another q, then another shape: each a new key, walked eagerly
    enc, _ = _encode(dev, 5, q=90)
    assert enc.timings["plan_graph"] == 0
    enc, _ = _encode(dev, 5, w=640, h=384)
    assert enc.timings["plan_graph"] == 0
    assert len(TI._PLAN_GRAPHS[0].entries) == 3
    enc, _ = _encode(dev, 6)
    assert enc.timings["plan_graph"] == 1


def test_profiler_names_the_replayed_kernels(dev):
    for s in (1, 2):
        _encode(dev, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        enc, _ = _encode(dev, 3)
        torch.cuda.synchronize()
    assert enc.timings["plan_graph"] == 1
    cuda = torch.autograd.DeviceType.CUDA
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda and e.duration_ns() > 0}
    for k in ("pick61_kernel", "pick7_kernel", "kb_step_kernel"):
        assert any(k in n for n in names), (k, sorted(names)[:20])
