"""The port's spans and counters (``aom_av1_psy_tpu_torch/utils/trace.py``)
and the benchmark readers that read them.

On the CPU: spans nest, carry their parent's index and their frame's id,
and are kept only while a ``torch.profiler`` session runs; a span's
timeline record contains the profiler's event of a torch op run inside it
(one clock); a kernel launch counts and, under a profiler, is a ``launch``
span; the copies to a card count as syncs; a KEY encode's ``timings``
hold every key of ``KEY_TIMINGS``, and the plan's three spans (inputs,
submit, fetch) add up to ``plan_s`` within 1 % on the partition, tiled
and uniform-grid paths; a traced CPU run of the all-intra cell reports
the new per-layer metrics.

On a CUDA card (``gpu``, skipped without one): a span around a launch and
a synchronize contains the kernel's device interval; one 720p KEY frame
makes 1240 launches in its plan's submit when it captures the walk as a
CUDA graph and none (3 in the frame, KC's) when it replays it; and the
``syncs`` of a frame that walks eagerly, of one that captures and of one
that replays each equal the warnings of
``torch.cuda.set_sync_debug_mode("warn")`` over its encode.
Tolerance: exact, but the 1 % of the plan's split."""
import os
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TI
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import (KEY_TIMINGS,
                                                     GpuFrameEncoder)
from aom_av1_psy_tpu_torch.kernels import build
from aom_av1_psy_tpu_torch.utils import trace
from aom_av1_psy_tpu_torch.utils.testframes import make_frame
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PLAN_PARTS = ("plan_inputs_s", "plan_submit_s", "plan_fetch_s")


@pytest.fixture(autouse=True)
def no_records():
    trace.clear()
    yield
    trace.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_nest_with_parent_index_and_frame_id():
    with _cpu_profile():
        with trace.frame() as f1:
            with trace.span("a", x=1):
                with trace.span("b"):
                    pass
                with trace.span("c", y="z"):
                    pass
        with trace.span("between"):
            pass
        with trace.frame() as f2:
            with trace.span("d"):
                pass
    recs = trace.records()
    assert [r[0] for r in recs] == ["a", "b", "c", "between", "d"]
    assert [r[3] for r in recs] == [None, 0, 0, None, None]
    assert [r[4] for r in recs] == [f1.id, f1.id, f1.id, f1.id, f2.id]
    assert f2.id == f1.id + 1
    assert recs[0][5] == {"x": 1} and recs[2][5] == {"y": "z"}
    for name, t0, t1, *_ in recs:
        assert t0 <= t1, name
    a, b, c = recs[:3]
    assert a[1] <= b[1] <= b[2] <= c[1] <= c[2] <= a[2]


def test_span_seconds_and_frame_values_without_profiler():
    with trace.frame() as f:
        with trace.span("s", into="k") as sp:
            pass
        with trace.span("s", into="k"):
            pass
        trace.add("n", 1)
        trace.add("n", 2)
    assert sp.s is not None and sp.s >= 0
    assert f.values["k"] >= sp.s and f.values["n"] == 3
    assert f.pick(("k", "n", "absent")) == {"k": f.values["k"], "n": 3,
                                            "absent": 0}
    with trace.span("no frame", into="k") as sp2:
        pass
    assert sp2.s >= 0
    assert trace.records() == []


def test_no_records_without_profiler():
    enc = GpuFrameEncoder(make_frame(64, 64, seed=2),
                          EncoderConfig(base_q_idx=110), device="cpu")
    enc.encode()
    assert trace.records() == []
    assert enc.timings["plan_s"] > 0


def test_records_inside_a_cpu_profiler():
    enc = GpuFrameEncoder(make_frame(64, 64, seed=4),
                          EncoderConfig(base_q_idx=110), device="cpu")
    with _cpu_profile():
        enc.encode()
    after = trace.frame_id()
    recs = trace.records()
    names = [r[0] for r in recs]
    for name in ("plan", "plan.inputs", "plan.submit", "plan.fetch",
                 "plan.step", "pack", "lpf"):
        assert name in names, name
    assert {r[4] for r in recs} == {after}
    by = {r[0]: i for i, r in enumerate(recs)}
    assert recs[by["plan.submit"]][3] == names.index("plan")
    assert recs[by["lpf"]][3] == names.index("pack")
    steps = [r for r in recs if r[0] == "plan.step"]
    # a 64x64 frame is 2 x 2 cells of 32: 3 diagonals a wavefront
    assert [(r[5]["plane"], r[5]["diagonal"], r[5]["cells"])
            for r in steps] == [("y", 0, 1), ("y", 1, 2), ("y", 2, 1),
                                ("uv", 0, 1), ("uv", 1, 2), ("uv", 2, 1)]
    submit = by["plan.submit"]
    assert all(r[3] == submit for r in steps)
    # nothing kept once the session has ended
    enc2 = GpuFrameEncoder(make_frame(64, 64, seed=4),
                           EncoderConfig(base_q_idx=110), device="cpu")
    enc2.encode()
    assert len(trace.records()) == len(recs)


def test_span_clock_contains_a_cpu_op_event():
    x = torch.arange(100000, dtype=torch.float32)
    with _cpu_profile() as prof:
        with trace.span("op"):
            y = torch.cumsum(x, 0)
    assert float(y[-1]) > 0
    (_, t0, t1, *_), = trace.records()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::cumsum"]
    assert ev
    for e in ev:
        assert t0 <= e.start_ns() <= e.start_ns() + e.duration_ns() <= t1


class _FakeLib:
    pass


def test_launch_counts_and_is_a_span_under_a_profiler(monkeypatch):
    k = build.CudaKernel("fake_kernel", {})
    k._lib = _FakeLib()
    k._fns["f"] = lambda *a: 0
    monkeypatch.setattr(k, "stream_on", lambda device: 0)
    n0 = build.launches_total()
    k.launch("f", device=0, variant="v1")
    assert trace.records() == []
    with _cpu_profile():
        k.launch("f", device=0)
    assert build.launches_total() == n0 + 2 and k.launches == 2
    (name, t0, t1, parent, _, attrs), = trace.records()
    assert name == "launch" and t0 <= t1 and parent is None
    assert attrs == {"kernel": "fake_kernel", "variant": "f"}
    build._ALL.remove(k)


def test_copies_to_a_device_count_as_syncs():
    a = np.arange(6, dtype=np.int32)
    with trace.frame() as f:
        convert.to_device(a, "cpu")
        convert.to_host(torch.zeros(3))
        t = convert.to_device(a, "meta")
        convert.to_device(a, "meta", dtype=torch.int64)
    assert t.device.type == "meta"
    assert f.values.get("syncs") == 2
    p = convert.plane(a.reshape(2, 3), "cpu")
    a[0] = 99
    assert int(p[0, 0]) == 0 and p.dtype == torch.int32


@pytest.mark.parametrize("case", [
    ("part", 128, 64, {}),
    ("tiles", 256, 64, {"tile_cols_log2": 1}),
    ("uniform", 64, 64, {"block_size": 3}),
])
def test_key_timings_split_the_plan(case):
    name, w, h, kw = case
    enc = GpuFrameEncoder(make_frame(w, h, seed=7),
                          EncoderConfig(base_q_idx=110, **kw), device="cpu")
    enc.encode()
    t = enc.timings
    assert set(t) == set(KEY_TIMINGS)
    parts = sum(t[k] for k in PLAN_PARTS)
    assert all(t[k] > 0 for k in PLAN_PARTS), t
    assert abs(parts - t["plan_s"]) <= 0.01 * t["plan_s"], t
    # no kernel and no copy between host and card on the CPU
    assert t["plan_launches"] == 0 and t["syncs"] == 0
    if name == "uniform":
        assert t["lpf_s"] == 0
    else:
        assert 0 < t["lpf_s"] <= t["pack_s"]


def test_inter_timings_and_script_stage():
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video
    from aom_av1_psy_tpu_torch.utils.testframes import make_gop
    with _cpu_profile():
        _, encs = encode_video(make_gop(64, 64, 2),
                               EncoderConfig(base_q_idx=150), device="cpu")
    inter = encs[1]
    assert set(inter.timings) == {"plan_s", "pack_s"}
    assert set(inter.pack_stages) == {"script_s"}
    assert 0 < inter.pack_stages["script_s"] <= inter.timings["pack_s"]
    recs = trace.records()
    # the KEY's temporal filter runs before its frame begins
    frames = sorted({r[4] for r in recs if r[0] == "plan"})
    assert len(frames) == 2 and frames[1] == frames[0] + 1
    assert [r[4] for r in recs if r[0] == "tf"] == [frames[0] - 1]
    last = [r for r in recs if r[4] == frames[1]]
    names = [r[0] for r in last]
    for name in ("plan", "pack", "lpf", "cdef", "script"):
        assert name in names, name
    pack = names.index("pack")
    assert all(last[names.index(n)][3] is not None for n in
               ("lpf", "cdef", "script"))
    assert recs.index(last[pack]) == last[names.index("script")][3]


def test_traced_cpu_run_reports_the_plan_metrics():
    from benchmark.harness import spec
    from benchmark.harness.execute import execute
    cell = spec.cell(ROOT, "ai-720p-q110")
    r = execute(ROOT, cell, 11, 1.0, True, device="cpu",
                overrides={"traffic": {"width": 128, "height": 64}})
    assert r["correct"], r["checks"]
    m = r["metrics"]
    for name in ("key_plan_inputs_ms", "key_plan_submit_ms",
                 "key_plan_fetch_ms", "key_lpf_ms"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms", name
    assert m["key_plan_ms"]["value"] == pytest.approx(
        sum(m[k]["value"] for k in ("key_plan_inputs_ms",
                                    "key_plan_submit_ms",
                                    "key_plan_fetch_ms")), rel=0.01)
    assert m["syncs_per_frame"] == {"value": 0.0, "unit": "syncs"}
    # no kernel launches on the CPU: nothing to divide
    assert "key_launch_us" not in m
    # CPU tensors never take the graph path
    assert m["key_graph_hit_pct"] == {"value": 0.0, "unit": "%"}


def test_launch_and_sync_readers():
    from benchmark.harness import spec

    class Run:
        frames = [
            {"type": "key", "traced": True, "plan_submit_s": 1.0,
             "plan_launches": 10, "syncs": 40},
            {"type": "key", "traced": False, "plan_submit_s": 0.08,
             "plan_launches": 1240, "syncs": 33},
            {"type": "key", "traced": False, "plan_submit_s": 0.07,
             "plan_launches": 1240, "syncs": 35}]

    us = spec.metric_reader("key_launch_us").read(Run)
    assert us == pytest.approx(1e6 * 0.15 / 2480)
    assert spec.metric_reader("syncs_per_frame").read(Run) == 34.0

    class Parent:                  # a program without the counters
        frames = [{"type": "key", "traced": False, "plan_s": 0.09,
                   "pack_s": 0.005}]

    for name in ("key_launch_us", "syncs_per_frame", "key_plan_inputs_ms",
                 "key_plan_submit_ms", "key_plan_fetch_ms", "key_lpf_ms"):
        assert spec.metric_reader(name).read(Parent) is None, name


def test_graph_hit_reader():
    from benchmark.harness import spec
    read = spec.metric_reader("key_graph_hit_pct").read

    class Run:
        frames = [
            {"type": "key", "traced": True, "plan_graph": 0},
            {"type": "key", "traced": False, "plan_graph": 1},
            {"type": "key", "traced": False, "plan_graph": 0},
            {"type": "key", "traced": False, "plan_graph": 1},
            {"type": "key", "traced": False, "plan_graph": 2},
            {"type": "inter", "traced": False, "plan_s": 0.01}]

    assert read(Run) == 75.0

    class Traced:                  # every frame in the traced stretch
        frames = [{"type": "key", "traced": True, "plan_graph": 1},
                  {"type": "key", "traced": True, "plan_graph": 0}]

    assert read(Traced) == 50.0

    class Parent:                  # a program without the counter
        frames = [{"type": "key", "traced": False, "plan_s": 0.09,
                   "plan_launches": 1240}]

    assert read(Parent) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_clock_contains_the_kernel_device_interval(dev):
    x = torch.zeros(1 << 22, device=dev)
    x.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert trace.profiling()
        with trace.span("launch and wait"):
            x.mul_(3)
            torch.cuda.synchronize()
    (_, t0, t1, *_), = trace.records()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and e.duration_ns() > 0]
    assert ev
    for e in ev:
        assert t0 <= e.start_ns() <= e.start_ns() + e.duration_ns() <= t1


def _720p(dev, seed):
    return GpuFrameEncoder(make_frame(1280, 720, seed=seed),
                           EncoderConfig(base_q_idx=110), device=dev)


@pytest.mark.gpu
def test_720p_plan_launches(dev):
    TI._PLAN_GRAPHS.clear()
    _720p(dev, 1).encode()                    # the key's eager walk
    enc = _720p(dev, 2)
    n0 = build.launches_total()
    enc.encode()
    # the capture: 23 x 40 cells of 32, 62 diagonals, 5 KA + 5 KB a step,
    # two planes; the frame's other launches are KC's three
    assert enc.timings["plan_launches"] == 1240
    assert enc.timings["plan_graph"] == 0
    assert build.launches_total() - n0 == 1243
    t = enc.timings
    assert abs(sum(t[k] for k in PLAN_PARTS) - t["plan_s"]) \
        <= 0.01 * t["plan_s"], t
    # a replay of the graph makes no launch from the host
    enc = _720p(dev, 3)
    n0 = build.launches_total()
    enc.encode()
    assert enc.timings["plan_launches"] == 0
    assert enc.timings["plan_graph"] == 1
    assert build.launches_total() - n0 == 3
    t = enc.timings
    assert abs(sum(t[k] for k in PLAN_PARTS) - t["plan_s"]) \
        <= 0.01 * t["plan_s"], t


WALKS = ("eager", "capture", "replay")


@pytest.mark.gpu
@pytest.mark.parametrize("walk", WALKS)
def test_720p_syncs_match_torch_sync_debug_mode(dev, walk):
    # the key's first plan walks eagerly, its second captures the walk as
    # a CUDA graph, its third replays it: each counts what torch warns of
    _720p(dev, 1).encode()                    # builds and caches first
    TI._PLAN_GRAPHS.clear()
    before = WALKS.index(walk)
    for seed in range(before):
        _720p(dev, 2 + seed).encode()
    enc = _720p(dev, 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            enc.encode()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in got if "synchroniz" in str(w.message)]
    assert enc.timings["syncs"] == len(syncs), \
        (enc.timings["syncs"], [str(w.message)[:80] for w in syncs])
    pg, = TI._PLAN_GRAPHS[torch.cuda.current_device()].entries.values()
    assert pg.plans == before + 1
    assert (pg.graph is not None) == (walk != "eager")
    assert enc.timings["plan_graph"] == int(walk == "replay")
    assert enc.timings["plan_launches"] == (0 if walk == "replay" else 1240)
