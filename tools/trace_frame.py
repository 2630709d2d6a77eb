#!/usr/bin/env python3
"""Where the card waits during KEY frames: encode stills under
``torch.profiler`` and split the device's idle time by the program's
innermost span (``aom_av1_psy_tpu_torch/utils/trace.py``).

    python3 tools/trace_frame.py --width 1280 --height 720 --frames 8

Each still (``utils/testframes.make_frame``, one seed a frame) is coded as
a KEY frame by ``GpuFrameEncoder`` at ``--q`` with the encoder's defaults
(the 32 -> 16 plan, the LPF search, one tile), after ``--warmup`` frames
that build and load the kernels; the stills are coded once without the
profiler and once more under it. The profiler records CUDA activity (CPU
activity on ``--device cpu``, which has no device events) from the first
traced frame's submit to a synchronize after the last. The device's busy
time is the union of its kernel, copy and set intervals; every idle
stretch between them is cut at the span boundaries inside it and each
piece is labelled by the innermost span open there (``plan.step`` by its
plane, ``launch`` by the span around it), or ``outside any span``.

Printed: the frames' mean ``timings`` without and under the profiler
(what keeping the timeline costs), the device's busy and idle time
over the traced stretch, the idle time by label, and each span's count
and host time. ``--json PATH`` writes the same as one JSON object.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _label(recs, i) -> str:
    name, attrs = recs[i][0], recs[i][5]
    if name == "plan.step":
        return f"plan.step {attrs['plane']}"
    if name == "launch":
        parent = recs[i][3]
        return "launch in " + (_label(recs, parent) if parent is not None
                               else "no span")
    return name


def _segments(recs, lo: int, hi: int) -> list:
    """[(start, end, label)] covering [lo, hi]: the innermost span open in
    each stretch between consecutive span boundaries."""
    marks = []
    for i, r in enumerate(recs):
        if r[2] is None or r[2] <= lo or r[1] >= hi:
            continue
        marks.append((max(r[1], lo), 1, i))
        marks.append((min(r[2], hi), 0, i))
    # ends before starts at one instant; among starts, outer spans first
    marks.sort(key=lambda m: (m[0], m[1], m[2] if m[1] else -m[2]))
    out, stack, t = [], [], lo
    for when, is_start, i in marks:
        if when > t:
            out.append((t, when, _label(recs, stack[-1]) if stack
                        else "outside any span"))
            t = when
        if is_start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if hi > t:
        out.append((t, hi, _label(recs, stack[-1]) if stack
                    else "outside any span"))
    return out


def idle_by_span(busy: list, recs: list, lo: int, hi: int) -> dict:
    """Seconds of [lo, hi] outside the merged ``busy`` intervals, by the
    label of the innermost span (``_segments``)."""
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, min(s, hi)))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((prev, hi))
    idle = collections.Counter()
    segs = _segments(recs, lo, hi)
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, t, label = segs[k]
            idle[label] += (min(t, b) - max(s, a)) / 1e9
            k += 1
    return dict(idle.most_common())


def device_busy(prof) -> list:
    """Merged [start, end] ns of every device event of the session."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == cuda and e.duration_ns() > 0)
    merged = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--q", type=int, default=110)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    a = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    from aom_av1_psy_tpu_torch.utils import trace
    from aom_av1_psy_tpu_torch.utils.testframes import make_frame

    cuda = a.device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = EncoderConfig(base_q_idx=a.q)
    stills = [make_frame(a.width, a.height, seed=a.seed + i)
              for i in range(a.warmup + a.frames)]
    for f in stills[:a.warmup]:
        GpuFrameEncoder(f, cfg, device=a.device).encode()
    plain = []
    for f in stills[a.warmup:]:
        enc = GpuFrameEncoder(f, cfg, device=a.device)
        enc.encode()
        plain.append(enc.timings)
    sync()
    trace.clear()
    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    rows = []
    with profile(activities=[act]) as prof:
        lo = time.time_ns()
        for f in stills[a.warmup:]:
            enc = GpuFrameEncoder(f, cfg, device=a.device)
            enc.encode()
            rows.append(enc.timings)
        sync()
        hi = time.time_ns()
    recs = trace.records()
    trace.clear()
    busy = device_busy(prof)
    busy_s = sum(min(t, hi) - max(s, lo) for s, t in busy
                 if t > lo and s < hi) / 1e9
    idle = idle_by_span(busy, recs, lo, hi)
    spans = collections.defaultdict(lambda: [0, 0.0])
    for i, r in enumerate(recs):
        if r[2] is not None:
            row = spans[_label(recs, i) if r[0] == "plan.step" else r[0]]
            row[0] += 1
            row[1] += (r[2] - r[1]) / 1e9
    def mean(rows):
        return {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}

    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "size": [a.width, a.height], "frames": a.frames,
           "timings_mean_plain": mean(plain), "timings_mean": mean(rows),
           "stretch_s": (hi - lo) / 1e9, "busy_s": busy_s,
           "idle_s": (hi - lo) / 1e9 - busy_s, "idle_by_span_s": idle,
           "spans": {k: {"count": n, "host_s": s}
                     for k, (n, s) in sorted(spans.items())}}
    print(f"{out['device']}, {a.width}x{a.height}, {a.frames} KEY frames")
    for key, what in (("timings_mean_plain", "without the profiler"),
                      ("timings_mean", "under the profiler")):
        print(f"timings, mean a frame, {what}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in out[key].items()))
    print(f"traced stretch {out['stretch_s']:.4f} s, device busy "
          f"{busy_s:.4f} s, idle {out['idle_s']:.4f} s")
    print("device idle by innermost span (s, share of the idle time):")
    for k, v in idle.items():
        print(f"  {k:32s} {v:10.4f}  {100 * v / max(out['idle_s'], 1e-12):6.2f} %")
    print("spans (count, host s):")
    for k, v in out["spans"].items():
        print(f"  {k:32s} {v['count']:8d} {v['host_s']:10.4f}")
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
