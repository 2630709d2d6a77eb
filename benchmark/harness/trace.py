"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
only (kernels, copies and sets as the device ran them; no CPU operator
events), over a bounded stretch of the window: from the window's start to
the end of the first unit (frame or chunk) that ends ``stretch_s`` or more
after it. The stretch ends with a synchronize.

From the events: the busy time (the union of every device interval), the
device time by kernel name, and the idle gaps, each labelled by the
innermost host span open at its midpoint (``harness`` where none is)."""
from __future__ import annotations

import bisect
import collections
import time


class Tracer:
    def __init__(self, enabled: bool, stretch_s: float, device="cuda"):
        self.enabled = enabled
        self.cuda = str(device).startswith("cuda")
        self.stretch_s = stretch_s
        self.active = False
        self.prof = None
        self.t0 = self.t1 = None
        self.t0_ns = self.t1_ns = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        # CPU activity only where there is no card (the tests): it has no
        # device events, so the device metrics stay silent there
        act = ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU
        self.prof = profile(activities=[act])
        self.prof.__enter__()
        self.active = True
        self.t0, self.t0_ns = time.perf_counter(), time.time_ns()
        self._sync = torch.cuda.synchronize if self.cuda else (lambda: None)

    def after_unit(self, last: bool = False) -> bool:
        """Call after each unit of the window; True while that unit was
        traced. Ends the stretch once it has lasted ``stretch_s``."""
        if not self.active:
            return False
        if last or time.perf_counter() - self.t0 >= self.stretch_s:
            self._sync()
            self.t1, self.t1_ns = time.perf_counter(), time.time_ns()
            self.prof.__exit__(None, None, None)
            self.active = False
        return True

    def summary(self, spans) -> dict | None:
        """busy_s, window_s, kernels {name: s}, the breakdown's lists."""
        if self.prof is None:
            return None
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        iv, by_name = [], collections.Counter()
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.duration_ns() <= 0:
                continue
            s = e.start_ns()
            iv.append((s, s + e.duration_ns()))
            by_name[e.name()] += e.duration_ns() / 1e9
        iv.sort()
        merged = []
        for s, t in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged) / 1e9
        lo, hi = self.t0_ns, self.t1_ns
        gaps, prev = [], lo
        for s, t in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if hi > prev:
            gaps.append((prev, hi))
        idle = collections.Counter()
        spans = sorted(spans, key=lambda x: x[1])
        starts = [sp[1] for sp in spans]
        for a, b in gaps:
            mid = (a + b) // 2
            label = "harness"
            # the latest-starting span still open at mid is the innermost
            for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if spans[k][2] > mid:
                    label = spans[k][0]
                    break
            idle[label] += (min(b, hi) - max(a, lo)) / 1e9
        return {"busy_s": busy, "window_s": self.t1 - self.t0,
                "kernels": dict(by_name),
                "device_ops": [[n[:160], s] for n, s in
                               by_name.most_common(10)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(10)],
                "events": len(iv)}
