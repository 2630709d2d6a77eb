"""One run of a cell: set-up, the measured window, the check, the
metrics. ``execute`` takes the device as an argument so that the tests
can drive a whole run on the CPU with the program's plain versions; the
benchmark's own runs give it the card (``run.py`` looks for it first)."""
from __future__ import annotations

import copy
import json
import sys
import time

from . import content, host, spec
from .check import Numbers
from .spans import Spans
from .trace import Tracer

PROGRAM = "aom_av1_psy_tpu_torch"


class Run:
    """What a run gathers. The per-layer readers get it: ``frames`` (one
    record per coded frame: ``type`` key / arf / inter, the program's
    ``plan_s``, ``pack_s``, ``script_s``, ``tf_s``, the harness's
    ``latency_s``, and ``traced`` when it lay in the traced stretch),
    ``displayed``, ``launches``, ``window_s``, ``setup_s``, ``trace`` (the
    traced stretch's summary, ``harness/trace.py``) and ``traffic``."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, overrides: dict | None):
        o = overrides or {}
        self.cell = cell
        self.config = cell["config_file"]
        self.traffic = {**cell["traffic_file"], **o.get("traffic", {})}
        self.check_cfg = {**cell["check"], **o.get("check", {})}
        self.seed, self.seconds = seed, seconds
        self.device = device
        self.frames = []
        self.displayed = self.attempted = self.failed = 0
        self.errors = []
        self.spans = Spans()
        self.tracer = Tracer(trace, cell["trace"]["stretch_s"], device)
        self.t_start = self.t_end = None
        self.launches = 0
        self.coded_bytes = 0     # the window's packets: a measure of its work
        self.trace = None
        self.program = {}        # filled by the driver: faults patch these

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start


def program_kernels() -> list:
    """Every ``CudaKernel`` object of the loaded program modules."""
    build = sys.modules.get(PROGRAM + ".kernels.build")
    if build is None:
        return []
    seen, out = set(), []
    for name, m in list(sys.modules.items()):
        if name.split(".")[0] != PROGRAM or m is None:
            continue
        for v in vars(m).values():
            if isinstance(v, build.CudaKernel) and id(v) not in seen:
                seen.add(id(v))
                out.append(v)
    return out


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _context(device) -> None:
    """The CUDA context: the first allocation and kernel on the card."""
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.init()
        torch.ones(1, device=device).add_(1)


def _libraries(device) -> None:
    """Load every library of the loaded program modules (nvcc builds a
    stale one first, all at once) and the native range coder (g++)."""
    from aom_av1_psy_tpu_torch.native import get_lib
    get_lib()
    if str(device).startswith("cuda"):
        from aom_av1_psy_tpu_torch.kernels.build import build_all
        build_all(program_kernels())


def _content(run) -> None:
    from aom_av1_psy_tpu_torch.utils.frame import Frame
    run.pool, run.order = content.make(run.traffic, run.seed, run.device,
                                       Frame)


def execute(root: str, cell: dict, seed: int, seconds: float, trace: bool,
            device="cuda", t0: float | None = None,
            overrides: dict | None = None, fault: str | None = None,
            control: bool = False) -> dict:
    """Run ``cell`` once; the result line's fields, with ``checks`` (the
    compared numbers and their limits) last. ``fault`` plants a fault of
    ``harness/faults.py`` under the timed path (the driver's ``plant``);
    ``control`` adds ``control_checks``: the numbers with the reference,
    one precision below, in the program's place (the readings that set
    the limits). ``host`` holds the host's readings (``harness/host.py``)."""
    import torch
    t0 = time.perf_counter() if t0 is None else t0
    split = {"import_s": time.perf_counter() - t0}
    run = Run(cell, seed, seconds, trace, device, overrides)
    drv = spec.driver(run.config["driver"])

    def phase(name, fn, *a):
        t = time.perf_counter()
        fn(*a)
        _sync(device)
        split[name] = time.perf_counter() - t

    phase("program_import_s", drv.load, run)
    phase("context_s", _context, device)
    phase("libraries_s", _libraries, device)
    phase("content_s", _content, run)
    phase("warmup_s", drv.warmup, run)
    run.setup_split = split
    if fault:
        drv.plant(run, fault)
    if trace:
        run.spans.install()
    kernels = program_kernels()
    before = {id(k): k.launches for k in kernels}
    readings = host.Window()
    readings.start()
    drv.window(run)
    _sync(device)
    host_info = readings.stop()
    run.launches = sum(k.launches - before[id(k)] for k in kernels)
    run.setup_s = run.t_start - t0
    cuda = str(device).startswith("cuda")
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        run.spans.remove()
        run.trace = run.tracer.summary(run.spans.items)
    numbers = Numbers(run.check_cfg["limits"])
    drv.check(run, numbers)
    if control:
        ctl = Numbers(run.check_cfg["limits"])
        drv.check(run, ctl, control=True)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = spec.metric_reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(mem)}
    result = {"correct": bool(numbers.ok() and run.failed == 0
                              and run.attempted > 0),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["errors"] = run.errors[:5]
    result["setup_split"] = split
    result["host"] = {**host_info, "coded_bytes": run.coded_bytes}
    if control:
        result["control_checks"] = ctl.as_dict()
    result["checks"] = numbers.as_dict()
    result["_lines"] = [
        "setup " + " ".join(f"{k} {v:.3f}" for k, v in split.items()),
        "host " + json.dumps(host_info, sort_keys=True),
        "window " + _quarters(run)] + numbers.lines() + [
        f"check frames_failed {run.failed} limit 0 "
        f"{'ok' if run.failed == 0 else 'FAIL'}"]
    return result


def _quarters(run) -> str:
    """Coded frames completed in each quarter of the window, a view of
    how steady it ran."""
    q = [0, 0, 0, 0]
    for f in run.frames:
        q[min(3, int(4 * f["done_s"] / run.window_s))] += 1
    return (f"{run.window_s:.3f} s, {run.displayed} displayed frames, "
            f"{run.coded_bytes} coded bytes; coded frames by quarter {q}")


def report(result: dict) -> None:
    """Print the result line (last on standard output) and the compared
    numbers beside their limits (last on standard error)."""
    r = copy.copy(result)
    lines = r.pop("_lines")
    print(json.dumps(r), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
