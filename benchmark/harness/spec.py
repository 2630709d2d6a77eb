"""``BENCHMARK.json`` and the files it names, found by name: a cell's file
``benchmark/workloads/<cell>.json``, a configuration's ``file``, a traffic
mix ``benchmark/traffic/<name>.json``, the generator of its kind
``benchmark/generators/<kind>.py``, a driver
``benchmark/drivers/<name>.py``, a per-layer metric's reader
``benchmark/metrics/<name>.py`` and a span point
``benchmark/spans/<name>.json``. Adding any of them is adding a file.

A staged cell (``benchmark/staged/<cell>.json``) holds the
``BENCHMARK.json`` entries of a cell whose files are here but which
``BENCHMARK.json`` does not list yet; ``with_staged`` adds them, for the
tests and for readings on the chip."""
from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(kind: str, name: str, ext: str) -> str:
    path = os.path.join(HERE, kind, name + ext)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    return path


def benchmark(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _module(path: str, name: str):
    s = importlib.util.spec_from_file_location(name, path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def cell(root: str, name: str, bench: dict | None = None) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry (or ``bench``'s),
    its own file (``check``, ``trace``), its configuration and traffic,
    and the metrics it reports."""
    b = bench or benchmark(root)
    entry = {w["name"]: w for w in b["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    conf = {c["name"]: c for c in b["configs"]}[entry["config"]]
    out = dict(entry)
    out.update(_json(_file("workloads", name, ".json")))
    out["config_entry"] = conf
    out["config_file"] = _json(os.path.join(root, conf["file"]))
    out["traffic_file"] = _json(_file("traffic", entry["traffic"], ".json"))
    out["end_to_end"] = [m for m in b["end_to_end"]
                         if name in m.get("workloads", [name])]
    # every per-layer metric lists its cells
    out["per_layer"] = [m for m in b["per_layer"] if name in m["workloads"]]
    out["run_seconds"] = b["run_seconds"]
    return out


def driver(name: str):
    return _module(_file("drivers", name, ".py"), f"benchmark_driver_{name}")


def generator(kind: str):
    """The generator of traffic kind ``kind``: its ``make(t, seed, device,
    frame_type)`` returns (pool, order)."""
    return _module(_file("generators", kind, ".py"),
                   "benchmark_generator_" + kind)


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: its ``read(run)`` returns
    the metric's value, or None where the run has nothing to read."""
    return _module(_file("metrics", name, ".py"),
                   "benchmark_metric_" + name.replace(".", "_")
                   .replace("-", "_"))


def span_points() -> dict:
    """Every span point: name -> {"module", "attr"[, "class"]}."""
    return {os.path.basename(p)[:-5]: _json(p) for p in
            sorted(glob.glob(os.path.join(HERE, "spans", "*.json")))}


def with_staged(root: str) -> dict:
    """``BENCHMARK.json`` with every staged cell's entries added: its
    configuration, its cell, its own per-layer metrics, and the cell
    named in the ``workloads`` of the metrics it ``also_reports``."""
    b = benchmark(root)
    for p in sorted(glob.glob(os.path.join(HERE, "staged", "*.json"))):
        s = _json(p)
        b["configs"].append(s["config"])
        b["workloads"].append(s["workload"])
        for m in b["per_layer"]:
            if m["name"] in s["also_reports"]:
                m["workloads"] = m["workloads"] + [s["workload"]["name"]]
        b["per_layer"] += s["per_layer"]
    return b
