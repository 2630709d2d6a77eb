"""The benchmark's files are found by name, and a new cell, configuration,
traffic mix, kind of content, metric or span point needs only new
files."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from _tiny import ROOT

sys.path.insert(0, ROOT)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _all():
    from benchmark.harness import spec
    return spec.with_staged(ROOT)


def test_every_named_file_is_found():
    from benchmark.harness import spec
    b = _all()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        spec.driver(conf["driver"])
    for w in b["workloads"]:
        cell = spec.cell(ROOT, w["name"], b)
        assert cell["traffic_file"]["kind"]
        assert cell["end_to_end"] and cell["per_layer"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    assert spec.span_points()


def test_every_file_is_named():
    """No cell, metric, driver, traffic mix or generator file lies
    unused by the listed and staged cells."""
    b = _all()
    here = os.path.join(ROOT, "benchmark")
    metrics = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    assert {f[:-3] for f in os.listdir(os.path.join(here, "metrics"))
            if f.endswith(".py")} == metrics
    assert {f[:-5] for f in os.listdir(os.path.join(here, "workloads"))} \
        == {w["name"] for w in b["workloads"]}
    drivers = {json.load(open(os.path.join(ROOT, c["file"])))["driver"]
               for c in b["configs"]}
    assert {f[:-3] for f in os.listdir(os.path.join(here, "drivers"))
            if f.endswith(".py")} == drivers
    mixes = {w["traffic"] for w in b["workloads"]}
    assert {f[:-5] for f in os.listdir(os.path.join(here, "traffic"))} \
        == mixes
    kinds = {json.load(open(os.path.join(here, "traffic", m + ".json")))
             ["kind"] for m in mixes}
    assert {f[:-3] for f in os.listdir(os.path.join(here, "generators"))
            if f.endswith(".py")} == kinds


def test_new_cell_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    b["workloads"].append({"name": "ai-360p-q110", "config": "ai-q110",
                           "traffic": "stills-360p", "chips": 1,
                           "why": "a new cell"})
    b["per_layer"].append({"name": "frames_per_window", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "stream driver", "moves": "fps",
                           "workloads": ["ai-360p-q110"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    t = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                    "stills-720p.json")))
    t.update(width=640, height=360)
    (tmp_path / "benchmark" / "traffic" / "stills-360p.json").write_text(
        json.dumps(t))
    (tmp_path / "benchmark" / "workloads" / "ai-360p-q110.json").write_text(
        (tmp_path / "benchmark" / "workloads" / "ai-720p-q110.json")
        .read_text())
    (tmp_path / "benchmark" / "metrics" / "frames_per_window.py").write_text(
        "def read(run):\n    return run.displayed\n")
    # a new kind of content: a generator file and a traffic mix naming it
    (tmp_path / "benchmark" / "generators" / "flat.py").write_text(
        "def make(t, seed, device, frame_type):\n"
        "    return [t['level'] + seed], [0]\n")
    (tmp_path / "benchmark" / "traffic" / "flat-1.json").write_text(
        json.dumps({"kind": "flat", "level": 3}))
    code = ("from benchmark.harness import spec, content; import os, json; "
            "c = spec.cell(os.getcwd(), 'ai-360p-q110'); "
            "print(c['traffic_file']['width'], "
            "[m['name'] for m in c['per_layer']], "
            "content.make(json.load(open('benchmark/traffic/flat-1.json')), "
            "4, 'cpu', None)[0][0], "
            "spec.metric_reader('frames_per_window').read("
            "type('R', (), {'displayed': 7})()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)},
                         capture_output=True, text=True, check=True).stdout
    assert out.split()[0] == "640"
    assert "frames_per_window" in out and out.strip().endswith("7 7")


def test_staged_cells_are_not_listed():
    from benchmark.harness import spec
    listed = {w["name"] for w in _bench()["workloads"]}
    staged = {w["name"] for w in _all()["workloads"]} - listed
    assert staged == {"ra-720p-psy-q110"}
    with pytest.raises(KeyError):
        spec.cell(ROOT, "ra-720p-psy-q110")


def test_unknown_names_raise():
    from benchmark.harness import spec
    with pytest.raises(KeyError):
        spec.cell(ROOT, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
