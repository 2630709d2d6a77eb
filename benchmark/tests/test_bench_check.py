"""A whole run of each cell at a tiny size on the CPU: sound runs are
correct, the control (the reference one precision below in the program's
place) is not, and each fault planted under the timed path turns
``correct`` false."""
import sys

import pytest

from _tiny import CELLS, ROOT, run_tiny

sys.path.insert(0, ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_and_control(cell):
    r = run_tiny(cell, control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"fps", "setup_s"}
    assert [k for k in r if not k.startswith("_")][-2:] == \
        ["control_checks", "checks"]
    ctl = r["control_checks"]
    assert any(v["value"] > v["limit"] for v in ctl.values()), ctl


@pytest.mark.parametrize("fault", ["stale", "half", "token"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    r = run_tiny(cell, fault=fault, seconds=1.5)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer(cell):
    r = run_tiny(cell, trace=True)
    assert r["correct"]
    assert "fps" not in r["metrics"]
    assert "launches_per_frame" in r["metrics"]
    assert r["device"]["window_s"] > 0
