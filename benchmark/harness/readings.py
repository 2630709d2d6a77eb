"""The readings that set a cell's limits, in one process: for each seed a
short window at the cell's own size, its compared numbers (the sound
readings) and the same numbers with the reference, one precision below,
in the program's place (the control); for each fault seed, the numbers of
a window with each fault of ``harness/faults.py`` planted. One JSON line a
reading; the benchmark's own runs do not run this. A staged cell
(``benchmark/staged/``) can be read too.

    python3 -m benchmark.harness.readings --workload <cell> --seconds 3 \
        --seeds 1 2 3 --fault-seeds 1 2 3
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def readings(cell_name: str, seconds: float, seeds, fault_seeds,
             device="cuda", overrides=None, root=ROOT):
    """Yield one dict a reading: seed, kind (sound, control or the
    fault's name), correct, and the numbers."""
    from . import spec
    from .execute import execute
    from .faults import FAULTS
    cell = spec.cell(root, cell_name, spec.with_staged(root))
    for seed in seeds:
        r = execute(root, cell, seed, seconds, False, device=device,
                    overrides=overrides, control=True)
        yield {"seed": seed, "kind": "sound", "correct": r["correct"],
               "numbers": {k: v["value"] for k, v in r["checks"].items()},
               "fps": r["metrics"]["fps"]["value"]}
        yield {"seed": seed, "kind": "control",
               "correct": all(v["value"] <= v["limit"]
                              for v in r["control_checks"].values()),
               "numbers": {k: v["value"]
                           for k, v in r["control_checks"].items()}}
    for seed in fault_seeds:
        for f in FAULTS:
            r = execute(root, cell, seed, seconds, False, device=device,
                        overrides=overrides, fault=f)
            yield {"seed": seed, "kind": f, "correct": r["correct"],
                   "numbers": {k: v["value"] for k, v in r["checks"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    for r in readings(a.workload, a.seconds, a.seeds, a.fault_seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
