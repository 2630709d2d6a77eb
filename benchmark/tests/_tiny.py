"""Shared by the benchmark's CPU tests: a tiny size at which a whole run
of a cell fits into a test, on the program's plain versions. The staged
cells (``benchmark/staged/``) are held as the listed ones are."""
from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("ai-720p-q110", "ra-720p-psy-q110")
TINY = {"traffic": {"width": 128, "height": 64}}


def run_tiny(cell_name: str, seed: int = 5, seconds: float = 1.0,
             trace: bool = False, fault=None, control: bool = False):
    import torch
    torch.set_num_threads(1)
    from benchmark.harness import spec
    from benchmark.harness.execute import execute
    cell = spec.cell(ROOT, cell_name, spec.with_staged(ROOT))
    return execute(ROOT, cell, seed, seconds, trace,
                   device="cpu", overrides=TINY, fault=fault,
                   control=control)
