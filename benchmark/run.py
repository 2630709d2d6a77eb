"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (``benchmark/configs/<name>.json``: the
encoder's settings and the driver, ``benchmark/drivers/<driver>.py``) and
a traffic mix (``benchmark/traffic/<name>.json``, made by the generator
of its kind, ``benchmark/generators/<kind>.py``);
``benchmark/workloads/<cell>.json`` holds the cell's check and trace
settings and the limits of its compared numbers.
Set-up makes the content from the seed on the card and warms up the
cell's shapes; the window measures for ``--seconds``; then the check
compares what the window produced with the plain references
(``benchmark/reference/``). With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``benchmark/metrics/<name>.py``), the device's busy time over a traced
stretch of the window and a breakdown.

The last line of standard output is the result (JSON); the numbers
compared, each beside its limit, are the last lines of standard error.
Without a CUDA card, or with fewer than the cell asks for, the run prints
no result and exits with 2; with a module of JAX or of the JAX package
loaded, with 3.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# no module of these top-level names may be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "aom_av1_psy_tpu", "bench")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its libraries into ``build/aom_av1_psy_tpu_torch``
    beside the package)."""
    cache = os.path.join(root, "build", "benchmark-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    import torch
    from benchmark.harness import spec
    cell = spec.cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: the cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness.execute import execute, report
    result = execute(ROOT, cell, args.seed, args.seconds, bool(args.trace),
                     device="cuda", t0=T0)
    bad = forbidden_modules()
    if bad:
        print("run.py: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
