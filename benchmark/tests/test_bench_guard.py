"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), the reference loads nothing of the program, and without
a card ``run.py`` exits non-zero and prints no result."""
import os
import subprocess
import sys

from _tiny import ROOT

sys.path.insert(0, ROOT)

SCAN = ("import sys; {body}; "
        "bad = sorted({{m.split('.')[0] for m in sys.modules}} & {names}); "
        "print('LOADED', bad)")


def _loaded(body, names):
    out = subprocess.run(
        [sys.executable, "-c", SCAN.format(body=body, names=names)],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": ROOT}).stdout
    return out.strip().splitlines()[-1]


def test_forbidden_names_compared_whole():
    from benchmark import run
    saved = dict(sys.modules)
    try:
        for m in ("aom_av1_psy_tpu_torch_x", "benchmark_y", "jaxy"):
            sys.modules[m] = object()
        assert not [m for m in run.forbidden_modules()
                    if m.startswith(("aom_av1_psy_tpu_torch", "benchmark",
                                     "jaxy"))]
        sys.modules["jaxlib.xla"] = object()
        sys.modules["aom_av1_psy_tpu.ops"] = object()
        assert {"jaxlib.xla", "aom_av1_psy_tpu.ops"} <= \
            set(run.forbidden_modules())
    finally:
        for m in set(sys.modules) - set(saved):
            del sys.modules[m]


def test_a_run_loads_no_jax():
    body = ("import torch; torch.set_num_threads(1); "
            "sys.path.insert(0, 'benchmark/tests'); from _tiny import run_tiny; "
            "[run_tiny(c, seconds=0.5, trace=True) "
            "for c in ('ai-720p-q110', 'ra-720p-psy-q110')]; "
            "import benchmark.harness.readings")
    names = {"jax", "jaxlib", "flax", "aom_av1_psy_tpu", "bench"}
    assert _loaded(body, names) == "LOADED []"


def test_reference_loads_nothing_of_the_program():
    body = ("import benchmark.reference.temporal_filter, "
            "benchmark.reference.av1.decoder.obu")
    names = {"aom_av1_psy_tpu_torch", "jax", "jaxlib", "aom_av1_psy_tpu",
             "bench"}
    assert _loaded(body, names) == "LOADED []"


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ai-720p-q110",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
