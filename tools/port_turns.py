#!/usr/bin/env python3
"""Two checkouts of the PyTorch + CUDA port on one card, in turns.

Times the 1080p KEY frame's plan (untiled, two tile columns, the
``BLOCK_8X8`` uniform grid: a first frame, then the median of 3 steady
frames, with KA's and KB's launches per frame), KN's ``sad`` at
B = 8160 16x16 blocks (CUDA events, beside
``F.pairwise_distance(p=1)``) and KB's batched entry ``txq_recon_skip``
at the 1080p P-frame's batches (bs 16 B = 8160, bs 32 B = 2040, bs 8
B = 8160: CUDA events and the profiler's device time of KB's kernel) for
checkout A and checkout B, each turn a fresh process, in the order
A B B A (``--rounds`` times). Both checkouts build their kernels into
their own ``build/`` at first use.

    python3 tools/port_turns.py PARENT_DIR CHANGE_DIR [--rounds 1]

Prints the card (name, power limit), one JSON line per turn, and the
medians per checkout as the last line. Needs a CUDA device.
"""
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
import numpy as np
import torch
import torch.nn.functional as F
sys.path.insert(0, sys.argv[1])
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TI
from aom_av1_psy_tpu_torch.encoder.tpu_frame import (EncoderConfig,
                                                     FrameContext,
                                                     GpuFrameEncoder)
from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.ops import txq as TQ
from aom_av1_psy_tpu_torch.kernels.build import build_all
from aom_av1_psy_tpu_torch.ops import metrics as ME
from aom_av1_psy_tpu_torch.ops.deblock_torch import KC
from aom_av1_psy_tpu_torch.ops.intra_pred import KA
from aom_av1_psy_tpu_torch.ops.txq import KB
from aom_av1_psy_tpu_torch.utils import testframes

build_all((KA, KB, KC, ME.KN))
frame = testframes.make_frame(1920, 1080)
out = {"tree": sys.argv[1]}
for name, cfg in (("untiled", EncoderConfig(base_q_idx=100)),
                  ("tiled", EncoderConfig(base_q_idx=100, tile_cols_log2=1)),
                  ("bs8", EncoderConfig(base_q_idx=100, block_size=3))):
    GpuFrameEncoder(frame, cfg, device="cuda").encode()
    torch.cuda.synchronize()
    KA.reset()
    KB.reset()
    plans, walls = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        enc = GpuFrameEncoder(frame, cfg, device="cuda")
        enc.encode()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        plans.append(enc.timings["plan_s"])
    out[name] = {"plan_s": statistics.median(plans),
                 "frame_s": statistics.median(walls),
                 "ka_launches_per_frame": KA.launches / 3,
                 "kb_launches_per_frame": KB.launches / 3}


def events_ms(fn, iters=50):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


rng = np.random.default_rng(0)
a, b = (torch.as_tensor(rng.integers(0, 256, (8160, 16, 16)).astype(
    np.int32), device="cuda") for _ in range(2))
af, bf = a.reshape(-1, 256).float(), b.reshape(-1, 256).float()
out["kn_sad_ms"] = events_ms(lambda: ME.sad(a, b))
out["pairwise_ms"] = events_ms(
    lambda: F.pairwise_distance(af, bf, p=1, eps=0.0))


def device_ms(fn, iters=20):
    # the profiler's device time per call of KB's kernels in fn
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    t = sum(e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "kb_" in e.key)
    return t / 1e3 / iters if t else None


rt = {k: tuple(torch.as_tensor(np.asarray(x, np.float32), device="cuda")
               for x in v)
      for k, v in TI._rate_tables(FrameContext(100)).items()}
for bs, B, key in ((16, 8160, "y16"), (32, 2040, "y32"), (8, 8160, "uv8")):
    src = rng.integers(0, 256, (B, bs, bs))
    pred = np.clip(src + rng.integers(-30, 31, (B, bs, bs)), 0, 255)
    a = (torch.as_tensor(src.astype(np.int32), device="cuda"),
         torch.as_tensor(pred.astype(np.int32), device="cuda"),
         tables.dc_quant(100), tables.ac_quant(100),
         TI._scan(TI.BS_TO_TX[bs], "cuda"),
         torch.as_tensor(rng.uniform(5e3, 6e4, B).astype(np.float32),
                         device="cuda"), *rt[key])
    out[f"kb_bs{bs}_ms"] = events_ms(lambda: TQ.txq_recon_skip(*a), 20)
    out[f"kb_bs{bs}_device_ms"] = device_ms(lambda: TQ.txq_recon_skip(*a))
print(json.dumps(out))
"""


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    rounds = 1
    if "--rounds" in sys.argv:
        rounds = int(sys.argv[sys.argv.index("--rounds") + 1])
        args.remove(str(rounds))
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in args]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    runs = {t: [] for t in trees}
    for _ in range(rounds):
        for t in (trees[0], trees[1], trees[1], trees[0]):
            p = subprocess.run([sys.executable, "-c", CHILD, t], cwd=t,
                               capture_output=True, text=True, timeout=900)
            if p.returncode != 0:
                print(p.stdout[-2000:], p.stderr[-4000:], file=sys.stderr)
                return p.returncode
            line = json.loads(p.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[t].append(line)
    med = {}
    for t, lines in runs.items():
        med[t] = {f"{k} {m}": statistics.median(x[k][m] for x in lines)
                  for k in ("untiled", "tiled", "bs8")
                  for m in ("plan_s", "frame_s", "ka_launches_per_frame",
                            "kb_launches_per_frame")}
        for k in ("kn_sad_ms", "pairwise_ms") + tuple(
                f"kb_bs{bs}{m}" for bs in (16, 32, 8)
                for m in ("_ms", "_device_ms")):
            vals = [x[k] for x in lines if x[k] is not None]
            med[t][k] = statistics.median(vals) if vals else None
    print(json.dumps({"medians": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
