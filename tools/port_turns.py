#!/usr/bin/env python3
"""Two checkouts of the PyTorch + CUDA port on one card, in turns.

Times, for checkout A and checkout B, each turn a fresh process, in the
order A B B A (``--rounds`` times):
- the 1080p KEY frame's plan (untiled, two tile columns, the
  ``BLOCK_8X8`` uniform grid: a first frame, then the median of 3 steady
  frames, with KA's and KB's launches per frame);
- KN's ``sad`` at B = 8160 16x16 blocks (CUDA events, beside
  ``F.pairwise_distance(p=1)``) and KB's batched entry ``txq_recon_skip``
  at the 1080p P-frame's batches (bs 16 B = 8160, bs 32 B = 2040, bs 8
  B = 8160: CUDA events and the profiler's device time of KB's kernel);
- KJ's ``full_pel_grid_search`` at the 1980 full 32x32 blocks of a 1080p
  frame, radius 16, on 64x64 windows cut from the frame padded with 128
  (events and device time), and the temporal filter's
  ``SpanGrid.motion_inputs`` for one 1080p frame of a 5-frame span (host
  clock to a synchronize, median of 25 after a first; KJ's launches per
  call);
- KD's ``mc_8tap`` at bw 16, K = 9, B = 8160, SAD only (events and device
  time);
- KE's ``fullpel_search`` at B = 8160, bw 16 with centres on the 1088x1920
  luma and bw 8 on its half-resolution plane, and KC's ``lpf_ladder`` at
  1088x1920 luma and 544x960 chroma, 6 levels with the source (events, and
  the device time of every kernel and memset in the profiled window: the
  two checkouts' kernels have other names);
- KF at the 1080p P-frame's planes and strengths (1, 1, 0, 1, 4):
  ``cdef_apply_fused`` with the directions given (events and the device
  time of every KF kernel), and where the checkout has it the frame pass
  ``cdef_frame`` with the search and the sources (device time);
- the 1080p P-frame: each P-frame of ``make_gop(1920, 1080, 5)`` at q100
  re-encoded alone from the GOP's chain, twice: the median ``plan_s``,
  ``pack_s`` and frame time, the pack's stages by wrappers around them
  (``apply_cdef_refs``, the host ``find_dir_blocks`` inside it, the LPF
  pick ``_lpf_device``, ``_pack_script`` and, inside it, the MV-reference
  walk ``_mv_ops`` and the native coder ``native_run_script``: the
  median over P-frames of each one's ms per P-frame), KD's
  launches per P-frame, and KD's, KE's, KC's and KF's launches and device
  time summed over one P-frame under the profiler;
- one untiled 1080p KEY frame under the profiler: KC's launches and device
  time, and the device kernels and copies of the frame.
Only entry points that both checkouts have are timed. Both checkouts
build their kernels into their own ``build/`` at first use.

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


def device_ms(fn, iters=20, name="kb_"):
    # the profiler's device time per call of the kernels named name in fn
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
            and name in e.key)
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

# KJ and the temporal filter's search inputs: frame 0 of a 1080p span
from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
from aom_av1_psy_tpu_torch.ops import mvsearch as MV
gop = testframes.make_gop(1920, 1080, 5)
planes = TF.upload([f.planes() for f in gop], "cuda")
grid = TF.SpanGrid(planes[2])


def cut(plane, r0, c0, h, w):
    ar_h = torch.arange(h, device=plane.device)
    ar_w = torch.arange(w, device=plane.device)
    return plane[(r0[:, None] + ar_h[None])[:, :, None],
                 (c0[:, None] + ar_w[None])[:, None, :]]


full = (grid.hs == 32) & (grid.ws == 32)
by, bx = grid.by[full], grid.bx[full]
padded = torch.full((1080 + 32, 1920 + 32), 128, dtype=torch.int32,
                    device="cuda")
padded[16:-16, 16:-16] = planes[0][0]
src = cut(planes[2][0], by, bx, 32, 32).contiguous()
win = cut(padded, by, bx, 64, 64).contiguous()
kj = lambda: MV.full_pel_grid_search(src, win, 16)
out["kj_ms"] = events_ms(kj, 20)
out["kj_device_ms"] = device_ms(kj, 20, "kj_kernel")
MV.KJ.reset()
walls = []
for _ in range(26):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid.motion_inputs(planes[0])
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
out["tf_motion_s"] = statistics.median(walls[1:])
out["kj_launches_per_motion_inputs"] = MV.KJ.launches / 26

# KD at the subpel step's shape
from aom_av1_psy_tpu_torch.encoder import tpu_inter as TIN
from aom_av1_psy_tpu_torch.ops import mc as MC
y = torch.zeros((1088, 1920), dtype=torch.int32, device="cuda")
y[:1080] = planes[1][0]
y[1080:] = y[1079]
K, B = 9, 8160
gy, gx = TIN._origins(B, 120, 16, "cuda")
qr = torch.as_tensor(rng.integers(-64, 65, (K, B)).astype(np.int32),
                     device="cuda")
qc = torch.as_tensor(rng.integers(-64, 65, (K, B)).astype(np.int32),
                     device="cuda")
kern = TIN._all_kernels("cuda")[torch.arange(K, device="cuda") % 3]
s16 = torch.as_tensor(rng.integers(0, 256, (B, 16, 16)).astype(np.int32),
                      device="cuda")
kd = lambda: MC.mc_8tap(y, gy, gx, qr, qc, 16, 1080, 1920, kern, src=s16,
                        want_pred=False)
out["kd_ms"] = events_ms(kd, 20)
out["kd_device_ms"] = device_ms(kd, 20, "kd_kernel")

# KE at the P-frame's two levels, KC at the KEY frame's planes
from aom_av1_psy_tpu_torch.ops import deblock_torch as DT
from aom_av1_psy_tpu_torch.ops import fullpel as FP
half = (y[0::2, 0::2] + y[1::2, 0::2] + y[0::2, 1::2] + y[1::2, 1::2]
        + 2) >> 2
for bw, plane, (ch, cw), cen in ((8, half, (540, 960), False),
                                 (16, y, (1080, 1920), True)):
    gy, gx = TIN._origins(B, 120, bw, "cuda")
    s_b = TIN._blocks(torch.roll(plane, (3, -5), (0, 1)), bw).contiguous()
    kw = {}
    if cen:
        kw = {k: torch.as_tensor(rng.integers(-32, 33, B).astype(np.int32),
                                 device="cuda") for k in ("cy", "cx")}
    ke = lambda: FP.fullpel_search(s_b, plane, gy, gx, ch, cw, bw, **kw)
    out[f"ke_bw{bw}_ms"] = events_ms(ke, 20)
    out[f"ke_bw{bw}_device_ms"] = device_ms(ke, 20, "")
cands = torch.tensor([0, 7, 12, 14, 16, 28], dtype=torch.int32,
                     device="cuda")
split16 = torch.as_tensor(rng.random((68, 120)) < .5, device="cuda")
for pl, (hb, wb, cell, luma, w, h) in zip(
        frame.planes(), ((1088, 1920, 16, True, 1920, 1080),
                         (544, 960, 8, False, 960, 540))):
    srcp = np.zeros((hb, wb), np.int32)
    srcp[:pl.shape[0], :pl.shape[1]] = pl
    recon = (srcp // 6) * 6 + rng.integers(0, 3, srcp.shape)
    a = (torch.as_tensor(recon.astype(np.int32), device="cuda"), split16,
         cands, torch.as_tensor(srcp, device="cuda"), w, h, cell, luma)
    kc = lambda: DT.lpf_ladder(*a)
    tag = "luma" if luma else "chroma"
    out[f"kc_{tag}_ms"] = events_ms(kc, 20)
    out[f"kc_{tag}_device_ms"] = device_ms(kc, 20, "")

# KF at the 1080p P-frame's planes: the frame with the directions given
# (both checkouts), and the frame pass with the search and the sources
from aom_av1_psy_tpu_torch.ops import cdef_torch as CT
from aom_av1_psy_tpu_torch.ops.cdef import find_dir_blocks
yb = y[:1080].cpu().numpy().reshape(135, 8, 240, 8).transpose(0, 2, 1, 3)
dirs, var = find_dir_blocks(yb.reshape(-1, 8, 8), 0)
dirs = torch.as_tensor(dirs.astype(np.int32), device="cuda")
var = torch.as_tensor(var.astype(np.int32), device="cuda")
skip8 = torch.as_tensor(rng.random((135, 240)) < .3, device="cuda")
uvp = torch.zeros((544, 960), dtype=torch.int32, device="cuda")
uvp[:540] = planes[1][1]
cplanes = (y, uvp, uvp.roll(5, 1).contiguous())
kf = lambda: CT.cdef_apply_fused(cplanes, skip8, dirs, var, 1, 1, 0, 1, 4,
                                 mi_rows=270, mi_cols=480, nplanes=3)
out["kf_frame_ms"] = events_ms(kf, 20)
out["kf_frame_device_ms"] = device_ms(kf, 20, "kf_")
out["kf_frame_pass_device_ms"] = None
if hasattr(CT, "cdef_frame"):
    srcs = [p.roll(3, 0).contiguous() for p in cplanes]
    kfs = lambda: CT.cdef_frame(cplanes, skip8, 1, 1, 0, 1, 4, mi_rows=270,
                                mi_cols=480, nplanes=3, srcs=srcs)
    out["kf_frame_pass_device_ms"] = device_ms(kfs, 20, "kf_")

# the 1080p P-frame, re-encoded alone from the GOP's chain; the pack's
# stages timed by wrappers around the functions (the same in both
# checkouts), summed per P-frame
import collections
from aom_av1_psy_tpu_torch.encoder import tpu_interframe as TIF
from aom_av1_psy_tpu_torch.ops import cdef as HCD
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
    GpuInterFrameEncoder, _ref_chain_planes, encode_video)
cfg = EncoderConfig(base_q_idx=100)
_, encs = encode_video(gop, cfg, device="cuda")
torch.cuda.synchronize()
STAGES = ("cdef", "find_dir", "_lpf_device", "_pack_script", "_mv_ops",
          "native_run_script")
stage_s = collections.defaultdict(list)
frame_s = collections.Counter()


def timed(name, fn):
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        frame_s[name] += time.perf_counter() - t0
        return r
    return wrapper


TIF.apply_cdef_refs = timed("cdef", TIF.apply_cdef_refs)
TIF.native_run_script = timed("native_run_script", TIF.native_run_script)
HCD.find_dir_blocks = timed("find_dir", HCD.find_dir_blocks)
for m in ("_lpf_device", "_pack_script", "_mv_ops"):
    setattr(GpuInterFrameEncoder, m,
            timed(m, getattr(GpuInterFrameEncoder, m)))
MC.KD.reset()
plans, packs, walls = [], [], []
for _ in range(2):
    for i in range(1, len(gop)):
        prev = encs[i - 1]
        t0 = time.perf_counter()
        enc = GpuInterFrameEncoder(gop[i], encs[i].cfg, prev.seq,
                                   _ref_chain_planes(prev), 1920, 1080,
                                   prev_fc=prev.saved_fc, device="cuda")
        enc.encode()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        plans.append(enc.timings["plan_s"])
        packs.append(enc.timings["pack_s"])
        for name in STAGES:
            stage_s[name].append(frame_s[name])
        frame_s.clear()
out["p_plan_s"] = statistics.median(plans)
out["p_pack_s"] = statistics.median(packs)
out["p_frame_s"] = statistics.median(walls)
out["kd_launches_per_p_frame"] = MC.KD.launches / len(plans)
for name, key in (("cdef", "p_cdef_host_ms"), ("find_dir", "p_find_dir_ms"),
                  ("_lpf_device", "p_lpf_host_ms"),
                  ("_pack_script", "p_script_ms"),
                  ("_mv_ops", "p_mv_ops_ms"),
                  ("native_run_script", "p_native_coder_ms")):
    out[key] = 1e3 * statistics.median(stage_s[name])
# KD's device time summed over one P-frame, under the profiler
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    GpuInterFrameEncoder(gop[2], encs[2].cfg, encs[1].seq,
                         _ref_chain_planes(encs[1]), 1920, 1080,
                         prev_fc=encs[1].saved_fc, device="cuda").encode()
    torch.cuda.synchronize()
# the kernels by name in either checkout
NAMES = {"kf": ("::kf_kernel(", "::kf_tile_kernel("),
         "kd": ("::kd_kernel<",),
         "ke": ("::ke_kernel<", "::ke_strip_kernel<"),
         "kc": ("::copy_kernel(", "::edge_kernel<", "::sse_kernel(",
                "::kc_tile_kernel<")}


def by_name(prof, key):
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(n in e.key for n in NAMES[key])]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


for k in ("kd", "ke", "kc", "kf"):
    out[f"{k}_p_frame_device_ms"], out[f"{k}_p_frame_launches"] = \
        by_name(prof, k)
# one untiled KEY frame under the profiler
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    GpuFrameEncoder(frame, EncoderConfig(base_q_idx=100),
                    device="cuda").encode()
    torch.cuda.synchronize()
out["kc_key_frame_device_ms"], out["kc_key_frame_launches"] = \
    by_name(prof, "kc")
out["key_frame_device_ops"] = sum(
    e.count for e in prof.key_averages()
    if e.device_type == torch.autograd.DeviceType.CUDA
    and e.self_device_time_total > 0)
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
        for k in ("kn_sad_ms", "pairwise_ms", "kj_ms", "kj_device_ms",
                  "tf_motion_s", "kj_launches_per_motion_inputs", "kd_ms",
                  "kd_device_ms", "p_plan_s", "p_frame_s",
                  "kd_launches_per_p_frame", "ke_bw8_ms",
                  "ke_bw8_device_ms", "ke_bw16_ms", "ke_bw16_device_ms",
                  "kc_luma_ms", "kc_luma_device_ms", "kc_chroma_ms",
                  "kc_chroma_device_ms", "kc_key_frame_device_ms",
                  "kc_key_frame_launches", "key_frame_device_ops",
                  "kf_frame_ms", "kf_frame_device_ms",
                  "kf_frame_pass_device_ms", "p_pack_s", "p_cdef_host_ms",
                  "p_find_dir_ms", "p_lpf_host_ms", "p_script_ms",
                  "p_mv_ops_ms", "p_native_coder_ms") + tuple(
                f"{k}_p_frame_{m}" for k in ("kd", "ke", "kc", "kf")
                for m in ("device_ms", "launches")) + tuple(
                f"kb_bs{bs}{m}" for bs in (16, 32, 8)
                for m in ("_ms", "_device_ms")):
            vals = [x[k] for x in lines if x[k] is not None]
            med[t][k] = statistics.median(vals) if vals else None
    print(json.dumps({"medians": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
