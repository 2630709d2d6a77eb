#!/usr/bin/env python3
"""Two checkouts of the PyTorch + CUDA port on one card, in turns.

Times, for checkout A and checkout B, each turn a fresh process, in the
order A B B A (``--rounds`` times):
- the temporal filter at 1080p: ``filter_key_frame`` of the KEY span of
  ``encode_video(make_gop(1920, 1080, 5))`` (frames 0-2, q 40; host clock
  to a synchronize, median of 15 after a first), and under the profiler
  over one call KK's launches and device time (every KK kernel in the
  window), KJ's device time and the device kernels and copies by name;
  ``SpanGrid.motion_inputs`` for frame 0 of a 5-frame span (median of 25
  after a first; KJ's launches per call) beside the search alone (the
  padded frame, KJ's plane entry per block shape, the MVs in block order),
  so that the rest of the parent's ``motion_inputs`` (origins, MSEs,
  distance factors) is their difference; with ``--tf-only`` a turn stops
  here;
- the 1080p KEY frame's plan (untiled, two tile columns, the
  ``BLOCK_8X8`` uniform grid: a first frame, then the median of 3 steady
  frames, with KA's and KB's launches per frame);
- KN's ``sad`` at B = 8160 16x16 blocks (CUDA events, beside
  ``F.pairwise_distance(p=1)``) and KB's batched entry ``txq_recon_skip``
  at the 1080p P-frame's batches (bs 16 B = 8160, bs 32 B = 2040, bs 8
  B = 8160: CUDA events and the profiler's device time of KB's kernel);
- KJ's ``full_pel_grid_search`` at the 1980 full 32x32 blocks of a 1080p
  frame, radius 16, on 64x64 windows cut from the frame padded with 128
  (events and device time);
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
With ``--vmaf-only`` a turn times the tune_vmaf kernels instead, and
nothing else: at 1080p (``make_frame(1920, 1080)``'s luma and its blur),
under the profiler, KG's device time per call (uint8 with the moments, the
encoder's call), KI's at scale 0 and KI's and ``vif_down2``'s summed over
the four scales of ``vif_lite`` (with their launches per call); and the
walls of ``vif_lite(source, blur)`` (the source a numpy plane, the blur a
tensor on the card, as phase 5f of ``chip_smoke.py`` passes its recon) and
of ``frame_preprocessing(source)``, host clock to a synchronize, median of
25 after a first.
With ``--k13-only`` a turn times kernels KM and KP instead, and nothing
else, at the 1080p shapes of ``chip_smoke.py`` 3f / 3g: under the
profiler, KM's device time per call of ``subpel_refine49`` (B = 8160
16x16 blocks of frame 1 of ``make_gop(1920, 1080, 2)``, 25x25 windows of
frame 0 at random full-pel MVs) and KP's per call of ``analyze_plane``
on ``make_frame(1920, 1080)``'s luma padded to 1088 rows at n = 16, 32, 8
and 4 and its u plane padded to 544 rows at n = 8 (with the launches per
call); the walls of the 5i subpel chain (the checkout's own
``chip_smoke._subpel_chain``: KJ r16, KM, KL, KN, KO on the 16x16 grid)
and of ``analyze_plane`` at n = 16, and of 5j's six KP calls (the three
planes, ``batched_analyze_step`` whole and in halves), host clock to a
synchronize, median of 25 after a first; KL's device time per call of
``subpel_predict`` at B = 8160 16x16 (per-block random phases, regions of
frame 0) and at the luma's 120 whole 128x128 blocks (where the checkout's
KL takes them, else null); KQ's per call of ``calc_indices`` on a 4096
point int32 block, K = 8, dim 1 (5j's luma call): the wall per call with
the total on the host (median of 200 after a first), the device time
and the device kernels and copies per call (every device row of the
profiler); and the wall of 5j's whole analysis path (the checkout's own
``chip_smoke._analysis_path`` on ``_palette_tiles``' centroids, median of
7 after a first).
With ``--ko-km-only`` a turn times kernels KO and KM alone: under the
profiler, KO's device time per ``satd`` call on the 4 x 8160 int32 8x8
residuals of the 1080p 16x16 grid (frame 1 of ``make_gop(1920, 1080, 2)``
less frame 0 at random full-pel MVs), warm and with the L2 flushed before
each call (a 64 MB fill, its own time not counted), ``hadamard8x8`` on the
same blocks, ``satd`` on them as int16 and on the source blocks as uint8,
and the host microseconds per ``satd`` call (2000 calls enqueued, then one
wait); KM's device time per ``subpel_refine49`` call at B = 8160 16x16
(as ``--k13-only``) and at the luma's 8640 whole 12x20 blocks (null where
the checkout's KM does not take them); and the wall of the 5i subpel chain
(the checkout's own ``chip_smoke._subpel_chain``).
With ``--kr`` a turn times kernel KR alone, at the checkout's own
``chip_smoke.KR_TIMED`` shapes on a 1080p luma's blocks (its
``_kr_inputs``): ``fwd_txfm2d`` and ``inv_txfm2d_add`` at each shape and
the WHT pair at B = 130560, by CUDA events (``chip_smoke._median_ms``:
the median of 3 means of 20 calls after a first) and by the profiler's
device time of KR's kernels per call, warm and with the L2 flushed
before each call (``chip_smoke.cold_device_ms``: a 256 MB read, its own
time not counted), and at 16x16 the host
microseconds of a wrapper call (1000 calls enqueued, then one wait);
and the wall of phase 5l's path
(the checkout's own ``chip_smoke._transform_path`` over frame 1 of
``make_gop(1920, 1080, 2)`` against frame 0: 14 launches), host clock
to a synchronize, median of 25 after a first.
Only entry points that both checkouts have are timed. Both checkouts
build their kernels into their own ``build/`` at first use.

    python3 tools/port_turns.py PARENT_DIR CHANGE_DIR [--rounds 1]
        [--tf-only | --vmaf-only | --k13-only | --ko-km-only | --kr]

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

out = {"tree": sys.argv[1]}
from torch.profiler import ProfilerActivity, profile
from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
from aom_av1_psy_tpu_torch.ops import mvsearch as MV


def host_s(fn, n=25):
    # host clock to a synchronize: the median of n runs after a first
    walls = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls[1:])


def kernel_ms(fn, keys, iters=20):
    # the profiler's device time (ms) and launches per call of fn, of the
    # kernels whose name holds one of keys (either checkout's names); None
    # for both where the profiler recorded none of them (it drops a window
    # now and then), so that the medians leave the turn out
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(k in e.key for k in keys)]
    n = sum(e.count for e in rows)
    if n == 0:
        return None, None
    return sum(e.self_device_time_total for e in rows) / 1e3 / iters, \
        n / iters


def device_per_call(fn, iters=20):
    # every device row of the profiler (kernels, copies, fills): device ms
    # and rows per call
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sum(e.self_device_time_total for e in rows) / 1e3 / iters, \
        sum(e.count for e in rows) / iters


if sys.argv[2:] == ["vmaf"]:
    from aom_av1_psy_tpu_torch.encoder import tune_vmaf as TV
    y_np = testframes.make_frame(1920, 1080).planes()[0]
    y = torch.as_tensor(y_np, device="cuda")
    blur = TV.gaussian_blur(y)
    r, d = y.to(torch.float32), blur.to(torch.float32)
    out["kg_device_ms"], out["kg_launches"] = kernel_ms(
        lambda: TV.gaussian_blur(y, moments=True), ("::kg_",))
    out["ki_s0_device_ms"], _ = kernel_ms(lambda: TV.vif_scale_sums(r, d),
                                          ("::ki_",))
    out["vif_lite_ki_device_ms"], out["vif_lite_ki_launches"] = kernel_ms(
        lambda: TV.vif_lite(r, d), ("::ki_",), 10)
    out["vif_lite_down2_device_ms"], out["vif_lite_down2_launches"] = \
        kernel_ms(lambda: TV.vif_lite(r, d),
                  ("::kd_kernel(", "::vif_down2_kernel("), 10)
    out["vif_lite_s"] = host_s(lambda: TV.vif_lite(y_np, blur))
    out["frame_preprocessing_s"] = host_s(
        lambda: TV.frame_preprocessing(y_np, device="cuda"))
    print(json.dumps(out))
    sys.exit(0)


if sys.argv[2:] == ["kokm"]:
    import chip_smoke as CS
    gop2 = testframes.make_gop(1920, 1080, 2)
    y0, y1 = (CS._luma_1088(f, "cuda") for f in gop2)
    by, bx = CS._grid(16, "cuda")
    src = CS._cut(y1, by, bx, 16, 16)
    mvs = torch.as_tensor(np.random.default_rng(6).integers(
        -8, 9, (by.numel(), 2)).astype(np.int32), device="cuda")
    win = CS._cut(y0, by + mvs[:, 0] - 4, bx + mvs[:, 1] - 4, 25, 25)
    res = (src - win[:, 4:20, 4:20]).reshape(-1, 2, 8, 2, 8) \
        .transpose(2, 3).reshape(-1, 4, 8, 8)
    src8 = src.reshape(-1, 2, 8, 2, 8).transpose(2, 3) \
        .reshape(-1, 4, 8, 8).to(torch.uint8)
    res16 = res.to(torch.int16)
    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    out["ko_satd_device_ms"], out["ko_launches"] = kernel_ms(
        lambda: ME.satd(res), ("::ko_kernel",))
    out["ko_satd_l2_flushed_device_ms"], _ = kernel_ms(
        lambda: (flush.fill_(1), ME.satd(res)), ("::ko_kernel",))
    out["ko_transform_device_ms"], _ = kernel_ms(
        lambda: ME.hadamard8x8(res), ("::ko_kernel",))
    out["ko_satd_int16_device_ms"], _ = kernel_ms(
        lambda: ME.satd(res16), ("::ko_kernel",))
    out["ko_satd_uint8_device_ms"], _ = kernel_ms(
        lambda: ME.satd(src8), ("::ko_kernel",))
    ME.satd(res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        ME.satd(res)
    out["ko_host_us"] = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    out["km_device_ms"], out["km_launches"] = kernel_ms(
        lambda: MV.subpel_refine49(src, win), ("::km_kernel",))
    gy, gx = CS._whole_grid(y1, 20, 12)
    s12 = CS._cut(y1, gy, gx, 20, 12)
    w12 = CS._cut(y0, gy - 4, gx - 4, 29, 21)
    try:
        MV.subpel_refine49(s12, w12)
    except ValueError:   # the parent's KM takes powers of two only
        out["km12x20_device_ms"] = None
    else:
        out["km12x20_device_ms"], _ = kernel_ms(
            lambda: MV.subpel_refine49(s12, w12), ("::km_kernel",))
    out["chain_s"] = host_s(lambda: CS._subpel_chain(y0, y1))
    print(json.dumps(out))
    sys.exit(0)


if sys.argv[2:] == ["kr"]:
    import chip_smoke as CS
    from aom_av1_psy_tpu_torch.normative.enums import TX_HEIGHT, TX_WIDTH
    from aom_av1_psy_tpu_torch.ops import txfm as TX
    rng = np.random.default_rng(20)
    flush = torch.ones(64 << 20, dtype=torch.int32, device="cuda")

    def cold_ms(fn, name):
        # the profiler's device time per call with the L2 flushed before
        # each call by a 256 MB read (as chip_smoke.cold_device_ms; the
        # parent's chip_smoke has none)
        return CS.device_ms(lambda: (flush.sum(), fn()), 20, name)

    for ts, tt, label in CS.KR_TIMED:
        w, h = int(TX_WIDTH[ts]), int(TX_HEIGHT[ts])
        b = 1088 * 1920 // (w * h)
        res, _, pred = (x.to("cuda") for x in CS._kr_inputs(rng, b, w, h))
        coeff = TX.fwd_txfm2d(res, ts, tt)
        for d, fn in (("fwd", lambda: TX.fwd_txfm2d(res, ts, tt)),
                      ("inv", lambda: TX.inv_txfm2d_add(coeff, pred, ts,
                                                        tt))):
            key = f"kr_{w}x{h}_{d}"
            out[f"{key}_ms"] = CS._median_ms(fn, 20)
            out[f"{key}_device_ms"], out[f"{key}_launches"] = kernel_ms(
                fn, (f"kr_{d}",))
            out[f"{key}_cold_device_ms"] = cold_ms(fn, f"kr_{d}")
            if w == h == 16:    # the wrapper's host time: 1000 enqueued
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    fn()
                out[f"kr_{d}_host_us"] = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
    b = 130560
    res, coeff, pred = (torch.as_tensor(rng.integers(lo, hi, (b, 4, 4)),
                                        dtype=torch.int32, device="cuda")
                        for lo, hi in ((-255, 256), (-2**12, 2**12),
                                       (0, 256)))
    for d, fn in (("fwht", lambda: TX.fwht4x4(res)),
                  ("iwht", lambda: TX.iwht4x4_add(coeff, pred))):
        out[f"kr_{d}_ms"] = CS._median_ms(fn, 50)
        out[f"kr_{d}_device_ms"], _ = kernel_ms(fn, (f"kr_{d}",))
        out[f"kr_{d}_cold_device_ms"] = cold_ms(fn, f"kr_{d}")
    f0, f1 = testframes.make_gop(1920, 1080, 2)
    ref, src = CS._luma_1088(f0, "cuda"), CS._luma_1088(f1, "cuda")
    out["kr_path_s"] = host_s(lambda: CS._transform_path(src, ref))
    print(json.dumps(out))
    sys.exit(0)


if sys.argv[2:] == ["k13"]:
    # the checkout's own chip_smoke.py: the 5i chain and its cuts
    import chip_smoke as CS
    from aom_av1_psy_tpu_torch.ops import analyze as AN
    from aom_av1_psy_tpu_torch.ops.txfm import SQUARE_TX
    from aom_av1_psy_tpu_torch.parallel.mesh import batched_analyze_step

    gop2 = testframes.make_gop(1920, 1080, 2)
    y0, y1 = (CS._luma_1088(f, "cuda") for f in gop2)
    by, bx = CS._grid(16, "cuda")
    src = CS._cut(y1, by, bx, 16, 16)
    mvs = torch.as_tensor(np.random.default_rng(6).integers(
        -8, 9, (by.numel(), 2)).astype(np.int32), device="cuda")
    win = CS._cut(y0, by + mvs[:, 0] - 4, bx + mvs[:, 1] - 4, 25, 25)
    out["km_device_ms"], out["km_launches"] = kernel_ms(
        lambda: MV.subpel_refine49(src, win), ("::km_kernel",))
    out["chain_s"] = host_s(lambda: CS._subpel_chain(y0, y1))
    planes = testframes.make_frame(1920, 1080).planes()
    y = CS._pad_rows(planes[0], 1088, "cuda")
    u, v = (CS._pad_rows(p, 544, "cuda") for p in planes[1:])
    dq, aq = tables.dc_quant(100), tables.ac_quant(100)
    for tag, p, n in (("y16", y, 16), ("y32", y, 32), ("y8", y, 8),
                      ("u8", u, 8), ("y4", y, 4)):
        out[f"kp_{tag}_device_ms"], out[f"kp_{tag}_launches"] = kernel_ms(
            lambda: AN.analyze_plane(p, dq, aq, n, SQUARE_TX[n]),
            ("::kp_kernel",), 10)
    out["analyze_plane_s"] = host_s(
        lambda: AN.analyze_plane(y, dq, aq, 16, SQUARE_TX[16]))
    blocks, edges = AN.blockify(y, 16), AN._edges_from_source(y, 16)
    step = batched_analyze_step(16, 100, device="cuda")
    half = blocks.shape[0] // 2

    def kp_path():
        # 5j's KP calls: the three planes, the step whole and in halves
        for p, n in ((y, 16), (u, 8), (v, 8)):
            AN.analyze_plane(p, dq, aq, n, SQUARE_TX[n])
        for sl in (slice(None), slice(None, half), slice(half, None)):
            step(*(t[sl] for t in (blocks, *edges)))

    out["analysis_kp_s"] = host_s(kp_path)

    # KL at 3f's 16x16 shape and at the whole 128x128 blocks
    from aom_av1_psy_tpu_torch.ops import convolve as CV
    from aom_av1_psy_tpu_torch.ops import palette as PAL
    rng = np.random.default_rng(16)

    def t32(a):
        return torch.as_tensor(a.astype(np.int32), device="cuda")

    for tag, bs in (("kl16", 16), ("kl128", 128)):
        gy, gx = torch.meshgrid(torch.arange(0, 1088 - bs + 1, bs),
                                torch.arange(0, 1920 - bs + 1, bs),
                                indexing="ij")
        gy, gx = gy.reshape(-1).cuda(), gx.reshape(-1).cuda()
        B = gy.numel()
        d = t32(rng.integers(-3, 4, (2, B)))
        reg = CS._cut(y0, gy + d[0] - 3, gx + d[1] - 3, bs + 7, bs + 7)
        sx, sy = t32(rng.integers(0, 16, B)), t32(rng.integers(0, 16, B))
        try:
            CV.subpel_predict(reg, bs, bs, sx, sy)
        except ValueError:   # the parent's KL takes w, h <= 64
            out[f"{tag}_device_ms"] = out[f"{tag}_launches"] = None
            continue
        out[f"{tag}_device_ms"], out[f"{tag}_launches"] = kernel_ms(
            lambda: CV.subpel_predict(reg, bs, bs, sx, sy), ("::kl_kernel",))

    # KQ: 5j's luma call (int32 tile, int64 centroids from k_means)
    dq32 = t32(rng.integers(0, 256, (64, 64)))
    cq = torch.as_tensor(rng.integers(0, 256, 8), device="cuda")
    out["kq_call_ms"] = host_s(lambda: PAL.calc_indices(dq32, cq, 1),
                               200) * 1e3
    out["kq_device_ms"], out["kq_launches"] = kernel_ms(
        lambda: PAL.calc_indices(dq32, cq, 1), ("::kq_kernel",))
    out["kq_all_device_ms"], out["kq_device_ops_per_call"] = \
        device_per_call(lambda: PAL.calc_indices(dq32, cq, 1))

    # 5j's whole path
    tiles, cents, _ = CS._palette_tiles([y, u, v], "cuda")
    out["analysis_path_s"] = host_s(
        lambda: CS._analysis_path([y, u, v], tiles, cents), 7)
    print(json.dumps(out))
    sys.exit(0)


# the temporal filter: the 1080p KEY span of encode_video (filter_key_frame
# at q 100 - 60: frames 0-2, centre 0) and SpanGrid.motion_inputs for frame
# 0 of a 5-frame span (centre 2), split into the search alone (the padded
# frame, KJ's plane entry per block shape, the MVs in block order: what
# both checkouts run) and the rest
gop = testframes.make_gop(1920, 1080, 5)
planes = TF.upload([f.planes() for f in gop], "cuda")
grid = TF.SpanGrid(planes[2])


def tf_search(f):
    padded = grid.padded(f[0])
    mv = torch.empty((grid.B, 2), dtype=torch.int32, device="cuda")
    for hw, ids in grid.groups:
        mv[ids] = MV.full_pel_plane_search(grid.src[hw], padded,
                                           *grid.origins[hw], 16)[0]
    return mv


MV.KJ.reset()
out["tf_motion_s"] = host_s(lambda: grid.motion_inputs(planes[0]))
out["kj_launches_per_motion_inputs"] = MV.KJ.launches / 26
out["tf_search_s"] = host_s(lambda: tf_search(planes[0]))
key_tf = lambda: TF.filter_key_frame(gop, 0, 40, device="cuda")
out["tf_key_s"] = host_s(key_tf, 15)
TF.KK.reset()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    key_tf()
    torch.cuda.synchronize()
dev_rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
kk_rows = [e for e in dev_rows
           if "::kk_kernel(" in e.key or "::kk_span_kernel<" in e.key]
out["tf_key_kk_launches"] = TF.KK.launches
out["tf_key_kk_device_ms"] = sum(e.self_device_time_total
                                 for e in kk_rows) / 1e3
out["tf_key_kj_device_ms"] = sum(e.self_device_time_total for e in dev_rows
                                 if "::kj_kernel" in e.key) / 1e3
out["tf_key_device_ops"] = sum(e.count for e in dev_rows)
out["tf_key_device_ms"] = sum(e.self_device_time_total
                              for e in dev_rows) / 1e3
out["tf_key_ops_by_name"] = {e.key[:60]: e.count for e in sorted(
    dev_rows, key=lambda e: -e.count)[:16]}
if sys.argv[2:] == ["tf"]:
    print(json.dumps(out))
    sys.exit(0)

build_all((KA, KB, KC, ME.KN))
frame = testframes.make_frame(1920, 1080)
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

# KJ at the 1980 full 32x32 blocks of frame 0 of the span


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
    # ``_mv_ops`` is a module function where the walk is native (and then
    # off the encoder's path: it reads 0)
    owner = GpuInterFrameEncoder if hasattr(GpuInterFrameEncoder, m) else TIF
    setattr(owner, m, timed(m, getattr(owner, m)))
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
    parts = (["tf"] if "--tf-only" in sys.argv else
             ["vmaf"] if "--vmaf-only" in sys.argv else
             ["k13"] if "--k13-only" in sys.argv else
             ["kokm"] if "--ko-km-only" in sys.argv else
             ["kr"] if "--kr" in sys.argv else [])
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
            p = subprocess.run([sys.executable, "-c", CHILD, t, *parts],
                               cwd=t,
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
                  for k in ("untiled", "tiled", "bs8") if k in lines[0]
                  for m in ("plan_s", "frame_s", "ka_launches_per_frame",
                            "kb_launches_per_frame")}
        for k in ("tf_motion_s", "tf_search_s", "tf_key_s",
                  "tf_key_kk_launches", "tf_key_kk_device_ms",
                  "tf_key_kj_device_ms", "tf_key_device_ops",
                  "tf_key_device_ms", "kn_sad_ms", "pairwise_ms", "kj_ms",
                  "kj_device_ms", "kj_launches_per_motion_inputs", "kd_ms",
                  "kd_device_ms", "p_plan_s", "p_frame_s",
                  "kd_launches_per_p_frame", "ke_bw8_ms",
                  "ke_bw8_device_ms", "ke_bw16_ms", "ke_bw16_device_ms",
                  "kc_luma_ms", "kc_luma_device_ms", "kc_chroma_ms",
                  "kc_chroma_device_ms", "kc_key_frame_device_ms",
                  "kc_key_frame_launches", "key_frame_device_ops",
                  "kf_frame_ms", "kf_frame_device_ms",
                  "kf_frame_pass_device_ms", "p_pack_s", "p_cdef_host_ms",
                  "p_find_dir_ms", "p_lpf_host_ms", "p_script_ms",
                  "p_mv_ops_ms", "p_native_coder_ms", "kg_device_ms",
                  "kg_launches", "ki_s0_device_ms", "vif_lite_ki_device_ms",
                  "vif_lite_ki_launches", "vif_lite_down2_device_ms",
                  "vif_lite_down2_launches", "vif_lite_s",
                  "frame_preprocessing_s", "km_device_ms", "km_launches",
                  "chain_s", "analyze_plane_s", "analysis_kp_s",
                  "kl16_device_ms", "kl16_launches", "kl128_device_ms",
                  "kl128_launches", "kq_call_ms", "kq_device_ms",
                  "kq_launches", "kq_all_device_ms",
                  "kq_device_ops_per_call", "analysis_path_s",
                  "ko_satd_device_ms", "ko_launches",
                  "ko_satd_l2_flushed_device_ms", "ko_transform_device_ms",
                  "ko_satd_int16_device_ms", "ko_satd_uint8_device_ms",
                  "ko_host_us", "km12x20_device_ms") + tuple(
                f"kp_{t}_{m}" for t in ("y16", "y32", "y8", "u8", "y4")
                for m in ("device_ms", "launches")) + tuple(
                f"{k}_p_frame_{m}" for k in ("kd", "ke", "kc", "kf")
                for m in ("device_ms", "launches")) + tuple(
                f"kb_bs{bs}{m}" for bs in (16, 32, 8)
                for m in ("_ms", "_device_ms")) + tuple(
                k for k in lines[0] if k.startswith("kr_")):
            vals = [x[k] for x in lines if x.get(k) is not None]
            if vals:
                med[t][k] = statistics.median(vals)
    print(json.dumps({"medians": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
