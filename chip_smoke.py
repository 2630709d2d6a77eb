#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``aom_av1_psy_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each prints a line with its seconds; any failure raises and the
exit code is not 0):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the six hand-written kernels from ``csrc/`` with nvcc (sm_90a), one
   nvcc process per source, all started together;
3. KA / KB / KC against their plain PyTorch versions on the card, at the
   shapes the 1080p KEY frame gives them, for exact equality, with both
   times (CUDA events);
3b. KD / KE / KF, and KB at the P-frame's batch sizes, against their plain
   versions at the 1080p P-frame's shapes, for exact equality, with both
   times;
4. closed loop at CIF (352x288), KEY frame: the CUDA stream equals the
   port's CPU (plain-path) stream byte for byte, and the in-repo decoder
   reconstructs the port's post-loop-filter planes exactly;
4b. closed loop at CIF, a 4-frame IPPP GOP (``encode_video``, CDEF on): the
   CUDA packets equal the CPU plain-path packets and every frame decodes to
   the port's post-LPF, post-CDEF reference chain;
5. the KEY path: ``GpuFrameEncoder.encode()`` of ``bench.make_frame(1920,
   1080)`` at ``base_q_idx=100`` — a first frame and 3 steady frames — with
   the launch counts read around that run;
5b. the main path of the slice: ``encode_video(bench.make_gop(1920, 1080,
   5), EncoderConfig(base_q_idx=100))`` twice (the first run warms up), the
   counts set to 0 just before the second and read just after; per-frame
   bytes, times and filter strengths; each P-frame re-encoded alone from
   the GOP's chain for its wall time; the whole GOP on the CPU plain path
   must give the same packets;
6. / 6b. a profiler window over one steady 1080p KEY frame and one steady
   1080p P-frame (device busy time by kernel).

``--only-kernels`` stops after phase 3b. The second-to-last line is
``{"kernels": [...]}`` (``launches`` from the GOP of phase 5b), the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def log(msg):
    print(msg, flush=True)


def cuda_time(fn, iters):
    """Mean milliseconds per call of fn on the current stream."""
    import torch
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


def max_abs_err(a, b):
    import torch
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def compare(name, got, want):
    """Exact equality of two (tuples of) tensors; returns the max error."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        err = max(err, max_abs_err(g, w))
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from plain, max abs "
                             f"err {err}")
    return err


def check_kernels(dev):
    """Phase 3: kernel vs plain version at the 1080p encode's shapes."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.encoder import tpu_intra as TI
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import FrameContext, tables
    from aom_av1_psy_tpu_torch.ops import deblock_torch as DT
    from aom_av1_psy_tpu_torch.ops import intra_pred as IP
    from aom_av1_psy_tpu_torch.ops import txq as TQ

    rng = np.random.default_rng(SEED)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    K = 61
    results = []

    # ---- KA: luma 32/16 (B=34, K=61), chroma 16/8 (B=2*34, K=7) ----
    err, times = 0.0, None
    for bs, B, k in ((32, 34, K), (16, 34, K), (16, 68, 7), (8, 68, 7)):
        above, left = t(rng.integers(0, 256, (B, bs))), \
            t(rng.integers(0, 256, (B, bs)))
        tl = t(rng.integers(0, 256, B))
        ha, hl = t(rng.random(B) < .8, torch.bool), \
            t(rng.random(B) < .8, torch.bool)
        src = t(rng.integers(0, 256, (B, bs, bs)))
        ext = {}
        if k == K:
            ext = dict(trreal=t(rng.random(B) < .5, torch.bool),
                       blreal=t(rng.random(B) < .5, torch.bool),
                       abext=t(rng.integers(0, 256, (B, bs))),
                       lfext=t(rng.integers(0, 256, (B, bs))),
                       ef=t(rng.random(B) < .5, torch.bool))
        cand = t(rng.integers(0, k, B))
        args = (above, left, tl, ha, hl)
        err = max(err, compare(
            f"KA sse bs{bs}", IP.intra_pred_sse(*args, src, k, **ext),
            IP.intra_pred_sse_plain(*args, src, k, **ext)))
        err = max(err, compare(
            f"KA one bs{bs}", IP.intra_pred_one(*args, cand, k, **ext),
            IP.intra_pred_one_plain(*args, cand, k, **ext)))
        if bs == 32:
            times = (cuda_time(lambda: IP.intra_pred_sse(*args, src, k, **ext),
                               50),
                     cuda_time(lambda: IP.intra_pred_sse_plain(
                         *args, src, k, **ext), 10))
    results.append({"name": "intra_pred_sse", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/intra_pred.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra_dir.py:241",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "timed_at": "bs32 B=34 K=61 (SSE of all candidates)"})
    log(f"[3] KA intra_pred_sse exact at bs 32/16 (K=61) and 16/8 (K=7); "
        f"bs32 B=34: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms")

    # ---- KB: luma 32/16 DCT (B=34), chroma 16/8 with ADST (B=68) ----
    fc = FrameContext(100)
    rt = {k: tuple(t(x, torch.float32) for x in v)
          for k, v in TI._rate_tables(fc).items()}
    dc_q, ac_q = tables.dc_quant(100), tables.ac_quant(100)
    err, times = 0.0, None
    for bs, B, key, adst in ((32, 34, "y32", False), (16, 34, "y16", False),
                             (16, 68, "uv16", True), (8, 68, "uv8", True)):
        src = t(rng.integers(0, 256, (B, bs, bs)))
        pred = t(np.clip(np.asarray(src.cpu()) + rng.integers(
            -40, 41, (B, bs, bs)), 0, 255))
        pred[: B // 4] = t(rng.integers(0, 256, (B // 4, bs, bs)))  # +-255
        rdm = t(rng.uniform(5e3, 6e4, B), torch.float32)
        scan = TI._scan(TI.BS_TO_TX[bs], str(dev))
        flags = {}
        if adst:
            flags = dict(vadst=t(rng.random(B) < .5, torch.bool),
                         hadst=t(rng.random(B) < .5, torch.bool))
        a = (src, pred, dc_q, ac_q, scan, rdm, *rt[key])
        err = max(err, compare(f"KB bs{bs}", TQ.txq_recon_skip(*a, **flags),
                               TQ.txq_recon_skip_plain(*a, **flags)))
        if bs == 32:
            times = (cuda_time(lambda: TQ.txq_recon_skip(*a), 50),
                     cuda_time(lambda: TQ.txq_recon_skip_plain(*a), 10))
    results.append({"name": "txq_recon_skip", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/txq.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra.py:157",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "timed_at": "bs32 B=34 DCT"})
    log(f"[3] KB txq_recon_skip exact at 32/16 (DCT) and 16/8 (ADST mix); "
        f"bs32 B=34: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms")

    # ---- KC: 1080p luma 1088x1920 and chroma 544x960, 6 levels ----
    import bench
    frame = bench.make_frame(1920, 1080, seed=SEED)
    g = 14
    cands = t([0, g // 2, g - 2, g, g + 2, 2 * g])
    split16 = t(rng.random((68, 120)) < .5, torch.bool)
    err, times = 0.0, None
    for pl, (hb, wb, cell, luma, w, h) in zip(
            frame.planes(), ((1088, 1920, 16, True, 1920, 1080),
                             (544, 960, 8, False, 960, 540))):
        src = np.zeros((hb, wb), np.int32)
        src[:pl.shape[0], :pl.shape[1]] = pl
        recon = (src // 6) * 6 + rng.integers(0, 3, src.shape)  # blocky
        a = (t(recon), split16, cands, t(src), w, h, cell, luma)
        err = max(err, compare(f"KC {'luma' if luma else 'chroma'}",
                               DT.lpf_ladder(*a), DT.lpf_ladder_plain(*a)))
        if luma:
            times = (cuda_time(lambda: DT.lpf_ladder(*a), 20),
                     cuda_time(lambda: DT.lpf_ladder_plain(*a), 3))
    results.append({"name": "lpf_ladder", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/deblock.cu",
                    "replaces": "aom_av1_psy_tpu/ops/deblock_jax.py:183",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "timed_at": "luma 1088x1920, 6 levels"})
    log(f"[3] KC lpf_ladder exact at 1088x1920 luma and 544x960 chroma, 6 "
        f"levels; luma: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms")
    return results


def closed_loop_cif(dev):
    """Phase 4: CUDA stream == CPU plain-path stream; decoder == recon."""
    import numpy as np
    import bench
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (Av1Decoder,
                                                         EncoderConfig,
                                                         GpuFrameEncoder)
    frame = bench.make_frame(352, 288, seed=SEED)
    cfg = EncoderConfig(base_q_idx=100)
    gpu = GpuFrameEncoder(frame, cfg, device=dev)
    pkt = gpu.encode()
    t0 = time.perf_counter()
    cpu_pkt = GpuFrameEncoder(frame, cfg, device="cpu").encode()
    cpu_s = time.perf_counter() - t0
    if pkt != cpu_pkt:
        raise AssertionError(f"CIF: CUDA stream ({len(pkt)} B) differs from "
                             f"the plain CPU stream ({len(cpu_pkt)} B)")
    dec = Av1Decoder().decode_packet(pkt)[0]
    for name, d, r in zip("yuv", dec.planes(), gpu.ref_planes_dev):
        r = r.cpu().numpy()[: d.shape[0], : d.shape[1]]
        if not np.array_equal(d.astype(np.int32), r):
            raise AssertionError(f"CIF: decoded {name} differs from the "
                                 f"post-LPF recon")
    log(f"[4] CIF 352x288 q100: {len(pkt)} bytes, CUDA == CPU plain stream "
        f"(CPU plain encode {cpu_s:.2f} s), decoder == post-LPF recon")


def main_path(dev, kernels):
    """Phase 5: the 1080p KEY encode; launch counts around it."""
    import numpy as np
    import torch
    import bench
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (EncoderConfig,
                                                         GpuFrameEncoder)
    frame = bench.make_frame(1920, 1080)
    cfg = EncoderConfig(base_q_idx=100)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    enc = GpuFrameEncoder(frame, cfg, device=dev)
    pkt = enc.encode()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times, plans, packs = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        enc = GpuFrameEncoder(frame, cfg, device=dev)
        p = enc.encode()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        plans.append(enc.timings["plan_s"])
        packs.append(enc.timings["pack_s"])
        if p != pkt:
            raise AssertionError("1080p: steady frame differs from the first")
    counts = {k.name: k.launches for k in kernels}
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 "path")
    for pl, want in zip(enc.ref_planes_dev, ((1088, 1920), (544, 960),
                                             (544, 960))):
        if tuple(pl.shape) != want or pl.dtype != torch.int32:
            raise AssertionError(f"1080p recon plane {tuple(pl.shape)}")
        a = pl.cpu().numpy()
        if a.min() < 0 or a.max() > 255:
            raise AssertionError("1080p recon outside 8-bit range")
    src = np.asarray(frame.planes()[0], np.float64)
    mse = float(((enc.ref_planes_dev[0].cpu().numpy()[:1080, :1920]
                  - src) ** 2).mean())
    psnr = 10 * np.log10(255 ** 2 / max(mse, 1e-9))
    if not (pkt[:2] == bytes([0x12, 0x00]) and psnr > 30):
        raise AssertionError(f"1080p: bad stream or recon (PSNR {psnr:.2f})")
    t0 = time.perf_counter()
    if GpuFrameEncoder(frame, cfg, device="cpu").encode() != pkt:
        raise AssertionError("1080p: CUDA stream differs from the plain CPU "
                             "stream")
    cpu_s = time.perf_counter() - t0
    med = statistics.median(times)
    log(f"[5] 1080p q100: {len(pkt)} bytes, luma PSNR {psnr:.3f} dB, first "
        f"frame {first_s:.3f} s, steady median {med:.4f} s/frame "
        f"({1 / med:.3f} fps, min {min(times):.4f}, max {max(times):.4f}), "
        f"plan {statistics.median(plans):.4f} s, pack+lpf "
        f"{statistics.median(packs):.4f} s, lf {enc.fh.lf.filter_level} "
        f"{enc.fh.lf.filter_level_u} {enc.fh.lf.filter_level_v}; CUDA == "
        f"CPU plain stream (CPU encode {cpu_s:.1f} s)")
    log(f"[5] launches on the main path: {json.dumps(counts)}")
    return counts, frame, cfg


def _device_rows(tag, prof, wall, extra=""):
    """Device busy share and the top device-side rows of a profile."""
    import torch
    # device-side events only (kernels, copies): an operator's own row
    # repeats the time of the kernels it launched
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        log(f"[{tag}] profiler shows no device time: busy share not "
            "measured")
        return
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[{tag}] one steady frame under the profiler: wall {wall:.4f} s, "
        f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
        f"{sum(r[1] for r in rows)} device kernels and copies"
        + (f"; {extra}" if extra else ""))
    for dt, n, key in rows[:12]:
        log(f"[{tag}]   {dt / 1e3:10.3f} ms  x{n:<6d} {key[:90]}")


def profile_frame(dev, frame, cfg):
    """Phase 6: device time by kernel over one steady 1080p KEY frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        GpuFrameEncoder(frame, cfg, device=dev).encode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _device_rows("6", prof, wall)
def check_inter_kernels(dev):
    """Phase 3b: KD / KE / KF (and KB at the P-frame's batch sizes) against
    their plain versions at the 1080p P-frame's shapes."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.encoder import tpu_inter as TI
    from aom_av1_psy_tpu_torch.encoder import tpu_intra as TIN
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import FrameContext, tables
    from aom_av1_psy_tpu_torch.ops import cdef_torch as CT
    from aom_av1_psy_tpu_torch.ops import fullpel as FP
    from aom_av1_psy_tpu_torch.ops import mc as MC
    from aom_av1_psy_tpu_torch.ops import txq as TQ
    import bench

    rng = np.random.default_rng(SEED + 1)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    frame = bench.make_gop(1920, 1080, 2, seed=SEED)[1]
    y = np.zeros((1088, 1920), np.int32)
    y[:1080] = frame.planes()[0]
    y[1080:] = y[1079]
    y[:64, :256] = 90                                  # flat: ties
    uv = np.zeros((544, 960), np.int32)
    uv[:540] = frame.planes()[1]
    uv[540:] = uv[539]
    results = []

    # ---- KD: every phase, all 3 families, MVs past every border ----
    kern3 = TI._all_kernels(str(dev))
    err, times = 0.0, None
    for bw, B, K, plane, (ch, cw) in ((16, 8160, 9, y, (1080, 1920)),
                                      (32, 2040, 5, y, (1080, 1920)),
                                      (8, 8160, 3, uv, (540, 960)),
                                      (16, 2040, 3, uv, (540, 960))):
        ncols = plane.shape[1] // bw
        by, bx = TI._origins(B, ncols, bw, str(dev))
        ph = (np.arange(K)[:, None] * 37 + np.arange(B)[None, :]) % 256
        mag = np.where(rng.random((K, B)) < .2, 4 * bw, 2 * bw)
        qr = 16 * rng.integers(-mag, mag + 1) + ph // 16
        qc = 16 * rng.integers(-mag, mag + 1) + ph % 16
        kern = kern3[torch.arange(K, device=dev) % 3]
        src = t(rng.integers(0, 256, (B, bw, bw)))
        a = (t(plane), by, bx, t(qr), t(qc), bw, ch, cw, kern)
        err = max(err, compare(f"KD bw{bw} K{K}", MC.mc_8tap(*a, src=src),
                               MC.mc_8tap_plain(*a, src=src)))
        err = max(err, compare(f"KD bw{bw} no-src", MC.mc_8tap(*a)[0],
                               MC.mc_8tap_plain(*a)[0]))
        sad = MC.mc_8tap(*a, src=src, want_pred=False)[1]
        err = max(err, compare(f"KD bw{bw} sad-only", sad,
                               MC.mc_8tap_plain(*a, src=src)[1]))
        if bw == 16 and K == 9:
            times = (cuda_time(lambda: MC.mc_8tap(*a, src=src,
                                                  want_pred=False), 20),
                     cuda_time(lambda: MC.mc_8tap_plain(*a, src=src), 3))
    results.append({"name": "mc_8tap", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/mc.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_inter.py:78",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "timed_at": "luma bw16 K=9 B=8160, SAD only (subpel "
                                "step)"})
    log(f"[3b] KD mc_8tap exact at luma bw16 K=9 / bw32 K=5 and chroma "
        f"bw8 / bw16 (256 phases, 3 families, MVs past the borders); bw16 "
        f"K=9 B=8160: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms")

    # ---- KE: bw 8 on the half-resolution plane, bw 16 with centres ----
    err, times = 0.0, None
    half = (y[0::2, 0::2] + y[1::2, 0::2] + y[0::2, 1::2] + y[1::2, 1::2]
            + 2) >> 2
    for bw, plane, (ch, cw), cen in ((8, half, (540, 960), False),
                                     (16, y, (1080, 1920), True)):
        B = 8160
        by, bx = TI._origins(B, 120, bw, str(dev))
        src = TI._blocks(t(np.roll(plane, (3, -5), (0, 1))), bw).contiguous()
        kw = {}
        if cen:
            kw = dict(cy=t(rng.integers(-32, 33, B)),
                      cx=t(rng.integers(-32, 33, B)))
        a = (src, t(plane), by, bx, ch, cw, bw)
        err = max(err, compare(f"KE bw{bw}", FP.fullpel_search(*a, **kw),
                               FP.fullpel_search_plain(*a, **kw)))
        if cen:
            times = (cuda_time(lambda: FP.fullpel_search(*a, **kw), 10),
                     cuda_time(lambda: FP.fullpel_search_plain(*a, **kw), 2))
    results.append({"name": "fullpel_ssd", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/fullpel.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_inter.py:106",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "timed_at": "bw16 B=8160 with centres, 1088x1920"})
    log(f"[3b] KE fullpel_ssd exact at bw8 B=8160 (544x960) and bw16 "
        f"B=8160 with centres (flat region: ties); bw16: kernel "
        f"{times[0]:.4f} ms, plain {times[1]:.4f} ms")

    # ---- KF: 1088x1920 luma, 544x960 chroma, pri = 0 / sec = 0 mixes ----
    from aom_av1_psy_tpu.ops.cdef import find_dir_blocks
    mh, mw = 1080, 1920
    yb = y[:mh, :mw].reshape(135, 8, 240, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    dirs, var = find_dir_blocks(yb, 0)
    dirs, var = t(dirs), t(var.astype(np.int32))
    touched = t(rng.random(dirs.shape[0]) < .7, torch.bool)
    err, times = 0.0, None
    for pri, sec in ((4, 2), (0, 2), (5, 0), (0, 0), (15, 4)):
        for plane, bs, v, dmp in ((y, 8, var, 5), (uv, 4, None, 4)):
            ph, pw = (mh, mw) if bs == 8 else (mh // 2, mw // 2)
            a = (t(plane), ph, pw, bs, touched, dirs, v, pri, sec, dmp)
            err = max(err, compare(f"KF bs{bs} pri{pri} sec{sec}",
                                   CT.cdef_filter(*a),
                                   CT.cdef_filter_plain(*a)))
            if bs == 8 and pri == 4:
                times = (cuda_time(lambda: CT.cdef_filter(*a), 20),
                         cuda_time(lambda: CT.cdef_filter_plain(*a), 3))
    results.append({"name": "cdef_filter", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/cdef.cu",
                    "replaces": "aom_av1_psy_tpu/ops/cdef_jax.py:144",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "timed_at": "luma 1088x1920 (1080x1920 filtered), pri 4 "
                                "sec 2"})
    log(f"[3b] KF cdef_filter exact on 1088x1920 / 544x960 with (pri, sec) "
        f"in (4,2) (0,2) (5,0) (0,0) (15,4); luma: kernel {times[0]:.4f} "
        f"ms, plain {times[1]:.4f} ms")

    # ---- KB at the P-frame's batches: B=8160 bs16, B=2040 bs32 ----
    rt = {k: tuple(t(x, torch.float32) for x in v)
          for k, v in TIN._rate_tables(FrameContext(100)).items()}
    dc_q, ac_q = tables.dc_quant(100), tables.ac_quant(100)
    for bs, B, key in ((16, 8160, "y16"), (32, 2040, "y32"),
                       (8, 8160, "uv8")):
        src = t(rng.integers(0, 256, (B, bs, bs)))
        pred = t(np.clip(np.asarray(src.cpu()) + rng.integers(
            -30, 31, (B, bs, bs)), 0, 255))
        rdm = t(rng.uniform(5e3, 6e4, B), torch.float32)
        a = (src, pred, dc_q, ac_q, TIN._scan(TIN.BS_TO_TX[bs], str(dev)),
             rdm, *rt[key])
        compare(f"KB bs{bs} B={B}", TQ.txq_recon_skip(*a),
                TQ.txq_recon_skip_plain(*a))
        kb = (cuda_time(lambda: TQ.txq_recon_skip(*a), 10),
              cuda_time(lambda: TQ.txq_recon_skip_plain(*a), 2))
        log(f"[3b] KB txq_recon_skip exact at bs{bs} B={B}: kernel "
            f"{kb[0]:.4f} ms, plain {kb[1]:.4f} ms")
    return results


def _decodes_to_chain(tag, packets, encs):
    import numpy as np
    from aom_av1_psy_tpu.decoder.obu import Av1Decoder
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import \
        _ref_chain_planes
    dec, out = Av1Decoder(), []
    for p in packets:
        out.extend(dec.decode_packet(p))
    if len(out) != len(encs):
        raise AssertionError(f"{tag}: {len(out)} frames decoded")
    for i, (f, enc) in enumerate(zip(out, encs)):
        for name, d, r in zip("yuv", f.planes(), _ref_chain_planes(enc)):
            r = r.cpu().numpy()[: d.shape[0], : d.shape[1]]
            if not np.array_equal(d.astype(np.int32), r):
                raise AssertionError(f"{tag}: frame {i} {name} differs from "
                                     "the reference chain")


def closed_loop_gop_cif(dev):
    """Phase 4b: CIF GOP, CUDA packets == CPU plain packets; decodes to
    the chain."""
    import bench
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video
    frames = bench.make_gop(352, 288, 4)
    cfg = EncoderConfig(base_q_idx=100)
    pk, encs = encode_video(frames, cfg, device=dev)
    t0 = time.perf_counter()
    cpu_pk, _ = encode_video(frames, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    if pk != cpu_pk:
        raise AssertionError(f"CIF GOP: CUDA packets {list(map(len, pk))} "
                             f"differ from the CPU plain packets "
                             f"{list(map(len, cpu_pk))}")
    _decodes_to_chain("CIF GOP", pk, encs)
    log(f"[4b] CIF 352x288 GOP of 4 q100: bytes {[len(p) for p in pk]}, "
        f"CUDA == CPU plain packets (CPU plain GOP {cpu_s:.2f} s), every "
        f"frame decodes to the post-LPF/CDEF chain; interp "
        f"{[e.fh.interp_filter for e in encs[1:]]}, cdef y_pri "
        f"{[e.fh.cdef.y_pri[0] for e in encs]}")


def gop_main_path(dev, kernels):
    """Phase 5b: the 1080p IPPP GOP through encode_video, twice; the
    launch counts around the second run."""
    import numpy as np
    import torch
    import bench
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
        GpuInterFrameEncoder, _ref_chain_planes, encode_video)
    frames = bench.make_gop(1920, 1080, 5)
    cfg = EncoderConfig(base_q_idx=100)
    t0 = time.perf_counter()
    warm, _ = encode_video(frames, cfg, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    pk, encs = encode_video(frames, cfg, device=dev)
    torch.cuda.synchronize()
    gop_s = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in the GOP")
    if pk != warm:
        raise AssertionError("1080p GOP: second run differs from the first")
    for i, (p, e) in enumerate(zip(pk, encs)):
        c = e.fh.cdef
        log(f"[5b] frame {i} {'KEY' if i == 0 else 'P'}: {len(p)} bytes, "
            f"plan {e.timings['plan_s']:.4f} s, pack "
            f"{e.timings['pack_s']:.4f} s, lf {e.fh.lf.filter_level} "
            f"{e.fh.lf.filter_level_u} {e.fh.lf.filter_level_v}, cdef "
            f"y {c.y_pri[0]}/{c.y_sec[0]} uv {c.uv_pri[0]}/{c.uv_sec[0]}"
            + (f", interp {e.fh.interp_filter}" if i else ""))
    src = np.asarray(frames[-1].planes()[0], np.float64)
    rec = encs[-1].ref_planes_out[0].cpu().numpy()[:1080, :1920]
    psnr = 10 * np.log10(255 ** 2 / max(float(((rec - src) ** 2).mean()),
                                        1e-9))
    if not (rec.min() >= 0 and rec.max() <= 255 and psnr > 30):
        raise AssertionError(f"1080p GOP: bad last recon (PSNR {psnr:.2f})")
    # the KEY frame's temporal filter (shared numpy host code) alone
    from aom_av1_psy_tpu.encoder import temporal_filter as TF
    t0 = time.perf_counter()
    TF.filter_key_frame(frames, 0, max(8, cfg.base_q_idx - 60))
    tf_s = time.perf_counter() - t0
    # the whole GOP again on the CPU plain path
    t0 = time.perf_counter()
    cpu_pk, _ = encode_video(frames, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu_pk != pk:
        bad = [i for i, (a, b) in enumerate(zip(cpu_pk, pk)) if a != b]
        raise AssertionError(f"1080p GOP: frames {bad} differ from the CPU "
                             "plain path")
    # each P-frame again, alone, from the GOP's chain: host clock around
    # construction + encode + synchronize
    p_s = []
    for i in range(1, len(frames)):
        prev = encs[i - 1]
        t0 = time.perf_counter()
        again = GpuInterFrameEncoder(
            frames[i], encs[i].cfg, prev.seq, _ref_chain_planes(prev), 1920,
            1080, prev_fc=prev.saved_fc, device=dev).encode()
        torch.cuda.synchronize()
        p_s.append(time.perf_counter() - t0)
        if again != pk[i]:
            raise AssertionError(f"1080p: P-frame {i} re-encode differs")
    med = statistics.median(p_s)
    log(f"[5b] 1080p GOP q100: warm-up {warm_s:.3f} s, GOP {gop_s:.3f} s "
        f"(of which the KEY temporal filter alone takes {tf_s:.3f} s), "
        f"P-frame median {med:.4f} s/frame ({1 / med:.3f} fps, min "
        f"{min(p_s):.4f}, max {max(p_s):.4f}; plan "
        f"{statistics.median(e.timings['plan_s'] for e in encs[1:]):.4f} s, "
        f"pack+lpf+cdef "
        f"{statistics.median(e.timings['pack_s'] for e in encs[1:]):.4f} "
        f"s), last-frame luma PSNR {psnr:.3f} dB; GOP == CPU plain path "
        f"(CPU GOP {cpu_s:.1f} s)")
    log(f"[5b] launches in the GOP: {json.dumps(counts)}")
    return counts, frames, encs


def profile_p_frame(dev, frames, encs):
    """Phase 6b: device time by kernel over one steady 1080p P-frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import \
        GpuInterFrameEncoder
    prev = encs[1]
    cfg = encs[2].cfg
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc = GpuInterFrameEncoder(frames[2], cfg, prev.seq,
                                   prev.ref_planes_out, 1920, 1080,
                                   prev_fc=prev.saved_fc, device=dev)
        enc.encode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _device_rows("6b", prof, wall, f"plan {enc.timings['plan_s']:.4f} s, "
                 f"pack {enc.timings['pack_s']:.4f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "aom_av1_psy_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from aom_av1_psy_tpu_torch.kernels.build import build_all
    from aom_av1_psy_tpu_torch.ops.cdef_torch import KF
    from aom_av1_psy_tpu_torch.ops.deblock_torch import KC
    from aom_av1_psy_tpu_torch.ops.fullpel import KE
    from aom_av1_psy_tpu_torch.ops.intra_pred import KA
    from aom_av1_psy_tpu_torch.ops.mc import KD
    from aom_av1_psy_tpu_torch.ops.txq import KB
    kernels = (KA, KB, KC, KD, KE, KF)
    t0 = time.perf_counter()
    build_all(kernels)
    log(f"[2] built {', '.join(k.name for k in kernels)} with nvcc sm_90a "
        f"in {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2]   {k.name}: {line.strip()}")

    def phase(tag, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
        return out

    results = phase("3", check_kernels, dev)
    results += phase("3b", check_inter_kernels, dev)
    if "--only-kernels" in sys.argv[1:]:
        return 0
    phase("4", closed_loop_cif, dev)
    phase("4b", closed_loop_gop_cif, dev)
    key_counts, frame, cfg = phase("5", main_path, dev, kernels[:3])
    counts, frames, encs = phase("5b", gop_main_path, dev, kernels)
    phase("6", profile_frame, dev, frame, cfg)
    phase("6b", profile_p_frame, dev, frames, encs)

    names = {"intra_pred_sse": KA, "txq_recon_skip": KB, "lpf_ladder": KC,
             "mc_8tap": KD, "fullpel_ssd": KE, "cdef_filter": KF}
    for r in results:
        k = names[r["name"]].name
        r["launches"] = counts[k]
        r["launches_key_frame"] = key_counts.get(k, 0)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
