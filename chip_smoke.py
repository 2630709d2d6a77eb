#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``aom_av1_psy_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the three hand-written kernels from ``csrc/`` with nvcc (sm_90a);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the 1080p encode gives it, for exact equality, with both times (CUDA
   events);
4. closed loop at CIF (352x288): the CUDA stream equals the port's CPU
   (plain-path) stream byte for byte, and the in-repo decoder reconstructs
   the port's post-loop-filter planes exactly;
5. the main path: ``GpuFrameEncoder.encode()`` of ``bench.make_frame(1920,
   1080)`` at ``base_q_idx=100`` — a first frame and 5 steady frames — with
   every kernel's launch count read around that run;
6. a profiler window over one steady frame (device busy time by kernel).

The second-to-last line is ``{"kernels": [...]}``, the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
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
    """Phase 5: the 1080p encode; launch counts around it."""
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
    for _ in range(5):
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


def profile_frame(dev, frame, cfg):
    """Phase 6: device time by kernel over one steady 1080p frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        GpuFrameEncoder(frame, cfg, device=dev).encode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): an operator's own row
    # repeats the time of the kernels it launched
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        log("[6] profiler shows no device time: busy share not measured")
        return
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[6] one steady frame under the profiler: wall {wall:.4f} s, "
        f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
        f"{sum(r[1] for r in rows)} device kernels and copies")
    for dt, n, key in rows[:12]:
        log(f"[6]   {dt / 1e3:10.3f} ms  x{n:<6d} {key[:90]}")


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
    from aom_av1_psy_tpu_torch.ops.deblock_torch import KC
    from aom_av1_psy_tpu_torch.ops.intra_pred import KA
    from aom_av1_psy_tpu_torch.ops.txq import KB
    kernels = (KA, KB, KC)
    t0 = time.perf_counter()
    build_all(kernels)
    log(f"[2] built {', '.join(k.name for k in kernels)} with nvcc sm_90a "
        f"in {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2]   {k.name}: {line.strip()}")

    results = check_kernels(dev)
    closed_loop_cif(dev)
    counts, frame, cfg = main_path(dev, kernels)
    profile_frame(dev, frame, cfg)

    names = {"intra_pred_sse": KA.name, "txq_recon_skip": KB.name,
             "lpf_ladder": KC.name}
    for r in results:
        r["launches"] = counts[names[r["name"]]]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
