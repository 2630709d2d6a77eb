#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``aom_av1_psy_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each prints a line with its seconds; any failure raises and the
exit code is not 0):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the hand-written kernels from ``csrc/`` with nvcc (sm_90a), one
   nvcc process per source, all started together (KA-KF, KG/KH/KI in
   ``tune_vmaf.cu``, KJ and KM ``mvsearch.cu``, KK ``temporal_filter.cu``,
   KL ``convolve.cu``, KN and KO ``metrics.cu``, KP ``analyze.cu``, KQ
   ``palette.cu``, KR ``txfm2d.cu``), and the native range coder
   (``native/ec.cpp``, g++);
3. KA / KB / KC against their plain PyTorch versions on the card, at the
   shapes the 1080p KEY frame gives them, for exact equality, with both
   times (CUDA events): KA's pick (``intra_pick``, the wavefronts' entry)
   at the longest 1080p diagonal (luma 32 and the four 16 quads, B = 34,
   K = 61; chroma 16 and the four 8 quads, B = 2 x 34) and its older
   entries ``intra_pred_sse`` / ``intra_pred_one``; KB's batched entry
   (``txq_recon_skip``) and its in-place entry (``txq_step``, the
   wavefronts') at the same diagonal: every call site of a step (luma
   32, the four 16 quads with the split and the recon write-back, the
   chroma 16 pair, the four 8 quad pairs) against its plain version on
   CPU tensors, timed with events, ``device_ms`` and host us per call;
   ``device_ms`` (the profiler's device time) of the pick, of the old
   pair and of KB; KC (the loop-filter ladder, 6 levels with the source)
   at 1088x1920 luma and 544x960 chroma, each timed with events,
   ``device_ms`` and its bound, and on zero, duplicated and level-63
   ladders at planes no multiple of its tile (208x336, 1080x1928 and
   their chroma) cropped below the buffer, with the source and without it
   at L = 1;
3b. KD / KE / KF, and KB's batched entry at the P-frame's batch sizes,
   against their plain versions at the 1080p P-frame's shapes, for exact
   equality, with both times and KB's ``device_ms``; KD at every K the
   plan uses (1, 2, 3, 5, 9) at bw 8 / 16 / 32, with and without the
   source blocks and the prediction, and its ``device_ms`` at bw 16,
   K = 9, B = 8160; KE at bw 8 on the half-resolution plane and at bw 16
   (B = 8160), with and without centres (to +-48: windows past every
   border of the crop), on 8-bit (words) and 10-bit (32-bit strips)
   samples, bw 16 with centres and bw 8 without timed with events,
   ``device_ms`` and their bounds; KF's direction search (the frame pass
   on the luma alone) at 1080x1920 against numpy ``find_dir_blocks`` and
   ``find_dir_plain``, and on the extreme blocks of
   ``tests/cdef_cases.py``; KF's frame pass
   ``cdef_frame`` at 1088x1920 / 544x960 for six strength mixes, three
   planes with and without the sources and luma alone; the per-plane
   ``cdef_filter`` at five (pri, sec) mixes; each timed with events,
   ``device_ms``, its plain version and its bound (the search also
   against numpy);
3c. KA and KB at 4x4 (KB with the sinpi ADST4 and the skip decision off)
   and KB with the skip off at 8x8, at the uniform grid's shapes (640x360:
   chroma B = 2 x 45; 1080p BLOCK_8X8: luma B = 135, chroma B = 270), and
   the pick and KB's in-place entry at the 1080p BLOCK_8X8 grid's longest
   diagonal (luma bs 8 B = 135, chroma bs 4 B = 2 x 135), for exact
   equality, with both times;
3d. KG (with and without the moments), KH and KI (the four VIF scales, and
   its ``vif_down2`` entry) against their plain versions at the 1080p
   shapes: KG, KH and down2 exact, KI within a relative 1e-4; KG also at
   its strips' edge sizes (uint8 and int32) and KI at odd sizes and on
   float32 values off the pyramid's grid; kernel, plain and (KI, down2)
   library-call times, and the profiler's device time of KG, KH, KI (at
   scale 0 and summed over the four scales) and ``vif_down2``;
3e. KJ (the temporal filter's full-pel SAD search) and KK (its span
   pass: weighting, accumulation and rounding of every frame of a span)
   at 1080p: KJ at the shapes of one ARF span (``make_gop(1920, 1080,
   5)``, centre 2), exact on the 32x32 blocks and on the 24-tall bottom
   row through both entries (the windows cut from the padded frame, and
   the plane entry reading them where they lie), ``full_pel_hierarchical``
   (radius 16, step 4) equal to the CPU plain path, KJ's strip-tiling edge
   cases (``_kj_edge_cases``); KK's ``tf_span_filter`` exact against the
   plain version at the KEY span of phase 5b (3 frames, centre 0, also on
   CPU tensors) and the first ARF span of phase 5g (5 frames, centre 2);
   kernel (events and ``device_ms``), plain and bound times (bytes, and
   the integer and float64 operations); KK's weight against ``np.exp`` at
   every truncation boundary (101 values within 50 ulp of each of the
   1000, and 0 and 7), and its division of the window totals against
   numpy's at every total (0 to 29 * 255^2) and divisor (25, 26, 27, 29);
3f. KL (subpel prediction), KM (the 49-point subpel refine), KN (the
   metric reducers) and KO (8x8 Hadamard / satd) against their plain
   versions at the 1080p P-frame's block grid (16x16, B = 8160): KL at
   every path and interp filter, also at 8x8, 4x4, 32x32, 64x64, the
   luma's whole 128x128 blocks, 12x20 (not a power of two) and 2x2 on the
   chroma plane (4:2:0's 2-wide blocks), with its device time and bound
   at each size; KM at 16x16 and at the luma's whole 128x128 and 128x64
   blocks; KN at 16x16, 8x8 and 4x4; KO on 4 x 8160 8x8 residuals; exact;
   kernel (CUDA events around the wrapper, and ``device_ms``: the kernel
   alone under the profiler; KN's also with the L2 flushed before each
   launch, and the wrapper's host time per call), plain, bound and
   library times;
3g. KP (the batched analysis: 7 predictions, SSE argmin, forward DCT,
   fp quantization, eob) and KQ (palette ``calc_indices``) against their
   plain versions on the card: KP at the 1080p KEY frame's shapes (the
   luma padded to 1088 rows at n = 16 / 32 / 8 / 4, B = 8160 / 2040 /
   32640 / 130560; the chroma planes padded to 544 rows at n = 8), on the
   plane entry at q100 and q255 and on the blocks entry with its totals;
   KQ on the golden k-means cases and at N = 4096 / K = 8 (dim 1) and
   N = 1024 / K = 8 (dim 2) on int64, int32 (5j's tiles) and uint8 data,
   and at N = 16384 (several CTAs); exact; kernel (per call, the total on
   the host), ``device_ms``, plain and bound times, and the device
   kernels and copies of one call on int32 data;
3h. KR (the general 2-D transforms, ``ops/txfm.py``'s four entries)
   against its plain version on the card and on the CPU: every one of the
   193 valid (tx_size, tx_type) pairs forward and inverse at bd 8, the
   inverse at bd 10 and 12 on a third of each size's types (every size),
   the WHT pair at bd 8 / 10 / 12, on mixed residuals (+-255 blocks,
   values that wrap in int32) and extreme coefficient blocks; exact;
   timed at a 1080p luma's blocks (``KR_TIMED``: TX_16X16 ADST_ADST
   B = 8160, TX_32X32 DCT_DCT 2040, TX_64X64 DCT_DCT 510, TX_16X64
   DCT_DCT 2040, TX_8X32 IDTX 8160, TX_4X4 FLIPADST_ADST 130560; the WHT
   pair at 130560), forward and inverse: kernel (CUDA events, median of 3
   after a first; ``device_ms`` warm, and with the L2 flushed before each
   call, ``cold_device_ms``), plain and bound times, and each time over
   its bound (the inverse's bytes count only the coded min(W, 32) x
   min(H, 32) corner of the coefficients, which is all it reads; the
   operations are counted from the normative stage data, ``_kr_ops``);
   the registers, stack and spill that ptxas reported for each of KR's
   40 instantiations (``ptxas_report``);
4. closed loop at CIF (352x288), KEY frame: the CUDA stream equals the
   port's CPU (plain-path) stream byte for byte, and the in-repo decoder
   reconstructs the port's post-loop-filter planes exactly;
4b. closed loop at CIF, a 4-frame IPPP GOP (``encode_video``, CDEF on): the
   CUDA packets equal the CPU plain-path packets and every frame decodes to
   the port's post-LPF, post-CDEF reference chain;
4c. closed loop at CIF with two tile columns (``tile_cols_log2=1``, two
   3-SB tiles): CUDA stream == CPU plain stream, decoder == post-LPF recon;
4d. closed loop at 640x360 with the default config, which takes the
   uniform grid (mi rows = 2 mod 8, 8x8 blocks, chroma at 4x4): CUDA stream
   == CPU plain stream, decoder == the plan recon after the host
   deblocker (the uniform path runs no device loop filter);
4e. closed loop at CIF with ``tune_vmaf=True``: a KEY frame and a 4-frame
   GOP, CUDA == CPU plain (packets and amounts), decoder == recon / chain;
4f. the ARF, CBR and RC GOP encodes at CIF on ``make_gop(352, 288, 6)`` (ARF
   group 4; CBR and RC at 0.8 x the rate ``encode_video`` reaches at
   q100): CUDA == CPU plain (packets, q, trace), q moves, and every
   displayed frame decodes to its encoder's chain (the non-shown ARF
   displays through its show_existing packet);
4g. the host inter encoder (``encoder/interframe.encode_video``) on
   ``panning_frames(96, 72, 3)`` at q120: CUDA == CPU plain packets and
   recons, every frame decodes to its recon, the launch counts (1 KJ + 3
   KL per inter block) read around the CUDA run;
5. the KEY path: ``GpuFrameEncoder.encode()`` of the 1920x1080 test
   frame (``utils/testframes.make_frame``, the arrays of ``bench.py``'s) at
   ``base_q_idx=100`` — a first frame and 3 steady frames (the first
   captures the walk as a CUDA graph, the others replay it), then a
   fourth replayed one — with the launch counts read around those runs
   (KA: 930 picks per frame on the card, 10 per diagonal step, and no
   launch of its older entries; KB: 930 launches per frame, all through
   ``txq_step``; a replayed frame launches neither from the host);
5b. the main path of slice 2: ``encode_video(make_gop(1920, 1080, 5),
   EncoderConfig(base_q_idx=100))`` twice (the first run warms up), the
   counts set to 0 just before the second and read just after (KF only
   as the frame pass, at most 2 launches per frame); per-frame bytes,
   times (the P-frame's pack split into the LPF pick, CDEF and the symbol
   script with the native coder) and filter strengths; each P-frame
   re-encoded alone from the GOP's chain for its wall time; the whole GOP on the CPU plain path
   must give the same packets;
5c. the tiled KEY path: the phase-5 frame with ``tile_cols_log2=1`` (two
   15-SB tiles batched through one wavefront of 63 diagonals) — a first
   frame and 3 steady frames with the launch counts read around them, the
   untiled steady median of phase 5 beside it; CUDA == CPU plain stream;
5d. the uniform grid at full width: 1080p with ``block_size=BLOCK_8X8``
   (R = 135, C = 240: 374 diagonals per plane) — a first frame and 3
   steady frames with the counts read around them, CUDA == CPU plain
   stream; then 640x360 (the default config's uniform grid), 3 steady;
5e. 1080p with ``search_cdef=True``: the searched strengths and the time;
   at CIF, CUDA == CPU plain stream;
5f. the main path of slice 4: the phase-5 frame with ``tune_vmaf=True`` —
   a first frame and 3 steady frames (preprocessing time beside plan and
   pack), the counts set to 0 before them and read after ``vif_lite``
   (source vs decoded) of this frame and of phase 5's; CUDA == CPU plain
   stream; a 3-frame 1080p ``encode_video`` with ``tune_vmaf``, timed,
   with the per-frame amounts and the counts set to 0 just before it and
   read just after;
5g. the main path of slice 5: ``encode_video_arf(make_gop(1920, 1080,
   9), EncoderConfig(base_q_idx=100), group=4)`` (11 packets) twice, the
   counts set to 0 just before the second run and read just after; the
   second run equals the first; per-packet bytes, the temporal filter's
   time for the KEY frame and each ARF, the GOP wall;
5h. 1080p RC and CBR GOPs (``make_gop(1920, 1080, 5)``) at 0.8 x the rate
   of phase 5b's GOP: q, bytes, achieved rate and wall; q must move;
5i. the main path of slice 6 at full width: frame 1 of ``make_gop(1920,
   1080, 2)`` searched against frame 0 on the 16x16 grid (B = 8160): KJ at
   radius 16, the 49-point refine (KM), the refined prediction (KL),
   ``variance`` / ``sse`` (KN) and the ``satd`` of the four 8x8 residuals
   (KO); equal to the same chain on the CPU plain path; timed (median of 3
   after a first) with the counts set to 0 before the 3 runs and read
   after; KN's device time inside one chain (the L2 as the chain leaves
   it);
5j. the main path of slice 7 at full width, on the 1080p KEY frame
   (luma padded to 1088, chroma to 544 rows): ``analyze_plane`` of the
   three planes (luma n = 16, chroma n = 8), ``batched_analyze_step(16,
   100)`` on the luma blocks and source edges whole and in two halves (the
   halves' int32 totals add up to the whole's), ``calc_indices`` of every
   64x64 luma block (dim 1) and co-located 32x32 chroma pair block (dim 2)
   at K = 8 with centroids from the host ``k_means``; equal to the same
   path on the CPU plain path; timed (median of 3 after a first) with the
   counts set to 0 before the 3 runs and read after;
5k. the tile columns sharded over a mesh (``GpuFrameEncoder.mesh``:
   ``make_mesh(T)`` where the machine has T cards, else ``cuda:0`` T
   times; the line names the mesh and ``torch.cuda.device_count()``): the
   phase-5c frame (T = 2) and ``make_frame(2008, 1080)`` with
   ``tile_cols_log2=2`` (T = 4: 32 superblock columns in slabs of 512 px,
   the last with 472 visible; 1920 px, 30 columns, codes one tile), each
   equal to the batched and CPU
   plain streams, a first frame and 3 steady frames with the KA / KB / KC
   counts set to 0 before them and read after, each tile's recon on its
   own card, the mesh and the batched path in turns (B M M B, twice:
   ``plan_s`` and the frame wall), the device copies of one mesh frame
   and the cross-card recon copies; ``sharded_analyze_step(mesh, 16,
   100)`` on phase 5j's luma blocks (B = 8160) at mesh sizes 1, 2 and 4,
   equal to ``batched_analyze_step``, timed (median of 3 after a first);
   the host cost of the kernels' device guard (the guarded stream lookup
   against the bare one, KA's pick wrapper with the guard and bypassed,
   in turns);
5l. the main path of kernel KR (the transform API): frame 1 of ``make_gop(1920,
   1080, 2)`` against frame 0 as its prediction (luma padded to 1088
   rows), cut into the blocks of each ``KR_TIMED`` shape, through
   ``fwd_txfm2d`` and ``inv_txfm2d_add``, and the 4x4 WHT pair, whose
   round trip gives the source back exactly; equal to the CPU plain path;
   timed (median of 3 after a first) with the counts set to 0 before the
   3 runs and read after (14 launches a run). No encode path of either
   package calls the general transforms on the device;
6. / 6b. a profiler window over one steady 1080p KEY frame and one steady
   1080p P-frame (device busy time by kernel; KC's launches and device
   time in the KEY frame; 6b also KD's, KE's, KC's and KF's in the
   P-frame, and its pack split).

``--only-kernels`` stops after phase 3h; ``--only-mesh`` runs phase 5k
alone after the build. The second-to-last line is
``{"kernels": [...]}``: ``launches`` from the GOP of phase 5b (for the
4x4 / no-skip entries, from the uniform KEY frames of phase 5d; for KG,
KH, KI and ``vif_down2``, from phase 5f; for KJ and KK, from the ARF GOP
of phase 5g; for KL, KM, KN and KO, from the chain of phase 5i; for KP
and KQ, from the analysis path of phase 5j; for KR's four entries, from
the transform path of phase 5l), with the counts of the KEY
frames of phases 5, 5c, 5d and 5f, of phase 5b's IPPP GOP, of phase 5f's
tune_vmaf GOP, of phase 5g's ARF GOP, of phase 5i's chain, of phase 5j's
analysis path, of phase 5l's transform path and of phase 4g's host
inter GOP beside it (launches from the host: a KEY frame that replays
its key's CUDA graph launches no KA or KB), and
``launches_per_key_frame``, the launches the card runs in one phase-5
KEY frame (its 3 steady frames launch from the host one walk, captured as
a CUDA graph, and KC's; two replay the walk without a launch: the 3
frames' host launches less two replays'), and
``host_launches_per_replayed_key_frame``, a fourth frame's. KA's and
KB's entries count only their own instances (``intra_pick`` bs 8/16/32,
``intra_pick bs4``; ``intra_pred_sse`` bs 8/16/32 and bs 4, no longer on
any encoder path; ``txq_step`` (``step`` bs 8/16/32) and ``txq_step
no-skip`` (``step bs4 / bs8 no-skip``), the wavefronts' in-place entry;
``txq_recon_skip`` bs 8/16/32 with the skip decision, the P-frame's
batched entry; ``txq_recon bs4 / bs8 no-skip``, the batched entry without
the skip, no longer on any encoder path), read from the per-variant
counts the wrappers keep. Each entry's ``bound_ms`` is the larger of its
bytes (inputs read once, outputs written once, from the timed call's
tensors) over 3.35 TB/s and its operations (estimated per kernel from the
shapes, in the comments beside each) over 67 T/s, float64 operations over
34 T/s; ``library_ms`` times one PyTorch call where one computes the
function (KI's box moments and ``vif_down2``: ``conv2d``; KN's ``sad``:
``pairwise_distance`` with p = 1), else null with the reason
(``library_none``). The last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
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


def device_ms(fn, iters, name):
    """Mean device time per call (ms) of the kernels whose name holds
    ``name``, from a profiler window over ``iters`` calls: the kernel
    alone, without the host's dispatch, which sets the CUDA-event time of
    a launch this small. None where the profiler shows no device time."""
    import torch
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


def cold_device_ms(fn, iters, name):
    """``device_ms`` with the L2 flushed before each call: a read of 256 MB
    (five times the H100's 50 MB L2; a read, so that the L2 holds no
    dirty lines to write back during the call), so that each call reads
    its inputs from HBM as a byte bound assumes. The read's own time is
    not counted (``name`` leaves it out)."""
    import torch
    flush = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    return device_ms(lambda: (flush.sum(), fn()), iters, name)


def ptxas_report(build_log):
    """What ptxas -v said of each entry function of a kernel's build log
    (``tools/sass_census.ptxas_info``): {its demangled name, without
    arguments: [its registers and stack / spill lines]}."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sass_census", os.path.join(REPO, "tools", "sass_census.py"))
    sass_census = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass_census)
    info = sass_census.ptxas_info(build_log.splitlines())
    names = sass_census.demangle(list(info))
    out = {}
    for m, lines in info.items():
        name, depth = names[m], 0
        if name.endswith(")"):      # drop the argument list
            for i in range(len(name) - 1, 0, -1):
                depth += (name[i] == ")") - (name[i] == "(")
                if depth == 0:
                    name = name[:i]
                    break
        for part in ("void ", "<unnamed>::", "(anonymous namespace)::"):
            name = name.replace(part, "")
        out[name] = lines
    return out


def device_ops(fn):
    """The device kernels, copies and fills of one call of fn (after a
    first), by name, from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def _host_us(fn, n=1000):
    """Host microseconds per call of fn: n calls enqueued, then one wait
    (the wrapper's dispatch where it outruns the card)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


# NVIDIA H100 SXM (data sheet): HBM3 bytes/s, the float32 rate outside
# the tensor cores, against which integer operations are counted too, and
# the float64 vector rate
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12


def nbytes(*xs):
    """Bytes of the tensors in xs (nested tuples, lists and dicts walked)."""
    import torch
    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif torch.is_tensor(x):
            total += x.numel() * x.element_size()
    return total


def bound(n_bytes, ops, fp64_ops=0):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the CUDA-core rate (float64 operations over
    the FP64 rate)."""
    tb = n_bytes / HBM_BYTES_PER_S
    to = ops / CUDA_CORE_OPS_PER_S + fp64_ops / FP64_OPS_PER_S
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


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


def _txq_ops(B, bs):
    """Operations of B square transform blocks of size bs: forward and
    inverse 2-D transforms (~8 bs^2 log2(bs) butterfly operations) and
    ~20 per coefficient for quantize, dequantize, recon and the rate."""
    return B * bs * bs * (8 * (bs.bit_length() - 1) + 20)


def _pick_calls(dev, uniform=False):
    """The pick's calls at one diagonal of the 1080p KEY frame, with the
    test frame's planes as recon and source: (name, call) pairs, where
    call(fn) runs ``fn`` (``intra_pick`` or ``intra_pick_plain``) with
    fresh output maps and returns its outputs and the maps. The partition
    plan's longest diagonal (d = 33 of 34 x 60 cells: B = 34): luma 32, the
    four luma 16 quads (K = 61), chroma 16 and the four chroma 8 quads (U
    and V pairs, 2 x 34 blocks, K = 7). ``uniform``: the BLOCK_8X8 grid's
    longest diagonal (d = 134 of 135 x 240: B = 135), luma bs 8 and the
    chroma bs 4 pairs (2 x 135 blocks). Neighbour modes and lambdas are
    seeded."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.encoder import tpu_intra as TI
    from aom_av1_psy_tpu_torch.encoder import tpu_intra_dir as DIR
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import FrameContext
    from aom_av1_psy_tpu_torch.ops import intra_pred as IP
    from aom_av1_psy_tpu_torch.utils import testframes

    rng = np.random.default_rng(SEED + 5)
    i32 = dict(dtype=torch.int32, device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    def lam(*shape):
        return t(rng.uniform(5e3, 6e4, shape).astype(np.float32))

    y, u, v = testframes.make_frame(1920, 1080, seed=SEED).planes()
    bs = 8 if uniform else 32
    R, C = 1080 // bs if uniform else 34, 1920 // bs
    cb = bs // 2
    ys = _pad_rows(y, R * bs, dev)
    uvs = [_pad_rows(p, R * cb, dev) for p in (u, v)]
    buf = torch.zeros((1, R * bs + bs + 2, C * bs + bs + 2), **i32)
    buf[0, 1:1 + R * bs, 1:1 + C * bs] = ys
    bufs = torch.zeros((2, R * cb + cb + 2, C * cb + cb + 2), **i32)
    for p in range(2):
        bufs[p, 1:1 + R * cb, 1:1 + C * cb] = uvs[p]
    tiles, rows, cols, offs = TI._diagonals(R, C, 1)
    d = R - 1
    tt, rc, cc = (t(a[offs[d]:offs[d + 1]]) for a in (tiles, rows, cols))
    B = rc.shape[0]
    sy, suv = (ys[None],), tuple(p[None] for p in uvs)   # source planes
    calls = []

    def call(args, kw, maps):
        def run(fn):
            fresh = {k: m.clone() for k, m in maps.items()}
            return (*fn(*args, **kw, **fresh), *fresh.values())
        # the bare kernel call (into the same maps each time), for timing
        run.bare = lambda: IP.intra_pick(*args, **kw, **maps)
        return run

    if uniform:
        kf7, angle7, uv = (t(x) for x in TI._plan_cost_tables(
            FrameContext(100)))
        grid = t(rng.integers(0, 7, (1, R, C)).astype(np.int32))
        rd = lam(1, R, C)
        calls.append(("luma bs8", call(
            (buf, tt, rc, cc, sy, bs, 7, rd),
            dict(mode_cost=kf7, angle_cost=angle7, nbr=grid,
                 nbr_plan=True), {"mode_out": grid})))
        calls.append(("chroma bs4", call(
            (bufs, tt, rc, cc, suv, cb, 7, rd),
            dict(uv_cost=uv, nbr=grid, nbr_plan=True),
            {"mode_out": torch.zeros_like(grid)})))
        return calls, B
    kf61, angle61, uv = (t(x) for x in TI._plan_cost_tables2(
        FrameContext(100)))
    masks = {k: t(m[None]) for k, m in DIR.position_masks(
        270, 480, 480, R, C).items()}
    mode16 = t(rng.integers(0, 13, (1, 2 * R, 2 * C)).astype(np.int32))
    y_m32 = t(rng.integers(0, 13, (1, R, C)).astype(np.int32))
    y_m16 = t(rng.integers(0, 13, (1, 2 * R, 2 * C)).astype(np.int32))
    rd32, rd16 = lam(1, R, C), lam(1, 2 * R, 2 * C)
    luma = dict(mode_cost=kf61, angle_cost=angle61, nbr=mode16,
                nbr_scale=2)
    calls.append(("luma bs32", call(
        (buf, tt, rc, cc, sy, 32, 61, rd32),
        dict(luma, ok=tuple(masks[f"ok{k}_32"] for k in (1, 2, 3))),
        {"mode_out": torch.zeros_like(y_m32),
         "delta_out": torch.zeros_like(y_m32)})))
    loc = buf.unfold(1, 34, 32).unfold(2, 34, 32)[tt, rc, cc]
    locs = bufs.unfold(1, 18, 16).unfold(2, 18, 16)[:, rc, cc] \
        .reshape(2 * B, 18, 18)
    for qr, qc in TI._QUADS:
        calls.append((f"luma bs16 quad {qr}{qc}", call(
            (loc, tt, rc, cc, sy, 16, 61, rd16),
            dict(luma, local=True, qr=qr, qc=qc, scale=2,
                 ok=tuple(masks[f"ok{k}_16"] for k in (1, 2, 3)),
                 trreal=masks["trreal_16"], blreal=masks["blreal_16"]),
            {"mode_out": y_m16.clone(), "delta_out": torch.zeros_like(
                y_m16)})))
    calls.append(("chroma bs16", call(
        (bufs, tt, rc, cc, suv, 16, 7, rd32), dict(uv_cost=uv, nbr=y_m32),
        {"mode_out": torch.zeros_like(y_m32)})))
    for qr, qc in TI._QUADS:
        calls.append((f"chroma bs8 quad {qr}{qc}", call(
            (locs, tt, rc, cc, suv, 8, 7, rd16),
            dict(uv_cost=uv, nbr=y_m16, nbr_scale=2, local=True, qr=qr,
                 qc=qc, scale=2), {"mode_out": torch.zeros_like(y_m16)})))
    return calls, B


def _pick_bytes(B, bs, npl, K):
    """Bytes the pick must move per call: each block's edges (2 bs + 1,
    and 2 bs more of extensions at K = 61), source, cost row and map
    entries read once, its prediction and pick row written once."""
    edges = (4 if K == 61 else 2) * bs + 1
    return 4 * B * (npl * (edges + 2 * bs * bs) + K + 8)


def _step_bytes(B, bs, npl, window=0):
    """Bytes KB's in-place entry must move per call: each block's source
    and prediction read once, its levels and recon written once, its
    pick row and map entries, and (a cell launch) its local window read
    and written once."""
    return 4 * npl * B * (4 * bs * bs + 16 + 2 * window * window)


def _step_sites(uniform=False):
    """KB's in-place entry (``TxqStep``) at one diagonal of the 1080p KEY
    frame, with the test frame's planes as source and as recon buffer:
    returns (run, B). ``run(where)`` builds fresh maps on ``where`` (the
    card or "cpu", the plain version), runs the step's KB calls in the
    wavefront's order with seeded KA outputs (the source plus noise,
    modes and rates at random) and returns (maps, calls): the maps after
    the step and the (name, bare call) pairs of the call sites. The
    partition plan's longest diagonal (d = 33 of 34 x 60 cells: B = 34):
    luma 32, the four 16 quads (quad (1, 1) with the split, the recon
    write-back and the mode context), chroma 16 and the four 8 quads (U
    and V pairs, 2 x 34 blocks, ADST from the mode). ``uniform``: the
    BLOCK_8X8 grid's longest diagonal (d = 134 of 135 x 240: B = 135), luma
    bs 8 and the chroma bs 4 pairs (2 x 135 blocks), no skip decision."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.encoder import plan_inputs as PI
    from aom_av1_psy_tpu_torch.encoder import tpu_intra as TI
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import FrameContext, tables
    from aom_av1_psy_tpu_torch.ops import txq as TQ
    from aom_av1_psy_tpu_torch.utils import testframes

    rng = np.random.default_rng(SEED + 9)
    y, u, v = (np.asarray(p, np.int32) for p in
               testframes.make_frame(1920, 1080, seed=SEED).planes())
    bs = 8 if uniform else 32
    R, C = (135, 240) if uniform else (34, 60)
    cb = bs // 2

    def pad(p, rows):
        out = np.empty((rows, p.shape[1]), np.int32)
        out[:p.shape[0]] = p
        out[p.shape[0]:] = p[-1]
        return out

    ys = pad(y, R * bs)[None]
    uvs = [pad(p, R * cb)[None] for p in (u, v)]
    buf = np.zeros((1, R * bs + bs + 2, C * bs + bs + 2), np.int32)
    buf[0, 1:1 + R * bs, 1:1 + C * bs] = ys[0]
    bufs = np.zeros((2, 1, R * cb + cb + 2, C * cb + cb + 2), np.int32)
    for p in range(2):
        bufs[p, 0, 1:1 + R * cb, 1:1 + C * cb] = uvs[p][0]
    tiles, rows, cols, offs = TI._diagonals(R, C, 1)
    d = R - 1
    cells = [a[offs[d]:offs[d + 1]] for a in (tiles, rows, cols)]
    B = len(cells[0])
    dc_q, ac_q = tables.dc_quant(100), tables.ac_quant(100)
    rt = TI._rate_tables(FrameContext(100))
    pr_none, pr_split = TI._part_rate_scalars(FrameContext(100))
    forced, no_split = PI.edge_cell_masks(R, C, 270, 480)

    def lam(*shape):
        return rng.uniform(5e3, 6e4, shape).astype(np.float32)

    host = {"rd32": lam(1, R, C), "rd16": lam(1, 2 * R, 2 * C),
            "forced": forced[None], "no_split": no_split[None],
            "m32": rng.integers(0, 13, (1, R, C)).astype(np.int32),
            "m16": rng.integers(0, 13, (1, 2 * R, 2 * C)).astype(np.int32),
            "mode16": rng.integers(0, 13, (1, 2 * R, 2 * C)).astype(np.int32),
            "split32": rng.integers(0, 2, (1, R, C)).astype(np.int32)}

    def ka_outputs(planes, b, r0, c0):
        """A pick (4, B) and a prediction near each plane's block."""
        blocks = np.concatenate([
            np.stack([pl[0, r:r + b, c:c + b] for r, c in zip(r0, c0)])
            for pl in planes])
        amp = rng.choice([1, 4, 25], len(blocks))[:, None, None]
        pred = np.clip(blocks + np.round(rng.uniform(-1, 1, blocks.shape)
                                         * amp), 0, 255).astype(np.int32)
        pick = np.zeros((4, B), np.int32)
        pick[0] = rng.integers(0, 7, B)
        pick[1] = rng.integers(0, 13, B)
        pick[3] = rng.integers(0, 3000, B)
        return pick, pred

    tt, rc, cc = cells
    if uniform:
        seq = [("luma bs8", None, ka_outputs([ys], bs, rc * bs, cc * bs)),
               ("chroma bs4", None, ka_outputs(uvs, cb, rc * cb, cc * cb))]
    else:
        seq = [("luma bs32", None, ka_outputs([ys], 32, rc * 32, cc * 32))]
        seq += [(f"luma bs16 quad {qr}{qc}", (qr, qc), ka_outputs(
            [ys], 16, rc * 32 + 16 * qr, cc * 32 + 16 * qc))
            for qr, qc in TI._QUADS]
        seq += [("chroma bs16", None, ka_outputs(uvs, 16, rc * 16,
                                                 cc * 16))]
        seq += [(f"chroma bs8 quad {qr}{qc}", (qr, qc), ka_outputs(
            uvs, 8, rc * 16 + 8 * qr, cc * 16 + 8 * qc))
            for qr, qc in TI._QUADS]

    def run(where):
        def t(a):
            # a copy: on the CPU, as_tensor would share (and the step
            # write into) the host arrays
            return torch.tensor(np.asarray(a), device=where)

        i32 = dict(dtype=torch.int32, device=where)
        h = {k: t(x) for k, x in host.items()}
        r = {k: tuple(t(x) for x in v) for k, v in rt.items()}
        cells_t = tuple(t(a.astype(np.int64)) for a in cells)
        m = {"buf": t(buf), "bufs": t(bufs)}
        sy, su, sv = t(ys), t(uvs[0]), t(uvs[1])
        if uniform:
            m.update(ylv=torch.zeros((1, 1, R, C, 64), **i32),
                     ye=torch.zeros((1, 1, R, C), **i32),
                     uvlv=torch.zeros((1, 2, R, C, 16), **i32),
                     uve=torch.zeros((1, 2, R, C), **i32))
            planes = m["bufs"].view(2, *bufs.shape[2:])
            sites = [TQ.uniform_step(
                8, sy, m["buf"], m["ylv"], m["ye"], dc_q=dc_q, ac_q=ac_q,
                scan=TI._scan(TI.BS_TO_TX[8], str(where))),
                     TQ.uniform_step(
                4, su, planes, m["uvlv"], m["uve"], src_v=sv, dc_q=dc_q,
                ac_q=ac_q, scan=TI._scan(TI.BS_TO_TX[4], str(where)))]
        else:
            m.update({k: h[k].clone() for k in ("m32", "m16", "mode16")})
            m.update(split=torch.zeros((1, R, C), **i32),
                     lv32=torch.zeros((1, 1, R, C, 1024), **i32),
                     e32=torch.zeros((1, 1, R, C), **i32),
                     lv16=torch.zeros((1, 1, 2 * R, 2 * C, 256), **i32),
                     e16=torch.zeros((1, 1, 2 * R, 2 * C), **i32),
                     loc=torch.zeros((B, 34, 34), **i32),
                     stage=torch.zeros((B, 32, 32), **i32),
                     cost=torch.zeros((2, B), dtype=torch.float32,
                                      device=where),
                     uvlv16=torch.zeros((1, 2, R, C, 256), **i32),
                     uve16=torch.zeros((1, 2, R, C), **i32),
                     uvlv8=torch.zeros((1, 2, 2 * R, 2 * C, 64), **i32),
                     uve8=torch.zeros((1, 2, 2 * R, 2 * C), **i32),
                     locs=torch.zeros((2 * B, 18, 18), **i32),
                     stages=torch.zeros((2 * B, 16, 16), **i32))
            planes = m["bufs"].view(2, *bufs.shape[2:])
            lc = dict(dc_q=dc_q, ac_q=ac_q, loc=m["loc"], stage=m["stage"],
                      cost=m["cost"])
            cc_ = dict(dc_q=dc_q, ac_q=ac_q, loc=m["locs"],
                       stage=m["stages"])
            scan = {b: TI._scan(TI.BS_TO_TX[b], str(where))
                    for b in (32, 16, 8)}
            kb32 = TQ.luma_cell_step(
                sy, m["buf"], m["lv32"], m["e32"], scan=scan[32],
                rd=h["rd32"], rt=r["y32"], pr_none=pr_none, **lc)
            kb16 = TQ.luma_quad_step(
                sy, m["buf"], m["lv16"], m["e16"], scan=scan[16],
                rd=h["rd16"], rt=r["y16"], rd_cell=h["rd32"],
                forced=h["forced"], no_split=h["no_split"],
                split=m["split"], m32=m["m32"], m16=m["m16"],
                mode16=m["mode16"], pr_split=pr_split, **lc)
            kc16 = TQ.chroma_cell_step(
                su, sv, planes, m["uvlv16"], m["uve16"], scan=scan[16],
                rd=h["rd32"], rt=r["uv16"], **cc_)
            kc8 = TQ.chroma_quad_step(
                su, sv, planes, m["uvlv8"], m["uve8"], scan=scan[8],
                rd=h["rd16"], rt=r["uv8"], split=h["split32"], **cc_)
            sites = [kb32] + [kb16] * 4 + [kc16] + [kc8] * 4
        calls = []
        for site, (name, quad, (pick, pred)) in zip(sites, seq):
            args = (*cells_t, t(pick), t(pred), *(quad or ()))
            if not uniform and name.startswith("luma"):
                # what KA's pick writes before KB: its mode into the map
                tt_, rc_, cc_t = cells_t
                if quad is None:
                    m["m32"][tt_, rc_, cc_t] = args[3][1]
                else:
                    m["m16"][tt_, 2 * rc_ + quad[0],
                             2 * cc_t + quad[1]] = args[3][1]
            site(*args)
            calls.append((name, (lambda s=site, a=args: s(*a))))
        return m, calls

    return run, B


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
            args32, src32, cand32, ext32 = args, src, cand, ext
            times = (cuda_time(lambda: IP.intra_pred_sse(*args, src, k, **ext),
                               50),
                     cuda_time(lambda: IP.intra_pred_sse_plain(
                         *args, src, k, **ext), 10))
            # ~4 operations per predicted pixel, 3 for its squared error
            bnd = bound(nbytes(args, src, ext, IP.intra_pred_sse(
                *args, src, k, **ext)), 7 * k * B * bs * bs)
    results.append({"name": "intra_pred_sse", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/intra_pred.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra_dir.py:241",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    **bnd, "library_ms": None,
                    "library_none": "no single PyTorch call predicts and "
                                    "scores the directional intra modes",
                    "timed_at": "bs32 B=34 K=61 (SSE of all candidates)"})
    log(f"[3] KA intra_pred_sse exact at bs 32/16 (K=61) and 16/8 (K=7); "
        f"bs32 B=34: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms")
    # the old pair's device time (both launches of one pick at bs 32)
    pair = (lambda: (IP.intra_pred_sse(*args32, src32, K, **ext32),
                     IP.intra_pred_one(*args32, cand32, K, **ext32)))
    pair_t = (cuda_time(pair, 50), device_ms(pair, 20, "ka_"))
    results[-1]["device_ms"] = device_ms(
        lambda: IP.intra_pred_sse(*args32, src32, K, **ext32), 20,
        "ka_sse_kernel")
    results[-1]["launches_note"] = ("not on any encoder path: the "
                                    "wavefronts run intra_pick")

    # ---- KA's pick: one diagonal of the 1080p KEY frame ----
    calls, B = _pick_calls(dev)
    err = 0.0
    for name, run in calls:
        err = max(err, compare(f"KA pick {name}", run(IP.intra_pick),
                               run(IP.intra_pick_plain)))
    run32 = calls[0][1]
    pick_t = (cuda_time(run32.bare, 50),
              cuda_time(lambda: run32(IP.intra_pick_plain), 5),
              device_ms(run32.bare, 20, "pick61_kernel"),
              _host_us(run32.bare))
    # ~4 operations per predicted pixel, 3 for its squared error
    bnd = bound(_pick_bytes(B, 32, 1, K), 7 * K * B * 32 * 32)
    results.append({"name": "intra_pick", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/intra_pred.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra.py:570",
                    "max_abs_err": err, "ms": pick_t[0],
                    "plain_ms": pick_t[1], "device_ms": pick_t[2], **bnd,
                    "library_ms": None,
                    "library_none": "no single PyTorch call predicts, prices "
                                    "and chooses among the intra modes",
                    "host_us_per_call": pick_t[3],
                    "old_pair_ms": pair_t[0], "old_pair_device_ms": pair_t[1],
                    "timed_at": "luma bs32 B=34 K=61 (one 1080p diagonal); "
                                "old pair: intra_pred_sse + intra_pred_one "
                                "at bs32 B=34 K=61"})
    log(f"[3] KA intra_pick exact against intra_pick_plain at one 1080p "
        f"diagonal ({', '.join(n for n, _ in calls)}; B={B}); luma bs32: "
        f"kernel {pick_t[0]:.4f} ms (device {pick_t[2]} ms, host "
        f"{pick_t[3]:.2f} us per call), plain "
        f"{pick_t[1]:.4f} ms, bound {bnd['bound_ms']:.5f} ms "
        f"({bnd['bound_by']}); the old pair intra_pred_sse + "
        f"intra_pred_one {pair_t[0]:.4f} ms (device {pair_t[1]} ms)")

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
                     cuda_time(lambda: TQ.txq_recon_skip_plain(*a), 10),
                     device_ms(lambda: TQ.txq_recon_skip(*a), 20,
                               "kb_batch_kernel"))
            bnd = bound(nbytes(a, TQ.txq_recon_skip(*a)), _txq_ops(B, bs))
    results.append({"name": "txq_recon_skip", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/txq.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra.py:157",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "device_ms": times[2], **bnd, "library_ms": None,
                    "library_none": "no single PyTorch call runs the integer "
                                    "AV1 transforms, quantizer and skip "
                                    "decision",
                    "timed_at": "bs32 B=34 DCT (the batched entry)",
                    "launches_note": "the batched entry: the P-frame's; the "
                                     "KEY wavefronts run txq_step"})
    log(f"[3] KB txq_recon_skip exact at 32/16 (DCT) and 16/8 (ADST mix); "
        f"bs32 B=34: kernel {times[0]:.4f} ms (device {times[2]} ms), "
        f"plain {times[1]:.4f} ms, bound {bnd['bound_ms']:.5f} ms "
        f"({bnd['bound_by']})")

    # ---- KB's in-place entry: one diagonal of the 1080p KEY frame ----
    run, B = _step_sites()
    got, calls = run(dev)
    want, _ = run("cpu")
    err = 0.0
    for k in want:
        err = max(err, compare(f"KB step {k}", got[k].cpu(), want[k]))
    bare = dict(calls)
    step32 = bare["luma bs32"]
    step_t = (cuda_time(step32, 50),
              cuda_time(lambda: run("cpu"), 3),
              device_ms(step32, 20, "kb_step_kernel"),
              _host_us(step32),
              device_ms(bare["luma bs16 quad 11"], 20, "kb_step_kernel"),
              device_ms(lambda: [f() for _, f in calls], 10,
                        "kb_step_kernel"))
    bnd = bound(_step_bytes(B, 32, 1, 34), _txq_ops(B, 32))
    results.append({"name": "txq_step", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/txq.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra.py:157; "
                                "aom_av1_psy_tpu/encoder/tpu_intra.py:570",
                    "max_abs_err": err, "ms": step_t[0],
                    "plain_ms": step_t[1], "device_ms": step_t[2], **bnd,
                    "library_ms": None,
                    "library_none": "no single PyTorch call runs the integer "
                                    "AV1 transforms, quantizer, skip "
                                    "decision and partition choice",
                    "host_us_per_call": step_t[3],
                    "quad11_device_ms": step_t[4],
                    "step_device_ms": step_t[5],
                    "timed_at": "luma bs32 B=34 (one 1080p diagonal, the "
                                "cell launch); plain: the whole step's 10 "
                                "calls on CPU tensors; step_device_ms: the "
                                "step's 10 KB launches"})
    log(f"[3] KB txq_step exact against its plain version at one 1080p "
        f"diagonal ({', '.join(n for n, _ in calls)}; B={B}); luma bs32: "
        f"kernel {step_t[0]:.4f} ms (device {step_t[2]} ms, host "
        f"{step_t[3]:.2f} us per call), quad 11 with the split device "
        f"{step_t[4]} ms, the step's 10 launches device {step_t[5]} ms, "
        f"bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}); plain step "
        f"on the CPU {step_t[1]:.4f} ms")

    # ---- KC: 1080p luma 1088x1920 and chroma 544x960, 6 levels ----
    from aom_av1_psy_tpu_torch.utils import testframes
    frame = testframes.make_frame(1920, 1080, seed=SEED)
    g = 14
    cands = t([0, g // 2, g - 2, g, g + 2, 2 * g])
    split16 = t(rng.random((68, 120)) < .5, torch.bool)
    err, kc_t = 0.0, {}
    for pl, (hb, wb, cell, luma, w, h) in zip(
            frame.planes(), ((1088, 1920, 16, True, 1920, 1080),
                             (544, 960, 8, False, 960, 540))):
        src = np.zeros((hb, wb), np.int32)
        src[:pl.shape[0], :pl.shape[1]] = pl
        recon = (src // 6) * 6 + rng.integers(0, 3, src.shape)  # blocky
        a = (t(recon), split16, cands, t(src), w, h, cell, luma)
        tag = "luma" if luma else "chroma"
        err = max(err, compare(f"KC {tag}", DT.lpf_ladder(*a),
                               DT.lpf_ladder_plain(*a)))
        # ~20 operations per pixel and level (edge masks, filters, the
        # squared error)
        kc_t[tag] = (cuda_time(lambda: DT.lpf_ladder(*a), 20),
                     cuda_time(lambda: DT.lpf_ladder_plain(*a), 3),
                     device_ms(lambda: DT.lpf_ladder(*a), 20,
                               "kc_tile_kernel"),
                     bound(nbytes(a, DT.lpf_ladder(*a)),
                           20 * len(cands) * hb * wb))
    cases = _kc_edge_cases(dev, rng)
    results.append({"name": "lpf_ladder", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/deblock.cu",
                    "replaces": "aom_av1_psy_tpu/ops/deblock_jax.py:183",
                    "max_abs_err": err, "ms": kc_t["luma"][0],
                    "plain_ms": kc_t["luma"][1], **kc_t["luma"][3],
                    "device_ms": kc_t["luma"][2],
                    "chroma_ms": kc_t["chroma"][0],
                    "chroma_plain_ms": kc_t["chroma"][1],
                    "chroma_device_ms": kc_t["chroma"][2],
                    "chroma_bound_ms": kc_t["chroma"][3]["bound_ms"],
                    "library_ms": None,
                    "library_none": "no single PyTorch call runs the AV1 "
                                    "deblocking filters",
                    "timed_at": "luma 1088x1920, 6 levels (chroma_*: "
                                "544x960)"})
    log(f"[3] KC lpf_ladder exact at 1088x1920 luma and 544x960 chroma, 6 "
        f"levels, and on {cases}; "
        + "; ".join(f"{k}: kernel {v[0]:.4f} ms (device {v[2]} ms), plain "
                    f"{v[1]:.4f} ms, bound {v[3]['bound_ms']:.4f} ms "
                    f"({v[3]['bound_by']})" for k, v in kc_t.items()))
    return results


def _kc_edge_cases(dev, rng):
    """KC against its plain version on all-zero and duplicated ladders and
    at level 63, on planes no multiple of its tile cropped below the
    buffer, with the source and without it at L = 1 (``lpf_apply``'s
    call)."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.ops import deblock_torch as DT

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    n = 0
    for hb, wb, h, w in ((208, 336, 198, 330), (1080, 1928, 1075, 1921)):
        split16 = rng.random((-(-hb // 16), -(-wb // 16))) < .5
        for luma in (True, False):
            cell = 16 if luma else 8
            ph, pw, ch, cw = ((hb, wb, h, w) if luma else
                              (hb // 2, wb // 2, (h + 1) // 2, (w + 1) // 2))
            blocks = rng.integers(0, 256, (-(-ph // 8), -(-pw // 8)))
            buf = np.kron(blocks, np.ones((8, 8), np.int64))[:ph, :pw]
            buf = (buf + rng.integers(0, 3, (ph, pw))).astype(np.int32)
            src = rng.integers(0, 256, (ph, pw)).astype(np.int32)
            for cands in ([0, 0, 0], [14, 14, 7, 7], [63], [0, 63, 63, 40]):
                a = (t(buf), t(split16), t(np.array(cands, np.int32)),
                     t(src), cw, ch, cell, luma)
                compare(f"KC {ph}x{pw} {cands}", DT.lpf_ladder(*a),
                        DT.lpf_ladder_plain(*a))
                b = (a[0], a[1], t(np.array(cands[-1:], np.int32)),
                     None) + a[4:]
                compare(f"KC {ph}x{pw} L=1 no src", DT.lpf_ladder(*b)[0],
                        DT.lpf_ladder_plain(*b)[0])
                n += 2
    return (f"{n} edge cases (zero, duplicated and level-63 ladders, "
            "208x336 and 1080x1928 planes and their chroma, L = 1 without "
            "the source)")


def check_uniform_kernels(dev):
    """Phase 3c: KA at 4x4 (K=7), KB at 4x4 (DCT/ADST mix, skip off) and KB
    at 8x8 with the skip off, at the uniform grid's shapes."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.encoder import tpu_intra as TI
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import tables
    from aom_av1_psy_tpu_torch.ops import intra_pred as IP
    from aom_av1_psy_tpu_torch.ops import txq as TQ

    rng = np.random.default_rng(SEED + 2)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    results = []
    # ---- KA bs 4, K=7: 640x360 chroma (B=90), 1080p BLOCK_8X8 (B=270) ----
    err, times = 0.0, None
    for B in (90, 270):
        args = (t(rng.integers(0, 256, (B, 4))),
                t(rng.integers(0, 256, (B, 4))), t(rng.integers(0, 256, B)),
                t(rng.random(B) < .8, torch.bool),
                t(rng.random(B) < .8, torch.bool))
        src = t(rng.integers(0, 256, (B, 4, 4)))
        cand = t(rng.integers(0, 7, B))
        err = max(err, compare(f"KA sse bs4 B={B}",
                               IP.intra_pred_sse(*args, src, 7),
                               IP.intra_pred_sse_plain(*args, src, 7)))
        err = max(err, compare(f"KA one bs4 B={B}",
                               IP.intra_pred_one(*args, cand, 7),
                               IP.intra_pred_one_plain(*args, cand, 7)))
        if B == 270:
            times = (cuda_time(lambda: IP.intra_pred_sse(*args, src, 7), 50),
                     cuda_time(lambda: IP.intra_pred_sse_plain(*args, src, 7),
                               20))
            bnd = bound(nbytes(args, src, IP.intra_pred_sse(*args, src, 7)),
                        7 * 7 * B * 16)
    results.append({"name": "intra_pred_sse bs4", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/intra_pred.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra.py:64",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    **bnd, "library_ms": None,
                    "library_none": "no single PyTorch call predicts and "
                                    "scores the directional intra modes",
                    "timed_at": "bs4 B=270 K=7 (1080p BLOCK_8X8 chroma)"})
    log(f"[3c] KA intra_pred_sse exact at bs4 K=7, B=90 and 270; B=270: "
        f"kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms")
    results[-1]["launches_note"] = ("not on any encoder path: the "
                                    "wavefronts run intra_pick")

    # ---- KA's pick on the 1080p BLOCK_8X8 grid's longest diagonal ----
    calls, B = _pick_calls(dev, uniform=True)
    err = 0.0
    for name, run in calls:
        err = max(err, compare(f"KA pick uniform {name}", run(IP.intra_pick),
                               run(IP.intra_pick_plain)))
    run4 = calls[1][1]
    times = (cuda_time(run4.bare, 50),
             cuda_time(lambda: run4(IP.intra_pick_plain), 10),
             device_ms(run4.bare, 20, "pick7_kernel"))
    bnd = bound(_pick_bytes(B, 4, 2, 7), 7 * 7 * 2 * B * 16)
    results.append({"name": "intra_pick bs4", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/intra_pred.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra.py:345",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "device_ms": times[2], **bnd, "library_ms": None,
                    "library_none": "no single PyTorch call predicts, prices "
                                    "and chooses among the intra modes",
                    "timed_at": f"chroma bs4 pairs, B=2x{B} K=7 (1080p "
                                "BLOCK_8X8 diagonal)"})
    log(f"[3c] KA intra_pick exact at the 1080p BLOCK_8X8 diagonal (luma bs8 "
        f"B={B}, chroma bs4 B=2x{B}); chroma bs4: kernel {times[0]:.4f} ms "
        f"(device {times[2]} ms), plain {times[1]:.4f} ms")

    # ---- KB, skip off: bs 4 ADST mix (B=90, 270), bs 8 DCT (B=135) ----
    dc_q, ac_q = tables.dc_quant(100), tables.ac_quant(100)
    for bs, Bs, adst, name, replaces in (
            (4, (90, 270), True, "txq_recon bs4 no-skip",
             "aom_av1_psy_tpu/encoder/tpu_intra.py:195"),
            (8, (135,), False, "txq_recon bs8 no-skip",
             "aom_av1_psy_tpu/encoder/tpu_intra.py:157")):
        err, times = 0.0, None
        for B in Bs:
            src = t(rng.integers(0, 256, (B, bs, bs)))
            pred = t(np.clip(np.asarray(src.cpu()) + rng.integers(
                -60, 61, (B, bs, bs)), 0, 255))
            pred[: B // 4] = t(rng.integers(0, 256, (B // 4, bs, bs)))
            flags = {}
            if adst:
                flags = dict(vadst=t(rng.random(B) < .5, torch.bool),
                             hadst=t(rng.random(B) < .5, torch.bool))
            a = (src, pred, dc_q, ac_q, TI._scan(TI.BS_TO_TX[bs], str(dev)))
            err = max(err, compare(f"KB no-skip bs{bs} B={B}",
                                   TQ.txq_recon(*a, **flags),
                                   TQ.tq_recon(*a, **flags)))
            times = (cuda_time(lambda: TQ.txq_recon(*a, **flags), 50),
                     cuda_time(lambda: TQ.tq_recon(*a, **flags), 20))
            bnd = bound(nbytes(a, flags, TQ.txq_recon(*a, **flags)),
                        _txq_ops(B, bs))
        results.append({"name": name, "route": "cuda",
                        "source": "aom_av1_psy_tpu_torch/csrc/txq.cu",
                        "replaces": replaces, "max_abs_err": err,
                        "ms": times[0], "plain_ms": times[1],
                        **bnd, "library_ms": None,
                        "library_none": "no single PyTorch call runs the "
                                        "integer AV1 transforms and quantizer",
                        "timed_at": f"bs{bs} B={Bs[-1]}"
                                    + (" DCT/ADST mix" if adst else " DCT")})
        results[-1]["launches_note"] = ("the batched entry: on no encoder "
                                        "path, the uniform wavefronts run "
                                        "txq_step")
        log(f"[3c] KB {name} exact at B={Bs}; B={Bs[-1]}: kernel "
            f"{times[0]:.4f} ms, plain {times[1]:.4f} ms")

    # ---- KB's in-place entry on the 1080p BLOCK_8X8 grid's diagonal ----
    run, B = _step_sites(uniform=True)
    got, calls = run(dev)
    want, _ = run("cpu")
    err = 0.0
    for k in want:
        err = max(err, compare(f"KB uniform step {k}", got[k].cpu(),
                               want[k]))
    bare = dict(calls)
    times = (cuda_time(bare["chroma bs4"], 50),
             cuda_time(lambda: run("cpu"), 5),
             device_ms(bare["chroma bs4"], 20, "kb_step_kernel"),
             device_ms(bare["luma bs8"], 20, "kb_step_kernel"),
             _host_us(bare["chroma bs4"]))
    bnd = bound(_step_bytes(B, 4, 2), _txq_ops(2 * B, 4))
    results.append({"name": "txq_step no-skip", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/txq.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_intra.py:282; "
                                "aom_av1_psy_tpu/encoder/tpu_intra.py:345",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "device_ms": times[2], **bnd, "library_ms": None,
                    "library_none": "no single PyTorch call runs the integer "
                                    "AV1 transforms and quantizer",
                    "luma_bs8_device_ms": times[3],
                    "host_us_per_call": times[4],
                    "timed_at": f"chroma bs4 pairs, B=2x{B} (1080p BLOCK_8X8 "
                                "diagonal); plain: both calls on CPU "
                                "tensors"})
    log(f"[3c] KB txq_step exact at the 1080p BLOCK_8X8 diagonal (luma bs8 "
        f"B={B}, chroma bs4 B=2x{B}); chroma bs4: kernel {times[0]:.4f} ms "
        f"(device {times[2]} ms, host {times[4]:.2f} us per call), luma bs8 "
        f"device {times[3]} ms, plain {times[1]:.4f} ms, bound "
        f"{bnd['bound_ms']:.5f} ms")
    return results

VIF_RTOL = 1e-4


def check_tune_vmaf_kernels(dev):
    """Phase 3d: KG (with and without the moments), KH, and KI with its
    down2 entry against their plain versions at the 1080p tune_vmaf and VIF
    shapes: KG, KH and down2 exact, KI's two sums within VIF_RTOL."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from aom_av1_psy_tpu_torch.encoder import tune_vmaf as TV
    from aom_av1_psy_tpu_torch.utils import testframes
    y = torch.as_tensor(testframes.make_frame(1920, 1080, seed=SEED)
                        .planes()[0], device=dev)
    H, W = y.shape
    src = "aom_av1_psy_tpu_torch/csrc/tune_vmaf.cu"
    ref = "aom_av1_psy_tpu/encoder/tune_vmaf.py"
    results = []

    # ---- KG: uint8 and int32 input, with and without the moments ----
    want = TV.gaussian_blur_plain(y)
    got, mom = TV.gaussian_blur(y, moments=True)
    err = max(compare("KG blur", TV.gaussian_blur(y), want),
              compare("KG blur int32", TV.gaussian_blur(y.to(torch.int32)),
                      want),
              compare("KG blur + moments", (got, mom),
                      (want, TV.blur_moments_plain(y, want))))
    times = (cuda_time(lambda: TV.gaussian_blur(y, moments=True), 50),
             cuda_time(lambda: TV.blur_moments_plain(
                 y, TV.gaussian_blur_plain(y)), 5),
             device_ms(lambda: TV.gaussian_blur(y, moments=True), 20,
                       "kg_strip_kernel"))
    plain_blur = cuda_time(lambda: TV.gaussian_blur(y), 50)
    # 2 x 8 taps of 2 operations, rounding and clip, 6 for the moments
    results.append({"name": "gauss_blur", "route": "cuda", "source": src,
                    "replaces": f"{ref}:49", "max_abs_err": err,
                    "ms": times[0], "plain_ms": times[1],
                    "device_ms": times[2],
                    **bound(nbytes(y, got, mom), 48 * H * W),
                    "library_ms": None,
                    "library_none": "no single PyTorch call rounds the "
                                    "integer blur between its two passes",
                    "timed_at": "1080x1920 uint8 with the moments (the "
                                "encoder's call)"})
    log(f"[3d] KG gauss_blur exact (uint8, int32; blur and moments) at "
        f"1080x1920: with moments kernel {times[0]:.4f} ms (device "
        f"{times[2]} ms), plain "
        f"{times[1]:.4f} ms; blur alone {plain_blur:.4f} ms")
    # the strips' edges: a lane's 4 columns, a band of TV.KG_BAND columns,
    # a warp's TV.KG_ROWS rows and a CTA's eight warps
    rng = np.random.default_rng(SEED + 14)
    sizes = [(h, w) for h in (1, 7, 8, 9, 16, 17, 64, 65)
             for w in (1, 3, 5, 127, 128, 129, 130)]
    for h, w in sizes:
        yy = torch.as_tensor(rng.integers(0, 256, (h, w)).astype(np.uint8),
                             device=dev)
        yb = TV.gaussian_blur_plain(yy)
        for t in (yy, yy.to(torch.int32)):
            compare(f"KG {h}x{w} {t.dtype}", TV.gaussian_blur(t), yb)
            compare(f"KG {h}x{w} {t.dtype} + moments",
                    TV.gaussian_blur(t, moments=True),
                    (yb, TV.blur_moments_plain(t, yb)))
    log(f"[3d] KG exact at the {len(sizes)} strip-edge sizes "
        f"(heights 1-65, widths 1-130; uint8 and int32, with and without "
        f"the moments)")

    # ---- KH: the reference's 1080p amount and the ceiling ----
    err = 0.0
    for a in (0.18498, 0.3, 0.04742):
        out = TV.unsharp(y, want, a)
        err = max(err, compare(f"KH a={a}", out, TV.unsharp_plain(y, want,
                                                                  a)))
    times = (cuda_time(lambda: TV.unsharp(y, want, 0.18498), 50),
             cuda_time(lambda: TV.unsharp_plain(y, want, 0.18498), 10),
             device_ms(lambda: TV.unsharp(y, want, 0.18498), 20,
                       "kh_kernel"))
    results.append({"name": "unsharp_apply", "route": "cuda", "source": src,
                    "replaces": f"{ref}:74", "max_abs_err": err,
                    "ms": times[0], "plain_ms": times[1],
                    "device_ms": times[2],
                    **bound(nbytes(y, want, out), 8 * H * W),
                    "library_ms": None,
                    "library_none": "no single PyTorch call rounds a*d and s "
                                    "+ a*d apart and clips",
                    "timed_at": "1080x1920, a = 0.18498"})
    log(f"[3d] KH unsharp_apply exact at 1080x1920 (a = 0.18498, 0.3, "
        f"0.04742): kernel {times[0]:.4f} ms (device {times[2]} ms), plain "
        f"{times[1]:.4f} ms")

    # ---- KI: the four scales of vif_lite(source, blur), and down2 ----
    r, d = y.to(torch.float32), want.to(torch.float32)
    err, rel, k_err = 0.0, 0.0, 0.0
    k3 = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=torch.float32,
                      device=dev)[None, None] / 16.0
    ki_dev = []
    for s in range(4):
        got, ref_sums = TV.vif_scale_sums(r, d), TV.vif_scale_plain(r, d)
        rel = max(rel, float(((got - ref_sums).abs()
                              / ref_sums.abs().clamp(min=1e-30)).max()))
        err = max(err, max_abs_err(got, ref_sums))
        ki_dev.append(device_ms(lambda: TV.vif_scale_sums(r, d), 20,
                                "ki_tile_kernel"))
        if s == 0:
            Ho, Wo = r.shape[0] - 8, r.shape[1] - 8
            # what the function needs per output pixel: the three products,
            # five separable 9x9 box means (8 + 8 adds and a scale each)
            # and ~30 for the variances, g, sv and the two log2 terms
            ki_bnd = bound(nbytes(r, d, got), (3 + 5 * 17 + 30) * Ho * Wo)
            ki_t = (cuda_time(lambda: TV.vif_scale_sums(r, d), 20),
                    cuda_time(lambda: TV.vif_scale_plain(r, d), 5))
            x5 = torch.stack([r, d, r * r, d * d, r * d])[:, None]
            box = torch.full((1, 1, 9, 9), 1.0 / 81.0, device=dev)
            ki_lib = cuda_time(lambda: F.conv2d(x5, box), 10)
        nr = TV.down2(r)
        k_err = max(k_err, compare(f"down2 scale {s}", nr,
                                   TV.down2_plain(r)))
        if s == 0:
            lib_err = max_abs_err(nr, F.conv2d(r[None, None], k3, stride=2,
                                               padding=1)[0, 0])
            d2_t = (cuda_time(lambda: TV.down2(r), 50),
                    cuda_time(lambda: TV.down2_plain(r), 20),
                    cuda_time(lambda: F.conv2d(r[None, None], k3, stride=2,
                                               padding=1), 50),
                    device_ms(lambda: TV.down2(r), 20, "vif_down2_kernel"))
            d2_bnd = bound(nbytes(r, nr), 18 * nr.numel())
        r, d = nr, TV.down2(d)
    # odd sizes (the 9 x 9 minimum, one past a 24 x 32 output tile) and
    # float32 values off the pyramid's grid
    for h, w, scale in ((9, 9, 1.0), (9, 41, 1.0), (37, 53, 1.0),
                        (41, 33, 1.0), (1080, 1920, 100.0)):
        if scale == 1.0:
            a = torch.as_tensor(rng.integers(0, 256, (h, w)), device=dev,
                                dtype=torch.float32)
            b = TV.gaussian_blur_plain(a.to(torch.uint8)).to(torch.float32)
        else:
            a, b = (torch.as_tensor(rng.standard_normal((h, w)) * scale,
                                    device=dev, dtype=torch.float32)
                    for _ in range(2))
        got, ref_sums = TV.vif_scale_sums(a, b), TV.vif_scale_plain(a, b)
        rel = max(rel, float(((got - ref_sums).abs()
                              / ref_sums.abs().clamp(min=1e-30)).max()))
    if rel > VIF_RTOL:
        raise AssertionError(f"KI: relative error {rel:.3g} above "
                             f"{VIF_RTOL}")
    results.append({"name": "vif_scale", "route": "cuda", "source": src,
                    "replaces": f"{ref}:94", "max_abs_err": err,
                    "max_rel_err": rel, "ms": ki_t[0], "plain_ms": ki_t[1],
                    "device_ms": ki_dev[0],
                    "device_ms_4_scales": (sum(ki_dev) if None not in ki_dev
                                           else None),
                    **ki_bnd, "library_ms": ki_lib,
                    "library_call": "conv2d of the five box moments (9x9, "
                                    "TF32 off)",
                    "timed_at": "scale 0, 1080x1920 float32"})
    results.append({"name": "vif_down2", "route": "cuda", "source": src,
                    "replaces": f"{ref}:111", "max_abs_err": k_err,
                    "ms": d2_t[0], "plain_ms": d2_t[1],
                    "device_ms": d2_t[3], **d2_bnd,
                    "library_ms": d2_t[2],
                    "library_call": "conv2d 3x3, stride 2, padding 1",
                    "timed_at": "1080x1920 -> 540x960 float32"})
    log(f"[3d] KI vif_scale within {VIF_RTOL} at the four scales, at odd "
        f"sizes and off the grid (max relative {rel:.3g}, max abs "
        f"{err:.4g} at 1080p): scale 0 kernel {ki_t[0]:.4f} ms (device "
        f"{ki_dev[0]} ms; scales 0-3 {ki_dev}), plain {ki_t[1]:.4f} ms, "
        f"box-moment conv2d {ki_lib:.4f} ms; vif_down2 exact: kernel "
        f"{d2_t[0]:.4f} ms (device {d2_t[3]} ms), plain "
        f"{d2_t[1]:.4f} ms, strided conv2d {d2_t[2]:.4f} ms (max abs "
        f"difference from the kernel {lib_err:.3g})")
    return results


def closed_loop_tune_vmaf_cif(dev):
    """Phase 4e: CIF with tune_vmaf, a KEY frame and a 4-frame GOP: CUDA ==
    CPU plain (packets and amounts); decoder == the port's recon / chain."""
    import numpy as np
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (Av1Decoder,
                                                         EncoderConfig,
                                                         GpuFrameEncoder)
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video
    from aom_av1_psy_tpu_torch.utils import testframes
    frame = testframes.make_frame(352, 288, seed=SEED)
    cfg = EncoderConfig(base_q_idx=100, tune_vmaf=True)
    gpu = GpuFrameEncoder(frame, cfg, device=dev)
    pkt = gpu.encode()
    cpu = GpuFrameEncoder(frame, cfg, device="cpu")
    if cpu.encode() != pkt or \
            cpu.vmaf_unsharp_amount != gpu.vmaf_unsharp_amount:
        raise AssertionError("CIF tune_vmaf: CUDA stream or amount differs "
                             "from the plain CPU path")
    dec = Av1Decoder().decode_packet(pkt)[0]
    for name, d, r in zip("yuv", dec.planes(), gpu.ref_planes_dev):
        if not np.array_equal(d.astype(np.int32),
                              r.cpu().numpy()[: d.shape[0], : d.shape[1]]):
            raise AssertionError(f"CIF tune_vmaf: decoded {name} differs "
                                 "from the post-LPF recon")
    frames = testframes.make_gop(352, 288, 4)
    pk, encs = encode_video(frames, cfg, device=dev)
    cpu_pk, cpu_encs = encode_video(frames, cfg, device="cpu")
    amounts = [e.vmaf_unsharp_amount for e in encs]
    if pk != cpu_pk or amounts != [e.vmaf_unsharp_amount for e in cpu_encs]:
        raise AssertionError("CIF tune_vmaf GOP: CUDA packets or amounts "
                             "differ from the plain CPU path")
    _decodes_to_chain("CIF tune_vmaf GOP", pk, encs)
    log(f"[4e] CIF 352x288 q100 tune_vmaf: KEY {len(pkt)} bytes, amount "
        f"{gpu.vmaf_unsharp_amount:.6f}; GOP of 4 bytes "
        f"{[len(p) for p in pk]}, amounts {[round(a, 6) for a in amounts]}; "
        f"CUDA == CPU plain, decoder == recon / chain")


def tune_vmaf_path(dev, kernels, plain_pkt, plain_enc):
    """Phase 5f: the 1080p KEY frame with tune_vmaf (a first frame, then 3
    steady ones with the launch counts set to 0 just before them and read
    after vif_lite of this frame and of the phase-5 frame), CUDA == CPU
    plain for one frame, and a 3-frame 1080p GOP. The VIF compares the
    source with each frame's post-LPF recon on the device, which is what
    the decoder shows (no CDEF here; phases 4 / 4e close that loop)."""
    import torch
    from aom_av1_psy_tpu_torch.encoder import tune_vmaf as TV
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (EncoderConfig,
                                                         GpuFrameEncoder)
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder import tpu_intra
    frame = testframes.make_frame(1920, 1080)
    cfg = EncoderConfig(base_q_idx=100, tune_vmaf=True)
    # phase 5's key: cleared, the first frame walks it eagerly and the
    # first steady one captures it (its launches count), as in phase 5
    tpu_intra._PLAN_GRAPHS.clear()
    t0 = time.perf_counter()
    pkt = GpuFrameEncoder(frame, cfg, device=dev).encode()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset(kernels)
    times, vmafs, plans, packs = [], [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        enc = GpuFrameEncoder(frame, cfg, device=dev)
        p = enc.encode()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vmafs.append(enc.vmaf_s)
        plans.append(enc.timings["plan_s"])
        packs.append(enc.timings["pack_s"])
        if p != pkt:
            raise AssertionError("tune_vmaf steady frame differs from the "
                                 "first")
    y = torch.as_tensor(frame.planes()[0], device=dev)
    t0 = time.perf_counter()
    vif = [TV.vif_lite(y, e.ref_planes_dev[0][:1080, :1920])
           for e in (enc, plain_enc)]
    vif_s = time.perf_counter() - t0
    counts = _counts(kernels)
    _need("1080p tune_vmaf", counts, (
        "tune_vmaf gauss_blur moments", "tune_vmaf unsharp_apply",
        "tune_vmaf vif_scale", "tune_vmaf vif_down2",
        "intra_pred pick bs32", "txq step bs32", "deblock"))
    if not (0.0 < enc.vmaf_unsharp_amount <= TV.MAX_AMOUNT
            and 0.0 < vif[0] <= 1.0 and 0.0 < vif[1] <= 1.0):
        raise AssertionError(f"1080p tune_vmaf: amount "
                             f"{enc.vmaf_unsharp_amount}, VIF {vif}")
    cpu_s = _cpu_equal("1080p tune_vmaf", frame, cfg, pkt)
    med = statistics.median(times)
    log(f"[5f] 1080p q100 tune_vmaf: {len(pkt)} bytes (phase 5 without: "
        f"{len(plain_pkt)}), amount {enc.vmaf_unsharp_amount:.6f}, first "
        f"frame {first_s:.3f} s, steady median {med:.4f} s/frame (min "
        f"{min(times):.4f}, max {max(times):.4f}), preprocessing "
        f"{statistics.median(vmafs):.4f} s, plan "
        f"{statistics.median(plans):.4f} s, pack+lpf "
        f"{statistics.median(packs):.4f} s; CUDA == CPU plain stream (CPU "
        f"encode {cpu_s:.1f} s)")
    log(f"[5f] vif_lite(source, decoded luma): tune_vmaf {vif[0]:.6f}, "
        f"without (phase 5) {vif[1]:.6f} ({vif_s:.3f} s for both)")
    log(f"[5f] launches over the 3 steady tune_vmaf frames and the two "
        f"vif_lite: {json.dumps(counts)}")
    frames = testframes.make_gop(1920, 1080, 3)
    _reset(kernels)
    t0 = time.perf_counter()
    pk, encs = encode_video(frames, cfg, device=dev)
    torch.cuda.synchronize()
    gop_s = time.perf_counter() - t0
    gop_counts = _counts(kernels)
    _need("1080p tune_vmaf GOP", gop_counts, (
        "tune_vmaf gauss_blur moments", "tune_vmaf unsharp_apply",
        "mc", "fullpel"))
    log(f"[5f] 1080p tune_vmaf GOP of 3: {gop_s:.3f} s, bytes "
        f"{[len(q) for q in pk]}, amounts "
        f"{[round(e.vmaf_unsharp_amount, 6) for e in encs]}, preprocessing "
        f"{[round(e.vmaf_s, 4) for e in encs]} s")
    log(f"[5f] launches over the tune_vmaf GOP of 3 (KEY + 2 P): "
        f"{json.dumps(gop_counts)}")
    return counts, gop_counts


def closed_loop_tiles_cif(dev):
    """Phase 4c: CIF with two tile columns; CUDA == CPU plain, decoder ==
    post-LPF recon."""
    import numpy as np
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (Av1Decoder,
                                                         EncoderConfig,
                                                         GpuFrameEncoder)
    frame = testframes.make_frame(352, 288, seed=SEED)
    cfg = EncoderConfig(base_q_idx=100, tile_cols_log2=1)
    gpu = GpuFrameEncoder(frame, cfg, device=dev)
    pkt = gpu.encode()
    if gpu.tile_T != 2 or gpu.fh.tiles.tile_cols != 2:
        raise AssertionError(f"CIF tiles: tile_T {gpu.tile_T}")
    if GpuFrameEncoder(frame, cfg, device="cpu").encode() != pkt:
        raise AssertionError("CIF tiles: CUDA stream differs from the plain "
                             "CPU stream")
    dec = Av1Decoder().decode_packet(pkt)[0]
    for name, d, r in zip("yuv", dec.planes(), gpu.ref_planes_dev):
        if not np.array_equal(d.astype(np.int32),
                              r.cpu().numpy()[: d.shape[0], : d.shape[1]]):
            raise AssertionError(f"CIF tiles: decoded {name} differs from "
                                 "the post-LPF recon")
    log(f"[4c] CIF 352x288 q100, 2 tiles of {gpu.tile_sb} SBs: {len(pkt)} "
        f"bytes, CUDA == CPU plain stream, decoder == post-LPF recon")


def closed_loop_uniform(dev):
    """Phase 4d: 640x360 default config (the uniform grid); CUDA == CPU
    plain, decoder == plan recon after the host deblocker."""
    import numpy as np
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (Av1Decoder,
                                                         EncoderConfig,
                                                         GpuFrameEncoder)
    frame = testframes.make_frame(640, 360, seed=SEED)
    cfg = EncoderConfig(base_q_idx=100)
    gpu = GpuFrameEncoder(frame, cfg, device=dev)
    pkt = gpu.encode()
    if gpu.use_part or gpu.bs != 8:
        raise AssertionError(f"640x360: use_part {gpu.use_part} bs {gpu.bs}")
    t0 = time.perf_counter()
    if GpuFrameEncoder(frame, cfg, device="cpu").encode() != pkt:
        raise AssertionError("640x360: CUDA stream differs from the plain "
                             "CPU stream")
    cpu_s = time.perf_counter() - t0
    dec = Av1Decoder().decode_packet(pkt)[0]
    for name, d, r in zip("yuv", dec.planes(),
                          gpu._host_lpf_planes(gpu.fh, search=False)):
        if not np.array_equal(d.astype(np.int32),
                              r[: d.shape[0], : d.shape[1]]):
            raise AssertionError(f"640x360: decoded {name} differs from the "
                                 "host-deblocked plan recon")
    log(f"[4d] 640x360 q100, uniform grid bs {gpu.bs} ({gpu.R}x{gpu.C} "
        f"blocks): {len(pkt)} bytes, CUDA == CPU plain stream (CPU encode "
        f"{cpu_s:.2f} s), decoder == host-deblocked plan recon, lf "
        f"{gpu.fh.lf.filter_level}")


def _steady(dev, frame, cfg, kernels, n=3):
    """A first encode, then ``n`` steady ones with the launch counts set to
    0 just before them and read just after. Returns (packet, encoder,
    first_s, steady times, plan_s, pack_s, counts)."""
    import torch
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    t0 = time.perf_counter()
    pkt = GpuFrameEncoder(frame, cfg, device=dev).encode()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset(kernels)
    times, plans, packs = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        enc = GpuFrameEncoder(frame, cfg, device=dev)
        p = enc.encode()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        plans.append(enc.timings["plan_s"])
        packs.append(enc.timings["pack_s"])
        if p != pkt:
            raise AssertionError("steady frame differs from the first")
    counts = _counts(kernels)
    return pkt, enc, first_s, times, plans, packs, counts


def _cpu_equal(tag, frame, cfg, pkt):
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    t0 = time.perf_counter()
    if GpuFrameEncoder(frame, cfg, device="cpu").encode() != pkt:
        raise AssertionError(f"{tag}: CUDA stream differs from the plain CPU "
                             "stream")
    return time.perf_counter() - t0


def _reset(kernels):
    for k in kernels:
        k.reset()


def _counts(kernels):
    """Launches since the last ``_reset``: each kernel's total under its
    name, and each variant's under "<name> <variant>" (KA "intra_pred pick
    bs4", KB "txq bs8 no-skip", ...)."""
    counts = {k.name: k.launches for k in kernels}
    for k in kernels:
        counts.update({f"{k.name} {v}": n for v, n in k.variants.items()})
    return counts


def _need(tag, counts, names):
    for name in names:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{tag}: kernel {name} never launched")


def tiled_key_path(dev, kernels, untiled_med):
    """Phase 5c: the 1080p KEY frame with two tile columns."""
    import dataclasses
    import torch
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (EncoderConfig,
                                                         GpuFrameEncoder)
    frame = testframes.make_frame(1920, 1080)
    cfg = EncoderConfig(base_q_idx=100, tile_cols_log2=1)
    pkt, enc, first_s, times, plans, packs, counts = _steady(
        dev, frame, cfg, kernels)
    if enc.tile_T != 2:
        raise AssertionError(f"1080p tiles: tile_T {enc.tile_T}")
    _need("1080p tiles", counts, ("intra_pred pick bs32",
                                  "intra_pred pick bs16",
                                  "intra_pred pick bs8",
                                  "txq step bs32", "txq step bs16",
                                  "txq step bs8", "deblock"))
    cpu_s = _cpu_equal("1080p tiles", frame, cfg, pkt)
    # untiled and tiled in turns (U T T U, twice): the plan times of the
    # two, compared on the same card and host state
    turns = {0: [], 1: []}
    for lg in (0, 1, 1, 0, 0, 1, 1, 0):
        enc_t = GpuFrameEncoder(frame, dataclasses.replace(
            cfg, tile_cols_log2=lg), device=dev)
        enc_t.encode()
        torch.cuda.synchronize()
        turns[lg].append(enc_t.timings["plan_s"])
    ratio = statistics.median(turns[1]) / statistics.median(turns[0])
    log(f"[5c] plan in turns (U T T U x2): untiled "
        f"{[round(x, 4) for x in turns[0]]} s, tiled "
        f"{[round(x, 4) for x in turns[1]]} s; tiled/untiled median plan "
        f"{ratio:.3f} (63/93 = {63 / 93:.3f})")
    med = statistics.median(times)
    log(f"[5c] 1080p q100, 2 tiles ({enc.R // 2 + enc.tile_pw // 32 - 1} "
        f"diagonals): {len(pkt)} bytes, first frame {first_s:.3f} s, steady "
        f"median {med:.4f} s/frame (min {min(times):.4f}, max "
        f"{max(times):.4f}), plan {statistics.median(plans):.4f} s, "
        f"pack+lpf {statistics.median(packs):.4f} s; untiled steady median "
        f"(phase 5) {untiled_med:.4f} s, tiled/untiled "
        f"{med / untiled_med:.3f}; CUDA == CPU plain stream (CPU encode "
        f"{cpu_s:.1f} s)")
    log(f"[5c] launches over the 3 steady tiled frames: {json.dumps(counts)}")
    return counts, pkt


def uniform_key_path(dev, kernels):
    """Phase 5d: the uniform grid at 1080p BLOCK_8X8, then 640x360."""
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import EncoderConfig
    frame = testframes.make_frame(1920, 1080)
    cfg = EncoderConfig(base_q_idx=100, block_size=3)
    pkt, enc, first_s, times, plans, packs, counts = _steady(
        dev, frame, cfg, kernels)
    if enc.use_part or (enc.bs, enc.R, enc.C) != (8, 135, 240):
        raise AssertionError(f"1080p bs8: bs {enc.bs} grid {enc.R}x{enc.C}")
    _need("1080p bs8", counts, ("intra_pred pick bs8", "intra_pred pick bs4",
                                "txq step bs8 no-skip",
                                "txq step bs4 no-skip"))
    cpu_s = _cpu_equal("1080p bs8", frame, cfg, pkt)
    med = statistics.median(times)
    log(f"[5d] 1080p q100 BLOCK_8X8 uniform grid ({enc.R}x{enc.C} blocks, "
        f"{enc.R + enc.C - 1} diagonals per plane): {len(pkt)} bytes, first "
        f"frame {first_s:.3f} s, steady median {med:.4f} s/frame (min "
        f"{min(times):.4f}, max {max(times):.4f}), plan "
        f"{statistics.median(plans):.4f} s, pack "
        f"{statistics.median(packs):.4f} s; CUDA == CPU plain stream (CPU "
        f"encode {cpu_s:.1f} s)")
    log(f"[5d] launches over the 3 steady 1080p bs8 frames: "
        f"{json.dumps(counts)}")
    small = testframes.make_frame(640, 360)
    _, enc, _, t360, p360, k360, _ = _steady(dev, small, EncoderConfig(
        base_q_idx=100), kernels)
    log(f"[5d] 640x360 q100 (uniform bs {enc.bs}): steady median "
        f"{statistics.median(t360):.4f} s/frame (min {min(t360):.4f}, max "
        f"{max(t360):.4f}), plan {statistics.median(p360):.4f} s, pack "
        f"{statistics.median(k360):.4f} s")
    return counts


def search_cdef_path(dev):
    """Phase 5e: 1080p with the KEY-frame CDEF strength search; CIF CUDA ==
    CPU plain."""
    import torch
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (EncoderConfig,
                                                         GpuFrameEncoder)
    cfg = EncoderConfig(base_q_idx=100, search_cdef=True)
    frame = testframes.make_frame(1920, 1080)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        enc = GpuFrameEncoder(frame, cfg, device=dev)
        pkt = enc.encode()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    c = enc.fh.cdef
    rest = walls[-1] - enc.timings["plan_s"] - enc.timings["pack_s"]
    cif = testframes.make_frame(352, 288, seed=SEED)
    small = GpuFrameEncoder(cif, cfg, device=dev).encode()
    _cpu_equal("CIF search_cdef", cif, cfg, small)
    log(f"[5e] 1080p q100 search_cdef: {len(pkt)} bytes, strengths y "
        f"{c.y_pri[0]}/{c.y_sec[0]} uv {c.uv_pri[0]}/{c.uv_sec[0]} damping "
        f"{c.damping}; frame {walls[-1]:.4f} s (first {walls[0]:.4f} s), "
        f"plan {enc.timings['plan_s']:.4f} s, pack+lpf "
        f"{enc.timings['pack_s']:.4f} s, search + CDEF apply {rest:.4f} s; "
        f"CIF: CUDA == CPU plain stream ({len(small)} bytes)")


def closed_loop_cif(dev):
    """Phase 4: CUDA stream == CPU plain-path stream; decoder == recon."""
    import numpy as np
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (Av1Decoder,
                                                         EncoderConfig,
                                                         GpuFrameEncoder)
    frame = testframes.make_frame(352, 288, seed=SEED)
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
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder import tpu_intra
    frame = testframes.make_frame(1920, 1080)
    cfg = EncoderConfig(base_q_idx=100)
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    # the first encode walks the key eagerly; of the 3 steady frames the
    # first captures the walk as a CUDA graph (its launches count) and the
    # other two replay it, without a launch
    tpu_intra._PLAN_GRAPHS.clear()
    pkt, enc, first_s, times, plans, packs, counts = _steady(
        dev, frame, cfg, kernels)
    _need("1080p", counts, counts)
    # a fourth frame replays: its host launches are KC's alone
    _reset(kernels)
    enc4 = GpuFrameEncoder(frame, cfg, device=dev)
    if enc4.encode() != pkt:
        raise AssertionError("1080p: a replayed frame differs from the first")
    replay = _counts(kernels)
    if enc4.timings["plan_graph"] != 1 or replay.get("intra_pred", 0) or \
            replay.get("txq", 0):
        raise AssertionError(f"1080p: the fourth frame did not replay the "
                             f"walk ({enc4.timings['plan_graph']}, {replay})")
    # the card runs the walk every frame, launched or replayed
    per_frame = {k: v - 2 * replay.get(k, 0) for k, v in counts.items()}
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
    # one pick and one KB per luma 32 and per 16 quad, per chroma 16 and
    # 8 quad: 10 of each per diagonal step, 93 steps (34 x 60 cells)
    picks = per_frame.get("intra_pred", 0)
    if picks != 10 * (34 + 60 - 1) or picks != sum(
            per_frame.get(f"intra_pred pick bs{b}", 0) for b in (8, 16, 32)):
        raise AssertionError(f"1080p: {picks} KA launches per frame, want "
                             f"930 picks")
    # one KB launch per pick, all through the in-place entry
    kbs = per_frame.get("txq", 0)
    if kbs != picks or kbs != sum(
            per_frame.get(f"txq step bs{b}", 0) for b in (8, 16, 32)):
        raise AssertionError(f"1080p: {kbs} KB launches per frame, want "
                             f"930 txq_step launches")
    cpu_s = _cpu_equal("1080p", frame, cfg, pkt)
    med = statistics.median(times)
    log(f"[5] KA launches the card runs per 1080p KEY frame: {picks} (all "
        f"picks); KB: {kbs} (all txq_step); from the host, one walk over "
        f"the 3 steady frames (a capture, two replays) and none in a "
        f"replayed frame: {json.dumps(replay)}")
    log(f"[5] 1080p q100: {len(pkt)} bytes, luma PSNR {psnr:.3f} dB, first "
        f"frame {first_s:.3f} s, steady median {med:.4f} s/frame "
        f"({1 / med:.3f} fps, min {min(times):.4f}, max {max(times):.4f}), "
        f"plan {statistics.median(plans):.4f} s, pack+lpf "
        f"{statistics.median(packs):.4f} s, lf {enc.fh.lf.filter_level} "
        f"{enc.fh.lf.filter_level_u} {enc.fh.lf.filter_level_v}; CUDA == "
        f"CPU plain stream (CPU encode {cpu_s:.1f} s)")
    log(f"[5] host launches over the 3 steady frames: {json.dumps(counts)}")
    return (counts, per_frame, replay), frame, cfg, med, pkt, enc


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
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "kc_tile_kernel" in e.key]
    log(f"[6] KC: {sum(e.count for e in rows)} launches, "
        f"{sum(e.self_device_time_total for e in rows) / 1e3:.4f} ms of "
        f"device time in the KEY frame")


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
    from aom_av1_psy_tpu_torch.utils import testframes

    rng = np.random.default_rng(SEED + 1)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    frame = testframes.make_gop(1920, 1080, 2, seed=SEED)[1]
    y = np.zeros((1088, 1920), np.int32)
    y[:1080] = frame.planes()[0]
    y[1080:] = y[1079]
    y[:64, :256] = 90                                  # flat: ties
    uv = np.zeros((544, 960), np.int32)
    uv[:540] = frame.planes()[1]
    uv[540:] = uv[539]
    results = []

    # ---- KD: every phase, all 3 families, MVs past every border, every K
    # the plan uses (1, 2, 3, 5, 9) at bw 8 / 16 / 32 ----
    kern3 = TI._all_kernels(str(dev))
    err, times, cases = 0.0, None, []
    for bw, B, K, plane, (ch, cw) in ((16, 8160, 9, y, (1080, 1920)),
                                      (16, 8160, 2, y, (1080, 1920)),
                                      (32, 2040, 5, y, (1080, 1920)),
                                      (32, 2040, 1, y, (1080, 1920)),
                                      (8, 8160, 3, uv, (540, 960)),
                                      (8, 8160, 1, uv, (540, 960)),
                                      (16, 2040, 3, uv, (540, 960)),
                                      (16, 2040, 1, uv, (540, 960))):
        ncols = plane.shape[1] // bw
        by, bx = TI._origins(B, ncols, bw, str(dev))
        ph = (np.arange(K)[:, None] * 37 + np.arange(B)[None, :]) % 256
        mag = np.where(rng.random((K, B)) < .2, 4 * bw, 2 * bw)
        qr = 16 * rng.integers(-mag, mag + 1) + ph // 16
        qc = 16 * rng.integers(-mag, mag + 1) + ph % 16
        kern = kern3[torch.arange(K, device=dev) % 3]
        src = t(rng.integers(0, 256, (B, bw, bw)))
        a = (t(plane), by, bx, t(qr), t(qc), bw, ch, cw, kern)
        want = MC.mc_8tap_plain(*a, src=src)
        err = max(err, compare(f"KD bw{bw} K{K}", MC.mc_8tap(*a, src=src),
                               want))
        err = max(err, compare(f"KD bw{bw} K{K} no-src", MC.mc_8tap(*a)[0],
                               want[0]))
        got = MC.mc_8tap(*a, src=src, want_pred=False)
        if got[0] is not None:
            raise AssertionError("KD: a prediction without want_pred")
        err = max(err, compare(f"KD bw{bw} K{K} sad-only", got[1:],
                               want[1:]))
        cases.append(f"bw{bw} K{K} B{B}")
        if bw == 16 and K == 9:
            sad_only = lambda: MC.mc_8tap(*a, src=src, want_pred=False)
            times = (cuda_time(sad_only, 20),
                     cuda_time(lambda: MC.mc_8tap_plain(*a, src=src), 3),
                     device_ms(sad_only, 20, "kd_kernel"))
            # each input read once (the plane, the origins, the MVs, the
            # taps and the blocks), each output written once; 8 + 8 taps
            # of 2 operations and 3 for the SAD per pixel
            bnd = bound(nbytes(a, src, sad_only()), 35 * K * B * bw * bw)
    results.append({"name": "mc_8tap", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/mc.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_inter.py:78",
                    "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                    "device_ms": times[2], **bnd, "library_ms": None,
                    "library_none": "no single PyTorch call rounds between "
                                    "the two 8-tap passes",
                    "timed_at": "luma bw16 K=9 B=8160, SAD only (subpel "
                                "step)"})
    log(f"[3b] KD mc_8tap exact at {', '.join(cases)} (256 phases, 3 "
        f"families, MVs past the borders; with src, without, SAD only); "
        f"bw16 K=9 B=8160: kernel {times[0]:.4f} ms (device "
        f"{times[2]} ms), plain {times[1]:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")

    # ---- KE: bw 8 on the half-resolution plane, bw 16 with centres; the
    # same at 10 bits (the 32-bit strips), windows past every border ----
    err, ke_t = 0.0, {}
    half = (y[0::2, 0::2] + y[1::2, 0::2] + y[0::2, 1::2] + y[1::2, 1::2]
            + 2) >> 2
    n = 2 * FP.SEARCH_RAD + 1
    for bw, plane, (ch, cw), cen in ((8, half, (540, 960), False),
                                     (16, y, (1080, 1920), True),
                                     (8, half, (540, 960), True),
                                     (16, y, (1080, 1920), False)):
        B = 8160
        by, bx = TI._origins(B, 120, bw, str(dev))
        for bits in (8, 10):
            pl = plane if bits == 8 else plane * 4 + 3
            src = TI._blocks(t(np.roll(pl, (3, -5), (0, 1))), bw)
            src = src.contiguous()
            kw = {}
            if cen:
                kw = dict(cy=t(rng.integers(-48, 49, B)),
                          cx=t(rng.integers(-48, 49, B)))
            a = (src, t(pl), by, bx, ch, cw, bw)
            tag = f"bw{bw}{' centres' if cen else ''}{' 10-bit' * (bits > 8)}"
            err = max(err, compare(f"KE {tag}", FP.fullpel_search(*a, **kw),
                                   FP.fullpel_search_plain(*a, **kw)))
            if bits == 8 and (bw == 16) == cen:
                # 33 x 33 offsets, 3 operations per pixel of each SSD
                ke_t[bw] = (
                    cuda_time(lambda: FP.fullpel_search(*a, **kw), 10),
                    cuda_time(lambda: FP.fullpel_search_plain(*a, **kw), 2),
                    device_ms(lambda: FP.fullpel_search(*a, **kw), 20,
                              "ke_strip_kernel"),
                    bound(nbytes(a, kw, FP.fullpel_search(*a, **kw)),
                          3 * n * n * B * bw * bw))
    results.append({"name": "fullpel_ssd", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/fullpel.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/tpu_inter.py:106",
                    "max_abs_err": err, "ms": ke_t[16][0],
                    "plain_ms": ke_t[16][1], **ke_t[16][3],
                    "device_ms": ke_t[16][2], "bw8_ms": ke_t[8][0],
                    "bw8_plain_ms": ke_t[8][1], "bw8_device_ms": ke_t[8][2],
                    "bw8_bound_ms": ke_t[8][3]["bound_ms"],
                    "library_ms": None,
                    "library_none": "no single PyTorch call takes the integer"
                                    " SSD argmin over a window",
                    "timed_at": "bw16 B=8160 with centres, 1088x1920 (bw8_*:"
                                " B=8160 on the 544x960 half plane)"})
    log(f"[3b] KE fullpel_ssd exact at bw8 B=8160 (544x960) and bw16 "
        f"B=8160, with and without centres (to +-48: windows past every "
        f"border of the crop), 8-bit (words) and 10-bit (32-bit strips), "
        f"flat region (ties); "
        + "; ".join(f"bw{k}: kernel {v[0]:.4f} ms (device {v[2]} ms), plain "
                    f"{v[1]:.4f} ms, bound {v[3]['bound_ms']:.4f} ms "
                    f"({v[3]['bound_by']})" for k, v in sorted(ke_t.items())))

    # ---- KF: the direction search at 1088x1920 (and on the extreme
    # blocks), the frame pass (3 planes, the sources, phase 3b's mixes) and
    # the per-plane entry, against their plain versions ----
    from aom_av1_psy_tpu_torch.ops.cdef import find_dir_blocks
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from cdef_cases import as_plane, extreme_blocks
    mh, mw = 1080, 1920
    yd = t(y)
    yb = y[:mh, :mw].reshape(135, 8, 240, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    t0 = time.perf_counter()
    dirs, var = find_dir_blocks(yb, 0)
    numpy_ms = 1e3 * (time.perf_counter() - t0)
    dirs, var = t(dirs), t(var.astype(np.int32))

    def search(plane, ph, pw):
        """The frame pass on one plane with every block all-skip (the
        search, and the plane copied): its directions and variances."""
        skip = torch.ones((ph // 8, pw // 8), dtype=torch.bool, device=dev)
        return CT.cdef_frame((plane,), skip, 1, 1, 0, 0, 4, mi_rows=ph // 4,
                             mi_cols=pw // 4, nplanes=1)[1:3]

    err = compare("KF search vs numpy", search(yd, mh, mw), (dirs, var))
    err = max(err, compare("KF search", search(yd, mh, mw),
                           CT.find_dir_plain(yd, mh, mw)))
    xb = extreme_blocks()
    xd, xv = find_dir_blocks(xb, 0)
    err = max(err, compare("KF search extreme blocks",
                           search(t(as_plane(xb)), 8, 8 * len(xb)),
                           (t(xd), t(xv.astype(np.int32)))))
    dir_t = (cuda_time(lambda: search(yd, mh, mw), 20),
             cuda_time(lambda: CT.find_dir_plain(yd, mh, mw), 3),
             device_ms(lambda: search(yd, mh, mw), 20, "kf_tile_kernel"))
    # the luma read and written (copied), the directions and variances
    # written; 15 line sums of 8 directions (2 operations a pixel and
    # direction), ~60 operations per block for the costs and the argmax
    dir_bnd = bound(2 * nbytes(yd) + 2 * dirs.numel() * 4,
                    16 * mh * mw + 60 * dirs.numel())
    touched = t(rng.random(dirs.shape[0]) < .7, torch.bool)
    skip8 = ~touched.reshape(135, 240)
    planes = (yd, t(uv), t(np.roll(uv, 5, 1)))
    srcs = [t(np.clip(np.asarray(p.cpu()) + rng.integers(-9, 10, p.shape),
                      0, 255)) for p in planes]
    for st in ((4, 2, 3, 2, 5), (0, 2, 0, 2, 5), (5, 0, 4, 0, 5),
               (0, 0, 0, 0, 5), (15, 4, 12, 4, 6), (1, 1, 0, 1, 4)):
        for npl, sr in ((3, srcs), (3, None), (1, srcs[:1])):
            kw = dict(mi_rows=mh // 4, mi_cols=mw // 4, nplanes=npl,
                      srcs=sr)
            got = CT.cdef_frame(planes, skip8, *st, **kw)
            want = CT.cdef_frame_plain(planes, skip8, *st, **kw)
            tag = f"KF frame {st} nplanes {npl}{' srcs' * (sr is not None)}"
            err = max(err, compare(tag, got[0] + got[1:3],
                                   want[0] + want[1:3]))
            if sr is not None:
                err = max(err, compare(tag + " sums", got[3], want[3]))
    kw = dict(mi_rows=mh // 4, mi_cols=mw // 4, nplanes=3, srcs=srcs)
    st = (1, 1, 0, 1, 4)                       # the P-frame's at q100
    frame = lambda: CT.cdef_frame(planes, skip8, *st, **kw)
    frame_t = (cuda_time(frame, 20),
               cuda_time(lambda: CT.cdef_frame_plain(planes, skip8, *st,
                                                     **kw), 3),
               device_ms(frame, 20, "kf_tile_kernel"))
    # the planes read and written, the sources, the block maps; 12 taps of
    # ~11 operations per filtered pixel and the search's ~16
    npx = mh * mw * 3 // 2
    frame_bnd = bound(nbytes(planes, frame(), srcs, skip8),
                      150 * npx + 16 * mh * mw)
    for pri, sec in ((4, 2), (0, 2), (5, 0), (0, 0), (15, 4)):
        for plane, bs, v, dmp in ((yd, 8, var, 5), (t(uv), 4, None, 4)):
            ph, pw = (mh, mw) if bs == 8 else (mh // 2, mw // 2)
            a = (plane, ph, pw, bs, touched, dirs, v, pri, sec, dmp)
            err = max(err, compare(f"KF bs{bs} pri{pri} sec{sec}",
                                   CT.cdef_filter(*a),
                                   CT.cdef_filter_plain(*a)))
            if bs == 8 and pri == 4:
                plane_t = (cuda_time(lambda: CT.cdef_filter(*a), 20),
                           cuda_time(lambda: CT.cdef_filter_plain(*a), 3),
                           device_ms(lambda: CT.cdef_filter(*a), 20,
                                     "kf_tile_kernel"))
                plane_bnd = bound(nbytes(a, CT.cdef_filter(*a)),
                                  150 * ph * pw)
    results.append({"name": "cdef_filter", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/cdef.cu",
                    "replaces": "aom_av1_psy_tpu/ops/cdef_jax.py:144",
                    "max_abs_err": err, "ms": frame_t[0],
                    "plain_ms": frame_t[1], "device_ms": frame_t[2],
                    **frame_bnd, "library_ms": None,
                    "library_none": "no single PyTorch call runs the CDEF "
                                    "direction search and filter",
                    "timed_at": "the frame pass cdef_frame: 1088x1920 luma "
                                "(1080x1920 filtered), 544x960 chroma, the "
                                "sources, 70 % of the blocks touched, "
                                "(1, 1, 0, 1, 4)",
                    "search_ms": dir_t[0], "search_plain_ms": dir_t[1],
                    "search_device_ms": dir_t[2],
                    "search_bound_ms": dir_bnd["bound_ms"],
                    "search_numpy_ms": numpy_ms,
                    "search_timed_at": "the frame pass on the 1088x1920 "
                                       "luma alone, every block all-skip "
                                       "(search_plain_ms: find_dir_plain)",
                    "plane_ms": plane_t[0], "plane_plain_ms": plane_t[1],
                    "plane_device_ms": plane_t[2],
                    "plane_bound_ms": plane_bnd["bound_ms"],
                    "plane_timed_at": "cdef_filter luma 1088x1920, pri 4 "
                                      "sec 2"})
    log(f"[3b] KF exact: the direction search at 1080x1920 (== numpy "
        f"find_dir_blocks, == find_dir_plain) and on {len(xb)} extreme "
        f"blocks; the frame pass at "
        f"1088x1920 / 544x960 with (y_pri, y_sec, uv_pri, uv_sec, damping) "
        f"in (4,2,3,2,5) (0,2,0,2,5) (5,0,4,0,5) (0,0,0,0,5) (15,4,12,4,6) "
        f"(1,1,0,1,4), 3 planes with and without the sources, luma alone; "
        f"cdef_filter at (pri, sec) (4,2) (0,2) (5,0) (0,0) (15,4)")
    log(f"[3b] KF frame pass (1,1,0,1,4) with sources: kernel "
        f"{frame_t[0]:.4f} ms (device {frame_t[2]} ms), plain "
        f"{frame_t[1]:.4f} ms, bound {frame_bnd['bound_ms']:.4f} ms "
        f"({frame_bnd['bound_by']}); the search (luma alone, every block "
        f"all-skip): kernel {dir_t[0]:.4f} ms (device {dir_t[2]} ms), "
        f"find_dir_plain {dir_t[1]:.4f} ms, numpy find_dir_blocks "
        f"{numpy_ms:.1f} ms, bound "
        f"{dir_bnd['bound_ms']:.5f} ms; cdef_filter luma (4, 2): kernel "
        f"{plane_t[0]:.4f} ms (device {plane_t[2]} ms), plain "
        f"{plane_t[1]:.4f} ms, bound {plane_bnd['bound_ms']:.4f} ms")

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
        err = compare(f"KB bs{bs} B={B}", TQ.txq_recon_skip(*a),
                      TQ.txq_recon_skip_plain(*a))
        kb = (cuda_time(lambda: TQ.txq_recon_skip(*a), 10),
              cuda_time(lambda: TQ.txq_recon_skip_plain(*a), 2),
              device_ms(lambda: TQ.txq_recon_skip(*a), 10,
                        "kb_batch_kernel"))
        kb_bnd = bound(nbytes(a, TQ.txq_recon_skip(*a)), _txq_ops(B, bs))
        log(f"[3b] KB txq_recon_skip exact at bs{bs} B={B}: kernel "
            f"{kb[0]:.4f} ms (device {kb[2]} ms), plain {kb[1]:.4f} ms, "
            f"bound {kb_bnd['bound_ms']:.5f} ms ({kb_bnd['bound_by']})")
        # K6 / K7: the P-frame's luma TQ (8160 16x16, 2040 32x32) and
        # chroma TQ (U and V of 4080 16x16 chroma blocks as 8x8 transforms)
        name, replaces, what = {
            8: ("txq_recon_skip bs8 P chroma", "tpu_inter.py:375",
                "bs8 B=8160 (1080p P-frame chroma)"),
            16: ("txq_recon_skip bs16 P", "tpu_inter.py:197",
                 "bs16 B=8160 (1080p P-frame luma 16)"),
            32: ("txq_recon_skip bs32 P", "tpu_inter.py:197",
                 "bs32 B=2040 (1080p P-frame luma 32)")}[bs]
        results.append({
            "name": name, "route": "cuda",
            "source": "aom_av1_psy_tpu_torch/csrc/txq.cu",
            "replaces": f"aom_av1_psy_tpu/encoder/{replaces}",
            "max_abs_err": err, "ms": kb[0], "plain_ms": kb[1],
            "device_ms": kb[2], **kb_bnd, "library_ms": None,
            "library_none": "no single PyTorch call runs the integer AV1 "
                            "transforms, quantizer and skip decision",
            "timed_at": what})
    return results


def _decodes_to_chain(tag, packets, encs):
    import numpy as np
    from aom_av1_psy_tpu_torch.decoder.obu import Av1Decoder
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
        _ref_chain_planes, displayed_encoders)
    dec, out = Av1Decoder(), []
    for p in packets:
        out.extend(dec.decode_packet(p))
    shown = displayed_encoders(encs)
    if len(out) != len(shown):
        raise AssertionError(f"{tag}: {len(out)} frames decoded, "
                             f"{len(shown)} displayed")
    for i, (f, enc) in enumerate(zip(out, shown)):
        for name, d, r in zip("yuv", f.planes(), _ref_chain_planes(enc)):
            r = r.cpu().numpy()[: d.shape[0], : d.shape[1]]
            if not np.array_equal(d.astype(np.int32), r):
                raise AssertionError(f"{tag}: frame {i} {name} differs from "
                                     "the reference chain")


def closed_loop_gop_cif(dev):
    """Phase 4b: CIF GOP, CUDA packets == CPU plain packets; decodes to
    the chain."""
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video
    frames = testframes.make_gop(352, 288, 4)
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
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
        GpuInterFrameEncoder, _ref_chain_planes, encode_video)
    frames = testframes.make_gop(1920, 1080, 5)
    cfg = EncoderConfig(base_q_idx=100)
    t0 = time.perf_counter()
    warm, _ = encode_video(frames, cfg, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _reset(kernels)
    t0 = time.perf_counter()
    pk, encs = encode_video(frames, cfg, device=dev)
    torch.cuda.synchronize()
    gop_s = time.perf_counter() - t0
    counts = _counts(kernels)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in the GOP")
    # KF: the frame pass (direction search fused) and no other entry, at
    # most 2 launches per frame
    if counts["temporal_filter"] != 1:
        raise AssertionError(f"1080p GOP: {counts['temporal_filter']} KK "
                             f"launches for one filtered KEY frame")
    if counts.get("cdef frame search", 0) != counts["cdef"] or \
            counts["cdef"] > 2 * len(frames):
        raise AssertionError(f"1080p GOP: KF launches {counts['cdef']}, "
                             f"frame passes "
                             f"{counts.get('cdef frame search', 0)}")
    if pk != warm:
        raise AssertionError("1080p GOP: second run differs from the first")
    for i, (p, e) in enumerate(zip(pk, encs)):
        c = e.fh.cdef
        log(f"[5b] frame {i} {'KEY' if i == 0 else 'P'}: {len(p)} bytes, "
            f"plan {e.timings['plan_s']:.4f} s, pack "
            f"{e.timings['pack_s']:.4f} s"
            + (" (script + native coder {script_s:.4f})"
               .format(**e.pack_stages) if i else "")
            + f", lf {e.fh.lf.filter_level} "
            f"{e.fh.lf.filter_level_u} {e.fh.lf.filter_level_v}, cdef "
            f"y {c.y_pri[0]}/{c.y_sec[0]} uv {c.uv_pri[0]}/{c.uv_sec[0]}"
            + (f", interp {e.fh.interp_filter}" if i else ""))
    src = np.asarray(frames[-1].planes()[0], np.float64)
    rec = encs[-1].ref_planes_out[0].cpu().numpy()[:1080, :1920]
    psnr = 10 * np.log10(255 ** 2 / max(float(((rec - src) ** 2).mean()),
                                        1e-9))
    if not (rec.min() >= 0 and rec.max() <= 255 and psnr > 30):
        raise AssertionError(f"1080p GOP: bad last recon (PSNR {psnr:.2f})")
    # the KEY frame's temporal filter (KJ + KK) alone
    from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
    t0 = time.perf_counter()
    TF.filter_key_frame(frames, 0, max(8, cfg.base_q_idx - 60), device=dev)
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
        f"(the KEY temporal filter in it {encs[0].tf_s:.4f} s, alone "
        f"{tf_s:.4f} s), "
        f"P-frame median {med:.4f} s/frame ({1 / med:.3f} fps, min "
        f"{min(p_s):.4f}, max {max(p_s):.4f}; plan "
        f"{statistics.median(e.timings['plan_s'] for e in encs[1:]):.4f} s, "
        f"pack+lpf+cdef "
        f"{statistics.median(e.timings['pack_s'] for e in encs[1:]):.4f} "
        f"s: script_s "
        f"{statistics.median(e.pack_stages['script_s'] for e in encs[1:]):.4f}"
        f"), last-frame luma PSNR {psnr:.3f} dB; GOP == CPU plain path "
        f"(CPU GOP {cpu_s:.1f} s)")
    log(f"[5b] launches in the GOP: {json.dumps(counts)}")
    log(f"[5b] KK span launches per filtered KEY frame: "
        f"{counts['temporal_filter']}")
    rate = sum(map(len, pk)) * 8 * 30.0 / len(pk)
    return counts, frames, encs, rate


def profile_p_frame(dev, frames, encs):
    """Phase 6b: device time by kernel over one steady 1080p P-frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import \
        GpuInterFrameEncoder
    prev = encs[1]
    cfg = encs[2].cfg
    from aom_av1_psy_tpu_torch.utils import trace
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc = GpuInterFrameEncoder(frames[2], cfg, prev.seq,
                                   prev.ref_planes_out, 1920, 1080,
                                   prev_fc=prev.saved_fc, device=dev)
        enc.encode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the LPF pick and CDEF stages of the pack: its spans' timeline records
    tm = {**enc.timings, **enc.pack_stages}
    for name in ("lpf", "cdef"):
        tm[name + "_s"] = sum((r[2] - r[1]) / 1e9 for r in trace.records()
                              if r[0] == name)
    _device_rows("6b", prof, wall, f"plan {tm['plan_s']:.4f} s, "
                 f"pack {tm['pack_s']:.4f} s (LPF {tm['lpf_s']:.4f}, CDEF "
                 f"host {tm['cdef_s']:.4f}, script + native coder "
                 f"{tm['script_s']:.4f})")
    for kernel, key in (("KD", "kd_kernel"), ("KE", "ke_strip_kernel"),
                        ("KC", "kc_tile_kernel"), ("KF", "kf_tile_kernel")):
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and key in e.key]
        log(f"[6b] {kernel}: {sum(e.count for e in rows)} launches, "
            f"{sum(e.self_device_time_total for e in rows) / 1e3:.4f} ms of "
            f"device time in the P-frame")


def _kj_edge_cases(dev):
    """KJ's strip tiling at its edges, both entries against their plain
    versions: m = 33, 13 and 5 (not multiples of the strip's 12 offsets);
    B = 1; the host inter encoder's largest block at radius 16 (64x64);
    the 32-bit path (a width of 30, values up to 1023); flat blocks on a
    flat patch (ties); the cost grid; the stride-4 coarse level. Returns
    the max error (0)."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.ops import mvsearch as MV
    rng = np.random.default_rng(SEED + 5)
    err, names = 0.0, []
    for h, w, r, B, spb, top in ((64, 64, 16, 1, 0, 256),
                                 (64, 64, 16, 3, 4, 256),
                                 (32, 32, 16, 1, 0, 256),
                                 (16, 16, 6, 300, 4, 256),
                                 (8, 8, 2, 300, 0, 256),
                                 (24, 24, 16, 60, 0, 256),
                                 (32, 30, 16, 60, 0, 256),
                                 (32, 32, 16, 60, 4, 1024)):
        m = 2 * r + 1
        wh, ww = h + m - 1, w + m - 1
        H, W = 3 * wh, 3 * ww
        plane = rng.integers(0, top, (H, W))
        plane[:wh, :ww] = 128                          # flat: ties
        oy = rng.integers(0, H - wh + 1, B)
        ox = rng.integers(0, W - ww + 1, B)
        oy[0] = ox[0] = 0
        src = rng.integers(0, min(top, 256), (B, h, w))
        src[0] = 128
        for b in range(1, B, 2):                       # planted matches
            dy, dx = rng.integers(0, m, 2)
            y, x = oy[b] + dy, ox[b] + dx
            src[b] = plane[y:y + h, x:x + w]
        t = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
        P, S, Y, X = t(plane), t(src), t(oy), t(ox)
        cost = None
        if spb:
            cost = torch.as_tensor(MV._cost_grid(r, spb).reshape(-1),
                                   device=dev)
        win = MV.cut(P, Y.long(), X.long(), wh, ww)
        want = MV.sad_argmin_plain(S, win, m, 1, cost)
        err = max(err, compare(f"KJ edge {h}x{w} r{r} B{B}",
                               MV.sad_argmin(S, win, m, 1, cost), want))
        err = max(err, compare(f"KJ plane edge {h}x{w} r{r} B{B}",
                               MV.sad_argmin_plane(S, P, Y, X, m, cost),
                               MV.sad_argmin_plane_plain(S, P, Y, X, m,
                                                         cost)))
        err = max(err, compare(f"KJ plane edge {h}x{w} vs windows",
                               MV.sad_argmin_plane(S, P, Y, X, m, cost),
                               want))
        names.append(f"{h}x{w} r{r} B{B}")
    # the coarse level of full_pel_hierarchical: stride 4, m = 9
    B, h, w, m, step = 60, 32, 32, 9, 4
    win = rng.integers(0, 256, (B, h + (m - 1) * step, w + (m - 1) * step))
    win[-2:] = 128
    src = rng.integers(0, 256, (B, h, w))
    src[-2:] = 128
    src[0] = win[0, 8:8 + h, 12:12 + w]
    S, Wn = (torch.as_tensor(a.astype(np.int32), device=dev)
             for a in (src, win))
    err = max(err, compare("KJ coarse stride 4", MV.sad_argmin(S, Wn, m,
                                                               step),
                           MV.sad_argmin_plain(S, Wn, m, step)))
    log(f"[3e] KJ edge cases exact, both entries: {', '.join(names)}; the "
        f"stride-4 coarse level (m = 9, B = 60)")
    return err


def check_tf_kernels(dev):
    """Phase 3e: KJ and KK against their plain versions at 1080p: KJ at
    the shapes of one ARF span (``make_gop(1920, 1080, 5)``, centre 2) on
    the full 32x32 blocks and on the 24-tall bottom row, ``full_pel_
    hierarchical`` (radius 16, step 4) on the same blocks against the plain
    path on CPU tensors; KK's span pass at the KEY span of phase 5b and the
    first ARF span of phase 5g against the plain version on the card (the
    KEY span also on CPU tensors); KK's weight against ``np.exp`` at every
    truncation boundary and its division at every window total. Exact
    equality throughout."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
    from aom_av1_psy_tpu_torch.ops import mvsearch as MV
    from aom_av1_psy_tpu_torch.utils import testframes
    frames = testframes.make_gop(1920, 1080, 5)
    planes = TF.upload([f.planes() for f in frames], dev)
    grid = TF.SpanGrid(planes[2])
    rad = TF.SEARCH_RAD
    n = 2 * rad + 1
    results = []

    # ---- KJ: frame 0 against the centre, every block shape, both entries
    padded = grid.padded(planes[0][0])
    err, shapes = 0.0, []
    for (h, w), ids in grid.groups:
        src = grid.src[(h, w)]
        oy, ox = grid.origins[(h, w)]
        win = MV.cut(padded, oy, ox, h + 2 * rad, w + 2 * rad)
        shapes.append(f"{tuple(src.shape)}")
        want = MV.full_pel_grid_search_plain(src, win, rad)
        err = max(err, compare(f"KJ {tuple(src.shape)}",
                               MV.full_pel_grid_search(src, win, rad), want))
        err = max(err, compare(
            f"KJ plane {tuple(src.shape)}",
            MV.full_pel_plane_search(src, padded, oy, ox, rad),
            MV.full_pel_plane_search_plain(src, padded, oy, ox, rad)))
        err = max(err, compare(
            f"KJ plane {tuple(src.shape)} vs windows",
            MV.full_pel_plane_search(src, padded, oy, ox, rad), want))
        hier = MV.full_pel_hierarchical(src, win, rad, step=4)
        want = MV.full_pel_hierarchical(src.cpu(), win.cpu(), rad, step=4)
        err = max(err, compare(f"KJ hierarchical {tuple(src.shape)}",
                               tuple(x.cpu() for x in hier), want))
        if (h, w) == (32, 32):
            B = src.shape[0]
            on_windows = lambda: MV.full_pel_grid_search(src, win, rad)
            on_plane = lambda: MV.full_pel_plane_search(src, padded, oy, ox,
                                                        rad)
            kj_t = (cuda_time(on_windows, 20),
                    cuda_time(lambda: MV.full_pel_grid_search_plain(
                        src, win, rad), 2),
                    device_ms(on_windows, 20, "kj_kernel"),
                    cuda_time(on_plane, 20),
                    device_ms(on_plane, 20, "kj_kernel"))
            # 33 x 33 offsets, 3 operations (difference, absolute value,
            # add) per pixel of each SAD
            kj_bnd = bound(nbytes(src, win, on_windows()),
                           3 * n * n * B * 32 * 32)
    err = max(err, _kj_edge_cases(dev))
    results.append({"name": "fullpel_sad", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/mvsearch.cu",
                    "replaces": "aom_av1_psy_tpu/ops/mvsearch.py:48",
                    "max_abs_err": err, "ms": kj_t[0], "plain_ms": kj_t[1],
                    "device_ms": kj_t[2], "plane_ms": kj_t[3],
                    "plane_device_ms": kj_t[4], **kj_bnd,
                    "library_ms": None,
                    "library_none": "no single PyTorch call takes the SAD "
                                    "argmin over a window",
                    "timed_at": "B=1980 32x32 blocks, radius 16, 64x64 "
                                "windows (1080p); plane_*: the plane entry "
                                "(the temporal filter's) on the same blocks"})
    log(f"[3e] KJ fullpel_sad exact on blocks {shapes} (radius 16), both "
        f"entries, and full_pel_hierarchical (step 4) == the CPU plain "
        f"path; the edge cases exact; 32x32 B=1980: windows "
        f"{kj_t[0]:.4f} ms (device {kj_t[2]} ms), plane entry "
        f"{kj_t[3]:.4f} ms (device {kj_t[4]} ms), plain {kj_t[1]:.4f} ms, "
        f"bound {kj_bnd['bound_ms']:.4f} ms ({kj_bnd['bound_by']})")

    # ---- KK: the span pass at the 5b KEY span and the 5g ARF span ----
    from aom_av1_psy_tpu_torch.normative import tables
    spans = {}
    for tag, n_gop, lo, hi, c, q_idx, strength in (
            ("key", 5, 0, 3, 0, 40, 1), ("arf", 9, 2, 7, 2, 100, 2)):
        # the KEY span of filter_key_frame (q 100 - 60, strength 1) and
        # the first ARF span of encode_video_arf (group 4: frames 2-6,
        # centre 4; strength 2 at the group's q)
        span = testframes.make_gop(1920, 1080, n_gop)[lo:hi]
        sp = TF.upload([f.planes() for f in span], dev)
        sgrid = TF.SpanGrid(sp[c])
        mvs = torch.zeros((len(sp), sgrid.B, 2), dtype=torch.int32,
                          device=dev)
        for fi, f in enumerate(sp):
            if fi != c:
                mvs[fi] = sgrid.motion_inputs(f)
        noise = [max(TF.estimate_noise_level(p), 0.0) for p in sp[c]]
        params = TF.filter_params(max(1, tables.ac_quant(q_idx) // 4),
                                  strength, noise)
        args = (c, sp, mvs, params)
        got = TF.tf_span_filter(*args)
        err = compare(f"KK {tag} span", tuple(got),
                      tuple(TF.tf_span_filter_plain(*args)))
        if tag == "key":
            err = max(err, compare(
                "KK key span vs CPU plain", tuple(x.cpu() for x in got),
                tuple(TF.tf_span_filter(c, [[p.cpu() for p in f]
                                            for f in sp], mvs.cpu(),
                                        params))))
        else:
            # weights near 1000 (q factor 30000), where every frame counts
            hi_q = (c, sp, mvs, TF.filter_params(30000, strength, noise))
            got_hi = TF.tf_span_filter(*hi_q)
            err = max(err, compare("KK arf span q 30000", tuple(got_hi),
                                   tuple(TF.tf_span_filter_plain(*hi_q))))
            if torch.equal(got_hi[0], sp[c][0].to(torch.uint8)):
                raise AssertionError("KK arf span at q 30000: the luma is "
                                     "unfiltered")
        changed = [float((o != p).double().mean()) for o, p in zip(got, sp[c])]
        npix = sum(p.numel() for p in sp[c])
        # per pixel and non-centre frame: the difference and square, 10
        # separable window adds, 4 luma adds (chroma), the accumulation;
        # 11 float64 operations (conversions, the divide, 4 products, the
        # sum, the clamp and the threshold compares); the rounding per pixel
        k = len(sp) - 1
        spans[tag] = {
            "err": err, "frames": len(sp), "changed": changed,
            "ms": cuda_time(lambda: TF.tf_span_filter(*args), 20),
            "device_ms": device_ms(lambda: TF.tf_span_filter(*args), 20,
                                   "kk_span_kernel"),
            "plain_ms": cuda_time(lambda: TF.tf_span_filter_plain(*args),
                                  3),
            **bound(nbytes(sp, mvs, got), (20 * k + 5) * npix,
                    11 * k * npix)}
    arf, key = spans["arf"], spans["key"]
    results.append({"name": "tf_span_filter", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/temporal_filter.cu",
                    "replaces": "aom_av1_psy_tpu/encoder/temporal_filter.py"
                                ":33 (host numpy, not a TPU program)",
                    "max_abs_err": max(arf["err"], key["err"]),
                    "ms": arf["ms"], "plain_ms": arf["plain_ms"],
                    "device_ms": arf["device_ms"],
                    "bound_ms": arf["bound_ms"], "bound_by": arf["bound_by"],
                    "library_ms": None,
                    "library_none": "no single PyTorch call weights and "
                                    "accumulates the temporal filter",
                    "timed_at": "the 1080p ARF span of 5g (5 frames, "
                                "centre 2, B=2040); span_key_*: the 1080p "
                                "KEY span of 5b (3 frames, centre 0)",
                    **{f"span_{t}_{m}": spans[t][m] for t in ("key", "arf")
                       for m in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by")}})
    for tag, sp in spans.items():
        log(f"[3e] KK tf_span_filter exact against the plain version at the "
            f"1080p {tag.upper()} span ({sp['frames']} frames"
            + (", and on CPU tensors" if tag == "key" else ", and at q 30000")
            + f"; share of pixels the filter changed, y u v: "
            f"{[round(x, 5) for x in sp['changed']]}): kernel {sp['ms']:.4f} ms (device {sp['device_ms']} ms), "
            f"plain {sp['plain_ms']:.4f} ms, bound {sp['bound_ms']:.4f} ms "
            f"({sp['bound_by']})")

    # ---- KK's weight against np.exp at every truncation boundary ----
    sweep = TF.weight_boundary_values()
    want = (np.exp(-sweep) * TF.TF_WEIGHT_SCALE).astype(np.int64)
    got = TF.tf_weight(torch.as_tensor(sweep, device=dev)).cpu().numpy()
    flips = np.nonzero(got != want)[0]
    if flips.size:
        raise AssertionError(
            f"KK weight differs from np.exp at {flips.size} of {sweep.size} "
            f"boundary values: " + ", ".join(
                f"scaled {sweep[i]!r}: card {got[i]}, numpy {want[i]}"
                for i in flips[:5]))
    log(f"[3e] KK's weight == (np.exp(-s) * 1000).astype(int64) at all "
        f"{sweep.size} boundary values (101 within 50 ulp of each of the "
        f"1000 truncation boundaries, and 0 and 7): no flip")

    # ---- KK's division of the window totals against numpy's ----
    totals = np.arange(TF.MAX_TOTAL + 1, dtype=np.float64)
    for n in (25, 26, 27, 29):
        got = TF.divide_totals(n, dev).cpu().numpy()
        flips = np.nonzero(got != totals / n)[0]
        if flips.size:
            raise AssertionError(
                f"KK: total / {n} differs from numpy's at {flips.size} "
                f"totals, the first {flips[:5].tolist()}")
    log(f"[3e] KK's total / n == numpy's at every total 0..{TF.MAX_TOTAL} "
        f"for n = 25, 26, 27, 29")
    return results


def _luma_1088(frame, dev):
    """The 1080p luma padded to 1088 rows by its last row (int32 on dev),
    the plane KE and KD search at 1080p."""
    return _pad_rows(frame.planes()[0], 1088, dev)


def _pad_rows(plane, rows, dev):
    """An 8-bit plane padded to ``rows`` by its last row (int32 on dev)."""
    import numpy as np
    import torch
    out = np.empty((rows, plane.shape[1]), np.int32)
    out[:plane.shape[0]] = plane
    out[plane.shape[0]:] = plane[-1]
    return torch.as_tensor(out, device=dev)


def _grid(bs, dev):
    """Origins (by, bx) of the bs x bs blocks of the 1088 x 1920 plane."""
    import torch
    by, bx = torch.meshgrid(torch.arange(0, 1088, bs, device=dev),
                            torch.arange(0, 1920, bs, device=dev),
                            indexing="ij")
    return by.reshape(-1), bx.reshape(-1)


def _whole_grid(plane, h, w):
    """Origins (by, bx) of the whole (h, w) blocks of ``plane``."""
    import torch
    by, bx = torch.meshgrid(
        torch.arange(0, plane.shape[0] - h + 1, h, device=plane.device),
        torch.arange(0, plane.shape[1] - w + 1, w, device=plane.device),
        indexing="ij")
    return by.reshape(-1), bx.reshape(-1)


def _cut(plane, r0, c0, h, w, ch=None, cw=None):
    """(B, h, w) patches at origins r0 / c0 (B,), each index clamped to
    [0, ch) x [0, cw) (default: the plane), as the host encoder clamps its
    search windows (``interframe.py:146-148``)."""
    import torch
    ch = plane.shape[0] if ch is None else ch
    cw = plane.shape[1] if cw is None else cw
    ar = torch.arange(max(h, w), device=plane.device)
    rows = (r0[:, None] + ar[None, :h]).clamp(0, ch - 1)
    cols = (c0[:, None] + ar[None, :w]).clamp(0, cw - 1)
    return plane[rows[:, :, None], cols[:, None, :]]


def _path_ops(sx, sy, w, h):
    """Operations of a batch of subpel predictions by the path each item's
    phases select: 2 per tap (8 taps) and ~4 for the rounding and clip per
    output of each pass; the 2-D path's x pass covers h + 7 rows."""
    both = int(((sx > 0) & (sy > 0)).sum())
    one = int(((sx > 0) != (sy > 0)).sum())
    return both * ((h + 7) * w + h * w) * 20 + one * h * w * 20


def _km_ops(B, h, w):
    """The least work of KM on B (h, w) blocks. Sub-pel phases 4, 8 and 12
    each occur at the integer offsets 0 and 1, so one pass per phase over
    one more column (or row) serves both: an x pass per column phase over
    (h + 8) x (w + 1), a y pass per pair of phases over (h + 1) x (w + 1),
    a y-only pass per row phase over (h + 1) x w, the x-only rounding and
    clip (~4 per output) over h x (w + 1) per column phase, the copy, and
    a 3-operation SAD of each of the 49."""
    return B * (3 * (h + 8) * (w + 1) * 20 + 9 * (h + 1) * (w + 1) * 20
                + 3 * (h + 1) * w * 20 + 3 * h * (w + 1) * 4
                + 49 * h * w * 3)


def check_k13b_kernels(dev):
    """Phase 3f: KL, KM, KN and KO against their plain versions on the card
    at the 1080p P-frame's block grid (``make_gop(1920, 1080, 2)``, the
    luma padded to 1088 rows): KL at every path (per-block random phases)
    and interp filter at 16x16 (B = 8160), 8x8, 4x4, 32x32, 64x64, the
    luma's whole 128x128 blocks (B = 120), 12x20 (B = 8640) and 2x2 on the
    u plane padded to 544 rows (B = 130560), with the device time and
    bound at each size; KM on the 49-point lattice at 16x16, at the
    luma's whole 128x128, 128x64, 12x20 and 128x2 blocks and the u plane's
    2x2 blocks, with the device time and bound at each size; KN's reducers
    at 16x16, and sad / sse / variance at 8x8 and 4x4; KO on the 4 x 8160
    8x8 residuals of the 16x16 grid in int32, int16 and int8 and on the
    source blocks in uint8, at B = 32640 and 32637, both variants, with
    the device time (warm and with the L2 flushed) and the host time per
    call. Exact equality; kernel, plain, bound and library times."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from aom_av1_psy_tpu_torch.ops import convolve as CV
    from aom_av1_psy_tpu_torch.ops import metrics as ME
    from aom_av1_psy_tpu_torch.ops import mvsearch as MV
    from aom_av1_psy_tpu_torch.utils import testframes

    rng = np.random.default_rng(SEED + 6)
    frames = testframes.make_gop(1920, 1080, 2, seed=SEED)
    y0, y1 = _luma_1088(frames[0], dev), _luma_1088(frames[1], dev)
    results = []

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.int32)

    # ---- KL: per-block phases (every path) x the four filters, at the
    # square sizes of the luma grid, 12x20 and 2x2 on the chroma plane ----
    # (the sizes after 4x4 draw from their own generator, so that the
    # inputs of KM and of the sizes before stay as they were)
    u0 = _pad_rows(frames[0].planes()[1], 544, dev)
    wide = np.random.default_rng(SEED + 16)
    err, kl = 0.0, {}
    for w, h, plane in ((16, 16, y0), (8, 8, y0), (4, 4, y0), (32, 32, y0),
                        (64, 64, y0), (128, 128, y0), (12, 20, y0),
                        (2, 2, u0)):
        g = rng if w in (16, 8, 4) else wide
        by, bx = _whole_grid(plane, h, w)
        B = by.numel()
        d = t(g.integers(-3, 4, (2, B)))
        reg = _cut(plane, by + d[0] - 3, bx + d[1] - 3, h + 7, w + 7)
        sx, sy = t(g.integers(0, 16, B)), t(g.integers(0, 16, B))
        for interp in range(4):
            a = (reg, w, h, sx, sy, interp, interp)
            got = CV.subpel_predict(*a)
            err = max(err, compare(f"KL {w}x{h} interp {interp}", got,
                                   CV.subpel_predict_plain(*a)))
        kl[w, h] = (reg, sx, sy, got)
    kl_sizes = {}
    for (w, h), (reg, sx, sy, got) in kl.items():
        a = (reg, w, h, sx, sy)
        kl_sizes[f"{w}x{h}"] = {
            "B": reg.shape[0],
            "device_ms": device_ms(lambda: CV.subpel_predict(*a), 20,
                                   "kl_kernel"),
            **bound(nbytes(reg, sx, sy, got), _path_ops(sx, sy, w, h))}
    reg, sx, sy, pred16 = kl[16, 16]
    a = (reg, 16, 16, sx, sy)
    kl_t = (cuda_time(lambda: CV.subpel_predict(*a), 20),
            cuda_time(lambda: CV.subpel_predict_plain(*a), 3),
            device_ms(lambda: CV.subpel_predict(*a), 20, "kl_kernel"))
    kl_bnd = bound(nbytes(reg, sx, sy, pred16), _path_ops(sx, sy, 16, 16))
    results.append({"name": "subpel_predict", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/convolve.cu",
                    "replaces": "aom_av1_psy_tpu/ops/convolve.py:119",
                    "max_abs_err": err, "ms": kl_t[0], "plain_ms": kl_t[1],
                    "device_ms": kl_t[2], **kl_bnd, "library_ms": None,
                    "library_none": "no single PyTorch call rounds between "
                                    "the two passes and picks the path by "
                                    "phase",
                    "device_ms_by_size": kl_sizes,
                    "timed_at": "B=8160 16x16, per-block random phases, "
                                "EIGHTTAP_REGULAR (1080p P-frame grid)"})
    log(f"[3f] KL subpel_predict exact at every path and interp filter "
        f"({', '.join(f'{k} B={v['B']}' for k, v in kl_sizes.items())}); "
        f"16x16: kernel {kl_t[0]:.4f} ms (device {kl_t[2]} ms), plain "
        f"{kl_t[1]:.4f} ms, bound {kl_bnd['bound_ms']:.4f} ms "
        f"({kl_bnd['bound_by']})")
    log(f"[3f] KL device ms and bound by size: " + ", ".join(
        f"{k} {v['device_ms']} [{v['bound_ms']:.4f} {v['bound_by']}]"
        for k, v in kl_sizes.items()))

    # ---- KM: the 49-point lattice around a full-pel MV per block ----
    by, bx = _grid(16, dev)
    B = by.numel()
    src = _cut(y1, by, bx, 16, 16)
    mvs = t(rng.integers(-8, 9, (B, 2)))
    win = _cut(y0, by + mvs[:, 0] - 4, bx + mvs[:, 1] - 4, 25, 25)
    got = MV.batched_subpel_refine(src, win, mvs)
    want = MV.subpel_refine49_plain(src, win)
    err = compare("KM", MV.subpel_refine49(src, win), want)
    err = max(err, compare("KM mv8", got, (
        mvs * 8 + torch.as_tensor(MV._LATTICE49, device=dev)[want[0]],
        want[1].to(torch.int32))))
    km_t = (cuda_time(lambda: MV.subpel_refine49(src, win), 20),
            cuda_time(lambda: MV.subpel_refine49_plain(src, win), 3),
            device_ms(lambda: MV.subpel_refine49(src, win), 20, "km_kernel"))
    # AV1's largest blocks: the luma's whole 128x128 and 128x64 blocks;
    # sizes that are not powers of two in 4..128: 12x20 and 128x2 on the
    # luma, 2x2 on the u plane (KM's ragged chunks and padded lanes)
    km_sizes = {}
    u1 = _pad_rows(frames[1].planes()[1], 544, dev)
    for w, h, p0, p1 in ((128, 128, y0, y1), (128, 64, y0, y1),
                         (12, 20, y0, y1), (128, 2, y0, y1),
                         (2, 2, u0, u1)):
        by, bx = _whole_grid(p1, h, w)
        Bw = by.numel()
        srcw = _cut(p1, by, bx, h, w)
        mvw = t(wide.integers(-8, 9, (Bw, 2)))
        winw = _cut(p0, by + mvw[:, 0] - 4, bx + mvw[:, 1] - 4, h + 9,
                    w + 9)
        gotw = MV.subpel_refine49(srcw, winw)
        err = max(err, compare(f"KM {w}x{h}", gotw,
                               MV.subpel_refine49_plain(srcw, winw)))
        a = (srcw, winw)
        km_sizes[f"{w}x{h}"] = {
            "B": Bw,
            "device_ms": device_ms(lambda: MV.subpel_refine49(*a), 20,
                                   "km_kernel"),
            **bound(nbytes(srcw, winw, gotw), _km_ops(Bw, h, w))}
    h = w = 16
    km_bnd = bound(nbytes(src, win, got), _km_ops(B, h, w))
    # the same function counted candidate by candidate (an x pass over h + 7
    # rows for each of the 36 2-D ones), for comparison in the log
    lat = torch.as_tensor(MV._LATTICE49 & 7)
    km_bnd_each = bound(nbytes(src, win, got), B * (
        _path_ops(lat[:, 1], lat[:, 0], h, w) + 49 * h * w * 3))
    results.append({"name": "subpel_refine49", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/mvsearch.cu",
                    "replaces": "aom_av1_psy_tpu/ops/mvsearch.py:195",
                    "max_abs_err": err, "ms": km_t[0], "plain_ms": km_t[1],
                    "device_ms": km_t[2], **km_bnd, "library_ms": None,
                    "library_none": "no single PyTorch call predicts and "
                                    "scores a candidate lattice",
                    "device_ms_by_size": km_sizes,
                    "timed_at": "B=8160 16x16 blocks, 25x25 windows (1080p "
                                "P-frame grid)"})
    log(f"[3f] KM subpel_refine49 exact (16x16 B=8160, 49 candidates); "
        f"kernel {km_t[0]:.4f} ms (device {km_t[2]} ms), plain "
        f"{km_t[1]:.4f} ms, bound {km_bnd['bound_ms']:.4f} ms "
        f"({km_bnd['bound_by']}; one pass per sub-pel phase), "
        f"{km_bnd_each['bound_ms']:.4f} ms counted per candidate; exact at "
        f"AV1's largest blocks and at sizes that are not powers of two, "
        f"device ms and bound: " + ", ".join(
            f"{k} B={v['B']} {v['device_ms']} [{v['bound_ms']:.4f} "
            f"{v['bound_by']}]" for k, v in km_sizes.items()))

    # ---- KN: every reducer at 16x16; sad / sse / variance at 8 and 4 ----
    err = 0.0
    for bs in (16, 8, 4):
        by, bx = _grid(bs, dev)
        B = by.numel()
        a, b = _cut(y1, by, bx, bs, bs), kl[bs, bs][3]
        for name in ("sad", "sse", "variance"):
            err = max(err, compare(f"KN {name} {bs}x{bs}",
                                   getattr(ME, name)(a, b),
                                   getattr(ME, name + "_plain")(a, b)))
        if bs != 16:
            continue
        sad_in = (a, b)
        refs = torch.stack([kl[16, 16][3].roll(k, 0) for k in range(4)], 1)
        cases = {
            "sad_x4": (a, refs),
            "block_error": (t(rng.integers(-4000, 4000, (B, 256))),
                            t(rng.integers(-4000, 4000, (B, 256)))),
            "obmc_sad": (a, t(rng.integers(0, 255 * 4096, (B, 16, 16))),
                         t(rng.integers(0, 4097, (B, 16, 16)))),
            "masked_sad": (a, b, _cut(y0, by, bx, 16, 16),
                           t(rng.integers(0, 65, (B, 16, 16)))),
        }
        cases["obmc_variance"] = cases["obmc_sad"]
        for name, args in cases.items():
            err = max(err, compare(f"KN {name}", getattr(ME, name)(*args),
                                   getattr(ME, name + "_plain")(*args)))
        ext = _cut(y0, by, bx, 17, 17)
        for xo, yo in ((0, 0), (3, 5), (7, 2)):
            for name, args in (("subpel_project", (ext, 16, 16, xo, yo)),
                               ("sub_pixel_variance", (ext, a, xo, yo)),
                               ("sub_pixel_avg_variance", (ext, a, xo, yo,
                                                           b))):
                err = max(err, compare(f"KN {name} {xo} {yo}",
                                       getattr(ME, name)(*args),
                                       getattr(ME, name + "_plain")(*args)))
    a, b = sad_in
    af, bf = a.reshape(-1, 256).float(), b.reshape(-1, 256).float()
    # L2 flushed before each launch: a 64 MB write (the L2 holds 50 MB)
    flush = torch.empty(16 << 20, dtype=torch.int32, device=dev)
    kn_t = (cuda_time(lambda: ME.sad(a, b), 20),
            cuda_time(lambda: ME.sad_plain(a, b), 5),
            cuda_time(lambda: F.pairwise_distance(af, bf, p=1, eps=0.0), 20),
            device_ms(lambda: ME.sad(a, b), 20, "kn_kernel"),
            device_ms(lambda: (flush.fill_(1), ME.sad(a, b)), 20,
                      "kn_kernel"))
    host_us = _host_us(lambda: ME.sad(a, b), 2000)
    var_t = cuda_time(lambda: ME.variance(a, b), 20)
    kn_bnd = bound(nbytes(a, b, ME.sad(a, b)), 3 * a.numel())
    results.append({"name": "block_reduce", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/metrics.cu",
                    "replaces": "aom_av1_psy_tpu/ops/metrics.py:20",
                    "max_abs_err": err, "ms": kn_t[0], "plain_ms": kn_t[1],
                    "device_ms": kn_t[3], "device_ms_l2_flushed": kn_t[4],
                    "host_us_per_call": host_us, **kn_bnd,
                    "library_ms": kn_t[2],
                    "library_call": "F.pairwise_distance(p=1) on float32 "
                                    "(B, 256) copies",
                    "timed_at": "sad, B=8160 16x16 (1080p P-frame grid); "
                                f"variance {var_t:.4f} ms"})
    log(f"[3f] KN block_reduce exact: sad, sse, variance at 16/8/4, and "
        f"sad_x4, block_error, obmc_sad / _variance, masked_sad, "
        f"subpel_project, sub_pixel_(avg_)variance at 16x16; sad B=8160: "
        f"kernel {kn_t[0]:.4f} ms (device {kn_t[3]} ms warm, {kn_t[4]} ms "
        f"with the L2 flushed; host {host_us:.2f} us per call), plain "
        f"{kn_t[1]:.4f} ms, library "
        f"(pairwise_distance p=1) {kn_t[2]:.4f} ms, bound "
        f"{kn_bnd['bound_ms']:.4f} ms ({kn_bnd['bound_by']}); variance "
        f"{var_t:.4f} ms")

    # ---- KO: the four 8x8 residuals of every 16x16 block ----
    res = (src - pred16).reshape(-1, 2, 8, 2, 8).transpose(2, 3) \
        .reshape(-1, 4, 8, 8)
    # the four input types KO reads as they are: the residuals (int32,
    # int16, int8 clamped) and the source blocks (uint8), each at B = 32640
    # and at B = 32637 (the last warp part-filled); both variants
    ko_in = {"int32": res, "int16": res.to(torch.int16),
             "int8": res.clamp(-128, 127).to(torch.int8),
             "uint8": src.reshape(-1, 2, 8, 2, 8).transpose(2, 3)
             .reshape(-1, 4, 8, 8).to(torch.uint8).contiguous()}
    err = 0.0
    for name, x in ko_in.items():
        for xb in (x, x.reshape(-1, 8, 8)[:-3]):
            B = xb.numel() // 64
            err = max(err, compare(f"KO satd {name} B={B}", ME.satd(xb),
                                   ME.satd_plain(xb)))
            err = max(err, compare(f"KO hadamard {name} B={B}",
                                   ME.hadamard8x8(xb),
                                   ME.hadamard8x8_plain(xb)))
    ko_t = (cuda_time(lambda: ME.satd(res), 20),
            cuda_time(lambda: ME.satd_plain(res), 5),
            device_ms(lambda: ME.satd(res), 20, "ko_kernel"),
            device_ms(lambda: (flush.fill_(1), ME.satd(res)), 20,
                      "ko_kernel"))
    ko_host_us = _host_us(lambda: ME.satd(res), 2000)
    # per block: 2 passes x 8 vectors x 12 butterflies x 2, 64 abs, 64 adds
    ko_ops = 512 * res.numel() // 64
    ko_bnd = bound(nbytes(res, ME.satd(res)), ko_ops)
    ko_variants = {}
    for label, fn, x in (("transform int32", ME.hadamard8x8, res),
                         ("satd int16", ME.satd, ko_in["int16"]),
                         ("satd uint8", ME.satd, ko_in["uint8"])):
        ko_variants[label] = {
            "device_ms": device_ms(lambda: fn(x), 20, "ko_kernel"),
            **bound(nbytes(x, fn(x)), ko_ops)}
    results.append({"name": "satd8x8", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/metrics.cu",
                    "replaces": "aom_av1_psy_tpu/ops/metrics.py:97",
                    "max_abs_err": err, "ms": ko_t[0], "plain_ms": ko_t[1],
                    "device_ms": ko_t[2], "device_ms_l2_flushed": ko_t[3],
                    "host_us_per_call": ko_host_us, **ko_bnd,
                    "library_ms": None,
                    "library_none": "no single PyTorch call sums the "
                                    "absolute Hadamard transform",
                    "device_ms_by_variant": ko_variants,
                    "timed_at": "4 x 8160 8x8 residuals (1080p P-frame "
                                "grid), satd only, int32"})
    log(f"[3f] KO satd8x8 exact (hadamard8x8 and satd; int32, int16, int8, "
        f"uint8; B = 32640 and 32637); satd int32: kernel {ko_t[0]:.4f} ms "
        f"(device {ko_t[2]} ms warm, {ko_t[3]} ms with the L2 flushed; "
        f"host {ko_host_us:.2f} us per call), plain {ko_t[1]:.4f} ms, bound "
        f"{ko_bnd['bound_ms']:.4f} ms ({ko_bnd['bound_by']}); " + ", ".join(
            f"{k} {v['device_ms']} [{v['bound_ms']:.4f} {v['bound_by']}]"
            for k, v in ko_variants.items()))
    return results


def closed_loop_host_inter(dev, kernels):
    """Phase 4g: the host inter encoder (``encoder/interframe.encode_video``)
    closed loop on the reference's own closed-loop content,
    ``panning_frames(96, 72, 3)`` at q120: the counts set to 0 just before
    the CUDA run and read just after (KJ + 3 KL per inter block); CUDA ==
    CPU plain packets and recons; every frame decodes to the recon."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.decoder.obu import Av1Decoder
    from aom_av1_psy_tpu_torch.encoder import interframe as IF
    from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
    from aom_av1_psy_tpu_torch.utils import testframes
    frames = testframes.panning_frames(96, 72, 3)
    cfg = EncoderConfig(base_q_idx=120)
    _reset(kernels)
    t0 = time.perf_counter()
    pk, rec = IF.encode_video(frames, cfg, device=dev)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    counts = _counts(kernels)
    kj, kl = counts.get("mvsearch", 0), counts.get("convolve", 0)
    if kj <= 0 or kl != 3 * kj:
        raise AssertionError(f"host inter GOP: {kj} KJ and {kl} KL launches "
                             "(want 3 KL per KJ)")
    t0 = time.perf_counter()
    cpu_pk, cpu_rec = IF.encode_video(frames, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    if pk != cpu_pk or not all(np.array_equal(a, b) for r, q in
                               zip(rec, cpu_rec) for a, b in zip(r, q)):
        raise AssertionError("host inter GOP: CUDA packets / recons differ "
                             "from the CPU plain path")
    dec, out = Av1Decoder(), []
    for p in pk:
        out.extend(dec.decode_packet(p))
    if len(out) != len(frames):
        raise AssertionError(f"host inter GOP: {len(out)} frames decoded")
    for i, (f, r) in enumerate(zip(out, rec)):
        for name, d, q in zip("yuv", f.planes(), r):
            if not np.array_equal(d, q[:d.shape[0], :d.shape[1]]):
                raise AssertionError(f"host inter GOP: frame {i} {name} "
                                     "decodes to other pixels than the recon")
    log(f"[4g] host inter encoder, panning 96x72 x 3 q120: bytes "
        f"{[len(p) for p in pk]} (CUDA {gpu_s:.2f} s, CPU plain "
        f"{cpu_s:.2f} s), CUDA == CPU plain packets and recons, every frame "
        f"decodes to its recon; launches {kj} KJ + {kl} KL")
    return counts


def _subpel_chain(y0, y1):
    """The slice's path on the 16x16 grid of 1088-row planes: KJ at radius
    16 (windows clamped to the 1080 x 1920 frame), the 49-point refine
    (KM), the refined prediction (KL, per-block phases), ``variance`` and
    ``sse`` (KN) and the ``satd`` of the four 8x8 residuals (KO). CUDA
    tensors take the kernels, CPU tensors the plain versions."""
    import torch
    from aom_av1_psy_tpu_torch.ops import convolve as CV
    from aom_av1_psy_tpu_torch.ops import metrics as ME
    from aom_av1_psy_tpu_torch.ops import mvsearch as MV
    r, ch, cw = 16, 1080, 1920
    by, bx = _grid(16, y0.device)
    src = _cut(y1, by, bx, 16, 16)
    win = _cut(y0, by - r, bx - r, 16 + 2 * r, 16 + 2 * r, ch, cw)
    mvs, _ = MV.full_pel_grid_search(src, win, r)
    win9 = _cut(y0, by + mvs[:, 0] - 4, bx + mvs[:, 1] - 4, 25, 25, ch, cw)
    mv8, sad = MV.batched_subpel_refine(src, win9, mvs)
    pos_r, pos_c = by * 8 + mv8[:, 0], bx * 8 + mv8[:, 1]
    reg = _cut(y0, (pos_r >> 3) - 3, (pos_c >> 3) - 3, 23, 23, ch, cw)
    pred = CV.subpel_predict(reg, 16, 16, ((pos_c & 7) << 1).int(),
                             ((pos_r & 7) << 1).int())
    var, _, _ = ME.variance(src, pred)
    res = (src - pred).reshape(-1, 2, 8, 2, 8).transpose(2, 3) \
        .reshape(-1, 4, 8, 8)
    return {"mvs": mvs, "mv8": mv8, "sad": sad, "pred": pred, "var": var,
            "sse": ME.sse(src, pred), "satd": ME.satd(res)}


def subpel_chain_path(dev, kernels):
    """Phase 5i: the slice's path at full width: frame 1 of
    ``make_gop(1920, 1080, 2)`` searched against frame 0 (``_subpel_chain``,
    B = 8160 16x16 blocks); equal to the same chain on the CPU plain path;
    the prediction's SAD equals KM's; timed (host clock to a synchronize,
    median of 3 after a first) with the counts set to 0 just before the 3
    runs and read just after."""
    import torch
    from aom_av1_psy_tpu_torch.utils import testframes
    frames = testframes.make_gop(1920, 1080, 2)
    y0, y1 = _luma_1088(frames[0], dev), _luma_1088(frames[1], dev)
    t0 = time.perf_counter()
    got = _subpel_chain(y0, y1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset(kernels)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = _subpel_chain(y0, y1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _counts(kernels)
    _need("1080p subpel chain", counts, [k.name for k in kernels])
    # KN's device time as the chain leaves the L2 (one chain per window)
    kn_chain = device_ms(lambda: _subpel_chain(y0, y1), 1, "kn_kernel")
    t0 = time.perf_counter()
    want = _subpel_chain(y0.cpu(), y1.cpu())
    cpu_s = time.perf_counter() - t0
    for k in got:
        compare(f"1080p chain {k} (CUDA vs CPU plain)", got[k].cpu(), want[k])
        compare(f"1080p chain {k} (steady)", again[k], got[k])
    sad = (got["pred"] - _cut(y1, *_grid(16, dev), 16, 16)).abs() \
        .sum((1, 2)).to(torch.int32)
    compare("1080p chain: the prediction's SAD vs KM's", sad, got["sad"])
    moved = int((got["mv8"] != got["mvs"] * 8).any(1).sum())
    log(f"[5i] 1080p subpel chain (KJ r16 -> KM -> KL -> KN variance / sse "
        f"-> KO satd, B=8160 16x16): first {first_s:.4f} s, steady "
        f"{statistics.median(times):.4f} s (runs "
        f"{', '.join(f'{x:.4f}' for x in times)}), CPU plain {cpu_s:.2f} s; "
        f"CUDA == CPU plain; {moved} of 8160 MVs moved off full pel; mean "
        f"SAD {float(got['sad'].double().mean()):.1f}; KN device time in "
        f"the chain {kn_chain} ms for its 2 launches")
    log(f"[5i] launches in the 3 timed chains: {json.dumps(counts)}")
    return counts


def _analyze_ops(B, n):
    """Operations of KP on B n x n blocks, per pixel: 7 predictions with
    their squared differences and sums (~10 each), the residual, the two
    transform passes (~2 log2(n) stages of ~6 each) and the quantizer and
    eob (~10)."""
    return B * n * n * (80 + 24 * (n.bit_length() - 1))


def _palette_ops(N, K, dim):
    """Operations of KQ: per point and centroid the distance (3 per
    component) and the compare; per point the square and the sum."""
    return N * (K * (3 * dim + 2) + 4)


def _palette_tiles(planes, dev):
    """The 1080p KEY frame's palette inputs: every 64x64 block of the
    1088-row luma (dim 1) and the co-located 32x32 (u, v) pairs of the
    544-row chroma (dim 2), each with K = 8 centroids from the port's host
    ``k_means`` (set-up, host clock)."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.ops import analyze as AN
    from aom_av1_psy_tpu_torch.ops import palette as PAL
    y = AN.blockify(planes[0].cpu(), 64).numpy()
    uv = torch.stack([AN.blockify(p.cpu(), 32) for p in planes[1:]], -1) \
        .numpy()
    t0 = time.perf_counter()
    cents = ([PAL.k_means(b, 8, 1)[0] for b in y],
             [PAL.k_means(b, 8, 2)[0] for b in uv])
    kmeans_s = time.perf_counter() - t0
    tiles = (torch.as_tensor(y, device=dev), torch.as_tensor(uv, device=dev))
    cents = tuple(torch.as_tensor(np.stack(c), device=dev) for c in cents)
    return tiles, cents, kmeans_s


def check_k12_kernels(dev):
    """Phase 3g: KP and KQ against their plain versions on the card. KP at
    the 1080p KEY frame's shapes (``_luma_1088(make_frame(1920, 1080))`` at
    n = 16 (B = 8160), 32 (2040), 8 (32640) and 4 (130560); the two chroma
    planes padded to 544 rows at n = 8), on the plane entry and on the
    blocks entry with its totals; KQ on the golden k-means cases and at
    N = 4096 / K = 8 (dim 1) and N = 1024 / K = 8 (dim 2) on int64, int32
    and uint8 data, and at N = 16384 (dim 1). Exact equality; kernel (CUDA
    events around the wrapper, with the total on the host, and
    ``device_ms``), plain and bound times; the device kernels and copies
    of one call on int32 data."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.normative import tables
    from aom_av1_psy_tpu_torch.ops import analyze as AN
    from aom_av1_psy_tpu_torch.ops import palette as PAL
    from aom_av1_psy_tpu_torch.ops.txfm import SQUARE_TX
    from aom_av1_psy_tpu_torch.utils import testframes

    frame = testframes.make_frame(1920, 1080)
    y = _luma_1088(frame, dev)
    u, v = (_pad_rows(p, 544, dev) for p in frame.planes()[1:])
    dq, aq = tables.dc_quant(100), tables.ac_quant(100)
    results = []

    # ---- KP: luma at n = 16, 32, 8, 4; chroma at n = 8; q 100 and 255 ----
    err, shapes = 0.0, []
    for plane, n in ((y, 16), (y, 32), (y, 8), (y, 4), (u, 8), (v, 8)):
        B = plane.numel() // (n * n)
        for q in (100, 255):
            a = (plane, tables.dc_quant(q), tables.ac_quant(q), n,
                 SQUARE_TX[n])
            got = AN.analyze_plane(*a)
            err = max(err, compare(f"KP plane n={n} B={B} q={q}",
                                   tuple(got.values()),
                                   tuple(AN.analyze_plane_plain(*a)
                                         .values())))
        edges = AN._edges_from_source(plane, n)
        blocks = AN.blockify(plane, n)
        a = (blocks, *edges, dq, aq, SQUARE_TX[n])
        pl = AN.analyze_blocks_plain(*a)
        tot = torch.stack([pl["sse"].to(torch.int64).sum(),
                           pl["eob"].to(torch.int64).sum()]).to(torch.int32)
        err = max(err, compare(f"KP blocks n={n} B={B}", AN.analyze_blocks(*a),
                               (pl["mode"], pl["levels"], pl["eob"], tot[0],
                                tot[1])))
        shapes.append(f"n={n} B={B}")
    a = (y, dq, aq, 16, SQUARE_TX[16])
    out = AN.analyze_plane(*a)
    kp_t = (cuda_time(lambda: AN.analyze_plane(*a), 20),
            cuda_time(lambda: AN.analyze_plane_plain(*a), 3),
            device_ms(lambda: AN.analyze_plane(*a), 20, "kp_kernel"))
    kp_bnd = bound(nbytes(y, out), _analyze_ops(out["eob"].numel(), 16))
    n4 = (y, dq, aq, 4, SQUARE_TX[4])
    kp4 = (cuda_time(lambda: AN.analyze_plane(*n4), 10),
           device_ms(lambda: AN.analyze_plane(*n4), 10, "kp_kernel"))
    # the device time of the plane entry at every n (luma; chroma at n = 8)
    kp_by_n = {f"{tag} n={n}": device_ms(
        lambda p=p, n=n: AN.analyze_plane(p, dq, aq, n, SQUARE_TX[n]), 10,
        "kp_kernel")
        for tag, p, n in (("y", y, 16), ("y", y, 32), ("y", y, 8),
                          ("u", u, 8), ("y", y, 4))}
    results.append({"name": "analyze_blocks", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/analyze.cu",
                    "replaces": "aom_av1_psy_tpu/ops/analyze.py:119-148; "
                                "aom_av1_psy_tpu/parallel/mesh.py:32-75",
                    "max_abs_err": err, "ms": kp_t[0], "plain_ms": kp_t[1],
                    "device_ms": kp_t[2], **kp_bnd, "library_ms": None,
                    "library_none": "no single PyTorch call predicts, "
                                    "transforms and quantizes",
                    "device_ms_by_n": kp_by_n,
                    "timed_at": "1080p luma (1088x1920 int32) n=16 B=8160 "
                                f"q100; n=4 B=130560: {kp4[0]:.4f} ms "
                                f"(device {kp4[1]} ms)"})
    log(f"[3g] KP analyze_blocks exact on the plane and blocks entries "
        f"({', '.join(shapes)}; q100 / q255); luma n=16: kernel "
        f"{kp_t[0]:.4f} ms (device {kp_t[2]} ms), plain {kp_t[1]:.4f} ms, "
        f"bound {kp_bnd['bound_ms']:.4f} ms ({kp_bnd['bound_by']}); n=4: "
        f"{kp4[0]:.4f} ms (device {kp4[1]} ms); device ms of the plane "
        f"entry: {json.dumps(kp_by_n)}")

    # ---- KQ: the golden cases, N = 4096 / K = 8 dim 1, 1024 pairs dim 2 ----
    g = np.load(os.path.join(REPO, "tests", "golden", "golden_kmeans.npz"))
    err = 0.0
    for c in range(6):
        n, k = (int(x) for x in g[f"km{c}_meta"])
        data, cents = g[f"km{c}_data"][: n * 2], g[f"km{c}_cents"][: k * 2]
        for dim, d, ce in ((1, data[:n], cents[:k]), (2, data, cents)):
            got = PAL.calc_indices(torch.as_tensor(d, device=dev),
                                   torch.as_tensor(ce, device=dev), dim)
            want = (torch.as_tensor(g[f"km{c}_idx{dim}"][:n]
                                    .astype(np.uint8), device=dev),
                    int(g[f"km{c}_dist"][dim - 1]))
            err = max(err, compare(f"KQ golden {c} dim {dim}", got[0],
                                   want[0]))
            if got[1] != want[1]:
                raise AssertionError(f"KQ golden {c} dim {dim}: total "
                                     f"{got[1]} != {want[1]}")
    rng = np.random.default_rng(SEED + 7)
    timed = {}
    for dim, n in ((1, 4096), (2, 1024)):
        d = torch.as_tensor(rng.integers(0, 256, (n, dim)), device=dev)
        c = torch.as_tensor(rng.integers(0, 256, (8, dim)), device=dev)
        got = PAL.calc_indices(d, c, dim)
        want = PAL.calc_indices_plain(d, c, dim)
        err = max(err, compare(f"KQ N={n} dim {dim}", got[0], want[0]))
        if got[1] != want[1]:
            raise AssertionError(f"KQ N={n} dim {dim}: total {got[1]} != "
                                 f"{want[1]}")
        timed[dim] = (cuda_time(lambda: PAL.calc_indices(d, c, dim), 20),
                      cuda_time(lambda: PAL.calc_indices_plain(d, c, dim),
                                20),
                      device_ms(lambda: PAL.calc_indices(d, c, dim), 20,
                                "kq_kernel"),
                      bound(nbytes(d, c, got[0]) + 8, _palette_ops(n, 8, dim)))
    kq_t = timed[1]
    # the data as 5j hands it (int32 tiles) and as 8-bit samples, K = 8
    # int64 centroids as k_means makes them; N = 16384 takes four CTAs
    by_type = {}
    for dtype in (torch.int32, torch.uint8):
        for dim, n in ((1, 4096), (2, 1024), (1, 16384)):
            d = torch.as_tensor(rng.integers(0, 256, (n, dim)),
                                device=dev).to(dtype)
            c = torch.as_tensor(rng.integers(0, 256, (8, dim)), device=dev)
            got = PAL.calc_indices(d, c, dim)
            want = PAL.calc_indices_plain(d, c, dim)
            tag = f"{str(dtype)[6:]} N={n} dim {dim}"
            err = max(err, compare(f"KQ {tag}", got[0], want[0]))
            if got[1] != want[1]:
                raise AssertionError(f"KQ {tag}: total {got[1]} != "
                                     f"{want[1]}")
            by_type[tag] = {
                "ms": cuda_time(lambda: PAL.calc_indices(d, c, dim), 20),
                "device_ms": device_ms(lambda: PAL.calc_indices(d, c, dim),
                                       20, "kq_kernel"),
                **bound(nbytes(d, c, got[0]) + 8, _palette_ops(n, 8, dim))}
    d32 = torch.as_tensor(rng.integers(0, 256, (4096, 1)),
                          device=dev).to(torch.int32)
    c64 = torch.as_tensor(rng.integers(0, 256, (8, 1)), device=dev)
    one_call = device_ops(lambda: PAL.calc_indices(d32, c64, 1))
    results.append({"name": "palette_indices", "route": "cuda",
                    "source": "aom_av1_psy_tpu_torch/csrc/palette.cu",
                    "replaces": "aom_av1_psy_tpu/ops/palette.py:20",
                    "max_abs_err": err, "ms": kq_t[0], "plain_ms": kq_t[1],
                    "device_ms": kq_t[2], **kq_t[3], "library_ms": None,
                    "library_none": "torch.cdist gives the distances but not "
                                    "the first-index argmin and the total in "
                                    "one call",
                    "by_type": by_type,
                    "device_ops_per_call_int32": one_call,
                    "timed_at": "N=4096 K=8 dim 1 int64 data, with the total "
                                f"on the host; N=1024 K=8 dim 2: "
                                f"{timed[2][0]:.4f} ms (device "
                                f"{timed[2][2]} ms), plain "
                                f"{timed[2][1]:.4f} ms"})
    log(f"[3g] KQ palette_indices exact (6 golden cases x dims 1, 2; "
        f"N=4096 K=8 dim 1; N=1024 K=8 dim 2); dim 1: kernel "
        f"{kq_t[0]:.4f} ms (device {kq_t[2]} ms), plain {kq_t[1]:.4f} ms, "
        f"bound {kq_t[3]['bound_ms']:.6f} ms ({kq_t[3]['bound_by']}); "
        f"dim 2: kernel {timed[2][0]:.4f} ms, plain {timed[2][1]:.4f} ms")
    log("[3g] KQ exact on int32 and uint8 data; ms per call (device ms) "
        "[bound]: " + ", ".join(
            f"{k} {v['ms']:.4f} ({v['device_ms']}) [{v['bound_ms']:.6f}]"
            for k, v in by_type.items()))
    log(f"[3g] KQ: the device kernels and copies of one calc_indices call "
        f"on int32 data (N=4096 K=8 dim 1): {json.dumps(one_call)}")
    return results


# the timed shapes of phases 3h and 5l: (tx_size, tx_type, label) with a
# 1080p luma's blocks (1088 x 1920 pixels: B = 8160 at 16x16); the WHT
# pair at 4x4 (B = 130560)
KR_TIMED = ((2, 3, "TX_16X16 ADST_ADST"), (3, 0, "TX_32X32 DCT_DCT"),
            (4, 0, "TX_64X64 DCT_DCT"), (17, 0, "TX_16X64 DCT_DCT"),
            (15, 9, "TX_8X32 IDTX"), (0, 8, "TX_4X4 FLIPADST_ADST"))


def _kr_ops(B, ts, tt, inverse, bd=8):
    """Operations of one launch of the general transforms over B blocks,
    counted from the normative stage data (``ops/txfm_host.
    _compiled_stages``), so the bound is the same work whatever implements
    KR: 3 a stage entry (two products and their sum), 2 more for a
    butterfly's round shift and 2 for a stage clamp (the inverse's); 30
    an ADST4 vector (its sinpi products, sums and four round shifts); 3
    an IDTX element; ~4 an element and pass (the shifts, a flip, the
    rescale, an input clamp); 3 a pixel for the inverse's recon (add and
    clip); the inverse's row pass over the coded min(H, 32) rows only."""
    from aom_av1_psy_tpu_torch.normative.enums import TxType1D
    from aom_av1_psy_tpu_torch.ops import txfm as TX
    from aom_av1_psy_tpu_torch.ops.txfm_host import _compiled_stages
    w, h, lw, lh, vtype, htype, _, _ = TX._pair(ts, tt)
    if inverse:     # rows past the coded 32 are zero: no row pass needed
        passes = ((htype, w, min(h, 32), TX.INV_COS_BIT),
                  (vtype, h, w, TX.INV_COS_BIT))
    else:
        passes = ((vtype, h, w, TX.FWD_COS_BIT_COL[lw][lh]),
                  (htype, w, h, TX.FWD_COS_BIT_ROW[lw][lh]))
    ops = 3 * w * h if inverse else 0
    for kind, n, nvec, cos_bit in passes:
        if kind == TxType1D.IDTX:
            per = 3 * n
        elif kind != TxType1D.DCT and n == 4:
            per = 30
        else:
            func = (f"av1_{'i' if inverse else 'f'}"
                    f"{'dct' if kind == TxType1D.DCT else 'adst'}{n}")
            per = sum(3 * len(ia) + 2 * int(btf.sum())
                      + (2 * int(clamp.sum()) if inverse else 0)
                      for ia, _, _, _, btf, clamp in
                      _compiled_stages(func, int(cos_bit)))
        ops += nvec * (per + 4 * n)
    return B * ops


def _wht_ops(B, inverse):
    """Operations of the WHT pair over B 4x4 blocks: 8 butterflies of 7
    and 16 scalings (forward) or 16 shifts and 16 x 3 for the recon
    (inverse)."""
    return B * (56 + (64 if inverse else 16))


def _kr_inputs(rng, B, w, h, bd=8):
    """Mixed residuals (B, h, w) (+-40 noise, a third at +-255, two flat
    +-255 blocks, one past the transforms' range that wraps in int32),
    coefficients (B, w, h) (noise, both input clamps, raw int32 values)
    and bd-bit predictions (B, h, w), int32 on the CPU."""
    import numpy as np
    import torch
    res = rng.integers(-40, 41, (B, h, w))
    res[: B // 3] = rng.integers(-255, 256, (B // 3, h, w))
    res[B // 3] = 255
    res[B // 3 + 1] = -255
    res[B // 3 + 2] = rng.integers(-2**20, 2**20, (h, w))
    lim = 1 << (bd + 7)
    coeff = rng.integers(-3000, 3001, (B, w, h))
    coeff[0] = lim - 1
    coeff[1] = -lim
    coeff[2] = rng.integers(-2**31, 2**31, (w, h))
    coeff[3:6] = rng.integers(-lim, lim, (3, w, h))
    pred = rng.integers(0, 1 << bd, (B, h, w))
    return tuple(torch.as_tensor(a.astype(np.int32))
                 for a in (res, coeff, pred))


def _median_ms(fn, iters):
    """Median of 3 CUDA-event means of ``iters`` calls, after a first."""
    fn()
    return statistics.median(cuda_time(fn, iters) for _ in range(3))


def check_kr_kernels(dev):
    """Phase 3h: KR against its plain version on the card and on the CPU,
    exact: every one of the 193 valid (tx_size, tx_type) pairs forward
    and inverse at bd 8 (B = 2 x 128 / max(w, h) + 3: the last CTA
    part-filled), the inverse at bd 10 and 12 on a third of each size's
    types (every size), the WHT pair (B = 1000, bd 8 / 10 / 12), on mixed
    residuals and extreme coefficients (``_kr_inputs``). Timed at a
    1080p luma's blocks (``KR_TIMED``, residuals of the same mix): kernel
    (CUDA events around the wrapper, median of 3 after a first;
    ``device_ms`` warm and ``cold_device_ms`` with the L2 flushed before
    each call), plain (CUDA events) and bound times and the times over
    the bound, forward and inverse (the inverse's bytes: the coded
    min(W, 32) x min(H, 32) corner of the coefficients, the predictions
    and the output); the WHT pair at B = 130560; and what ptxas said of
    each KR instantiation (``ptxas_report``), also in each entry's
    ``ptxas``."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.normative.enums import TX_HEIGHT, TX_WIDTH
    from aom_av1_psy_tpu_torch.ops import txfm as TX

    rng = np.random.default_rng(SEED + 19)
    pairs = [(ts, tt) for ts in range(19) for tt in range(16)
             if TX.valid_pair(ts, tt)]
    if len(pairs) != 193:
        raise AssertionError(f"KR: {len(pairs)} valid pairs, not 193")
    err = {"fwd": 0.0, "inv": 0.0, "fwht": 0.0, "iwht": 0.0}
    n_hbd = 0
    for ts, tt in pairs:
        w, h = int(TX_WIDTH[ts]), int(TX_HEIGHT[ts])
        B = 2 * (128 // max(w, h)) + 3
        res, coeff, pred = _kr_inputs(rng, B, w, h)
        r, c, p = (x.to(dev) for x in (res, coeff, pred))
        got = TX.fwd_txfm2d(r, ts, tt)
        tag = f"KR fwd ts={ts} tt={tt}"
        err["fwd"] = max(err["fwd"], compare(
            tag, got, TX.fwd_txfm2d_plain(r, ts, tt)),
            compare(tag + " (CPU)", got.cpu(),
                    TX.fwd_txfm2d_plain(res, ts, tt)))
        got = TX.inv_txfm2d_add(c, p, ts, tt)
        tag = f"KR inv ts={ts} tt={tt} bd=8"
        err["inv"] = max(err["inv"], compare(
            tag, got, TX.inv_txfm2d_add_plain(c, p, ts, tt)),
            compare(tag + " (CPU)", got.cpu(),
                    TX.inv_txfm2d_add_plain(coeff, pred, ts, tt)))
        if tt in [t for s, t in pairs if s == ts][ts % 3::3]:
            for bd in (10, 12):
                _, coeff, pred = _kr_inputs(rng, B, w, h, bd)
                got = TX.inv_txfm2d_add(coeff.to(dev), pred.to(dev), ts, tt,
                                        bd=bd)
                err["inv"] = max(err["inv"], compare(
                    f"KR inv ts={ts} tt={tt} bd={bd} (CPU)", got.cpu(),
                    TX.inv_txfm2d_add_plain(coeff, pred, ts, tt, bd=bd)))
                n_hbd += 1
    for bd in (8, 10, 12):
        res = torch.as_tensor(rng.integers(-255, 256, (1000, 4, 4)),
                              dtype=torch.int32)
        res[0] = torch.as_tensor(rng.integers(-2**29, 2**29, (4, 4)))
        coeff = torch.as_tensor(rng.integers(-2**16, 2**16, (1000, 4, 4)),
                                dtype=torch.int32)
        coeff[0] = torch.as_tensor(rng.integers(-2**31, 2**31, (4, 4)))
        pred = torch.as_tensor(rng.integers(0, 1 << bd, (1000, 4, 4)),
                               dtype=torch.int32)
        got = TX.fwht4x4(res.to(dev))
        err["fwht"] = max(err["fwht"], compare(
            "KR fwht", got, TX.fwht4x4_plain(res.to(dev))),
            compare("KR fwht (CPU)", got.cpu(), TX.fwht4x4_plain(res)))
        got = TX.iwht4x4_add(coeff.to(dev), pred.to(dev), bd)
        err["iwht"] = max(err["iwht"], compare(
            f"KR iwht bd={bd}", got,
            TX.iwht4x4_add_plain(coeff.to(dev), pred.to(dev), bd)),
            compare(f"KR iwht bd={bd} (CPU)", got.cpu(),
                    TX.iwht4x4_add_plain(coeff, pred, bd)))
    log(f"[3h] KR exact against its plain version on the card and on the "
        f"CPU: 193 pairs forward and inverse at bd 8, {n_hbd} inverse "
        f"(pair, bd) at bd 10 / 12 covering all 19 sizes, the WHT pair at "
        f"bd 8 / 10 / 12")

    # ---- timed at a 1080p luma's blocks ----
    timed = {"fwd": {}, "inv": {}}
    for ts, tt, label in KR_TIMED:
        w, h = int(TX_WIDTH[ts]), int(TX_HEIGHT[ts])
        B = 1088 * 1920 // (w * h)
        res, _, pred = (x.to(dev) for x in _kr_inputs(rng, B, w, h))
        coeff = TX.fwd_txfm2d(res, ts, tt)
        out = TX.inv_txfm2d_add(coeff, pred, ts, tt)
        coded = B * min(w, 32) * min(h, 32) * coeff.element_size()
        iters = 20
        for d, fn, plain, n_bytes in (
                ("fwd", lambda: TX.fwd_txfm2d(res, ts, tt),
                 lambda: TX.fwd_txfm2d_plain(res, ts, tt),
                 nbytes(res, coeff)),
                ("inv", lambda: TX.inv_txfm2d_add(coeff, pred, ts, tt),
                 lambda: TX.inv_txfm2d_add_plain(coeff, pred, ts, tt),
                 coded + nbytes(pred, out))):
            timed[d][f"{label} B={B}"] = {
                "ms": _median_ms(fn, iters),
                "device_ms": device_ms(fn, iters, f"kr_{d}_kernel"),
                "cold_device_ms": cold_device_ms(fn, iters,
                                                 f"kr_{d}_kernel"),
                "plain_ms": cuda_time(plain, 3),
                **bound(n_bytes, _kr_ops(B, ts, tt, d == "inv"))}
    B = 130560
    res, coeff, pred = (torch.as_tensor(rng.integers(lo, hi, (B, 4, 4)),
                                        dtype=torch.int32, device=dev)
                        for lo, hi in ((-255, 256), (-2**12, 2**12),
                                       (0, 256)))
    wht = {}
    for name, fn, plain, io in (
            ("fwht4x4", lambda: TX.fwht4x4(res),
             lambda: TX.fwht4x4_plain(res), (res, coeff)),
            ("iwht4x4_add", lambda: TX.iwht4x4_add(coeff, pred),
             lambda: TX.iwht4x4_add_plain(coeff, pred),
             (coeff, pred, res))):
        kname = "kr_fwht_kernel" if name == "fwht4x4" else "kr_iwht_kernel"
        wht[name] = {"ms": _median_ms(fn, 50),
                     "device_ms": device_ms(fn, 50, kname),
                     "cold_device_ms": cold_device_ms(fn, 20, kname),
                     "plain_ms": cuda_time(plain, 10),
                     **bound(nbytes(io), _wht_ops(B, name != "fwht4x4"))}
    for d in ("fwd", "inv"):
        log(f"[3h] KR {d}: ms (cold device ms; warm device ms) [bound, "
            f"plain ms] per 1080p batch: " + "; ".join(
                f"{k} {v['ms']:.4f} ({v['cold_device_ms']}; "
                f"{v['device_ms']}) [{v['bound_ms']:.5f} {v['bound_by']}, "
                f"plain {v['plain_ms']:.3f}]" for k, v in timed[d].items()))
    log("[3h] KR WHT pair at B=130560: " + "; ".join(
        f"{k} {v['ms']:.4f} ({v['cold_device_ms']}; {v['device_ms']}) "
        f"[{v['bound_ms']:.5f} {v['bound_by']}, plain {v['plain_ms']:.3f}]"
        for k, v in wht.items()))
    nan = float("nan")
    for v in [*timed["fwd"].values(), *timed["inv"].values(), *wht.values()]:
        v["x_bound"] = v["ms"] / v["bound_ms"]
        for key in ("device_ms", "cold_device_ms"):
            if v[key]:
                v[key.replace("ms", "x_bound")] = v[key] / v["bound_ms"]
    for d, rows in (("fwd", timed["fwd"]), ("inv", timed["inv"]),
                    ("WHT pair", wht)):
        log(f"[3h] KR {d}: time over its bound, cold device time (warm "
            f"device time; CUDA events): " + "; ".join(
                f"{k} x{v.get('cold_device_x_bound', nan):.2f} "
                f"(x{v.get('device_x_bound', nan):.2f}; "
                f"x{v['x_bound']:.2f})" for k, v in rows.items()))
    ptxas = ptxas_report(TX.KR.build_log)
    clean = bool(ptxas) and all(
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
        in lines for lines in ptxas.values())
    log(f"[3h] KR registers of its {len(ptxas)} instantiations (ptxas -v of "
        f"this process's build; no stack, no spill: {clean}): " + ", ".join(
            f"{k} {ln.split()[1]}" for k, lines in sorted(ptxas.items())
            for ln in lines if ln.startswith("Used ")))
    src = "aom_av1_psy_tpu_torch/csrc/txfm2d.cu"
    none = "no single call runs the AV1 integer transforms"
    results = []
    for name, d, replaces in (
            ("txfm2d_fwd", "fwd", "aom_av1_psy_tpu/ops/txfm.py:105,129,185,"
                                  "197,211,227"),
            ("txfm2d_inv", "inv", "aom_av1_psy_tpu/ops/txfm.py:105,157,185,"
                                  "197,211,266")):
        first = next(iter(timed[d].items()))
        results.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "max_abs_err": err[d],
                        **first[1], "library_ms": None,
                        "library_none": none, "timed_at": first[0],
                        "by_shape": timed[d]})
    for name, key, line in (("fwht4x4", "fwht", 314),
                            ("iwht4x4_add", "iwht", 343)):
        results.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"aom_av1_psy_tpu/ops/txfm.py:{line}",
                        "max_abs_err": err[key], **wht[name],
                        "library_ms": None, "library_none": none,
                        "timed_at": "B=130560 4x4 blocks"})
    for r, d in zip(results, ("fwd", "inv", "fwht", "iwht")):
        r["ptxas"] = {k: v for k, v in ptxas.items() if f"kr_{d}" in k}
    return results



def _wrap32(x):
    return (x + 2**31) % 2**32 - 2**31


def _analysis_path(planes, tiles, cents):
    """The slice's path: ``analyze_plane`` of the luma (n = 16) and both
    chroma planes (n = 8); ``batched_analyze_step(16, 100)`` on the luma
    blocks and source edges, whole and in two halves of the batch (the
    reference's 2-device mesh); ``calc_indices`` of every 64x64 luma block
    (dim 1) and co-located 32x32 chroma pair block (dim 2) at K = 8. CUDA
    tensors take the kernels, CPU tensors the plain versions."""
    import torch
    from aom_av1_psy_tpu_torch.normative import tables
    from aom_av1_psy_tpu_torch.ops import analyze as AN
    from aom_av1_psy_tpu_torch.ops import palette as PAL
    from aom_av1_psy_tpu_torch.parallel.mesh import batched_analyze_step
    from aom_av1_psy_tpu_torch.ops.txfm import SQUARE_TX
    dev = planes[0].device
    dq, aq = tables.dc_quant(100), tables.ac_quant(100)
    out = {}
    for name, p, n in (("y", planes[0], 16), ("u", planes[1], 8),
                       ("v", planes[2], 8)):
        for k, t in AN.analyze_plane(p, dq, aq, n, SQUARE_TX[n]).items():
            out[f"{name} {k}"] = t
    y = planes[0]
    blocks, edges = AN.blockify(y, 16), AN._edges_from_source(y, 16)
    step = batched_analyze_step(16, 100, device=dev)
    half = blocks.shape[0] // 2
    for name, s in (("whole", slice(None)), ("top", slice(None, half)),
                    ("bottom", slice(half, None))):
        res = step(*(t[s] for t in (blocks, *edges)))
        for k, t in zip(("modes", "levels", "eob", "tot_sse", "tot_coeff"),
                        res):
            out[f"step {name} {k}"] = t
    for dim, (tl, ce) in enumerate(zip(tiles, cents), 1):
        got = [PAL.calc_indices(tl[b], ce[b], dim) for b in range(len(tl))]
        out[f"palette dim{dim} idx"] = torch.stack([g[0] for g in got])
        out[f"palette dim{dim} total"] = torch.tensor([g[1] for g in got])
    return out


def analysis_path(dev, kernels):
    """Phase 5j: the analysis path at full width on the 1080p KEY frame
    (``make_frame(1920, 1080)``, the luma padded to 1088 and the chroma to
    544 rows): ``_analysis_path`` (KP: 3 plane + 3 step launches; KQ: 510
    dim-1 + 510 dim-2 launches); the step's totals of the two halves add up
    (int32) to the whole's, and its modes / levels / eob equal the luma
    plane's; equal to the same path on the CPU plain path; timed (host
    clock to a synchronize, median of 3 after a first) with the counts set
    to 0 just before the 3 runs and read just after."""
    import torch
    from aom_av1_psy_tpu_torch.utils import testframes
    frame = testframes.make_frame(1920, 1080)
    planes = [_luma_1088(frame, dev)] + [_pad_rows(p, 544, dev)
                                         for p in frame.planes()[1:]]
    tiles, cents, kmeans_s = _palette_tiles(planes, dev)
    t0 = time.perf_counter()
    got = _analysis_path(planes, tiles, cents)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset(kernels)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = _analysis_path(planes, tiles, cents)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _counts(kernels)
    _need("1080p analysis path", counts, [k.name for k in kernels])
    t0 = time.perf_counter()
    want = _analysis_path([p.cpu() for p in planes],
                          [t.cpu() for t in tiles], [c.cpu() for c in cents])
    cpu_s = time.perf_counter() - t0
    for k in got:
        compare(f"1080p analysis {k} (CUDA vs CPU plain)", got[k].cpu(),
                want[k])
        compare(f"1080p analysis {k} (steady)", again[k], got[k])
    for k in ("modes", "levels", "eob"):
        compare(f"1080p step {k} vs the luma plane's", got[f"step whole {k}"],
                got[{"modes": "y mode"}.get(k, f"y {k}")])
    for k in ("tot_sse", "tot_coeff"):
        halves = _wrap32(int(got[f"step top {k}"])
                         + int(got[f"step bottom {k}"]))
        if halves != int(got[f"step whole {k}"]):
            raise AssertionError(f"1080p step {k}: halves {halves} != "
                                 f"whole {int(got[f'step whole {k}'])}")
    if int(got["step whole tot_sse"]) != _wrap32(int(got["y sse"].sum())):
        raise AssertionError("1080p step tot_sse != the luma plane's SSE sum")
    modes = torch.bincount(got["y mode"].long(), minlength=7).tolist()
    log(f"[5j] 1080p analysis path (KP: luma n=16, chroma n=8, the step "
        f"whole + 2 halves; KQ: 510 luma 64x64 dim 1 + 510 chroma pair "
        f"dim 2 at K=8): first {first_s:.4f} s, steady "
        f"{statistics.median(times):.4f} s (runs "
        f"{', '.join(f'{x:.4f}' for x in times)}), CPU plain {cpu_s:.2f} s, "
        f"host k_means set-up {kmeans_s:.2f} s; CUDA == CPU plain; halves "
        f"== whole; luma modes {modes}, tot_sse "
        f"{int(got['step whole tot_sse'])}, tot_coeff "
        f"{int(got['step whole tot_coeff'])}")
    log(f"[5j] launches in the 3 timed runs: {json.dumps(counts)}")
    return counts


def _sync_all():
    """Wait for every card (a mesh may span several)."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _mesh_of(n, dev):
    """``make_mesh(n)`` where the machine has n cards, else ``dev`` n
    times (each entry still one shard with its own launches)."""
    import torch
    from aom_av1_psy_tpu_torch.parallel import mesh as M
    return M.make_mesh(n) if torch.cuda.device_count() >= n \
        else M.Mesh([dev] * n)


def _cross_card(mesh, dev):
    """Entries of the mesh on another card than ``dev``."""
    return sum(d != dev for d in mesh.devices)


def _mesh_frames(dev, kernels, frame, lg, batched_pkt):
    """The 1080p KEY frame with 2**lg tile columns through
    ``GpuFrameEncoder.mesh``: equal to the batched and CPU plain streams,
    a first and 3 steady frames with the launch counts around them, the
    mesh and the batched path in turns (B M M B, twice), and the device
    copies of one mesh frame."""
    import torch
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import (EncoderConfig,
                                                         GpuFrameEncoder)
    T = 1 << lg
    mesh = _mesh_of(T, dev)
    cfg = EncoderConfig(base_q_idx=100, tile_cols_log2=lg)

    def encode(m):
        enc = GpuFrameEncoder(frame, cfg, device=dev)
        enc.mesh = m
        t0 = time.perf_counter()
        pkt = enc.encode()
        _sync_all()
        return pkt, enc, time.perf_counter() - t0

    tag = f"{frame.width}x{frame.height} {T} tiles"
    if batched_pkt is None:
        batched_pkt = encode(None)[0]
    cpu_s = _cpu_equal(f"{tag} (batched)", frame, cfg, batched_pkt)
    pkt, enc, first_s = encode(mesh)
    if enc.tile_T != T or pkt != batched_pkt:
        raise AssertionError(f"{tag}: mesh stream differs from the batched "
                             "stream")
    _reset(kernels)
    steady = [encode(mesh) for _ in range(3)]
    counts = _counts(kernels)
    if any(p != pkt for p, _, _ in steady):
        raise AssertionError(f"{tag}: a steady mesh frame differs")
    _need(f"{tag} mesh", counts, ("intra_pred pick bs32",
                                  "intra_pred pick bs16",
                                  "intra_pred pick bs8", "txq step bs32",
                                  "txq step bs16", "txq step bs8",
                                  "deblock"))
    for t, p in enumerate(steady[-1][1].tile_plans):
        if any(r.device != mesh.devices[t] for r in p["recon_dev"]):
            raise AssertionError(f"{tag}: tile {t}'s recon is not on "
                                 f"{mesh.devices[t]}")
    turns = {"B": [], "M": []}
    for which in "BMMBBMMB":
        _, e, wall = encode(mesh if which == "M" else None)
        turns[which].append((e.timings["plan_s"], wall))
    med = {k: (statistics.median(x[0] for x in v),
               statistics.median(x[1] for x in v)) for k, v in turns.items()}
    copies = {k: n for k, n in device_ops(lambda: encode(mesh)).items()
              if "Memcpy" in k}
    log(f"[5k] {tag} over {mesh} ({torch.cuda.device_count()} cards): "
        f"{len(pkt)} bytes, mesh == batched == CPU plain stream (CPU "
        f"encode {cpu_s:.1f} s); first {first_s:.3f} s, steady "
        f"{', '.join(f'{w:.4f}' for _, _, w in steady)} s; in turns (B M M "
        f"B x2): plan_s batched {[round(x[0], 4) for x in turns['B']]}, "
        f"mesh {[round(x[0], 4) for x in turns['M']]}; frame wall batched "
        f"{[round(x[1], 4) for x in turns['B']]}, mesh "
        f"{[round(x[1], 4) for x in turns['M']]}; medians plan "
        f"{med['B'][0]:.4f} / {med['M'][0]:.4f} s (mesh/batched "
        f"{med['M'][0] / med['B'][0]:.3f}), wall {med['B'][1]:.4f} / "
        f"{med['M'][1]:.4f} s ({med['M'][1] / med['B'][1]:.3f})")
    log(f"[5k] {tag}: cross-card recon copies per frame "
        f"{_cross_card(mesh, dev) * enc.nplanes}; device copies of one mesh "
        f"frame {json.dumps(copies)}; launches over the 3 steady mesh "
        f"frames: {json.dumps(counts)}")
    return counts


def _guard_cost(dev):
    """Host cost of the kernels' device guard: the guarded stream lookup
    against the bare one (100000 calls each), and KA's pick wrapper
    (1080p luma bs 32, B = 34) with the guard and with it bypassed, in
    turns (G N N G, twice; 1000 calls a turn)."""
    import torch
    from aom_av1_psy_tpu_torch.ops.intra_pred import KA
    raw, cur = torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice
    di = dev.index or 0
    guarded = _host_us(lambda: KA.stream_on(di), 100000)
    bare = _host_us(lambda: raw(cur()), 100000)
    run32 = _pick_calls(dev)[0][0][1]
    turns = {"G": [], "N": []}
    for which in "GNNGGNNG":
        if which == "N":
            KA.stream_on = lambda device: raw(cur())
        turns[which].append(_host_us(run32.bare))
        if which == "N":
            del KA.stream_on
    g, n = (statistics.median(turns[k]) for k in "GN")
    log(f"[5k] device guard: stream lookup {guarded:.4f} us guarded, "
        f"{bare:.4f} us bare (+{guarded - bare:.4f} us a launch); KA pick "
        f"wrapper (bs32 B=34) in turns (G N N G x2): guarded "
        f"{[round(x, 2) for x in turns['G']]}, bypassed "
        f"{[round(x, 2) for x in turns['N']]} us a call, medians {g:.2f} / "
        f"{n:.2f} us ({g - n:+.2f} us)")


def mesh_path(dev, kernels, tiled_pkt=None):
    """Phase 5k: the tile columns sharded over a mesh
    (``GpuFrameEncoder.mesh``; ``make_mesh(T)`` where the machine has T
    cards, else ``cuda:0`` T times): the 2-tile frame of phase 5c (its
    batched stream ``tiled_pkt``) and a 2008x1080 frame in 4 tiles (512
    px slabs, the last with 472 visible), each equal to the batched and
    CPU plain streams,
    counted and timed in turns against the batched path; then
    ``sharded_analyze_step(mesh, 16, 100)`` on phase 5j's luma blocks (B =
    8160) at mesh sizes 1, 2 and 4, equal to ``batched_analyze_step`` and
    timed (median of 3 after a first); and the device guard's host
    cost."""
    import torch
    from aom_av1_psy_tpu_torch.ops import analyze as AN
    from aom_av1_psy_tpu_torch.ops.analyze import KP
    from aom_av1_psy_tpu_torch.parallel import mesh as M
    from aom_av1_psy_tpu_torch.utils import testframes
    frame = testframes.make_frame(1920, 1080)
    # 1920 px is 30 superblock columns, which do not part into 4 equal
    # slabs (both encoders then code one tile); 2008 px is 32, four tiles
    # of 512 px, the last with 472 visible
    counts = {T: _mesh_frames(dev, kernels, f, lg, pkt)
              for T, lg, f, pkt in (
                  (2, 1, frame, tiled_pkt),
                  (4, 2, testframes.make_frame(2008, 1080), None))}
    y = _luma_1088(frame, dev)
    args = (AN.blockify(y, 16), *AN._edges_from_source(y, 16))
    batched = M.batched_analyze_step(16, 100, device=dev)

    def timed(fn):
        fn(*args)
        _sync_all()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(*args)
            _sync_all()
            times.append(time.perf_counter() - t0)
        return out, statistics.median(times)

    want, b_s = timed(batched)
    parts = [f"batched {b_s * 1e3:.3f} ms"]
    for k in (1, 2, 4):
        mesh = _mesh_of(k, dev)
        before = KP.launches
        got, s = timed(M.sharded_analyze_step(mesh, 16, 100))
        for name, g, w in zip(("modes", "levels", "eob", "tot_sse",
                               "tot_coeff"), got, want, strict=True):
            if g.device != dev:
                raise AssertionError(f"sharded step k={k} {name} on "
                                     f"{g.device}")
            compare(f"sharded step k={k} {name} vs batched", g, w)
        parts.append(f"k={k} over {mesh}: {s * 1e3:.3f} ms, "
                     f"{(KP.launches - before) // 4} KP launches a step, "
                     f"{5 * _cross_card(mesh, dev)} cross-card copies a step")
    log(f"[5k] sharded_analyze_step(mesh, 16, 100) on the 1080p luma blocks "
        f"(B={args[0].shape[0]}) == batched_analyze_step (modes, levels, "
        f"eob, int32 totals {int(want[3])} / {int(want[4])}); median of 3 "
        f"after a first: {'; '.join(parts)}")
    _guard_cost(dev)
    return counts


def _kr_blocks(plane, h, w):
    """(B, h, w) blocks of a (1088, 1920) plane, raster order."""
    H, W = plane.shape
    return (plane.reshape(H // h, h, W // w, w).permute(0, 2, 1, 3)
            .reshape(-1, h, w).contiguous())


def _transform_path(src, ref):
    """The transform API over a luma plane against a prediction plane: at
    each ``KR_TIMED`` shape the forward transform of the residual blocks
    and the inverse of its coefficients onto the prediction; at 4x4 the
    WHT pair. Returns {name: tensor}."""
    from aom_av1_psy_tpu_torch.normative.enums import TX_HEIGHT, TX_WIDTH
    from aom_av1_psy_tpu_torch.ops import txfm as TX
    out = {}
    for ts, tt, label in KR_TIMED:
        w, h = int(TX_WIDTH[ts]), int(TX_HEIGHT[ts])
        s, p = _kr_blocks(src, h, w), _kr_blocks(ref, h, w)
        out[f"{label} coeff"] = c = TX.fwd_txfm2d(s - p, ts, tt)
        out[f"{label} recon"] = TX.inv_txfm2d_add(c, p, ts, tt)
    s, p = _kr_blocks(src, 4, 4), _kr_blocks(ref, 4, 4)
    out["WHT coeff"] = c = TX.fwht4x4(s - p)
    out["WHT recon"] = TX.iwht4x4_add(c, p)
    return out


def transform_path(dev, kernels):
    """Phase 5l: the main path of kernel KR, the transform API
    at full width: frame 1 of ``make_gop(1920, 1080, 2)`` (luma padded to
    1088 rows) against frame 0 as its prediction, through
    ``_transform_path`` (6 shapes x (``fwd_txfm2d``, ``inv_txfm2d_add``)
    + ``fwht4x4`` / ``iwht4x4_add``: 14 KR launches); the WHT pair gives
    the source back exactly (AV1's lossless path); equal to the same path
    on the CPU plain path; timed (host clock to a synchronize, median of 3
    after a first) with the counts set to 0 just before the 3 runs and
    read just after. No encode path of either package calls the general
    transforms on the device: this path is the slice's own."""
    import torch
    from aom_av1_psy_tpu_torch.utils import testframes
    f0, f1 = testframes.make_gop(1920, 1080, 2)
    ref, src = _luma_1088(f0, dev), _luma_1088(f1, dev)
    t0 = time.perf_counter()
    got = _transform_path(src, ref)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset(kernels)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = _transform_path(src, ref)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _counts(kernels)
    _need("1080p transform path", counts, [k.name for k in kernels])
    t0 = time.perf_counter()
    want = _transform_path(src.cpu(), ref.cpu())
    cpu_s = time.perf_counter() - t0
    for k in got:
        compare(f"1080p transforms {k} (CUDA vs CPU plain)", got[k].cpu(),
                want[k])
        compare(f"1080p transforms {k} (steady)", again[k], got[k])
    compare("1080p WHT round trip == source", got["WHT recon"],
            _kr_blocks(src, 4, 4))
    trip = {k[:-6]: int((v - _kr_blocks(src, v.shape[1], v.shape[2]))
                        .abs().max())
            for k, v in got.items() if k.endswith(" recon")}
    log(f"[5l] 1080p transform path (6 shapes fwd + inv, the WHT pair): "
        f"first {first_s:.4f} s, steady {statistics.median(times):.4f} s "
        f"(runs {', '.join(f'{x:.4f}' for x in times)}), CPU plain "
        f"{cpu_s:.2f} s; CUDA == CPU plain; WHT round trip exact; round "
        f"trip max |recon - source| by shape (no quantizer; 64-point "
        f"sizes keep 32 x 32 coefficients): {json.dumps(trip)}")
    log(f"[5l] launches in the 3 timed runs: {json.dumps(counts)}")
    return counts


def closed_loop_gops_cif(dev):
    """Phase 4f: the ARF, CBR and RC GOP encodes at CIF: the CUDA packets (and
    q, trace) equal the CPU plain path's, every displayed frame decodes to
    its encoder's chain planes; CBR and RC aim at 0.8 x the rate that
    ``encode_video`` reaches on the same frames at q100, and move q."""
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
        encode_video, encode_video_arf, encode_video_cbr, encode_video_rc)
    from aom_av1_psy_tpu_torch.utils import testframes
    frames = testframes.make_gop(352, 288, 6)
    cfg = EncoderConfig(base_q_idx=100)
    t0 = time.perf_counter()
    pk, encs = encode_video_arf(frames, cfg, group=4, device=dev)
    gpu_s = time.perf_counter() - t0
    if pk != encode_video_arf(frames, cfg, group=4, device="cpu")[0]:
        raise AssertionError("CIF ARF GOP: CUDA packets differ from the "
                             "CPU plain packets")
    if [e is None for e in encs] != [False, False, False, False, False,
                                     True, False, True]:
        raise AssertionError("CIF ARF GOP: packet layout "
                             f"{[type(e).__name__ for e in encs]}")
    _decodes_to_chain("CIF ARF GOP", pk, encs)
    log(f"[4f] CIF ARF GOP of 6 (group 4): bytes {[len(p) for p in pk]} "
        f"({gpu_s:.2f} s), CUDA == CPU plain packets, 6 display frames == "
        f"their chains (the show_existing packets show the ARFs)")
    ipp, _ = encode_video(frames, cfg, device=dev)
    target = 0.8 * sum(map(len, ipp)) * 8 * 30.0 / len(frames)
    for name, fn in (("CBR", encode_video_cbr), ("RC", encode_video_rc)):
        got = fn(frames, target, fps=30.0, device=dev)
        want = fn(frames, target, fps=30.0, device="cpu")
        if got[0] != want[0] or got[2:] != want[2:]:
            raise AssertionError(f"CIF {name}: CUDA packets / q differ from "
                                 "the CPU plain path")
        qs = got[2]
        if len(set(qs)) < 2:
            raise AssertionError(f"CIF {name}: q never moved {qs}")
        _decodes_to_chain(f"CIF {name}", got[0], got[1])
        rate = sum(map(len, got[0])) * 8 * 30.0 / len(frames)
        log(f"[4f] CIF {name} at {target:.0f} b/s (0.8 x encode_video's at "
            f"q100): qs {qs}, bytes {[len(p) for p in got[0]]}, achieved "
            f"{rate:.0f} b/s; CUDA == CPU plain, decodes to the chain")


def arf_gop_path(dev, kernels):
    """Phase 5g: the 1080p ARF GOP (``make_gop(1920, 1080, 9)``, group 4:
    11 packets) twice; the launch counts set to 0 just before the second
    run and read just after; the second run equals the first."""
    import numpy as np
    import torch
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
        _ref_chain_planes, displayed_encoders, encode_video_arf)
    from aom_av1_psy_tpu_torch.utils import testframes
    from aom_av1_psy_tpu_torch.encoder import tpu_intra
    frames = testframes.make_gop(1920, 1080, 9)
    cfg = EncoderConfig(base_q_idx=100)
    # the KEY walks eagerly in the first run and is captured (its launches
    # counted) in the second, whatever keys the phases before left
    tpu_intra._PLAN_GRAPHS.clear()
    t0 = time.perf_counter()
    warm, _ = encode_video_arf(frames, cfg, group=4, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _reset(kernels)
    t0 = time.perf_counter()
    pk, encs = encode_video_arf(frames, cfg, group=4, device=dev)
    torch.cuda.synchronize()
    gop_s = time.perf_counter() - t0
    counts = _counts(kernels)
    _need("1080p ARF GOP", counts, [k.name for k in kernels])
    if pk != warm or len(pk) != 11:
        raise AssertionError(f"1080p ARF GOP: {len(pk)} packets, second run "
                             f"equal to the first: {pk == warm}")
    if counts["temporal_filter"] != 3:
        raise AssertionError(f"1080p ARF GOP: {counts['temporal_filter']} KK "
                             f"launches for 3 filtered spans")
    shown = displayed_encoders(encs)
    src = np.asarray(frames[4].planes()[0], np.float64)
    rec = _ref_chain_planes(shown[4])[0].cpu().numpy()[:1080, :1920]
    psnr = 10 * np.log10(255 ** 2 / max(float(((rec - src) ** 2).mean()),
                                        1e-9))
    if len(shown) != 9 or psnr < 30:
        raise AssertionError(f"1080p ARF GOP: {len(shown)} display frames, "
                             f"ARF luma PSNR {psnr:.2f}")
    kinds = ["KEY" if i == 0 else "show_existing" if e is None else
             "ARF" if not e.show else "P" for i, e in enumerate(encs)]
    log(f"[5g] 1080p ARF GOP q100 (9 frames, group 4): warm-up "
        f"{warm_s:.3f} s, GOP {gop_s:.3f} s, packets "
        f"{[f'{k} {len(p)}' for k, p in zip(kinds, pk)]}; temporal filter "
        f"KEY {encs[0].tf_s:.4f} s, ARFs "
        f"{[round(e.tf_s, 4) for e, k in zip(encs, kinds) if k == 'ARF']} "
        f"s; display frame 4 (the first ARF) luma PSNR {psnr:.3f} dB; "
        f"second run == first")
    log(f"[5g] launches in the ARF GOP: {json.dumps(counts)}")
    log(f"[5g] KK span launches in the ARF GOP: {counts['temporal_filter']} "
        f"(the filtered KEY frame and 2 ARF spans)")
    return counts


def rc_gop_paths(dev, rate_5b):
    """Phase 5h: 1080p RC and CBR GOPs (``make_gop(1920, 1080, 5)``) at
    0.8 x the rate phase 5b's GOP reached; q must move."""
    import torch
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
        encode_video_cbr, encode_video_rc)
    from aom_av1_psy_tpu_torch.utils import testframes
    frames = testframes.make_gop(1920, 1080, 5)
    target = 0.8 * rate_5b
    for name, fn in (("RC", encode_video_rc), ("CBR", encode_video_cbr)):
        t0 = time.perf_counter()
        out = fn(frames, target, fps=30.0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        qs = out[2]
        if len(set(qs)) < 2:
            raise AssertionError(f"1080p {name}: q never moved {qs}")
        rate = sum(map(len, out[0])) * 8 * 30.0 / len(frames)
        log(f"[5h] 1080p {name} at {target:.0f} b/s (0.8 x phase 5b's "
            f"{rate_5b:.0f}): qs {qs}, bytes {[len(p) for p in out[0]]}, "
            f"achieved {rate:.0f} b/s ({rate / target:.3f} of the target), "
            f"GOP {wall:.3f} s")


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
    from aom_av1_psy_tpu_torch.encoder.tune_vmaf import TV
    from aom_av1_psy_tpu_torch.encoder.temporal_filter import KK
    from aom_av1_psy_tpu_torch.ops.mvsearch import KJ, KM
    from aom_av1_psy_tpu_torch.ops.convolve import KL
    from aom_av1_psy_tpu_torch.ops.metrics import KN, KO
    from aom_av1_psy_tpu_torch.ops.analyze import KP
    from aom_av1_psy_tpu_torch.ops.palette import KQ
    from aom_av1_psy_tpu_torch.ops.txfm import KR
    from aom_av1_psy_tpu_torch.native import LIB_PATH, get_lib
    kernels = (KA, KB, KC, KD, KE, KF, KJ, KK)
    k13b = (KJ, KL, KM, KN, KO)
    k12 = (KP, KQ)
    built = kernels + (TV,) + k13b[1:] + k12 + (KR,)
    t0 = time.perf_counter()
    build_all(built)
    log(f"[2] built {', '.join(k.name for k in built)} "
        f"with nvcc sm_90a in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    if get_lib() is None:
        raise RuntimeError("the native range coder (native/ec.cpp) did not "
                           "build")
    log(f"[2] native range coder {os.path.relpath(LIB_PATH, REPO)} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in built:
        for fn, lines in ptxas_report(k.build_log).items():
            log(f"[2]   {k.name} {fn}: {'; '.join(lines)}")

    def phase(tag, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
        return out

    if "--only-mesh" in sys.argv[1:]:
        phase("5k", mesh_path, dev, kernels[:3])
        return 0
    results = phase("3", check_kernels, dev)
    results += phase("3b", check_inter_kernels, dev)
    uniform_results = phase("3c", check_uniform_kernels, dev)
    vmaf_results = phase("3d", check_tune_vmaf_kernels, dev)
    tf_results = phase("3e", check_tf_kernels, dev)
    k13b_results = phase("3f", check_k13b_kernels, dev)
    k12_results = phase("3g", check_k12_kernels, dev)
    kr_results = phase("3h", check_kr_kernels, dev)
    if "--only-kernels" in sys.argv[1:]:
        return 0
    phase("4", closed_loop_cif, dev)
    phase("4b", closed_loop_gop_cif, dev)
    phase("4c", closed_loop_tiles_cif, dev)
    phase("4d", closed_loop_uniform, dev)
    phase("4e", closed_loop_tune_vmaf_cif, dev)
    phase("4f", closed_loop_gops_cif, dev)
    host_inter_counts = phase("4g", closed_loop_host_inter, dev, k13b)
    key_counts, frame, cfg, key_med, key_pkt, key_enc = phase(
        "5", main_path, dev, kernels[:3])
    counts, frames, encs, rate_5b = phase("5b", gop_main_path, dev, kernels)
    tiled_counts, tiled_pkt = phase("5c", tiled_key_path, dev, kernels,
                                    key_med)
    uniform_counts = phase("5d", uniform_key_path, dev, kernels)
    phase("5e", search_cdef_path, dev)
    vmaf_counts, vmaf_gop_counts = phase("5f", tune_vmaf_path, dev,
                                         kernels + (TV,), key_pkt, key_enc)
    arf_counts = phase("5g", arf_gop_path, dev, kernels)
    phase("5h", rc_gop_paths, dev, rate_5b)
    chain_counts = phase("5i", subpel_chain_path, dev, k13b)
    analysis_counts = phase("5j", analysis_path, dev, k12)
    phase("5k", mesh_path, dev, kernels[:3], tiled_pkt)
    kr_counts = phase("5l", transform_path, dev, (KR,))
    phase("6", profile_frame, dev, frame, cfg)
    phase("6b", profile_p_frame, dev, frames, encs)

    # each entry's own launches: the kernel's total, or for KA and KB the
    # variants that the entry's check covered
    own = {"intra_pred_sse": ("intra_pred bs8", "intra_pred bs16",
                              "intra_pred bs32"),
           "intra_pick": ("intra_pred pick bs8", "intra_pred pick bs16",
                          "intra_pred pick bs32"),
           "intra_pick bs4": ("intra_pred pick bs4",),
           "txq_recon_skip": ("txq bs8", "txq bs16", "txq bs32"),
           "txq_recon_skip bs8 P chroma": ("txq bs8",),
           "txq_recon_skip bs16 P": ("txq bs16",),
           "txq_recon_skip bs32 P": ("txq bs32",),
           "txq_step": ("txq step bs8", "txq step bs16", "txq step bs32"),
           "txq_step no-skip": ("txq step bs8 no-skip",
                                "txq step bs4 no-skip"),
           "intra_pred_sse bs4": ("intra_pred bs4",),
           "txq_recon bs4 no-skip": ("txq bs4 no-skip",),
           "txq_recon bs8 no-skip": ("txq bs8 no-skip",),
           "gauss_blur": ("tune_vmaf gauss_blur",
                          "tune_vmaf gauss_blur moments"),
           "unsharp_apply": ("tune_vmaf unsharp_apply",),
           "vif_scale": ("tune_vmaf vif_scale",),
           "vif_down2": ("tune_vmaf vif_down2",),
           "txfm2d_fwd": ("txfm2d fwd",), "txfm2d_inv": ("txfm2d inv",),
           "fwht4x4": ("txfm2d fwht",), "iwht4x4_add": ("txfm2d iwht",)}
    total = {"lpf_ladder": KC, "mc_8tap": KD, "fullpel_ssd": KE,
             "cdef_filter": KF, "fullpel_sad": KJ, "tf_span_filter": KK,
             "subpel_predict": KL, "subpel_refine49": KM,
             "block_reduce": KN, "satd8x8": KO, "analyze_blocks": KP,
             "palette_indices": KQ}

    def n(name, c):
        if name in total:
            return c.get(total[name].name, 0)
        return sum(c.get(v, 0) for v in own[name])

    for r in results:
        r["launches"] = n(r["name"], counts)
        r["launches_from"] = "5b: the 1080p IPPP GOP"
    for r in uniform_results:
        r["launches"] = n(r["name"], uniform_counts)
        r["launches_from"] = "5d: 3 steady 1080p BLOCK_8X8 KEY frames"
    for r in vmaf_results:
        r["launches"] = n(r["name"], vmaf_counts)
        r["launches_from"] = ("5f: 3 steady 1080p tune_vmaf KEY frames and "
                              "two vif_lite")
    for r in tf_results:
        r["launches"] = n(r["name"], arf_counts)
        r["launches_from"] = "5g: the 1080p ARF GOP (9 frames, group 4)"
        if r["name"] == "tf_span_filter":
            # 5b's IPPP GOP filters one KEY frame
            r["launches_per_filtered_key_frame"] = n(r["name"], counts)
            r["launches_per_arf_gop"] = n(r["name"], arf_counts)
    for r in k13b_results:
        r["launches"] = n(r["name"], chain_counts)
        r["launches_from"] = "5i: 3 timed runs of the 1080p subpel chain"
    for r in k12_results:
        r["launches"] = n(r["name"], analysis_counts)
        r["launches_from"] = "5j: 3 timed runs of the 1080p analysis path"
    for r in kr_results:
        r["launches"] = n(r["name"], kr_counts)
        r["launches_from"] = "5l: 3 timed runs of the 1080p transform path"
        r["launches_note"] = ("no encode path of either package calls the "
                              "general transforms on the device: 0 on "
                              "every encode path below")
    results += (uniform_results + vmaf_results + tf_results + k13b_results
                + k12_results + kr_results)
    for r in results:
        r["launches_transform_path"] = n(r["name"], kr_counts)
        r["launches_analysis_path"] = n(r["name"], analysis_counts)
        r["launches_subpel_chain"] = n(r["name"], chain_counts)
        r["launches_host_inter_gop"] = n(r["name"], host_inter_counts)
        r["launches_ippp_gop"] = n(r["name"], counts)
        r["launches_arf_gop"] = n(r["name"], arf_counts)
        r["launches_key_frame"] = n(r["name"], key_counts[0])
        r["launches_per_key_frame"] = n(r["name"], key_counts[1])
        r["host_launches_per_replayed_key_frame"] = n(r["name"],
                                                      key_counts[2])
        r["launches_tiled_key_frames"] = n(r["name"], tiled_counts)
        r["launches_uniform_key_frames"] = n(r["name"], uniform_counts)
        r["launches_tune_vmaf_key_frames"] = n(r["name"], vmaf_counts)
        r["launches_tune_vmaf_gop"] = n(r["name"], vmaf_gop_counts)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
