"""Kernel KF ``cdef_filter``: frame-level CDEF (cdef_bits = 0, 8-bit
4:2:0, 8x8 luma / 4x4 chroma blocks, skip-gated), the torch counterpart of
``aom_av1_psy_tpu/ops/cdef_jax.py`` (``_adjust_strength``, ``_constrain``,
``_filter_plane``, ``cdef_apply_fused``: ``:35-192``), with the normative
direction search (``ops/cdef.find_dir_blocks``, libaom's
``cdef_find_dir_c``) on the device as well: the reference keeps it on the
host only because its backend has no 64-bit integers.

Every tap reads pre-CDEF pixels, so a plane filters as a pure function of
one copy padded by 2 with ``CDEF_VERY_LARGE`` outside the mi area. ``dirs``
/ ``var`` are per 8x8 block in raster order. Entries (one kernel,
``csrc/cdef.cu``, serves them all; on CPU tensors each runs its plain
version):

- ``cdef_frame``: the frame pass: the direction search, the three planes
  and, with sources, the A/B gate's squared errors (one launch);
- ``cdef_apply_fused``: the frame pass with the directions given;
- ``cdef_filter``: one plane with the directions given.

``floor(log2)`` is the integer bit length here. The reference's float32
``log2`` mis-floors only at 8192 and 32768 on the CPU backend: in
``_adjust_strength`` the result is clipped at 12, which hides both, and the
``_constrain`` thresholds are below 64.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cdef import CDEF_VERY_LARGE, DIRS, PRI_TAPS, SEC_TAPS
from ..kernels.build import CudaKernel, I, P, need
from .txq import floor_log2


class _KFPlane(ctypes.Structure):
    """``csrc/cdef.cu``'s ``KFPlane``, field for field."""
    _fields_ = ([(f, P) for f in ("inp", "out", "src")]
                + [(f, I) for f in ("H", "W", "src_stride", "ph", "pw", "bs",
                                    "pri", "sec", "damping", "adjust")])


class _KFArgs(ctypes.Structure):
    """``csrc/cdef.cu``'s ``KFArgs``, field for field."""
    _fields_ = ([("p", _KFPlane * 3)]
                + [(f, P) for f in ("skip", "dirs", "var", "sums")]
                + [(f, I) for f in ("np", "skip_stride", "nb_r", "nb_c",
                                    "search")])


KF = CudaKernel("cdef", {"cdef_launch": [ctypes.POINTER(_KFArgs)]})

# the kernel's tiles: 8 x 8 blocks (luma 64 px, chroma 32 px) and the halo
# each is staged with
TILE_BLOCKS = 8
HALO = 2


def kf_tiles(H: int, W: int, bs: int):
    """KF's tiles of an (H, W) plane of ``bs``-px blocks, clipped to the
    plane: (y0, y1, x0, x1). A CTA filters one tile from the tile and its
    ``HALO``-px border alone (and, for the search, the luma tile's blocks)."""
    T = TILE_BLOCKS * bs
    return [(y, min(y + T, H), x, min(x + T, W))
            for y in range(0, H, T) for x in range(0, W, T)]


def _dir_tables():
    """(8, 64) line index d * 15 + line of each pixel of an 8x8 block for
    every direction, and (8, 15) the cost weight of each line
    (``cdef_find_dir_c``)."""
    ii, jj = np.mgrid[0:8, 0:8]
    lines = [ii + jj, ii + jj // 2, ii, 3 + ii - jj // 2, 7 + ii - jj,
             3 - ii // 2 + jj, jj, ii // 2 + jj]
    index = np.stack([d * 15 + ln.reshape(-1) for d, ln in enumerate(lines)])
    div = [0, 840, 420, 280, 210, 168, 140, 120, 105]
    w = np.zeros((8, 15), np.int64)
    for d in (2, 6):
        w[d, :8] = div[8]
    for d in (0, 4):
        for i in range(7):
            w[d, i] = w[d, 14 - i] = div[i + 1]
        w[d, 7] = div[8]
    for d in (1, 3, 5, 7):
        w[d, 3:8] = div[8]
        for j in range(3):
            w[d, j] = w[d, 10 - j] = div[2 * j + 2]
    return index, w


DIR_INDEX, DIR_WEIGHTS = _dir_tables()


def find_dir_plain(y, ph: int, pw: int):
    """Plain version of KF's direction search: (dirs, var) int32 for every
    8x8 block of the (ph, pw) area of plane ``y``, in raster order; equal
    to ``ops/cdef.find_dir_blocks`` (int64 costs, the first largest cost,
    var = (best - cost[(best + 4) & 7]) >> 10)."""
    if ph % 8 or pw % 8 or ph > y.shape[0] or pw > y.shape[1]:
        raise ValueError(f"find_dir_plain: area {ph}x{pw} in {tuple(y.shape)}")
    nb_r, nb_c = ph // 8, pw // 8
    x = y[:ph, :pw].to(torch.int64).reshape(nb_r, 8, nb_c, 8) \
        .permute(0, 2, 1, 3).reshape(-1, 64) - 128
    B = x.shape[0]
    index = torch.as_tensor(DIR_INDEX.reshape(-1), device=y.device)
    partial = torch.zeros((B, 120), dtype=torch.int64, device=y.device) \
        .index_add_(1, index, x.repeat(1, 8)).reshape(B, 8, 15)
    cost = (partial * partial
            * torch.as_tensor(DIR_WEIGHTS, device=y.device)).sum(-1)
    best = torch.argmax(cost, dim=1, keepdim=True)
    var = (cost.gather(1, best) - cost.gather(1, (best + 4) & 7)) >> 10
    return best[:, 0].to(torch.int32), var[:, 0].to(torch.int32)


def _adjust_strength(strength: int, var):
    """adjust_strength: strength * (4 + min(msb(var >> 6), 12)) + 8 >> 4,
    0 where var == 0; var (B,) int32."""
    v6 = var >> 6
    msb = floor_log2(v6.clamp(min=1)).clamp(0, 12).to(torch.int32)
    i = torch.where(v6 >= 1, msb, torch.zeros_like(msb))
    adj = (strength * (4 + i) + 8) >> 4
    return torch.where(var != 0, adj, torch.zeros_like(adj))


def _constrain(diff, threshold, damping: int):
    """cdef constrain: shift = max(damping - floor(log2(threshold)), 0);
    threshold is a tensor broadcastable to diff, or an int."""
    t = torch.as_tensor(threshold, dtype=torch.int32, device=diff.device)
    shift = (damping - floor_log2(t.clamp(min=1))).clamp(min=0)
    a = diff.abs()
    v = diff.sign() * torch.minimum(a, (t - (a >> shift)).clamp(min=0))
    return torch.where(t == 0, torch.zeros_like(v), v)


def _plane_blocks(pad, nb_r: int, nb_c: int, bh: int, bw: int):
    """(B, bh+4, bw+4) block contexts from the padded plane."""
    return pad.unfold(0, bh + 4, bh).unfold(1, bw + 4, bw) \
        .reshape(nb_r * nb_c, bh + 4, bw + 4)


def _filter_plane(pad, dirs, pri_t, sec_t: int, damping: int, nb_r: int,
                  nb_c: int, bh: int, bw: int, touched):
    """Filter one plane's (nb_r * nb_c) blocks; returns (B, bh, bw).

    pad: (H+4, W+4) with CDEF_VERY_LARGE outside; dirs/pri_t (B,) int32;
    touched (B,) bool gates skip units."""
    ctx = _plane_blocks(pad, nb_r, nb_c, bh, bw)
    x = ctx[:, 2:2 + bh, 2:2 + bw]
    total = torch.zeros_like(x)
    mx, mn = x, x
    ar_y = torch.arange(bh, device=pad.device)
    ar_x = torch.arange(bw, device=pad.device)
    nb = torch.arange(ctx.shape[0], device=pad.device)[:, None, None]

    def tap(d, k, sign):
        dy = torch.as_tensor(DIRS[:, k, 0], device=pad.device)[d.long()]
        dx = torch.as_tensor(DIRS[:, k, 1], device=pad.device)[d.long()]
        yy = 2 + sign * dy[:, None, None] + ar_y[None, :, None]
        xx = 2 + sign * dx[:, None, None] + ar_x[None, None, :]
        return ctx[nb, yy, xx]

    pri_on = (pri_t != 0)[:, None, None]
    for k in range(2):
        ptap = torch.where((pri_t & 1) == 1, PRI_TAPS[1][k],
                           PRI_TAPS[0][k]).to(torch.int32)[:, None, None]
        for pv in (tap(dirs, k, 1), tap(dirs, k, -1)):
            mx = torch.where(pv != CDEF_VERY_LARGE, torch.maximum(pv, mx), mx)
            mn = torch.minimum(pv, mn)
            c = ptap * _constrain(pv - x, pri_t[:, None, None], damping)
            total = total + torch.where(pri_on, c, torch.zeros_like(c))
        for sv in (tap((dirs + 2) & 7, k, 1), tap((dirs - 2) & 7, k, 1),
                   tap((dirs + 2) & 7, k, -1), tap((dirs - 2) & 7, k, -1)):
            mx = torch.where(sv != CDEF_VERY_LARGE, torch.maximum(sv, mx), mx)
            mn = torch.minimum(sv, mn)
            if sec_t != 0:
                total = total + SEC_TAPS[k] * _constrain(sv - x, sec_t,
                                                         damping)
    y = x + ((8 + total - (total < 0).to(torch.int32)) >> 4)
    if sec_t != 0:
        y = torch.where(pri_on, torch.minimum(torch.maximum(y, mn), mx), y)
    untouched = ~touched[:, None, None]
    if sec_t == 0:
        untouched = untouched | ~pri_on
    return torch.where(untouched, x, y)


def cdef_filter_plain(plane, ph: int, pw: int, bs: int, touched, dirs, var,
                      pri: int, sec: int, damping: int):
    """Plain version of KF: one plane (Hs, Ws) int32 with its (ph, pw) mi
    area filtered in bs x bs blocks. ``var`` (B,) adjusts the primary
    strength per block (luma) or is None (chroma: ``pri`` as given);
    ``dirs`` are used only when ``pri`` != 0 (cdef.c ``use_dirs``)."""
    nb_r, nb_c = ph // bs, pw // bs
    pad = torch.full((ph + 4, pw + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                     device=plane.device)
    pad[2:2 + ph, 2:2 + pw] = plane[:ph, :pw]
    B = nb_r * nb_c
    pri_t = _adjust_strength(pri, var) if var is not None else \
        torch.full((B,), pri, dtype=torch.int32, device=plane.device)
    d = dirs if pri != 0 else torch.zeros_like(dirs)
    out = _filter_plane(pad, d, pri_t, sec, damping, nb_r, nb_c, bs, bs,
                        touched)
    new = plane.clone()
    new[:ph, :pw] = out.reshape(nb_r, nb_c, bs, bs).permute(0, 2, 1, 3) \
        .reshape(ph, pw)
    return new


def _apply_plain(planes, skip8, dirs, var, y_pri, y_sec, uv_pri, uv_sec,
                 damping, mh, mw, nplanes):
    nb_r, nb_c = mh // 8, mw // 8
    touched = ~skip8[:nb_r, :nb_c].reshape(-1)
    outs = [cdef_filter_plain(planes[0], mh, mw, 8, touched, dirs, var,
                              y_pri, y_sec, damping)]
    for p in range(1, nplanes):
        outs.append(cdef_filter_plain(planes[p], mh // 2, mw // 2, 4,
                                      touched, dirs, None, uv_pri, uv_sec,
                                      damping - 1))
    return tuple(outs)


def _gate_sums_plain(before, after, srcs, mh: int, mw: int):
    """(2, nplanes) int64: per plane, sum((before - src)^2) and
    sum((after - src)^2) over the mi area (luma mh x mw, chroma half)."""
    rows = [[], []]
    for p, (b, a, s) in enumerate(zip(before, after, srcs)):
        h, w = (mh, mw) if p == 0 else (mh // 2, mw // 2)
        src = s[:h, :w].to(torch.int64)
        for row, pl in zip(rows, (b, a)):
            d = pl[:h, :w].to(torch.int64) - src
            row.append((d * d).sum())
    return torch.stack([torch.stack(r) for r in rows])


def cdef_frame_plain(planes, skip8, y_pri: int, y_sec: int, uv_pri: int,
                     uv_sec: int, damping: int, *, mi_rows: int,
                     mi_cols: int, nplanes: int, srcs=None):
    """Plain version of ``cdef_frame``: ``find_dir_plain`` on the luma mi
    area, the planes filtered as ``cdef_apply_fused`` does, and with
    ``srcs`` the gate's sums (``_gate_sums_plain``). Returns (planes, dirs,
    var, sums or None)."""
    mh, mw = mi_rows * 4, mi_cols * 4
    dirs, var = find_dir_plain(planes[0], mh, mw)
    outs = _apply_plain(planes, skip8, dirs, var, y_pri, y_sec, uv_pri,
                        uv_sec, damping, mh, mw, nplanes)
    sums = None
    if srcs is not None:
        sums = _gate_sums_plain(planes[:nplanes], outs, srcs[:nplanes],
                                mh, mw)
    return outs, dirs, var, sums


# ---------------------------------------------------------------------------
# the kernel's entries


def _job(plane, ph: int, pw: int, bs: int, pri: int, sec: int, damping: int,
         adjust: bool, di: int, what: str, src=None):
    """One plane's ``_KFPlane`` and its output."""
    if plane.dim() != 2:
        raise ValueError(f"KF {what}: want a 2-D plane, got "
                         f"{tuple(plane.shape)}")
    plane = plane.contiguous()
    H, W = plane.shape
    if bs not in (4, 8) or ph > H or pw > W or ph % bs or pw % bs:
        raise ValueError(f"KF {what}: bs={bs}, area {ph}x{pw} in {H}x{W}")
    out = torch.empty_like(plane)
    job = _KFPlane(inp=need(plane, torch.int32, (H, W), di, what),
                   out=out.data_ptr(), H=H, W=W, ph=ph, pw=pw, bs=bs,
                   pri=pri, sec=sec, damping=damping, adjust=int(adjust))
    if src is not None:
        if src.dim() != 2 or src.shape[0] < ph or src.shape[1] < pw:
            raise ValueError(f"KF {what} source: {tuple(src.shape)} does not "
                             f"cover {ph}x{pw}")
        job.src = need(src, torch.int32, src.shape, di, f"{what} source")
        job.src_stride = src.shape[1]
    return job, out


def _launch(jobs, skip, nb_r: int, nb_c: int, dirs, var, search: bool, sums,
            variant: str) -> None:
    a = _KFArgs(skip=skip.data_ptr(), dirs=dirs.data_ptr(),
                var=0 if var is None else var.data_ptr(),
                sums=0 if sums is None else sums.data_ptr(), np=len(jobs),
                skip_stride=skip.shape[1], nb_r=nb_r, nb_c=nb_c,
                search=int(search))
    for i, j in enumerate(jobs):
        a.p[i] = j
    KF.launch("cdef_launch", ctypes.byref(a), device=skip.get_device(),
              variant=variant)


def _blocks_of(t, dtype, B: int, di: int, what: str):
    """A per-block (B,) input, contiguous and checked."""
    t = t.contiguous()
    need(t, dtype, (B,), di, f"KF {what}")
    return t


def cdef_filter(plane, ph: int, pw: int, bs: int, touched, dirs, var,
                pri: int, sec: int, damping: int):
    """``cdef_filter_plain``'s result. CPU tensors: plain version; CUDA
    tensors: kernel KF with the directions given (one launch)."""
    if plane.device.type == "cpu":
        return cdef_filter_plain(plane, ph, pw, bs, touched, dirs, var, pri,
                                 sec, damping)
    di = plane.get_device()
    nb_r, nb_c = ph // bs, pw // bs
    B = nb_r * nb_c
    touched = _blocks_of(touched, torch.bool, B, di, "touched")
    dirs = _blocks_of(dirs, torch.int32, B, di, "dirs")
    if var is not None:
        var = _blocks_of(var, torch.int32, B, di, "var")
    job, out = _job(plane, ph, pw, bs, pri, sec, damping, var is not None,
                    di, "plane")
    _launch([job], (~touched).view(nb_r, nb_c), nb_r, nb_c, dirs, var, False,
            None, f"plane bs{bs}")
    return out


def _frame(planes, skip8, dirs, var, y_pri, y_sec, uv_pri, uv_sec, damping,
           mi_rows, mi_cols, nplanes, srcs, variant):
    """One KF launch over the frame's planes: with ``dirs`` None the
    search runs and writes them. Returns (planes, dirs, var, sums)."""
    mh, mw = mi_rows * 4, mi_cols * 4
    nb_r, nb_c = mh // 8, mw // 8
    di = planes[0].get_device()
    if skip8.dim() != 2 or skip8.shape[0] < nb_r or skip8.shape[1] < nb_c:
        raise ValueError(f"KF skip8: {tuple(skip8.shape)} does not cover "
                         f"{nb_r}x{nb_c} blocks")
    need(skip8, torch.bool, skip8.shape, di, "KF skip8")
    search = dirs is None
    if search:
        dirs = torch.empty(nb_r * nb_c, dtype=torch.int32,
                           device=planes[0].device)
        var = torch.empty_like(dirs)
    else:
        dirs = _blocks_of(dirs, torch.int32, nb_r * nb_c, di, "dirs")
        var = _blocks_of(var, torch.int32, nb_r * nb_c, di, "var")
    srcs = srcs[:nplanes] if srcs is not None else (None,) * nplanes
    jobs, outs = [], []
    for p in range(nplanes):
        luma = p == 0
        job, out = _job(
            planes[p], mh if luma else mh // 2, mw if luma else mw // 2,
            8 if luma else 4, y_pri if luma else uv_pri,
            y_sec if luma else uv_sec, damping if luma else damping - 1,
            luma, di, f"plane {p}", src=srcs[p])
        jobs.append(job)
        outs.append(out)
    sums = None
    if srcs[0] is not None:
        sums = torch.zeros((2, nplanes), dtype=torch.int64,
                           device=planes[0].device)
    _launch(jobs, skip8, nb_r, nb_c, dirs, var, search, sums, variant)
    return tuple(outs), dirs, var, sums


def cdef_apply_fused(planes, skip8, dirs, var, y_pri: int, y_sec: int,
                     uv_pri: int, uv_sec: int, damping: int, *, mi_rows: int,
                     mi_cols: int, nplanes: int):
    """Frame-level CDEF (``cdef_jax.cdef_apply_fused``): planes (y, u, v)
    int32 tensors (mi-aligned or larger); skip8 (>= mi_rows/2,
    >= mi_cols/2) bool, True where the 8x8 unit is all-skip; dirs/var
    (nb,) int32 per 8x8 block in raster order. Returns the filtered planes
    in the input shapes. CPU tensors: plain version; CUDA tensors: one KF
    launch."""
    if planes[0].device.type == "cpu":
        return _apply_plain(planes, skip8, dirs, var, y_pri, y_sec, uv_pri,
                            uv_sec, damping, mi_rows * 4, mi_cols * 4,
                            nplanes)
    return _frame(planes, skip8, dirs, var, y_pri, y_sec, uv_pri, uv_sec,
                  damping, mi_rows, mi_cols, nplanes, None, "frame")[0]


def cdef_frame(planes, skip8, y_pri: int, y_sec: int, uv_pri: int,
               uv_sec: int, damping: int, *, mi_rows: int, mi_cols: int,
               nplanes: int, srcs=None):
    """The frame pass: the direction search on the luma mi area, the
    ``nplanes`` planes filtered (``cdef_apply_fused``) and, with ``srcs``
    (int32 source planes covering the mi area), the A/B gate's (2,
    nplanes) int64 sums (``_gate_sums_plain``). Returns (planes, dirs, var,
    sums or None). CPU tensors: ``cdef_frame_plain``; CUDA tensors: one KF
    launch (and the zeroing of the sums)."""
    if planes[0].device.type == "cpu":
        return cdef_frame_plain(planes, skip8, y_pri, y_sec, uv_pri, uv_sec,
                                damping, mi_rows=mi_rows, mi_cols=mi_cols,
                                nplanes=nplanes, srcs=srcs)
    return _frame(planes, skip8, None, None, y_pri, y_sec, uv_pri, uv_sec,
                  damping, mi_rows, mi_cols, nplanes, srcs, "frame search")
