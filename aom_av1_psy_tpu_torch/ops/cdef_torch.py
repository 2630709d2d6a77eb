"""Kernel KF ``cdef_filter``: frame-level CDEF apply (cdef_bits = 0, 8-bit
4:2:0, 8x8 luma / 4x4 chroma blocks, skip-gated), the torch counterpart of
``aom_av1_psy_tpu/ops/cdef_jax.py`` (``_adjust_strength``, ``_constrain``,
``_filter_plane``, ``cdef_apply_fused``: ``:35-192``).

Every tap reads pre-CDEF pixels, so a plane filters as a pure function of
one copy padded by 2 with ``CDEF_VERY_LARGE`` outside the mi area. The
direction search stays on the host, ``ops/cdef.find_dir_blocks`` (it is
normative and needs exact 64-bit costs); ``dirs``/``var`` come in per 8x8
block in raster order.

``floor(log2)`` is the integer bit length here. The reference's float32
``log2`` mis-floors only at 8192 and 32768 on the CPU backend: in
``_adjust_strength`` the result is clipped at 12, which hides both, and the
``_constrain`` thresholds are below 64.
"""
from __future__ import annotations

import torch

from .cdef import CDEF_VERY_LARGE, DIRS, PRI_TAPS, SEC_TAPS
from ..kernels.build import CudaKernel, I, P
from .txq import floor_log2

KF = CudaKernel("cdef", {
    # in, Hs, Ws, ph, pw, bs, nb_c, skip8, skip_stride, dirs, var, pri,
    # sec, damping, use_dirs, out
    "cdef_filter": [P, I, I, I, I, I, I, P, I, P, P, I, I, I, I, P],
})


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


def cdef_filter(plane, ph: int, pw: int, bs: int, touched, dirs, var,
                pri: int, sec: int, damping: int):
    """``cdef_filter_plain``'s result. CPU tensors: plain version; CUDA
    tensors: kernel KF."""
    if plane.device.type == "cpu":
        return cdef_filter_plain(plane, ph, pw, bs, touched, dirs, var, pri,
                                 sec, damping)
    nb_r, nb_c = ph // bs, pw // bs
    B = nb_r * nb_c
    Hs, Ws = plane.shape
    spec = [(plane, torch.int32, (Hs, Ws)), (touched, torch.bool, (B,)),
            (dirs, torch.int32, (B,))]
    if var is not None:
        spec.append((var, torch.int32, (B,)))
    args = []
    for t, dt, shape in spec:
        if t.device.type != "cuda" or t.dtype != dt or \
                tuple(t.shape) != shape:
            raise ValueError(f"KF input: want {dt} {shape} on cuda, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        args.append(t.contiguous())
    if bs not in (4, 8) or ph > Hs or pw > Ws or ph % bs or pw % bs:
        raise ValueError(f"KF: bs={bs}, area {ph}x{pw} in {Hs}x{Ws}")
    plane, touched, dirs = args[:3]
    out = torch.empty_like(plane)
    KF.launch("cdef_filter", plane.data_ptr(), Hs, Ws, ph, pw, bs, nb_c,
              touched.data_ptr(), nb_c, dirs.data_ptr(),
              args[3].data_ptr() if var is not None else 0, pri, sec,
              damping, int(pri != 0), out.data_ptr())
    return out


def cdef_apply_fused(planes, skip8, dirs, var, y_pri: int, y_sec: int,
                     uv_pri: int, uv_sec: int, damping: int, *, mi_rows: int,
                     mi_cols: int, nplanes: int):
    """Frame-level CDEF (``cdef_jax.cdef_apply_fused``): planes (y, u, v)
    int32 tensors (mi-aligned or larger); skip8 (>= mi_rows/2,
    >= mi_cols/2) bool, True where the 8x8 unit is all-skip; dirs/var
    (nb,) int32 per 8x8 block in raster order. Returns the filtered planes
    in the input shapes."""
    mh, mw = mi_rows * 4, mi_cols * 4
    nb_r, nb_c = mh // 8, mw // 8
    touched = ~skip8[:nb_r, :nb_c].reshape(-1)
    outs = [cdef_filter(planes[0], mh, mw, 8, touched, dirs, var, y_pri,
                        y_sec, damping)]
    if nplanes > 1:
        for p in (1, 2):
            outs.append(cdef_filter(planes[p], mh // 2, mw // 2, 4, touched,
                                    dirs, None, uv_pri, uv_sec, damping - 1))
    return tuple(outs)
