"""On-device deblocking for the fused plan's grids — torch counterpart of
``aom_av1_psy_tpu/ops/deblock_jax.py`` (``deblock_plane_fused`` :183,
``lpf_pick_and_filter`` :235, ``lpf_apply`` :279), built on kernel KC
``lpf_ladder``.

For the plan's geometry (TX == block size, aligned 32/16 luma cells,
uniform level, sharpness 0) every edge's parameters collapse: 14-tap luma
and 6-tap chroma everywhere, an edge exists at a cell boundary iff it is a
tx origin, and all edges of one direction are independent (a 14-tap
filter writes +-6 and reads +-7 around edges >= 16 px apart). So one
direction is one parallel gather -> filter -> scatter.

KC runs one CTA per tile, looping over the levels: tile origins half a
cell before an edge, so every edge reads and writes inside one tile and a
tile needs no halo. ``kc_tile`` states the kernel's layout and ``kc_tiles``
lists its tiles, so that ``tests/test_torch_kc_tiles.py`` holds the claim
against the plain version.

The level pick sums each candidate's squared error exactly in int64 (the
reference sums in float32 because JAX runs without x64; the picked levels
agree on the tested frames).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.build import CudaKernel, I, P

KC = CudaKernel("deblock", {
    # buf, Hb, Wb, split16, R2, C2, cands, L, cell, luma, nl_v, kv, nl_h,
    # kh, src, src_stride, pw, ph, outs, sse
    "lpf_ladder": [P, I, I, P, I, I, P, I, I, I, I, I, I, I, P, I, I, I,
                   P, P],
})

# KC's tile side in cells (luma 64 px, chroma 32 px: csrc/deblock.cu Tile)
TILE_CELLS = 4


def kc_tile(cell: int):
    """KC's tile layout for a cell size: (origin offset, side). Origins
    sit half a cell before an edge (luma 16m - 8, chroma 8m - 4): an edge at
    e reads and writes only inside [e - cell/2, e + cell/2), which lies in
    one tile in both directions."""
    return -(cell // 2), TILE_CELLS * cell


def kc_tiles(cell: int, hb: int, wb: int):
    """KC's tiles of an (hb, wb) plane as (y0, y1, x0, x1), row-major,
    clipped to the plane (the kernel's grid order)."""
    off, side = kc_tile(cell)
    ny, nx = -(-(hb - off) // side), -(-(wb - off) // side)
    return [(max(off + i * side, 0), min(off + (i + 1) * side, hb),
             max(off + j * side, 0), min(off + (j + 1) * side, wb))
            for i in range(ny) for j in range(nx)]


def _clamp127(v):
    return v.clamp(-128, 127)


def _filter4(p1, p0, q0, q1, mask, hev):
    ps1, ps0 = p1 - 128, p0 - 128
    qs0, qs1 = q0 - 128, q1 - 128
    f = _clamp127(ps1 - qs1) * hev
    f = _clamp127(f + 3 * (qs0 - ps0)) * mask
    f1 = _clamp127(f + 4) >> 3
    f2 = _clamp127(f + 3) >> 3
    oq0 = _clamp127(qs0 - f1) + 128
    op0 = _clamp127(ps0 + f2) + 128
    f = ((f1 + 1) >> 1) * (1 - hev)
    oq1 = _clamp127(qs1 - f) + 128
    op1 = _clamp127(ps1 + f) + 128
    return op1, op0, oq0, oq1


def _r3(v):
    return (v + 4) >> 3


def _r4(v):
    return (v + 8) >> 4


def _limits(level):
    lim = level.clamp(min=1) if torch.is_tensor(level) else max(level, 1)
    return lim, 2 * (level + 2) + lim, level >> 4


def _filter_seg14(px, on, level):
    """Length-14 luma edge filter on (N, 14) segments (p6..p0, q0..q6).
    Returns the modified 12 middle taps (N, 12) = indices 1..12."""
    lim, blimit, thresh = _limits(level)
    p = [px[:, 6 - i] for i in range(7)]
    q = [px[:, 7 + i] for i in range(7)]

    def ab(a, b):
        return (a - b).abs()

    fm2 = ~((ab(p[1], p[0]) > lim) | (ab(q[1], q[0]) > lim)
            | (ab(p[0], q[0]) * 2 + ab(p[1], q[1]) // 2 > blimit))
    fm3 = fm2 & ~((ab(p[2], p[1]) > lim) | (ab(q[2], q[1]) > lim))
    fm4 = fm3 & ~((ab(p[3], p[2]) > lim) | (ab(q[3], q[2]) > lim))
    flat3 = ~((ab(p[1], p[0]) > 1) | (ab(q[1], q[0]) > 1)
              | (ab(p[2], p[0]) > 1) | (ab(q[2], q[0]) > 1))
    flat4 = flat3 & ~((ab(p[3], p[0]) > 1) | (ab(q[3], q[0]) > 1))
    flat2 = ~((ab(p[1], p[0]) > 1) | (ab(q[1], q[0]) > 1)
              | (ab(p[4], p[0]) > 1) | (ab(q[4], q[0]) > 1)
              | (ab(p[5], p[0]) > 1) | (ab(q[5], q[0]) > 1)
              | (ab(p[6], p[0]) > 1) | (ab(q[6], q[0]) > 1))

    mask = fm4 & on
    hev = ((ab(p[1], p[0]) > thresh) | (ab(q[1], q[0]) > thresh)) \
        .to(torch.int32)
    n4p1, n4p0, n4q0, n4q1 = _filter4(p[1], p[0], q[0], q[1],
                                      mask.to(torch.int32), hev)
    wide8 = flat4 & mask
    wide14 = flat4 & flat2 & mask
    narrow = mask & ~wide8

    out = [px[:, i] for i in range(14)]
    for idx, v in ((5, n4p1), (6, n4p0), (7, n4q0), (8, n4q1)):
        out[idx] = torch.where(narrow, v, out[idx])

    w8 = wide8 & ~wide14
    o2 = _r3(p[3] * 3 + 2 * p[2] + p[1] + p[0] + q[0])
    o1 = _r3(p[3] * 2 + p[2] + 2 * p[1] + p[0] + q[0] + q[1])
    o0 = _r3(p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2])
    u0 = _r3(p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3])
    u1 = _r3(p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] * 2)
    u2 = _r3(p[0] + q[0] + q[1] + 2 * q[2] + q[3] * 3)
    for idx, v in ((4, o2), (5, o1), (6, o0), (7, u0), (8, u1), (9, u2)):
        out[idx] = torch.where(w8, v, out[idx])

    o5 = _r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0]
             + q[0])
    o4 = _r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] + p[0]
             + q[0] + q[1])
    o3 = _r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] + p[0]
             + q[0] + q[1] + q[2])
    o2 = _r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 + p[0]
             + q[0] + q[1] + q[2] + q[3])
    o1 = _r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 + p[0] * 2
             + q[0] + q[1] + q[2] + q[3] + q[4])
    o0 = _r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2
             + q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5])
    u0 = _r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2
             + q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6])
    u1 = _r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2
             + q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2)
    u2 = _r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2
             + q[3] * 2 + q[4] + q[5] + q[6] * 3)
    u3 = _r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2
             + q[4] * 2 + q[5] + q[6] * 4)
    u4 = _r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2
             + q[5] * 2 + q[6] * 5)
    u5 = _r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2
             + q[6] * 7)
    for idx, v in ((1, o5), (2, o4), (3, o3), (4, o2), (5, o1), (6, o0),
                   (7, u0), (8, u1), (9, u2), (10, u3), (11, u4), (12, u5)):
        out[idx] = torch.where(wide14, v, out[idx])
    return torch.stack(out[1:13], dim=-1)


def _filter_seg6(px, on, level):
    """Length-6 chroma edge filter on (N, 6) segments (p2,p1,p0,q0,q1,q2).
    Returns the modified 4 middle taps (N, 4) = p1,p0,q0,q1."""
    lim, blimit, thresh = _limits(level)
    p2, p1, p0, q0, q1, q2 = (px[:, i] for i in range(6))

    def ab(a, b):
        return (a - b).abs()

    fm2 = ~((ab(p1, p0) > lim) | (ab(q1, q0) > lim)
            | (ab(p0, q0) * 2 + ab(p1, q1) // 2 > blimit))
    fm3 = fm2 & ~((ab(p2, p1) > lim) | (ab(q2, q1) > lim))
    flat3 = ~((ab(p1, p0) > 1) | (ab(q1, q0) > 1)
              | (ab(p2, p0) > 1) | (ab(q2, q0) > 1))
    mask = fm3 & on
    hev = ((ab(p1, p0) > thresh) | (ab(q1, q0) > thresh)).to(torch.int32)
    n4p1, n4p0, n4q0, n4q1 = _filter4(p1, p0, q0, q1, mask.to(torch.int32),
                                      hev)
    wide6 = flat3 & mask
    narrow = mask & ~wide6
    o1 = _r3(p2 * 3 + p1 * 2 + p0 * 2 + q0)
    o0 = _r3(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1)
    u0 = _r3(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2)
    u1 = _r3(p0 + q0 * 2 + q1 * 2 + q2 * 3)
    outs = [torch.where(narrow, nar, torch.where(wide6, wid, orig))
            for nar, wid, orig in ((n4p1, o1, p1), (n4p0, o0, p0),
                                   (n4q0, u0, q0), (n4q1, u1, q1))]
    return torch.stack(outs, dim=-1)


def _edge_geometry(cell: int, w: int, h: int, bufshape):
    """Edge counts (boundaries k = 1..kv / 1..kh) + line extents."""
    n4c = (w + 3) // 4
    n4r = (h + 3) // 4
    kv = len([k for k in range(1, bufshape[1] // cell + 1)
              if cell * k < 4 * n4c])
    kh = len([k for k in range(1, bufshape[0] // cell + 1)
              if cell * k < 4 * n4r])
    nl_v = min(n4r * 4, bufshape[0])
    nl_h = min(n4c * 4, bufshape[1])
    return kv, kh, nl_v, nl_h


def deblock_plane_fused(buf, split16, lvl_v, lvl_h, *, cell: int, w: int,
                        h: int, luma: bool):
    """Filter one plane of the fused plan's recon (plain torch).

    buf (Hb, Wb) int32; split16 (R2, C2) bool per-cell split map (cell =
    16 px luma / 8 px chroma); lvl_v/lvl_h levels (int or 0-dim tensor);
    w/h: cropped plane dims. Returns a new plane."""
    kv, kh, nl_v, nl_h = _edge_geometry(cell, w, h, buf.shape)
    taps = 14 if luma else 6
    half = taps // 2
    nw = 12 if luma else 4           # written taps per edge, from tap 1
    filt = _filter_seg14 if luma else _filter_seg6
    dev = buf.device

    def idx(a):
        return torch.as_tensor(a, device=dev)

    buf = buf.clone()
    if kv:
        karr = np.arange(1, kv + 1)
        xs = karr * cell
        seg = buf[:nl_v][:, idx(xs[:, None] - half + np.arange(taps))]
        i_of_y = idx(np.arange(nl_v) // cell)
        tu = split16[i_of_y][:, idx(karr)] | idx(karr % 2 == 0)[None, :]
        on = tu & (lvl_v > 0)
        res = filt(seg.reshape(-1, taps), on.reshape(-1), lvl_v)
        buf[:nl_v, idx(xs[:, None] - half + 1 + np.arange(nw))] = \
            res.reshape(nl_v, kv, nw)
    if kh:
        karr = np.arange(1, kh + 1)
        ys = karr * cell
        seg = buf[idx(ys[:, None] - half + np.arange(taps))][:, :, :nl_h]
        seg = seg.permute(2, 0, 1)                          # (NL, Kh, taps)
        j_of_x = idx(np.arange(nl_h) // cell)
        tu = split16[idx(karr)][:, j_of_x].T | idx(karr % 2 == 0)[None, :]
        on = tu & (lvl_h > 0)
        res = filt(seg.reshape(-1, taps), on.reshape(-1), lvl_h)
        buf[idx(ys[:, None] - half + 1 + np.arange(nw)), :nl_h] = \
            res.reshape(nl_h, kh, nw).permute(1, 2, 0)
    return buf


def lpf_ladder_plain(buf, split16, cands, src, w: int, h: int, cell: int,
                     luma: bool):
    """Plain version of kernel KC: the plane filtered at each of the L
    candidate levels (L, Hb, Wb), and each one's exact squared error
    against ``src`` over the cropped (h, w) area (L,) int64 (``None``
    when src is None)."""
    outs = torch.stack([deblock_plane_fused(buf, split16, lvl, lvl,
                                            cell=cell, w=w, h=h, luma=luma)
                        for lvl in cands])
    if src is None:
        return outs, None
    d = (outs[:, :h, :w] - src[None, :h, :w]).to(torch.int64)
    return outs, (d * d).sum((1, 2))


def lpf_ladder(buf, split16, cands, src, w: int, h: int, cell: int,
               luma: bool):
    """Kernel KC for CUDA tensors, its plain version for CPU tensors."""
    if buf.device.type == "cpu":
        return lpf_ladder_plain(buf, split16, cands, src, w, h, cell, luma)
    Hb, Wb = buf.shape
    R2, C2 = split16.shape
    kv, kh, nl_v, nl_h = _edge_geometry(cell, w, h, buf.shape)
    half = 7 if luma else 3
    if (kv and kv * cell + half > Wb) or (kh and kh * cell + half > Hb) \
            or (nl_v - 1) // cell >= R2 or (nl_h - 1) // cell >= C2:
        raise ValueError("KC: edge taps or split map outside the plane")
    spec = [(buf, torch.int32, 2), (split16, torch.bool, 2),
            (cands, torch.int32, 1)]
    if src is not None:
        spec.append((src, torch.int32, 2))
    args = []
    for t, dt, nd in spec:
        if t.device.type != "cuda" or t.device != buf.device or \
                t.dtype != dt or t.dim() != nd:
            raise ValueError(f"KC input: want {nd}-D {dt} on {buf.device}, "
                             f"got {t.dim()}-D {t.dtype} on {t.device}")
        args.append(t.contiguous())
    buf, split16, cands = args[:3]
    L = cands.shape[0]
    outs = torch.empty((L, Hb, Wb), dtype=torch.int32, device=buf.device)
    if src is not None:
        src = args[3]
        if src.shape[0] < h or src.shape[1] < w:
            raise ValueError("KC: source smaller than the cropped plane")
        sse = torch.empty((L,), dtype=torch.int64, device=buf.device)
        src_args = (src.data_ptr(), src.shape[1], w, h)
    else:
        sse = None
        src_args = (0, 0, 0, 0)
    KC.launch("lpf_ladder", buf.data_ptr(), Hb, Wb, split16.data_ptr(), R2,
              C2, cands.data_ptr(), L, cell, int(luma), nl_v, kv, nl_h, kh,
              *src_args, outs.data_ptr(),
              0 if sse is None else sse.data_ptr(),
              device=buf.get_device(), variant="luma" if luma else "chroma")
    return outs, sse


def lpf_pick_and_filter(planes, srcs, split16, cands, *, w: int, h: int,
                        nplanes: int):
    """Device LPF ladder (av1_pick_filter_level analogue) + apply.

    planes/srcs: int32 tensors (pre-LPF recon, source), luma first;
    split16 (2R, 2C) bool; cands (L,) int32 candidate levels (0 among
    them). Each plane picks its own level by exact squared error over the
    cropped frame (first-best on ties); chroma levels are zeroed when luma
    picks 0. Returns (levels (3,) int32 tensor, filtered planes tuple)."""
    def eval_plane(buf, src, pw, ph, cell, luma):
        outs, sse = lpf_ladder(buf, split16, cands, src, pw, ph, cell, luma)
        # the pick stays on the device: indexing with a tensor index would
        # read it to the host first
        best = torch.argmin(sse).view(1)
        return cands.index_select(0, best)[0], outs.index_select(0, best)[0]

    lvl_y, out_y = eval_plane(planes[0], srcs[0], w, h, 16, True)
    levels, outs = [lvl_y], [out_y]
    if nplanes > 1:
        cw, ch = (w + 1) // 2, (h + 1) // 2
        for p in (1, 2):
            lvl, out = eval_plane(planes[p], srcs[p], cw, ch, 8, False)
            levels.append(torch.where(lvl_y > 0, lvl, torch.zeros_like(lvl)))
            outs.append(torch.where(lvl_y > 0, out, planes[p]))
    else:
        levels += [torch.zeros_like(lvl_y)] * 2
    return torch.stack(levels), tuple(outs)


def lpf_apply(planes, split16, levels, *, w: int, h: int, nplanes: int):
    """Apply given (3,) int32 levels to the plane tuple (no search)."""
    out = [lpf_ladder(planes[0], split16, levels[0:1], None, w, h, 16,
                      True)[0][0]]
    if nplanes > 1:
        cw, ch = (w + 1) // 2, (h + 1) // 2
        for p in (1, 2):
            out.append(lpf_ladder(planes[p], split16, levels[p:p + 1], None,
                                  cw, ch, 8, False)[0][0])
    return tuple(out)
