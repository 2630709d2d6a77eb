"""AV1 deblocking loop filter — normative, vectorized.

Reimplements ``av1/common/av1_loopfilter.c`` (edge parameter derivation,
set_lpf_parameters :223) and the ``aom_dsp/loopfilter.c`` kernels as
row-vectorized passes: all rows of a boundary column filter at once; the
boundary columns run left→right (the spec defines vertical-edge filtering
sequentially, later edges read earlier results). Horizontal edges likewise
top→bottom after all vertical edges.
"""
from __future__ import annotations

import numpy as np

MAX_LOOP_FILTER = 63


def _limits(level: int, sharpness: int) -> tuple[int, int, int]:
    """(blimit, limit, thresh) per update_sharpness / av1_loop_filter_init."""
    lim = level >> ((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        lim = min(lim, 9 - sharpness)
    lim = max(lim, 1)
    blimit = 2 * (level + 2) + lim
    thresh = level >> 4
    return blimit, lim, thresh


def _filter4(p1, p0, q0, q1, mask, thresh):
    """filter4 on int32 arrays; returns new (p1, p0, q0, q1)."""
    clamp = lambda v: np.clip(v, -128, 127)
    ps1, ps0 = p1 - 128, p0 - 128
    qs0, qs1 = q0 - 128, q1 - 128
    hev = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)
    f = clamp(ps1 - qs1) * hev
    f = clamp(f + 3 * (qs0 - ps0)) * mask
    f1 = clamp(f + 4) >> 3
    f2 = clamp(f + 3) >> 3
    oq0 = clamp(qs0 - f1) + 128
    op0 = clamp(ps0 + f2) + 128
    f = ((f1 + 1) >> 1) * ~hev
    oq1 = clamp(qs1 - f) + 128
    op1 = clamp(ps1 + f) + 128
    return op1, op0, oq0, oq1


def _r3(v):
    return (v + 4) >> 3


def _r4(v):
    return (v + 8) >> 4


def _filter_edge(px, length, blimit, limit, thresh):
    """Filter one boundary for a batch of lines.

    px: (N, 14) int32 — samples p6..p0,q0..q6 per line (unused taps may be
    anything for shorter lengths). length: (N,) in {0,4,6,8,14}.
    Returns new (N, 14).
    """
    p = [px[:, 6 - i] for i in range(7)]  # p0..p6
    q = [px[:, 7 + i] for i in range(7)]  # q0..q6
    ab = lambda a, b: np.abs(a - b)

    # masks per length
    fm2 = ~((ab(p[1], p[0]) > limit) | (ab(q[1], q[0]) > limit)
            | (ab(p[0], q[0]) * 2 + ab(p[1], q[1]) // 2 > blimit))
    fm3 = fm2 & ~((ab(p[2], p[1]) > limit) | (ab(q[2], q[1]) > limit))
    fm4 = fm3 & ~((ab(p[3], p[2]) > limit) | (ab(q[3], q[2]) > limit))
    flat3 = ~((ab(p[1], p[0]) > 1) | (ab(q[1], q[0]) > 1)
              | (ab(p[2], p[0]) > 1) | (ab(q[2], q[0]) > 1))
    flat4 = flat3 & ~((ab(p[3], p[0]) > 1) | (ab(q[3], q[0]) > 1))
    flat2 = ~((ab(p[1], p[0]) > 1) | (ab(q[1], q[0]) > 1)
              | (ab(p[4], p[0]) > 1) | (ab(q[4], q[0]) > 1)
              | (ab(p[5], p[0]) > 1) | (ab(q[5], q[0]) > 1)
              | (ab(p[6], p[0]) > 1) | (ab(q[6], q[0]) > 1))

    mask = np.where(length == 4, fm2, np.where(length == 6, fm3, fm4))
    n4p1, n4p0, n4q0, n4q1 = _filter4(p[1], p[0], q[0], q[1], mask, thresh)

    out = px.copy()

    # narrow (filter4 result) applies where not (flat && long enough)
    wide6 = (length == 6) & flat3 & mask
    wide8 = (length >= 8) & flat4 & mask
    wide14 = (length == 14) & flat4 & flat2 & mask
    narrow = (length >= 4) & ~wide6 & ~wide8

    for idx, v in ((5, n4p1), (6, n4p0), (7, n4q0), (8, n4q1)):
        out[:, idx] = np.where(narrow, v, out[:, idx])

    # filter6 (5-tap)
    w = wide6
    o1 = _r3(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0])
    o0 = _r3(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1])
    u0 = _r3(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2])
    u1 = _r3(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3)
    for idx, v in ((5, o1), (6, o0), (7, u0), (8, u1)):
        out[:, idx] = np.where(w, v, out[:, idx])

    # filter8 (7-tap) where wide8 but not wide14
    w = wide8 & ~wide14
    o2 = _r3(p[3] * 3 + 2 * p[2] + p[1] + p[0] + q[0])
    o1 = _r3(p[3] * 2 + p[2] + 2 * p[1] + p[0] + q[0] + q[1])
    o0 = _r3(p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2])
    u0 = _r3(p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3])
    u1 = _r3(p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] * 2)
    u2 = _r3(p[0] + q[0] + q[1] + 2 * q[2] + q[3] * 3)
    for idx, v in ((4, o2), (5, o1), (6, o0), (7, u0), (8, u1), (9, u2)):
        out[:, idx] = np.where(w, v, out[:, idx])

    # filter14 (13-tap)
    w = wide14
    o5 = _r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0] + q[0])
    o4 = _r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] + p[0]
             + q[0] + q[1])
    o3 = _r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] + p[0]
             + q[0] + q[1] + q[2])
    o2 = _r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 + p[0]
             + q[0] + q[1] + q[2] + q[3])
    o1 = _r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 + p[0] * 2
             + q[0] + q[1] + q[2] + q[3] + q[4])
    o0 = _r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2
             + q[1] + q[2] + q[3] + q[4] + q[5])
    u0 = _r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2
             + q[2] + q[3] + q[4] + q[5] + q[6])
    u1 = _r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2 + q[2] * 2
             + q[3] + q[4] + q[5] + q[6] * 2)
    u2 = _r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2 + q[3] * 2
             + q[4] + q[5] + q[6] * 3)
    u3 = _r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2 + q[4] * 2
             + q[5] + q[6] * 4)
    u4 = _r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2 + q[5] * 2
             + q[6] * 5)
    u5 = _r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2 + q[6] * 7)
    for idx, v in ((1, o5), (2, o4), (3, o3), (4, o2), (5, o1), (6, o0),
                   (7, u0), (8, u1), (9, u2), (10, u3), (11, u4), (12, u5)):
        out[:, idx] = np.where(w, v, out[:, idx])
    return out


# mode_lf_lut (av1_loopfilter.c:41): 0 for intra + NEAREST/NEAR/GLOBAL(MV),
# 1 for NEW-containing modes
MODE_LF_LUT = np.array([0] * 13 + [1, 1, 0, 1] + [1, 1, 1, 1, 1, 1, 0, 1],
                       np.int32)


class DeblockInfo:
    """Per-frame MI-grid info the filter needs (from the decoder/encoder).

    ``mi_ref0``/``mi_mode``/``mi_borigin_r``/``mi_borigin_c`` enable the
    per-block filter-level derivation (av1_get_filter_level with ref/mode
    deltas) and the prediction-edge / skip rules needed for inter frames;
    when omitted the frame is treated as all-intra with block edges only at
    tx boundaries (the behavior conformance-proven on intra streams)."""

    def __init__(self, mi_tx_size_y, mi_bsize, mi_skip, mi_is_inter,
                 mi_rows, mi_cols, mi_ref0=None, mi_mode=None,
                 mi_borigin_r=None, mi_borigin_c=None):
        self.tx_y = mi_tx_size_y
        self.bsize = mi_bsize
        self.skip = mi_skip
        self.is_inter = mi_is_inter
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.ref0 = mi_ref0
        self.mode = mi_mode
        self.borigin_r = mi_borigin_r
        self.borigin_c = mi_borigin_c


def loop_filter_plane(buf, plane, info: DeblockInfo, fh, seq,
                      uv_tx_grid=None) -> None:
    """Filter one plane in place (int32 array, plane dims)."""
    from ..normative.enums import TX_WIDTH, TX_HEIGHT
    if plane == 0:
        lvl_v, lvl_h = fh.lf.filter_level
        if lvl_v == 0 and lvl_h == 0:
            return
    elif plane == 1:
        lvl_v = lvl_h = fh.lf.filter_level_u
    else:
        lvl_v = lvl_h = fh.lf.filter_level_v
    if lvl_v == 0 and lvl_h == 0:
        return
    sx = seq.subsampling_x if plane else 0
    sy = seq.subsampling_y if plane else 0
    h, w = buf.shape
    # crop to真 frame dims
    w = (fh.width + sx) >> sx
    h = (fh.height + sy) >> sy

    # per-4x4 (plane units) grids of tx dims and block dims, in pixels
    n4r = (h + 3) // 4
    n4c = (w + 3) // 4
    r4 = np.arange(n4r)
    c4 = np.arange(n4c)
    mi_r = (sy | ((r4 * 4) << sy) // 4)[:, None] * np.ones(n4c, np.int32)[None, :]
    mi_c = (sx | ((c4 * 4) << sx) // 4)[None, :] * np.ones(n4r, np.int32)[:, None]
    mi_r = np.minimum(mi_r.astype(np.int32), info.mi_rows - 1)
    mi_c = np.minimum(mi_c.astype(np.int32), info.mi_cols - 1)
    if plane == 0:
        ts = info.tx_y[mi_r, mi_c]
    else:
        ts = uv_tx_grid[mi_r, mi_c]
    txw = TX_WIDTH[ts]
    txh = TX_HEIGHT[ts]
    from ..normative.enums import BLOCK_WIDTH, BLOCK_HEIGHT
    from ..normative.blocks import get_plane_block_size
    bs = info.bsize[mi_r, mi_c]
    pbs = np.empty_like(bs)
    # plane block size per entry (vectorize via lookup table)
    lut = np.array([get_plane_block_size(b, sx, sy) for b in range(22)],
                   np.int32)
    pbs = lut[bs]
    pbw = BLOCK_WIDTH[pbs]
    pbh = BLOCK_HEIGHT[pbs]
    # per-4x4 filter levels (av1_get_filter_level, av1_loopfilter.c:68):
    # base + ref_deltas[ref0]*scale (+ mode_deltas[mode_lf_lut[mode]]*scale
    # for inter blocks), clamped to [0, 63]
    if info.ref0 is not None:
        ref0 = info.ref0[mi_r, mi_c]
        mode = info.mode[mi_r, mi_c]
    else:
        ref0 = np.zeros_like(mi_r)
        mode = np.zeros_like(mi_r)

    def level_grid(base):
        if not fh.lf.delta_enabled:
            return np.full(mi_r.shape, base, np.int32)
        scale = 1 << (base >> 5)
        ref_d = np.asarray(fh.lf.ref_deltas, np.int32)[ref0]
        mode_d = np.asarray(fh.lf.mode_deltas, np.int32)[MODE_LF_LUT[mode]]
        lvl = base + ref_d * scale + np.where(ref0 > 0, mode_d * scale, 0)
        return np.clip(lvl, 0, MAX_LOOP_FILTER).astype(np.int32)

    lvl_grid_v = level_grid(lvl_v)
    lvl_grid_h = level_grid(lvl_h)
    skip_inter = (info.skip[mi_r, mi_c] & info.is_inter[mi_r, mi_c]) \
        if info.ref0 is not None else np.zeros_like(mi_r)
    if info.borigin_r is not None:
        bor_r = info.borigin_r[mi_r, mi_c]
        bor_c = info.borigin_c[mi_r, mi_c]
    else:
        bor_r = bor_c = None

    buf_h, buf_w = buf.shape

    # C evaluates edges by WALKING each line in steps of the tx size at the
    # current position (av1_filter_block_plane_vert/horz: advance_units =
    # tx_size_wide_unit[ts]).  When a chroma tx origin is misaligned with
    # its own size (sub-sampled origin of an odd-mi luma block), the walk
    # skips real tx boundaries — those edges are normatively NOT filtered.
    # Only walk-visited positions whose coord is size-aligned get filtered.
    def _walk_visited(sizes_u, chunk):
        """sizes_u: (lines, n) tx size in 4px units along the walk axis.
        The walk restarts every `chunk` groups — C calls the per-plane
        filter once per MAX_MIB_SIZE=32-MI block (thread_common.c:267),
        so a desynced walk resets at each 128-px (luma) chunk."""
        lines, n = sizes_u.shape
        vis = np.zeros((lines, n), bool)
        for r in range(lines):
            row = sizes_u[r]
            for c0 in range(0, n, chunk):
                x = c0
                lim = min(c0 + chunk, n)
                while x < lim:
                    vis[r, x] = True
                    x += max(int(row[x]), 1)
        return vis

    chunk_x = (128 >> sx) // 4
    chunk_y = (128 >> sy) // 4
    visited_v = _walk_visited(txw // 4, chunk_x)        # per row walk
    visited_h = _walk_visited((txh // 4).T, chunk_y).T  # per-column walk

    sharp = fh.lf.sharpness

    def _limits_vec(level):
        lim = level >> ((sharp > 0) + (sharp > 4))
        if sharp > 0:
            lim = np.minimum(lim, 9 - sharp)
        lim = np.maximum(lim, 1)
        return 2 * (level + 2) + lim, lim, level >> 4

    def do_edge(direction, b, r0, r1):
        """Filter the boundary at 4*b for perpendicular lines [r0*4, r1*4)."""
        coord = b * 4
        if direction == 0:
            tu_edge = ((coord % np.maximum(txw[r0:r1, b], 1)) == 0) \
                & visited_v[r0:r1, b]
            cur_u = txw[r0:r1, b] // 4
            pv_u = txw[r0:r1, b - 1] // 4
            lvl_c = lvl_grid_v[r0:r1, b]
            lvl_p = lvl_grid_v[r0:r1, b - 1]
            sk = skip_inter[r0:r1, b]
            if bor_r is not None:
                pu_edge = ((bor_r[r0:r1, b] != bor_r[r0:r1, b - 1])
                           | (bor_c[r0:r1, b] != bor_c[r0:r1, b - 1]))
            else:
                pu_edge = np.ones(r1 - r0, bool)
        else:
            tu_edge = ((coord % np.maximum(txh[b, r0:r1], 1)) == 0) \
                & visited_h[b, r0:r1]
            cur_u = txh[b, r0:r1] // 4
            pv_u = txh[b - 1, r0:r1] // 4
            lvl_c = lvl_grid_h[b, r0:r1]
            lvl_p = lvl_grid_h[b - 1, r0:r1]
            sk = skip_inter[b, r0:r1]
            if bor_r is not None:
                pu_edge = ((bor_r[b, r0:r1] != bor_r[b - 1, r0:r1])
                           | (bor_c[b, r0:r1] != bor_c[b - 1, r0:r1]))
            else:
                pu_edge = np.ones(r1 - r0, bool)
        if not tu_edge.any():
            return
        # level falls back to the neighbor's when the current block's is 0
        level = np.where(lvl_c > 0, lvl_c, lvl_p)
        edge_on = tu_edge & (level > 0) & (pu_edge | (sk == 0))
        if not edge_on.any():
            return
        dim_log2 = np.log2(np.maximum(np.minimum(cur_u, pv_u), 1)).astype(
            np.int32)
        if plane == 0:
            length = np.where(dim_log2 == 0, 4, np.where(dim_log2 == 1, 8, 14))
        else:
            length = np.where(dim_log2 == 0, 4, 6)
        length = np.where(edge_on, length, 0)
        # filter whole 4-line groups: lines may extend past the cropped frame
        # into the mi-aligned buffer (the C kernels always do 4 lines)
        p0 = r0 * 4
        buf_lines = buf.shape[0] if direction == 0 else buf.shape[1]
        nl = min((r1 - r0) * 4, buf_lines - p0)
        ll = np.repeat(length, 4)[:nl]
        if not ll.any():
            return
        blimit, limit, thresh = _limits_vec(np.repeat(level, 4)[:nl])
        lo = max(coord - 7, 0)
        hi = min(coord + 7, buf_w if direction == 0 else buf_h)
        seg = np.zeros((nl, 14), np.int32)
        if direction == 0:
            seg[:, 7 - (coord - lo) : 7 + (hi - coord)] = \
                buf[p0 : p0 + nl, lo:hi]
            out = _filter_edge(seg, ll, blimit, limit, thresh)
            buf[p0 : p0 + nl, lo:hi] = out[:, 7 - (coord - lo) : 7 + (hi - coord)]
        else:
            seg[:, 7 - (coord - lo) : 7 + (hi - coord)] = \
                buf[lo:hi, p0 : p0 + nl].T
            out = _filter_edge(seg, ll, blimit, limit, thresh)
            buf[lo:hi, p0 : p0 + nl] = \
                out[:, 7 - (coord - lo) : 7 + (hi - coord)].T

    # band-interleaved order (thread_common.c loop_filter_rows): per
    # MAX_MIB_SIZE=32-MI (128-px luma) row band, all vertical edges then all
    # horizontal edges
    band_rows = 128 >> sy  # plane px per band
    band_n4 = band_rows // 4
    any_v = bool(lvl_grid_v.max()) if fh.lf.delta_enabled else lvl_v > 0
    any_h = bool(lvl_grid_h.max()) if fh.lf.delta_enabled else lvl_h > 0
    for band in range(0, n4r, band_n4):
        band_end = min(band + band_n4, n4r)
        if any_v:
            for b in range(1, n4c):
                do_edge(0, b, band, band_end)
        if any_h:
            for b in range(max(band, 1), band_end):
                do_edge(1, b, 0, n4c)
