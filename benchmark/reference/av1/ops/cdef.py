"""CDEF — constrained directional enhancement filter (normative).

Reimplements ``av1/common/cdef.c`` + ``cdef_block.c`` as batched array code.
Key simplification with identical results: every CDEF tap reads *pre-CDEF*
(post-deblock) pixels — the reference's line/column buffers exist only to
preserve them — so the whole frame filters as a pure function of one padded
pre-CDEF copy, fully parallel over 8x8 blocks.
"""
from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x4000
PRI_TAPS = ((4, 2), (3, 3))
SEC_TAPS = (2, 1)

# (dy, dx) tap offsets per direction, two rings (cdef_block.c:25-47)
DIRS = np.array([
    [(-1, 1), (-2, 2)],
    [(0, 1), (-1, 2)],
    [(0, 1), (0, 2)],
    [(0, 1), (1, 2)],
    [(1, 1), (2, 2)],
    [(1, 0), (2, 1)],
    [(1, 0), (2, 0)],
    [(1, 0), (2, -1)],
], np.int32)


def _msb(v: np.ndarray | int):
    return np.maximum(np.int32(np.log2(np.maximum(v, 1))), 0).astype(np.int32)


def find_dir_blocks(blocks: np.ndarray, coeff_shift: int = 0):
    """Direction + variance per 8x8 block, vectorized (cdef_find_dir_c).

    blocks: (N, 8, 8) int array. Returns (dir (N,), var (N,))."""
    n = blocks.shape[0]
    x = (blocks >> coeff_shift).astype(np.int64) - 128
    partial = np.zeros((8, n, 15), np.int64)
    ii, jj = np.mgrid[0:8, 0:8]
    lines = [ii + jj, ii + jj // 2, ii, 3 + ii - jj // 2, 7 + ii - jj,
             3 - ii // 2 + jj, jj, ii // 2 + jj]
    for d in range(8):
        idx = lines[d]
        for i in range(8):
            for j in range(8):
                partial[d, :, idx[i, j]] += x[:, i, j]
    div = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)
    cost = np.zeros((8, n), np.int64)
    cost[2] = (partial[2, :, :8] ** 2).sum(1) * div[8]
    cost[6] = (partial[6, :, :8] ** 2).sum(1) * div[8]
    for i in range(7):
        cost[0] += (partial[0, :, i] ** 2 + partial[0, :, 14 - i] ** 2) * div[i + 1]
        cost[4] += (partial[4, :, i] ** 2 + partial[4, :, 14 - i] ** 2) * div[i + 1]
    cost[0] += partial[0, :, 7] ** 2 * div[8]
    cost[4] += partial[4, :, 7] ** 2 * div[8]
    for i in range(1, 8, 2):
        cost[i] += (partial[i, :, 3:8] ** 2).sum(1) * div[8]
        for j in range(3):
            cost[i] += (partial[i, :, j] ** 2
                        + partial[i, :, 10 - j] ** 2) * div[2 * j + 2]
    best_dir = np.argmax(cost, axis=0).astype(np.int32)
    best_cost = np.take_along_axis(cost, best_dir[None], 0)[0]
    ortho = np.take_along_axis(cost, ((best_dir + 4) & 7)[None], 0)[0]
    var = ((best_cost - ortho) >> 10).astype(np.int64)
    return best_dir, var


def _constrain(diff, threshold, damping):
    if threshold == 0:
        return np.zeros_like(diff)
    shift = max(0, damping - int(threshold).bit_length() + 1)
    a = np.abs(diff)
    return np.sign(diff) * np.minimum(a, np.maximum(0, threshold - (a >> shift)))


def filter_blocks(ctx: np.ndarray, dirs: np.ndarray, pri_t: np.ndarray,
                  sec_t: int, pri_damping: int, sec_damping: int,
                  coeff_shift: int, bh: int, bw: int) -> np.ndarray:
    """Filter N blocks. ctx: (N, bh+4, bw+4) int32 with 2px borders
    (CDEF_VERY_LARGE where unavailable); dirs/pri_t per block.
    Returns filtered (N, bh, bw)."""
    n = ctx.shape[0]
    x = ctx[:, 2 : 2 + bh, 2 : 2 + bw]
    total = np.zeros((n, bh, bw), np.int32)
    mx = x.copy()
    mn = x.copy()
    rows = 2 + np.arange(bh)[None, :, None]
    cols = 2 + np.arange(bw)[None, None, :]
    bidx = np.arange(n)[:, None, None]

    # primary taps: constrain threshold is per-block -> loop over distinct
    pri_groups = {}
    for i, t in enumerate(pri_t):
        pri_groups.setdefault(int(t), []).append(i)

    for k in range(2):
        d = DIRS[dirs][:, k]  # (N, 2)
        dy = d[:, 0][:, None, None]
        dx = d[:, 1][:, None, None]
        for sign in (1, -1):
            p = ctx[bidx, rows + sign * dy, cols + sign * dx]
            valid = p != CDEF_VERY_LARGE
            mx = np.where(valid, np.maximum(p, mx), mx)
            mn = np.minimum(p, mn)
            for t, members in pri_groups.items():
                if t == 0:
                    continue
                tap = PRI_TAPS[(t >> coeff_shift) & 1][k]
                m = np.zeros(n, bool)
                m[members] = True
                contrib = tap * _constrain(p - x, t, pri_damping)
                total += np.where(m[:, None, None], contrib, 0)
        # secondary taps at dir+2 / dir-2
        for ddir in (2, -2):
            d2 = DIRS[(dirs + ddir) & 7][:, k]
            dy2 = d2[:, 0][:, None, None]
            dx2 = d2[:, 1][:, None, None]
            for sign in (1, -1):
                s = ctx[bidx, rows + sign * dy2, cols + sign * dx2]
                valid = s != CDEF_VERY_LARGE
                mx = np.where(valid, np.maximum(s, mx), mx)
                mn = np.minimum(s, mn)
                if sec_t:
                    total += SEC_TAPS[k] * _constrain(s - x, sec_t, sec_damping)

    y = x + ((8 + total - (total < 0)) >> 4)
    # clipping applies when both primary and secondary paths are enabled;
    # per-block pri_t==0 disables primary -> no clip per reference dispatch
    clip = (pri_t != 0)[:, None, None] & (sec_t != 0)
    y = np.where(clip, np.clip(y, mn, mx), y)
    # when pri_t==0 and sec==0 the block is untouched
    untouched = (pri_t == 0)[:, None, None] & (sec_t == 0)
    return np.where(untouched, x, y)


def cdef_frame(planes, mi_skip, unit_strength, fh, seq, mi_rows, mi_cols):
    """Apply CDEF in place. planes: list of int32 (mi-aligned). mi_skip:
    (mi_rows, mi_cols) skip flags. unit_strength: per-64x64 strength index
    grid (-1 = not coded)."""
    c = fh.cdef
    nplanes = len(planes)
    damping = c.damping
    coeff_shift = 0  # 8-bit
    nvfb = (mi_rows + 15) // 16
    nhfb = (mi_cols + 15) // 16

    # context is the mi-aligned recon area; CDEF_VERY_LARGE strictly beyond
    # it (cdef_prepare_fb fill_rect at frame boundaries) — plane buffers
    # may be larger than the mi area, so crop first
    pre = []
    padded = []
    for p_i, p in enumerate(planes):
        sx = seq.subsampling_x if p_i else 0
        sy = seq.subsampling_y if p_i else 0
        mh = (mi_rows * 4) >> sy
        mw = (mi_cols * 4) >> sx
        cp = np.array(p[:mh, :mw], np.int32)
        pre.append(cp)
        pad = np.full((mh + 4, mw + 4), CDEF_VERY_LARGE, np.int32)
        pad[2 : 2 + mh, 2 : 2 + mw] = cp
        padded.append(pad)

    for fbr in range(nvfb):
        for fbc in range(nhfb):
            sidx = int(unit_strength[fbr, fbc])
            if sidx < 0:
                continue
            y_str = c.y_pri[sidx] * 4 + c.y_sec[sidx]
            uv_str = (c.uv_pri[sidx] * 4 + c.uv_sec[sidx]) if nplanes > 1 else 0
            lvl = [y_str // 4, uv_str // 4]
            sec = [y_str % 4, uv_str % 4]
            sec = [s + (s == 3) for s in sec]
            if lvl[0] == 0 and sec[0] == 0 and lvl[1] == 0 and sec[1] == 0:
                continue
            # non-skip 8x8 blocks in this 64x64 unit
            maxr = min(16, mi_rows - fbr * 16)
            maxc = min(16, mi_cols - fbc * 16)
            dlist = []
            for r in range(0, maxr, 2):
                for cc in range(0, maxc, 2):
                    sk = mi_skip[fbr * 16 + r : fbr * 16 + r + 2,
                                 fbc * 16 + cc : fbc * 16 + cc + 2]
                    if not sk.all():
                        dlist.append((r >> 1, cc >> 1))
            if not dlist:
                continue
            dl = np.array(dlist, np.int32)

            # luma directions (always computed from luma)
            ly0 = fbr * 64
            lx0 = fbc * 64
            yblocks = np.stack([
                pre[0][ly0 + 8 * by : ly0 + 8 * by + 8,
                       lx0 + 8 * bx : lx0 + 8 * bx + 8]
                for by, bx in dlist])
            dirs, var = find_dir_blocks(yblocks, coeff_shift)

            for plane in range(nplanes):
                pt = 1 if plane else 0
                if plane and lvl[1] == 0 and sec[1] == 0:
                    continue
                if plane == 0 and lvl[0] == 0 and sec[0] == 0:
                    continue
                sx = seq.subsampling_x if plane else 0
                sy = seq.subsampling_y if plane else 0
                bw = 8 >> sx
                bh = 8 >> sy
                pri_strength = lvl[pt] << coeff_shift
                sec_strength = sec[pt] << coeff_shift
                dmp = damping + coeff_shift - (1 if plane else 0)
                p_dirs = dirs
                if plane and sx != sy:
                    conv = ([7, 0, 2, 4, 5, 6, 6, 6] if sx
                            else [1, 2, 2, 2, 3, 4, 6, 0])
                    p_dirs = np.array([conv[d] for d in dirs], np.int32)
                if plane == 0:
                    pri_t = np.array([_adjust_strength(pri_strength, v)
                                      for v in var], np.int32)
                else:
                    pri_t = np.full(len(dlist), pri_strength, np.int32)
                use_dirs = np.where(pri_strength != 0, p_dirs, 0)

                pad = padded[plane]
                py0 = (ly0 >> sy)
                px0 = (lx0 >> sx)
                ctx = np.stack([
                    pad[py0 + bh * by : py0 + bh * by + bh + 4,
                        px0 + bw * bx : px0 + bw * bx + bw + 4]
                    for by, bx in dlist]).astype(np.int32)
                out = filter_blocks(ctx, use_dirs, pri_t, sec_strength, dmp,
                                    dmp, coeff_shift, bh, bw)
                dst = planes[plane]
                for i, (by, bx) in enumerate(dlist):
                    dst[py0 + bh * by : py0 + bh * by + bh,
                        px0 + bw * bx : px0 + bw * bx + bw] = out[i]


def _adjust_strength(strength: int, var: int) -> int:
    if not var:
        return 0
    i = min(int(var >> 6).bit_length() - 1, 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


def _adjust_strength_v(strength: int, var: np.ndarray) -> np.ndarray:
    """Vectorized _adjust_strength over a (N,) var array."""
    v6 = (var >> 6).astype(np.float64)
    _, e = np.frexp(np.maximum(v6, 1.0))
    i = np.minimum(e - 1, 12).astype(np.int64)
    i = np.where(v6 > 0, i, 0)
    t = (strength * (4 + i) + 8) >> 4
    return np.where(var != 0, t, 0).astype(np.int32)


def _unit_stack(plane: np.ndarray, bl: np.ndarray, ub: int) -> np.ndarray:
    """(N, ub+4, ub+4) CDEF contexts for the ``ub``-sized units listed in
    ``bl`` (unit coords), with CDEF_VERY_LARGE outside the plane area."""
    h, w = plane.shape
    pad = np.full((h + 4, w + 4), CDEF_VERY_LARGE, np.int32)
    pad[2 : 2 + h, 2 : 2 + w] = plane
    win = np.lib.stride_tricks.sliding_window_view(pad, (ub + 4, ub + 4))
    return np.ascontiguousarray(win[bl[:, 0] * ub, bl[:, 1] * ub])


def search_strengths(planes, srcp, mi_skip, mi_rows, mi_cols, damping,
                     pri_cands=(0, 1, 2, 3, 4, 6, 9, 12, 15),
                     sec_cands=(0, 1, 2, 4)):
    """Frame-level (cdef_bits=0) strength search, whole frame at once.

    The reference searches per-64x64 fb with SIMD MSE accumulation
    (av1/encoder/pickcdef.c); here every non-skip 8x8 unit of the frame is
    one row of a single block stack, directions are computed once, and each
    (pri, sec) candidate is one vectorized ``filter_blocks`` call — the
    TPU-era expression of the same brute force.  ``planes`` is the
    post-deblock recon (mi-aligned int32), ``srcp`` the source planes.
    Returns applied strengths (y_pri, y_sec, uv_pri, uv_sec); the caller
    codes sec as min(sec, 3) per the spec's 4->3 mapping.
    """
    nplanes = len(planes)
    nvb, nhb = mi_rows // 2, mi_cols // 2
    sk = mi_skip[: nvb * 2, : nhb * 2].reshape(nvb, 2, nhb, 2)
    nonskip = ~sk.all(axis=(1, 3)).astype(bool)
    bl = np.argwhere(nonskip).astype(np.int32)
    if bl.size == 0:
        return 0, 0, 0, 0

    mh, mw = mi_rows * 4, mi_cols * 4
    y = np.ascontiguousarray(planes[0][:mh, :mw], np.int32)
    ctx_y = _unit_stack(y, bl, 8)
    dirs, var = find_dir_blocks(ctx_y[:, 2:10, 2:10])
    src_y = srcp[0][:mh, :mw].reshape(nvb, 8, nhb, 8).transpose(0, 2, 1, 3)
    src_y = src_y[bl[:, 0], bl[:, 1]].astype(np.int64)

    def sweep(ctx_list, src_list, dmp, adjust):
        best = None
        for pri in pri_cands:
            if adjust:
                pri_t = _adjust_strength_v(pri, var)
            else:
                pri_t = np.full(len(bl), pri, np.int32)
            use_dirs = dirs if pri else np.zeros_like(dirs)
            for sec in sec_cands:
                e = 0
                for ctx, src in zip(ctx_list, src_list):
                    ub = ctx.shape[1] - 4
                    out = filter_blocks(ctx, use_dirs, pri_t, sec, dmp,
                                        dmp, 0, ub, ub)
                    e += int(((out.astype(np.int64) - src) ** 2).sum())
                if best is None or e < best[0]:
                    best = (e, pri, sec)
        return best[1], best[2]

    y_pri, y_sec = sweep([ctx_y], [src_y], damping, adjust=True)
    uv_pri = uv_sec = 0
    if nplanes > 1:
        ch, cw = mh // 2, mw // 2
        ctx_uv, src_uv = [], []
        for p in (1, 2):
            cp = np.ascontiguousarray(planes[p][:ch, :cw], np.int32)
            ctx_uv.append(_unit_stack(cp, bl, 4))
            s = srcp[p][:ch, :cw].reshape(nvb, 4, nhb, 4).transpose(0, 2, 1, 3)
            src_uv.append(s[bl[:, 0], bl[:, 1]].astype(np.int64))
        uv_pri, uv_sec = sweep(ctx_uv, src_uv, damping - 1, adjust=False)
    return y_pri, y_sec, uv_pri, uv_sec
