"""Motion search — TPU-native dense grid scan + subpel refinement.

The reference's motion search (av1/encoder/mcomp.c) walks sequential
diamond/hex/NSTEP patterns with early exits — a latency-bound scalar
program. On TPU we invert the structure: evaluate EVERY candidate in a
(2R+1)^2 full-pel window for a whole batch of blocks at once as one
dense SAD tensor contraction (MXU/VPU-friendly, no data-dependent
control flow), then argmin. Subpel refinement evaluates all 8 half/
quarter-pel neighbours in one shot through the normative convolve
kernels (ops/convolve.py) instead of iterative FIRST_LEVEL/SECOND_LEVEL
checks (mcomp.c:av1_find_best_sub_pixel_tree).

Cost model mirrors av1_mv_bit_cost (mcomp.c:96): mvcost[] lookups are
replaced round-1 by the standard log2-based approximation
``mv_err_cost`` with sad_per_bit weighting (mvsad_err_cost analogue).
"""
from __future__ import annotations

import functools

import numpy as np

from . import convolve as C


def _xp(x):
    """numpy, the only array type of the host kernels."""
    if isinstance(x, np.ndarray):
        return np
    raise TypeError(f"numpy array expected, got {type(x).__name__}")


# ---------------------------------------------------------------------------
# Full-pel dense grid search
# ---------------------------------------------------------------------------

def mv_cost_bits(dr, dc, weight: int = 0):
    """Approximate rate cost of an MV residual, in SAD-comparable units
    (analogue of mvsad_err_cost, mcomp.c:115: the exact table-driven
    cost is joint-class + component bits; round-1 uses the dominant
    magnitude term 2*log2(1+|d|) bits per component)."""
    xp = _xp(dr) if not isinstance(dr, (int, float)) else np
    bits = 2.0 * (xp.log2(1.0 + xp.abs(dr)) + xp.log2(1.0 + xp.abs(dc)))
    return (bits * weight).astype(xp.int32) if weight else \
        xp.zeros_like(bits, dtype=xp.int32)


def full_pel_grid_search(src_blocks, ref_windows, radius: int,
                         sad_per_bit: int = 0):
    """Exhaustive full-pel search over a square window, batched.

    src_blocks:  (B, h, w) source blocks.
    ref_windows: (B, h + 2*radius, w + 2*radius) reference windows whose
                 center (radius, radius) is the zero-MV position.
    Returns (mvs, best_sad): mvs (B, 2) int32 as (row, col) offsets in
    [-radius, radius], best_sad (B,) int32.

    Replaces av1_full_pixel_search / exhaustive_mesh_search
    (mcomp.c:2015): a mesh search with step 1, evaluated as one dense
    tensor op instead of nested scalar loops.
    """
    xp = _xp(src_blocks)
    B, h, w = src_blocks.shape
    n = 2 * radius + 1
    src = src_blocks.astype(xp.int32)[:, None, None]          # (B,1,1,h,w)

    # Gather all candidate windows: (B, n, n, h, w) as strided views.
    from numpy.lib.stride_tricks import sliding_window_view
    rw = ref_windows.astype(xp.int32)
    cand = sliding_window_view(rw, (h, w), axis=(1, 2))       # (B,n,n,h,w)

    sad = xp.abs(cand - src).sum(axis=(-1, -2))               # (B, n, n)
    if sad_per_bit:
        dr = xp.arange(n) - radius
        cost = mv_cost_bits(dr[:, None].astype(xp.float32),
                            dr[None, :].astype(xp.float32), sad_per_bit)
        sad = sad + cost[None]
    flat = sad.reshape(B, n * n)
    best = xp.argmin(flat, axis=1)
    best_sad = xp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    mvs = xp.stack([best // n - radius, best % n - radius], axis=1)
    return mvs.astype(xp.int32), best_sad.astype(xp.int32)


def full_pel_hierarchical(src_blocks, ref_windows, radius: int,
                          step: int = 4, sad_per_bit: int = 0):
    """Two-level grid search for big windows: coarse grid at `step`,
    then a dense refine of +/-(step-1) around the coarse winner.
    Keeps the candidate tensor small while covering the full window
    (the TPU equivalent of NSTEP's shrinking diamonds, mcomp.c:1672)."""
    xp = _xp(src_blocks)
    B, h, w = src_blocks.shape
    # Coarse: subsample candidate offsets by `step`.
    n = 2 * radius + 1
    offs = xp.arange(0, n, step)
    src = src_blocks.astype(xp.int32)[:, None, None]
    rw = ref_windows.astype(xp.int32)
    from numpy.lib.stride_tricks import sliding_window_view
    cand = sliding_window_view(rw, (h, w), axis=(1, 2))[:, ::step, ::step]
    sad = xp.abs(cand - src).sum(axis=(-1, -2))
    m = sad.shape[1]
    flat = sad.reshape(B, m * m)
    best = xp.argmin(flat, axis=1)
    cr = offs[best // m]
    cc = offs[best % m]
    # Fine: dense (2*step-1)^2 window around coarse winner.
    fine_r = step - 1
    fr0 = xp.clip(cr - fine_r, 0, n - 1 - 2 * fine_r)
    fc0 = xp.clip(cc - fine_r, 0, n - 1 - 2 * fine_r)
    fh, fw = h + 2 * fine_r, w + 2 * fine_r
    sub = np.stack([rw[b, fr0[b] : fr0[b] + fh, fc0[b] : fc0[b] + fw]
                    for b in range(B)])
    mv_f, best_sad = full_pel_grid_search(src_blocks, sub, fine_r,
                                          sad_per_bit)
    mvs = xp.stack([mv_f[:, 0] + fr0 + fine_r - radius,
                    mv_f[:, 1] + fc0 + fine_r - radius], axis=1)
    return mvs.astype(xp.int32), best_sad


# ---------------------------------------------------------------------------
# Subpel refinement
# ---------------------------------------------------------------------------

_NEIGH8 = np.array([(-1, -1), (-1, 0), (-1, 1),
                    (0, -1), (0, 0), (0, 1),
                    (1, -1), (1, 0), (1, 1)], np.int32)


def _subpel_pred_one(ref_pad, w, h, mv8_r, mv8_c, interp):
    """Prediction at 1/8-pel MV (mv8_*), ref_pad origin at [3+?,3+?].

    AV1 MVs are 1/8-pel but the convolve phase grid is 1/16
    (subpel = (mv & 7) << 1, reconinter.h:au (fractional part doubled))."""
    fr, sr = mv8_r >> 3, (mv8_r & 7) << 1
    fc, sc = mv8_c >> 3, (mv8_c & 7) << 1
    reg = ref_pad[fr : fr + h + 7, fc : fc + w + 7]
    return C.predict_subpel(reg, w, h, sc, sr, interp, interp)


def subpel_refine(src_block, ref_padded, mv_fullpel, levels: int = 3,
                  interp: int = C.EIGHTTAP_REGULAR):
    """Refine a full-pel MV to 1/2, 1/4, 1/8 pel by evaluating all 8
    neighbours at each precision level and keeping the SAD winner
    (parallel-evaluation analogue of av1_find_best_sub_pixel_tree,
    mcomp.c:3331: same candidate set, no early-termination pruning).

    src_block:  (h, w).
    ref_padded: window around the full-pel winner with >= levels of halo:
                origin [4,4] == full-pel MV position minus the (3,3)
                filter tap offset, i.e. shape (h+7+2, w+7+2) minimum.
    mv_fullpel: (row, col) ints — returned MV is 1/8-pel units including
                this full-pel part.
    Returns ((mv8_r, mv8_c), best_sad).
    """
    h, w = src_block.shape
    src = src_block.astype(np.int64)
    # work in 1/8-pel units relative to ref_padded origin + 1 full pel
    cur_r, cur_c = 8, 8   # full-pel center inside the 1-px halo
    best = None
    step = 4
    for _ in range(levels):
        preds = []
        for dr, dc in _NEIGH8:
            r8, c8 = cur_r + dr * step, cur_c + dc * step
            p = _subpel_pred_one(ref_padded, w, h, r8, c8, interp)
            preds.append(np.abs(np.asarray(p).astype(np.int64) - src).sum())
        k = int(np.argmin(preds))
        if best is None or preds[k] <= best:
            best = preds[k]
        cur_r += int(_NEIGH8[k, 0]) * step
        cur_c += int(_NEIGH8[k, 1]) * step
        step >>= 1
    mv8_r = (mv_fullpel[0] - 1) * 8 + cur_r
    mv8_c = (mv_fullpel[1] - 1) * 8 + cur_c
    return (int(mv8_r), int(mv8_c)), int(best)


def batched_subpel_refine(src_blocks, ref_windows, mvs_fullpel,
                          interp: int = C.EIGHTTAP_REGULAR):
    """Vectorized one-level half+quarter refine for a batch (used by the
    analyze pipeline): evaluates the 49-point 1/4-pel lattice around each
    full-pel winner in one batched convolve sweep.

    src_blocks (B,h,w); ref_windows (B,h+9,w+9) centered so [4,4] is the
    full-pel winner minus the tap offset. Returns (B,2) 1/8-pel MVs and
    (B,) SADs."""
    xp = _xp(src_blocks)
    B, h, w = src_blocks.shape
    src = src_blocks.astype(xp.int32)
    cands_sad = []
    cands_mv = []
    for dr in range(-3, 4):
        for dc in range(-3, 4):
            r8, c8 = 8 + dr * 2, 8 + dc * 2
            fr, sr = r8 >> 3, (r8 & 7) << 1
            fc, sc = c8 >> 3, (c8 & 7) << 1
            reg = ref_windows[:, fr : fr + h + 7, fc : fc + w + 7]
            p = C.predict_subpel(reg, w, h, sc, sr, interp, interp)
            cands_sad.append(xp.abs(p - src).sum(axis=(-1, -2)))
            cands_mv.append((dr * 2, dc * 2))
    sads = xp.stack(cands_sad, axis=1)            # (B, 49)
    best = xp.argmin(sads, axis=1)
    mvtab = xp.asarray(np.array(cands_mv, np.int32))
    mv8 = mvs_fullpel * 8 + mvtab[best]
    best_sad = xp.take_along_axis(sads, best[:, None], axis=1)[:, 0]
    return mv8.astype(xp.int32), best_sad.astype(xp.int32)
