"""AV1 intra prediction — normative predictors + edge preparation.

Reimplements the reference's predictor zoo and edge pipeline
(``aom_dsp/intrapred.c``, ``av1/common/reconintra.c:519-1330``) as
vectorized array code. The per-pixel double loops become whole-block
broadcasts; directional modes become clamped gathers over the prepared
edge, so a batch of same-shaped blocks evaluates in one fused XLA op.

This module works on prepared edge arrays; `build_intra_predictor`
reproduces the exact reference edge preparation (availability fill,
corner/edge filtering, upsampling) for one block — the sequential recon
loops call it per block; batched search paths call the leaf predictors
directly.
"""
from __future__ import annotations

import functools

import numpy as np

from ..normative.enums import PredictionMode, MODE_TO_ANGLE

SMOOTH_WEIGHT_LOG2_SCALE = 8
MAX_ANGLE_DELTA = 3
ANGLE_STEP = 3


@functools.cache
def _misc():
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "normative", "data", "misc_tables.npz")
    return np.load(path)


def smooth_weights(dim: int) -> np.ndarray:
    return _misc()["smooth_weights"][dim - 4 : 2 * dim - 4]


def dr_intra_derivative() -> np.ndarray:
    return _misc()["dr_intra_derivative"]


def get_dx(angle: int) -> int:
    d = dr_intra_derivative()
    if 0 < angle < 90:
        return int(d[angle])
    if 90 < angle < 180:
        return int(d[180 - angle])
    return 1


def get_dy(angle: int) -> int:
    d = dr_intra_derivative()
    if 90 < angle < 180:
        return int(d[angle - 90])
    if 180 < angle < 270:
        return int(d[270 - angle])
    return 1


def _round2(v, bits):
    return (v + (1 << (bits - 1))) >> bits


# ---------------------------------------------------------------------------
# Leaf predictors. above: (..., W[+H]) int array; left: (..., H[+W]);
# top_left: scalar/array. All return (..., H, W) int32.
# ---------------------------------------------------------------------------


def dc_pred(above, left, w, h, have_above=True, have_left=True, bd=8):
    a = above[..., :w].astype(np.int32)
    l = left[..., :h].astype(np.int32)
    if have_above and have_left:
        count = w + h
        s = a.sum(-1) + l.sum(-1)
        dc = (s + (count >> 1)) // count
    elif have_above:
        dc = (a.sum(-1) + (w >> 1)) >> (w.bit_length() - 1)
    elif have_left:
        dc = (l.sum(-1) + (h >> 1)) >> (h.bit_length() - 1)
    else:
        dc = np.asarray(1 << (bd - 1))
    return np.broadcast_to(dc[..., None, None] if np.ndim(dc) else dc,
                           a.shape[:-1] + (h, w)).astype(np.int32)


def v_pred(above, left, w, h):
    a = above[..., :w].astype(np.int32)
    return np.broadcast_to(a[..., None, :], a.shape[:-1] + (h, w)).copy()


def h_pred(above, left, w, h):
    l = left[..., :h].astype(np.int32)
    return np.broadcast_to(l[..., :, None], l.shape[:-1] + (h, w)).copy()


def paeth_pred(above, left, top_left, w, h):
    a = above[..., None, :w].astype(np.int32)
    l = left[..., :h, None].astype(np.int32)
    tl = np.asarray(top_left, dtype=np.int32)[..., None, None]
    base = l + a - tl
    pl, pt, ptl = abs(base - l), abs(base - a), abs(base - tl)
    take_l = (pl <= pt) & (pl <= ptl)
    take_t = pt <= ptl
    return np.where(take_l, np.broadcast_to(l, base.shape),
                    np.where(take_t, np.broadcast_to(a, base.shape),
                             np.broadcast_to(tl, base.shape))).astype(np.int32)


def smooth_pred(above, left, w, h):
    a = above[..., :w].astype(np.int32)
    l = left[..., :h].astype(np.int32)
    below = l[..., h - 1 : h]  # (...,1)
    right = a[..., w - 1 : w]
    ww = smooth_weights(w).astype(np.int32)
    wh = smooth_weights(h).astype(np.int32)
    scale = 1 << SMOOTH_WEIGHT_LOG2_SCALE
    p = (wh[:, None] * a[..., None, :]
         + (scale - wh)[:, None] * below[..., :, None]
         + ww[None, :] * l[..., :, None]
         + (scale - ww)[None, :] * right[..., :, None])
    return _round2(p, 1 + SMOOTH_WEIGHT_LOG2_SCALE).astype(np.int32)


def smooth_v_pred(above, left, w, h):
    a = above[..., :w].astype(np.int32)
    l = left[..., :h].astype(np.int32)
    below = l[..., h - 1 : h]
    wh = smooth_weights(h).astype(np.int32)
    scale = 1 << SMOOTH_WEIGHT_LOG2_SCALE
    p = wh[:, None] * a[..., None, :] + (scale - wh)[:, None] * below[..., :, None]
    return _round2(p, SMOOTH_WEIGHT_LOG2_SCALE).astype(np.int32)


def smooth_h_pred(above, left, w, h):
    a = above[..., :w].astype(np.int32)
    l = left[..., :h].astype(np.int32)
    right = a[..., w - 1 : w]
    ww = smooth_weights(w).astype(np.int32)
    scale = 1 << SMOOTH_WEIGHT_LOG2_SCALE
    p = ww[None, :] * l[..., :, None] + (scale - ww)[None, :] * right[..., :, None]
    return _round2(p, SMOOTH_WEIGHT_LOG2_SCALE).astype(np.int32)


def dr_pred_z1(above, w, h, upsample_above: int, dx: int):
    """av1_dr_prediction_z1_c: 0 < angle < 90. above indexed 0.. includes
    the top-right extension; length must cover (w+h)<<upsample + 1."""
    a = above.astype(np.int32)
    up = upsample_above
    max_base_x = (w + h - 1) << up
    frac_bits = 6 - up
    base_inc = 1 << up
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    x = dx * (r + 1)
    base = (x >> frac_bits) + c * base_inc
    shift = ((x << up) & 0x3F) >> 1
    over = base >= max_base_x
    b0 = np.minimum(base, max_base_x)
    b1 = np.minimum(base + 1, max_base_x)
    val = _round2(a[..., b0] * (32 - shift) + a[..., b1] * shift, 5)
    return np.where(over, a[..., max_base_x][..., None, None], val).astype(np.int32)


def dr_pred_z2(above_m2, left_m2, w, h, upsample_above: int,
               upsample_left: int, dx: int, dy: int):
    """av1_dr_prediction_z2_c: 90 < angle < 180.

    above_m2/left_m2: edge arrays STARTING AT POSITION -2 (i.e. index i in
    the array is edge position i-2), so the negative bases reachable after
    upsampling (base >= -2) gather in-bounds."""
    up_a, up_l = upsample_above, upsample_left
    ea = np.asarray(above_m2).astype(np.int32)
    el = np.asarray(left_m2).astype(np.int32)
    min_base_x = -(1 << up_a)
    frac_x = 6 - up_a
    frac_y = 6 - up_l
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    y = r + 1
    x = (c << 6) - y * dx
    base_x = x >> frac_x
    use_above = base_x >= min_base_x
    shift_x = ((x * (1 << up_a)) & 0x3F) >> 1
    bx0 = np.clip(base_x, -2, ea.shape[-1] - 3) + 2
    bx1 = np.clip(base_x + 1, -2, ea.shape[-1] - 3) + 2
    va = _round2(ea[..., bx0] * (32 - shift_x) + ea[..., bx1] * shift_x, 5)
    x2 = c + 1
    y2 = (r << 6) - x2 * dy
    base_y = y2 >> frac_y
    shift_y = ((y2 * (1 << up_l)) & 0x3F) >> 1
    by0 = np.clip(base_y, -2, el.shape[-1] - 3) + 2
    by1 = np.clip(base_y + 1, -2, el.shape[-1] - 3) + 2
    vl = _round2(el[..., by0] * (32 - shift_y) + el[..., by1] * shift_y, 5)
    return np.where(use_above, va, vl).astype(np.int32)


def dr_pred_z3(left, w, h, upsample_left: int, dy: int):
    """av1_dr_prediction_z3_c: 180 < angle < 270."""
    l = left.astype(np.int32)
    up = upsample_left
    max_base_y = (w + h - 1) << up
    frac_bits = 6 - up
    base_inc = 1 << up
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    y = dy * (c + 1)
    base = (y >> frac_bits) + r * base_inc
    shift = ((y << up) & 0x3F) >> 1
    over = base >= max_base_y
    b0 = np.minimum(base, max_base_y)
    b1 = np.minimum(base + 1, max_base_y)
    val = _round2(l[..., b0] * (32 - shift) + l[..., b1] * shift, 5)
    return np.where(over, l[..., max_base_y][..., None, None], val).astype(np.int32)


def filter_intra_pred(above_with_corner, left, w, h, fi_mode: int, bd=8):
    """av1_filter_intra_predictor_c: 4x2 tile recurrence.
    above_with_corner: (w+1,) starting at the corner p[-1]."""
    taps = _misc()["filter_intra_taps"][fi_mode][:, :7].astype(np.int32)
    buf = np.zeros((h + 1, w + 1), np.int32)
    buf[0, : w + 1] = above_with_corner[: w + 1]
    buf[1:, 0] = left[:h]
    for r in range(1, h + 1, 2):
        for c in range(1, w + 1, 4):  # w, h are multiples of 4/2: in-bounds
            p = np.array([buf[r - 1, c - 1], buf[r - 1, c], buf[r - 1, c + 1],
                          buf[r - 1, c + 2], buf[r - 1, c + 3],
                          buf[r, c - 1], buf[r + 1, c - 1]], np.int32)
            pr = taps @ p
            vals = np.clip(_round2_signed(pr, 4), 0, (1 << bd) - 1)
            for k in range(8):
                buf[r + (k >> 2), c + (k & 3)] = vals[k]
    return buf[1:, 1:].astype(np.int32)


def _round2_signed(v, bits):
    return np.where(v >= 0, (v + (1 << (bits - 1))) >> bits,
                    -((-v + (1 << (bits - 1))) >> bits))


# ---------------------------------------------------------------------------
# Edge preparation (reconintra.c build_intra_predictors)
# ---------------------------------------------------------------------------

NEED_LEFT = 1 << 1
NEED_ABOVE = 1 << 2
NEED_ABOVELEFT = 1 << 3
NEED_ABOVERIGHT = 1 << 4
NEED_BOTTOMLEFT = 1 << 5

EXTEND_MODES = {
    PredictionMode.DC_PRED: NEED_ABOVE | NEED_LEFT,
    PredictionMode.V_PRED: NEED_ABOVE,
    PredictionMode.H_PRED: NEED_LEFT,
    PredictionMode.D45_PRED: NEED_ABOVE | NEED_ABOVERIGHT,
    PredictionMode.D135_PRED: NEED_LEFT | NEED_ABOVE | NEED_ABOVELEFT,
    PredictionMode.D113_PRED: NEED_LEFT | NEED_ABOVE | NEED_ABOVELEFT,
    PredictionMode.D157_PRED: NEED_LEFT | NEED_ABOVE | NEED_ABOVELEFT,
    PredictionMode.D203_PRED: NEED_LEFT | NEED_BOTTOMLEFT,
    PredictionMode.D67_PRED: NEED_ABOVE | NEED_ABOVERIGHT,
    PredictionMode.SMOOTH_PRED: NEED_LEFT | NEED_ABOVE,
    PredictionMode.SMOOTH_V_PRED: NEED_LEFT | NEED_ABOVE,
    PredictionMode.SMOOTH_H_PRED: NEED_LEFT | NEED_ABOVE,
    PredictionMode.PAETH_PRED: NEED_LEFT | NEED_ABOVE | NEED_ABOVELEFT,
}


def is_directional(mode) -> bool:
    return PredictionMode.V_PRED <= mode <= PredictionMode.D67_PRED


def intra_edge_filter_strength(bs0, bs1, delta, type_) -> int:
    d = abs(delta)
    blk_wh = bs0 + bs1
    s = 0
    if type_ == 0:
        if blk_wh <= 8:
            s = 1 if d >= 56 else 0
        elif blk_wh <= 16:
            s = 1 if d >= 40 else 0
        elif blk_wh <= 24:
            s = 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        elif blk_wh <= 32:
            s = 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        else:
            s = 3 if d >= 1 else 0
    else:
        if blk_wh <= 8:
            s = 2 if d >= 64 else 1 if d >= 40 else 0
        elif blk_wh <= 16:
            s = 2 if d >= 48 else 1 if d >= 20 else 0
        elif blk_wh <= 24:
            s = 3 if d >= 4 else 0
        else:
            s = 3 if d >= 1 else 0
    return s


def use_intra_edge_upsample(bs0, bs1, delta, type_) -> bool:
    d = abs(delta)
    blk_wh = bs0 + bs1
    if d == 0 or d >= 40:
        return False
    return blk_wh <= 8 if type_ else blk_wh <= 16


def filter_intra_edge(p: np.ndarray, sz: int, strength: int) -> None:
    """In-place smoothing of an edge array (av1_filter_intra_edge_c)."""
    if not strength:
        return
    kernel = [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]][strength - 1]
    edge = p[:sz].copy().astype(np.int32)
    for i in range(1, sz):
        s = 0
        for j in range(5):
            k = min(max(i - 2 + j, 0), sz - 1)
            s += edge[k] * kernel[j]
        p[i] = (s + 8) >> 4


def upsample_intra_edge(p: np.ndarray, sz: int) -> np.ndarray:
    """av1_upsample_intra_edge_c. p: array where p[0] is the corner (-1
    position) followed by sz edge pixels; returns the upsampled array
    u such that u[i] corresponds to position (i - 2)/2 relative to the
    original edge, i.e. new_p[-2..2*sz-2]."""
    inb = np.empty(sz + 3, np.int32)
    inb[0] = inb[1] = p[0]
    inb[2 : sz + 2] = p[1 : sz + 1]
    inb[sz + 2] = p[sz]
    out = np.empty(2 * sz + 1, np.int32)  # positions -2 .. 2*sz-2
    out[0] = inb[0]
    i = np.arange(sz)
    s = -inb[i] + 9 * inb[i + 1] + 9 * inb[i + 2] - inb[i + 3]
    s = np.clip((s + 8) >> 4, 0, 255)
    out[1 + 2 * i] = s
    out[2 + 2 * i] = inb[i + 2]
    return out


def build_intra_predictor(above_ref, left_ref, top_left_ref, n_top_px,
                          n_topright_px, n_left_px, n_bottomleft_px, mode,
                          angle_delta, w, h, *, filter_intra_mode=None,
                          disable_edge_filter=False, intra_edge_filter_type=0,
                          bd=8):
    """Single-block normative intra prediction (reconintra.c:1081+).

    above_ref: available above pixels (>= n_top_px + max(n_topright_px,0)),
    left_ref likewise for left; top_left_ref scalar. n_topright_px /
    n_bottomleft_px use the reference convention: -1 means the predictor
    does not want that extension, >=0 means wanted with that many available.
    Returns (h, w) int32 prediction.
    """
    mode = PredictionMode(mode)
    use_filter_intra = filter_intra_mode is not None
    is_dr = is_directional(mode)
    p_angle = MODE_TO_ANGLE.get(mode, 0) + angle_delta * ANGLE_STEP if is_dr else 0

    need = EXTEND_MODES[mode]
    need_left = bool(need & NEED_LEFT)
    need_above = bool(need & NEED_ABOVE)
    need_above_left = bool(need & NEED_ABOVELEFT)
    if is_dr:
        if p_angle <= 90:
            need_above, need_left, need_above_left = True, False, True
        elif p_angle < 180:
            need_above, need_left, need_above_left = True, True, True
        else:
            need_above, need_left, need_above_left = False, True, True
    if use_filter_intra:
        need_left = need_above = need_above_left = True

    # 16-slot guard + edge data, defaults 127 above / 129 left.  Sized for
    # the worst case 2*max(w,h) (n_top+n_topright can reach 2w on wide tx
    # shapes like 64x16 where w+h is too small; reference uses
    # above_data[MAX_TX_SIZE*2+32], reconintra.c)
    edge_len = 16 + 2 * max(w, h) + 16
    above_row = np.full(edge_len, 127, np.int32)
    left_col = np.full(edge_len, 129, np.int32)
    AOFF = 16  # above_row[AOFF] is position 0
    LOFF = 16

    if (not need_above and n_left_px == 0) or (not need_left and n_top_px == 0):
        if need_left:
            val = int(above_ref[0]) if n_top_px > 0 else 129
        else:
            val = int(left_ref[0]) if n_left_px > 0 else 127
        return np.full((h, w), val, np.int32)

    if need_left:
        num_needed = h + (w if n_bottomleft_px >= 0 else 0)
        i = 0
        if n_left_px > 0:
            n = n_left_px + max(n_bottomleft_px, 0)
            left_col[LOFF : LOFF + n] = left_ref[:n]
            i = n
            if i < num_needed:
                left_col[LOFF + i : LOFF + num_needed] = left_col[LOFF + i - 1]
        elif n_top_px > 0:
            left_col[LOFF : LOFF + num_needed] = above_ref[0]

    if need_above:
        num_needed = w + (h if n_topright_px >= 0 else 0)
        if n_top_px > 0:
            n = n_top_px + max(n_topright_px, 0)
            above_row[AOFF : AOFF + n] = above_ref[:n]
            i = n
            if i < num_needed:
                above_row[AOFF + i : AOFF + num_needed] = above_row[AOFF + i - 1]
        elif n_left_px > 0:
            above_row[AOFF : AOFF + num_needed] = left_ref[0]

    if need_above_left:
        if n_top_px > 0 and n_left_px > 0:
            above_row[AOFF - 1] = top_left_ref
        elif n_top_px > 0:
            above_row[AOFF - 1] = above_ref[0]
        elif n_left_px > 0:
            above_row[AOFF - 1] = left_ref[0]
        else:
            above_row[AOFF - 1] = 128
        left_col[LOFF - 1] = above_row[AOFF - 1]

    if use_filter_intra:
        return filter_intra_pred(above_row[AOFF - 1 :], left_col[LOFF:], w, h,
                                 filter_intra_mode, bd)

    if is_dr:
        upsample_above = upsample_left = 0
        if not disable_edge_filter:
            need_right = p_angle < 90
            need_bottom = p_angle > 180
            ab_le = 1 if need_above_left else 0
            if p_angle != 90 and p_angle != 180:
                if need_above and need_left and (w + h >= 24):
                    s = (left_col[LOFF] * 5 + above_row[AOFF - 1] * 6 +
                         above_row[AOFF] * 5 + 8) >> 4
                    above_row[AOFF - 1] = s
                    left_col[LOFF - 1] = s
                if need_above and n_top_px > 0:
                    strength = intra_edge_filter_strength(
                        w, h, p_angle - 90, intra_edge_filter_type)
                    n_px = n_top_px + ab_le + (h if need_right else 0)
                    filter_intra_edge(above_row[AOFF - ab_le :], n_px, strength)
                if need_left and n_left_px > 0:
                    strength = intra_edge_filter_strength(
                        h, w, p_angle - 180, intra_edge_filter_type)
                    n_px = n_left_px + ab_le + (w if need_bottom else 0)
                    filter_intra_edge(left_col[LOFF - ab_le :], n_px, strength)
            upsample_above = use_intra_edge_upsample(
                w, h, p_angle - 90, intra_edge_filter_type)
            if need_above and upsample_above:
                n_px = w + (h if need_right else 0)
                up = upsample_intra_edge(above_row[AOFF - 1 :], n_px)
                above_row[AOFF - 2 : AOFF - 2 + len(up)] = up
            upsample_left = use_intra_edge_upsample(
                h, w, p_angle - 180, intra_edge_filter_type)
            if need_left and upsample_left:
                n_px = h + (w if need_bottom else 0)
                upl = upsample_intra_edge(left_col[LOFF - 1 :], n_px)
                left_col[LOFF - 2 : LOFF - 2 + len(upl)] = upl

        dx, dy = get_dx(p_angle), get_dy(p_angle)
        ab = above_row[AOFF:]
        lf = left_col[LOFF:]
        if 0 < p_angle < 90:
            return dr_pred_z1(ab, w, h, int(upsample_above), dx)
        if 90 < p_angle < 180:
            return dr_pred_z2(above_row[AOFF - 2 :], left_col[LOFF - 2 :], w, h,
                              int(upsample_above), int(upsample_left), dx, dy)
        if 180 < p_angle < 270:
            return dr_pred_z3(lf, w, h, int(upsample_left), dy)
        if p_angle == 90:
            return v_pred(ab, lf, w, h)
        return h_pred(ab, lf, w, h)

    ab = above_row[AOFF:]
    lf = left_col[LOFF:]
    if mode == PredictionMode.DC_PRED:
        return dc_pred(ab, lf, w, h, n_top_px > 0, n_left_px > 0, bd)
    if mode == PredictionMode.V_PRED:
        return v_pred(ab, lf, w, h)
    if mode == PredictionMode.H_PRED:
        return h_pred(ab, lf, w, h)
    if mode == PredictionMode.PAETH_PRED:
        return paeth_pred(ab, lf, above_row[AOFF - 1], w, h)
    if mode == PredictionMode.SMOOTH_PRED:
        return smooth_pred(ab, lf, w, h)
    if mode == PredictionMode.SMOOTH_V_PRED:
        return smooth_v_pred(ab, lf, w, h)
    if mode == PredictionMode.SMOOTH_H_PRED:
        return smooth_h_pred(ab, lf, w, h)
    raise ValueError(mode)
