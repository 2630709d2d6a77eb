"""Warped motion prediction — affine warp with separable 8-tap shear
filters (``av1/common/warped_motion.c``: av1_warp_affine_c), vectorized
over 8x8 warp tiles as batched gathers + tensor contractions.

The kernel processes the prediction area in 8x8 tiles; per tile the
affine model positions a 15x8 intermediate (horizontal shear) which the
vertical shear reduces to 8x8 (the standard AV1 two-pass formulation).
"""
from __future__ import annotations

import functools
import os

import numpy as np

WARPEDMODEL_PREC_BITS = 16
WARPEDPIXEL_PREC_BITS = 6
WARPEDPIXEL_PREC_SHIFTS = 1 << WARPEDPIXEL_PREC_BITS
WARPEDDIFF_PREC_BITS = WARPEDMODEL_PREC_BITS - WARPEDPIXEL_PREC_BITS
WARP_PARAM_REDUCE_BITS = 6
FILTER_BITS = 7


@functools.cache
def _filters() -> np.ndarray:
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "normative", "data", "misc_tables.npz")
    return np.load(path)["warped_filter"].astype(np.int64)


def _round2(v, bits):
    if bits == 0:
        return v
    return (v + (1 << (bits - 1))) >> bits


def warp_affine(mat, ref: np.ndarray, p_col: int, p_row: int, p_width: int,
                p_height: int, ss_x: int, ss_y: int, alpha: int, beta: int,
                gamma: int, delta: int, round0: int = 3,
                bd: int = 8) -> np.ndarray:
    """av1_warp_affine_c single-ref path. ref: (height, width) plane.
    Returns (p_height, p_width) predicted pixels."""
    height, width = ref.shape
    filters = _filters()
    reduce_h = round0
    reduce_v = 2 * FILTER_BITS - reduce_h
    offset_h = 1 << (bd + FILTER_BITS - 1)
    offset_v = 1 << (bd + 2 * FILTER_BITS - reduce_h)
    out = np.zeros((p_height, p_width), np.int64)
    refi = ref.astype(np.int64)

    ks = np.arange(-7, 8)              # 15 intermediate rows
    ls = np.arange(-4, 4)              # 8 columns
    ms = np.arange(8)                  # taps

    for i in range(p_row, p_row + p_height, 8):
        for j in range(p_col, p_col + p_width, 8):
            src_x = (j + 4) << ss_x
            src_y = (i + 4) << ss_y
            dst_x = mat[2] * src_x + mat[3] * src_y + mat[0]
            dst_y = mat[4] * src_x + mat[5] * src_y + mat[1]
            x4 = dst_x >> ss_x
            y4 = dst_y >> ss_y
            ix4 = int(x4 >> WARPEDMODEL_PREC_BITS)
            sx4 = int(x4 & ((1 << WARPEDMODEL_PREC_BITS) - 1))
            iy4 = int(y4 >> WARPEDMODEL_PREC_BITS)
            sy4 = int(y4 & ((1 << WARPEDMODEL_PREC_BITS) - 1))
            sx4 += alpha * (-4) + beta * (-4)
            sy4 += gamma * (-4) + delta * (-4)
            sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
            sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)

            # horizontal pass: (15, 8) intermediate
            iy = np.clip(iy4 + ks, 0, height - 1)          # (15,)
            sx = sx4 + beta * (ks + 4)[:, None] + alpha * (ls + 4)[None, :]
            offs = _round2(sx, WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            taps_h = filters[offs]                          # (15, 8, 8)
            sample_x = np.clip(ix4 + ls[None, :, None] - 3 + ms[None, None, :],
                               0, width - 1)                # (1, 8, 8)
            px = refi[iy[:, None, None], sample_x]          # (15, 8, 8)
            tmp = _round2((px * taps_h).sum(-1) + offset_h, reduce_h)

            # vertical pass: (8, 8)
            kv = np.arange(-4, min(4, p_row + p_height - i - 4))
            lv = np.arange(-4, min(4, p_col + p_width - j - 4))
            sy = sy4 + delta * (kv + 4)[:, None] + gamma * (lv + 4)[None, :]
            offs_v = _round2(sy, WARPEDDIFF_PREC_BITS) \
                + WARPEDPIXEL_PREC_SHIFTS
            taps_v = filters[offs_v]                        # (kv, lv, 8)
            rows = (kv[:, None, None] + ms[None, None, :] + 4)  # (kv,1,8)
            cols = lv[None, :, None] + 4                        # (1,lv,1)
            gathered = tmp[rows, cols]                      # (kv, lv, 8)
            s = _round2((gathered * taps_v).sum(-1) + offset_v, reduce_v)
            s = s - (1 << (bd - 1)) - (1 << bd)
            s = np.clip(s, 0, (1 << bd) - 1)
            out[i - p_row + kv[0] + 4 : i - p_row + kv[-1] + 5,
                j - p_col + lv[0] + 4 : j - p_col + lv[-1] + 5] = s
    return out


# ---------------------------------------------------------------------------
# Shear-parameter derivation (av1_get_shear_params, warped_motion.c:219)
# ---------------------------------------------------------------------------
DIV_LUT_BITS = 8
DIV_LUT_PREC_BITS = 14
# div_lut[i] = round(2^DIV_LUT_PREC_BITS * 256 / (256 + i))  (257 entries)
_DIV_LUT = [int(round((1 << DIV_LUT_PREC_BITS) * 256.0 / (256 + i)))
            for i in range(257)]


def _round2s(v, bits):
    if v < 0:
        return -((-v + (1 << (bits - 1))) >> bits)
    return (v + (1 << (bits - 1))) >> bits


def _resolve_divisor_32(d: int):
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    if shift > DIV_LUT_BITS:
        f = (e + (1 << (shift - DIV_LUT_BITS - 1))) >> (shift - DIV_LUT_BITS)
    else:
        f = e << (DIV_LUT_BITS - shift)
    return _DIV_LUT[f], shift + DIV_LUT_PREC_BITS


def get_shear_params(wm) -> bool:
    """Derive alpha/beta/gamma/delta; returns False when the model is not
    warpable (av1_get_shear_params)."""
    mat = wm.wmmat
    if mat[2] <= 0:
        return False
    c16 = lambda v: max(-32768, min(32767, v))
    wm.alpha = c16(mat[2] - (1 << WARPEDMODEL_PREC_BITS))
    wm.beta = c16(mat[3])
    y, shift = _resolve_divisor_32(abs(mat[2]))
    if mat[2] < 0:
        y = -y
    v = (mat[4] << WARPEDMODEL_PREC_BITS) * y
    wm.gamma = c16(_round2s(v, shift))
    v = (mat[3] * mat[4]) * y
    wm.delta = c16(mat[5] - _round2s(v, shift) - (1 << WARPEDMODEL_PREC_BITS))
    r = WARP_PARAM_REDUCE_BITS
    wm.alpha = _round2s(wm.alpha, r) * (1 << r)
    wm.beta = _round2s(wm.beta, r) * (1 << r)
    wm.gamma = _round2s(wm.gamma, r) * (1 << r)
    wm.delta = _round2s(wm.delta, r) * (1 << r)
    if (4 * abs(wm.alpha) + 7 * abs(wm.beta) >= (1 << WARPEDMODEL_PREC_BITS)
            or 4 * abs(wm.gamma) + 4 * abs(wm.delta)
            >= (1 << WARPEDMODEL_PREC_BITS)):
        return False
    return True


# ---------------------------------------------------------------------------
# Warp-model fit from neighbor MV samples (av1_find_projection /
# find_affine_int, warped_motion.c:894)
# ---------------------------------------------------------------------------
LS_MV_MAX = 256
LS_STEP = 8
WARPEDMODEL_TRANS_CLAMP = 128 << WARPEDMODEL_PREC_BITS
WARPEDMODEL_NONDIAGAFFINE_CLAMP = 1 << (WARPEDMODEL_PREC_BITS - 3)


def _ls_square(a):
    return (a * a * 4 + a * 4 * LS_STEP + LS_STEP * LS_STEP * 2) >> 4


def _ls_product1(a, b):
    return (a * b * 4 + (a + b) * 2 * LS_STEP + LS_STEP * LS_STEP) >> 4


def _ls_product2(a, b):
    return (a * b * 4 + (a + b) * 2 * LS_STEP + LS_STEP * LS_STEP * 2) >> 4


def _resolve_divisor_64(d: int):
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    if shift > DIV_LUT_BITS:
        f = (e + (1 << (shift - DIV_LUT_BITS - 1))) >> (shift - DIV_LUT_BITS)
    else:
        f = e << (DIV_LUT_BITS - shift)
    return _DIV_LUT[f], shift + DIV_LUT_PREC_BITS


def find_projection(np_samples: int, pts, pts_inref, bw: int, bh: int,
                    mv, wm, mi_row: int, mi_col: int) -> bool:
    """Fit the affine model; returns True on success (av1_find_projection
    returns 0). mv is (row, col) in 1/8 pel; wm is a mvref.WarpModel."""
    mvy, mvx = mv
    rsuy = bh // 2 - 1
    rsux = bw // 2 - 1
    suy = rsuy * 8
    sux = rsux * 8
    duy = suy + mvy
    dux = sux + mvx
    A00 = A01 = A11 = 0
    Bx0 = Bx1 = By0 = By1 = 0
    for i in range(np_samples):
        dx = pts_inref[i][0] - dux
        dy = pts_inref[i][1] - duy
        sx = pts[i][0] - sux
        sy = pts[i][1] - suy
        if abs(sx - dx) < LS_MV_MAX and abs(sy - dy) < LS_MV_MAX:
            A00 += _ls_square(sx)
            A01 += _ls_product1(sx, sy)
            A11 += _ls_square(sy)
            Bx0 += _ls_product2(sx, dx)
            Bx1 += _ls_product1(sy, dx)
            By0 += _ls_product1(sx, dy)
            By1 += _ls_product2(sy, dy)
    det = A00 * A11 - A01 * A01
    if det == 0:
        return False
    idet, shift = _resolve_divisor_64(abs(det))
    if det < 0:
        idet = -idet
    shift -= WARPEDMODEL_PREC_BITS
    if shift < 0:
        idet <<= -shift
        shift = 0
    px0 = A11 * Bx0 - A01 * Bx1
    px1 = -A01 * Bx0 + A00 * Bx1
    py0 = A11 * By0 - A01 * By1
    py1 = -A01 * By0 + A00 * By1
    c16 = 1 << WARPEDMODEL_PREC_BITS
    nd = WARPEDMODEL_NONDIAGAFFINE_CLAMP

    def diag(p):
        return max(c16 - nd + 1, min(c16 + nd - 1, _round2s(p * idet, shift)))

    def ndiag(p):
        return max(-nd + 1, min(nd - 1, _round2s(p * idet, shift)))

    wm.wmmat[2] = diag(px0)
    wm.wmmat[3] = ndiag(px1)
    wm.wmmat[4] = ndiag(py0)
    wm.wmmat[5] = diag(py1)
    isuy = mi_row * 4 + rsuy
    isux = mi_col * 4 + rsux
    vx = mvx * (1 << (WARPEDMODEL_PREC_BITS - 3)) \
        - (isux * (wm.wmmat[2] - c16) + isuy * wm.wmmat[3])
    vy = mvy * (1 << (WARPEDMODEL_PREC_BITS - 3)) \
        - (isux * wm.wmmat[4] + isuy * (wm.wmmat[5] - c16))
    wm.wmmat[0] = max(-WARPEDMODEL_TRANS_CLAMP,
                      min(WARPEDMODEL_TRANS_CLAMP - 1, vx))
    wm.wmmat[1] = max(-WARPEDMODEL_TRANS_CLAMP,
                      min(WARPEDMODEL_TRANS_CLAMP - 1, vy))
    return True
