"""Compound inter prediction kernels — dist-weighted two-ref convolve,
mask blends, and difference-weighted masks, batched.

Covers the reference family (SURVEY §2.12 convolve/inter-pred group):
``av1_dist_wtd_convolve_{2d,x,y,2d_copy}_c`` (av1/common/convolve.c:176+),
``aom_blend_a64_{mask,hmask,vmask}_c`` (aom_dsp/blend_a64*.c),
``aom_comp_avg_pred_c`` / ``aom_comp_mask_pred_c`` (aom_dsp/sad.c /
variance.c helpers) and ``av1_build_compound_diffwtd_mask_c``
(reconinter.c:345).
"""
from __future__ import annotations

import numpy as np

from .convolve import (FILTER_BITS, SUBPEL_MASK, filter_kernels,
                       EIGHTTAP_REGULAR)

DIST_PRECISION_BITS = 4
BLEND_A64_MAX_ALPHA = 64
DIFF_FACTOR = 16
ROUND0 = 3
ROUND1_COMPOUND = 7


def _round2(v, bits):
    if bits == 0:
        return v
    return (v + (1 << (bits - 1))) >> bits


def _first_pass(ref, w, h, subpel_x, subpel_y, kx, ky, bd=8):
    """Produce the CONV_BUF intermediate for one reference (do_average=0).
    ref: (..., h+7, w+7) padded region with origin at [3,3]."""
    x = np.asarray(ref).astype(np.int64)
    round0, round1 = ROUND0, ROUND1_COMPOUND
    offset_bits = bd + 2 * FILTER_BITS - round0
    round_offset = (1 << (offset_bits - round1)) \
        + (1 << (offset_bits - round1 - 1))
    if subpel_x and subpel_y:
        im = np.zeros(x.shape[:-2] + (h + 7, w), np.int64)
        off = 1 << (bd + FILTER_BITS - 1)
        for k in range(8):
            t = int(kx[k])
            if t:
                im += t * x[..., :, k : k + w]
        im = _round2(im + off, round0)
        out = np.zeros(x.shape[:-2] + (h, w), np.int64)
        for k in range(8):
            t = int(ky[k])
            if t:
                out += t * im[..., k : k + h, :]
        return _round2(out + (1 << offset_bits), round1)
    if subpel_x:
        out = np.zeros(x.shape[:-2] + (h, w), np.int64)
        for k in range(8):
            t = int(kx[k])
            if t:
                out += t * x[..., 3 : 3 + h, k : k + w]
        out = _round2(out, round0) << (FILTER_BITS - round1)
        return out + round_offset
    if subpel_y:
        out = np.zeros(x.shape[:-2] + (h, w), np.int64)
        for k in range(8):
            t = int(ky[k])
            if t:
                out += t * x[..., k : k + h, 3 : 3 + w]
        out <<= (FILTER_BITS - round0)
        return _round2(out, round1) + round_offset
    out = x[..., 3 : 3 + h, 3 : 3 + w] << (2 * FILTER_BITS - round0 - round1)
    return out + round_offset


def dist_wtd_avg(conv0, conv1, fwd_offset: int, bck_offset: int,
                 use_dist_wtd: bool, bd: int = 8):
    """Second-pass averaging of two CONV_BUF intermediates into pixels."""
    round0, round1 = ROUND0, ROUND1_COMPOUND
    offset_bits = bd + 2 * FILTER_BITS - round0
    round_offset = (1 << (offset_bits - round1)) \
        + (1 << (offset_bits - round1 - 1))
    round_bits = 2 * FILTER_BITS - round0 - round1
    if use_dist_wtd:
        tmp = (conv0 * fwd_offset + conv1 * bck_offset) >> DIST_PRECISION_BITS
    else:
        tmp = (conv0 + conv1) >> 1
    tmp = tmp - round_offset
    return np.clip(_round2(tmp, round_bits), 0, (1 << bd) - 1)


def compound_predict(ref0, ref1, w: int, h: int, subpel0, subpel1,
                     fwd_offset: int = 0, bck_offset: int = 0,
                     use_dist_wtd: bool = False,
                     interp: int = EIGHTTAP_REGULAR, bd: int = 8):
    """Two-reference compound MC (av1_dist_wtd_convolve facade pair:
    first ref fills the CONV_BUF, second averages into pixels)."""
    preds = []
    for ref, (sx, sy) in ((ref0, subpel0), (ref1, subpel1)):
        kx = filter_kernels(interp, w)[sx & SUBPEL_MASK]
        ky = filter_kernels(interp, h)[sy & SUBPEL_MASK]
        preds.append(_first_pass(ref, w, h, sx & SUBPEL_MASK,
                                 sy & SUBPEL_MASK, kx, ky, bd))
    return dist_wtd_avg(preds[0], preds[1], fwd_offset, bck_offset,
                        use_dist_wtd, bd)


# ---------------------------------------------------------------------------
# Blends
# ---------------------------------------------------------------------------

def blend_a64_mask(src0, src1, mask, subw: int = 0, subh: int = 0):
    """aom_blend_a64_mask_c incl. 2x subsampled mask variants
    (aom_dsp/blend_a64_mask.c:27): dst = (m*a + (64-m)*b + 32) >> 6."""
    a = np.asarray(src0).astype(np.int64)
    b = np.asarray(src1).astype(np.int64)
    m = np.asarray(mask).astype(np.int64)
    if subw and subh:
        mm = _round2(m[0::2, 0::2] + m[1::2, 0::2] + m[0::2, 1::2]
                     + m[1::2, 1::2], 2)
    elif subw:
        mm = _round2(m[:, 0::2] + m[:, 1::2], 1)
    elif subh:
        mm = _round2(m[0::2, :] + m[1::2, :], 1)
    else:
        mm = m
    return _round2(mm * a + (BLEND_A64_MAX_ALPHA - mm) * b, 6)


def blend_a64_hmask(src0, src1, mask_row):
    """aom_blend_a64_hmask_c: per-column mask."""
    m = np.asarray(mask_row).astype(np.int64)[None, :]
    return blend_a64_mask(src0, src1, np.broadcast_to(
        m, np.asarray(src0).shape))


def blend_a64_vmask(src0, src1, mask_col):
    """aom_blend_a64_vmask_c: per-row mask."""
    m = np.asarray(mask_col).astype(np.int64)[:, None]
    return blend_a64_mask(src0, src1, np.broadcast_to(
        m, np.asarray(src0).shape))


def comp_avg_pred(pred, ref):
    """aom_comp_avg_pred_c: (p + r + 1) >> 1."""
    return (np.asarray(pred).astype(np.int64)
            + np.asarray(ref).astype(np.int64) + 1) >> 1


def comp_mask_pred(pred, ref, mask, invert: bool = False):
    """aom_comp_mask_pred_c: mask blend of pred/ref."""
    if invert:
        return blend_a64_mask(ref, pred, mask)
    return blend_a64_mask(pred, ref, mask)


def build_compound_diffwtd_mask(src0, src1, inverse: bool = False,
                                mask_base: int = 38):
    """av1_build_compound_diffwtd_mask_c (DIFFWTD_38 / _INV)."""
    diff = np.abs(np.asarray(src0).astype(np.int64)
                  - np.asarray(src1).astype(np.int64))
    m = np.clip(mask_base + diff // DIFF_FACTOR, 0, BLEND_A64_MAX_ALPHA)
    return (BLEND_A64_MAX_ALPHA - m) if inverse else m


# ---------------------------------------------------------------------------
# Masked compound: wedge masks, difference-weighted masks, d16 blend
# (av1/common/reconinter.c init_wedge_master_masks :258,
#  av1_build_compound_diffwtd_mask_d16_c, aom_lowbd_blend_a64_d16_mask_c)
# ---------------------------------------------------------------------------
MASK_MASTER_SIZE = 64
WEDGE_WEIGHT_BITS = 6
DIFF_FACTOR = 16
(WEDGE_HORIZONTAL, WEDGE_VERTICAL, WEDGE_OBLIQUE27, WEDGE_OBLIQUE63,
 WEDGE_OBLIQUE117, WEDGE_OBLIQUE153) = range(6)

_WEDGE_MASTER_OBLIQUE_ODD = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 6, 18,
    37, 53, 60, 63, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64]
_WEDGE_MASTER_OBLIQUE_EVEN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 4, 11, 27,
    46, 58, 62, 63, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64]
_WEDGE_MASTER_VERTICAL = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 7, 21,
    43, 57, 62, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64]

# wedge codebooks (reconinter.c:198): (direction, x_offset, y_offset)
_CB_HGTW = [(WEDGE_OBLIQUE27, 4, 4), (WEDGE_OBLIQUE63, 4, 4),
            (WEDGE_OBLIQUE117, 4, 4), (WEDGE_OBLIQUE153, 4, 4),
            (WEDGE_HORIZONTAL, 4, 2), (WEDGE_HORIZONTAL, 4, 4),
            (WEDGE_HORIZONTAL, 4, 6), (WEDGE_VERTICAL, 4, 4),
            (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
            (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
            (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
            (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)]
_CB_HLTW = [(WEDGE_OBLIQUE27, 4, 4), (WEDGE_OBLIQUE63, 4, 4),
            (WEDGE_OBLIQUE117, 4, 4), (WEDGE_OBLIQUE153, 4, 4),
            (WEDGE_VERTICAL, 2, 4), (WEDGE_VERTICAL, 4, 4),
            (WEDGE_VERTICAL, 6, 4), (WEDGE_HORIZONTAL, 4, 4),
            (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
            (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
            (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
            (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)]
_CB_HEQW = [(WEDGE_OBLIQUE27, 4, 4), (WEDGE_OBLIQUE63, 4, 4),
            (WEDGE_OBLIQUE117, 4, 4), (WEDGE_OBLIQUE153, 4, 4),
            (WEDGE_HORIZONTAL, 4, 2), (WEDGE_HORIZONTAL, 4, 6),
            (WEDGE_VERTICAL, 2, 4), (WEDGE_VERTICAL, 6, 4),
            (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
            (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
            (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
            (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)]

_SF_HEQW = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1]
_SF_HGTW = [1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1]
_SF_HLTW = [1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1]
_SF_8X32 = [1, 1, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 1]
_SF_32X8 = [1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 0, 1, 0, 1]

# per-bsize wedge params: bsize -> (codebook, signflip)
WEDGE_PARAMS = {
    3: (_CB_HEQW, _SF_HEQW),    # 8x8
    4: (_CB_HGTW, _SF_HGTW),    # 8x16
    5: (_CB_HLTW, _SF_HLTW),    # 16x8
    6: (_CB_HEQW, _SF_HEQW),    # 16x16
    7: (_CB_HGTW, _SF_HGTW),    # 16x32
    8: (_CB_HLTW, _SF_HLTW),    # 32x16
    9: (_CB_HEQW, _SF_HEQW),    # 32x32
    18: (_CB_HGTW, _SF_8X32),   # 8x32
    19: (_CB_HLTW, _SF_32X8),   # 32x8
}

_wedge_master = None


def _build_wedge_master():
    """init_wedge_master_masks: [neg][direction] -> (64, 64) uint8."""
    global _wedge_master
    if _wedge_master is not None:
        return _wedge_master
    m = np.zeros((2, 6, 64, 64), np.uint8)
    shift = 16
    for i in range(0, 64, 2):
        for (row, master) in ((i, _WEDGE_MASTER_OBLIQUE_EVEN),
                              (i + 1, _WEDGE_MASTER_OBLIQUE_ODD)):
            s = shift if master is _WEDGE_MASTER_OBLIQUE_EVEN else shift - 1
            line = np.empty(64, np.uint8)
            if s >= 0:
                line[s:] = master[: 64 - s]
                line[:s] = master[0]
            else:
                line[: 64 + s] = master[-s:]
                line[64 + s :] = master[-1]
            m[0, WEDGE_OBLIQUE63, row] = line
        m[0, WEDGE_VERTICAL, i] = _WEDGE_MASTER_VERTICAL
        m[0, WEDGE_VERTICAL, i + 1] = _WEDGE_MASTER_VERTICAL
        shift -= 1
    msk = m[0, WEDGE_OBLIQUE63].astype(np.int32)
    m[0, WEDGE_OBLIQUE27] = msk.T
    m[0, WEDGE_OBLIQUE117] = (64 - msk)[:, ::-1]
    m[0, WEDGE_OBLIQUE153] = (64 - msk)[:, ::-1].T
    m[1, WEDGE_OBLIQUE63] = 64 - msk
    m[1, WEDGE_OBLIQUE27] = (64 - msk).T
    m[1, WEDGE_OBLIQUE117] = msk[:, ::-1]
    m[1, WEDGE_OBLIQUE153] = msk[:, ::-1].T
    mv = m[0, WEDGE_VERTICAL].astype(np.int32)
    m[0, WEDGE_HORIZONTAL] = mv.T
    m[1, WEDGE_VERTICAL] = 64 - mv
    m[1, WEDGE_HORIZONTAL] = (64 - mv).T
    _wedge_master = m
    return m


def wedge_mask(bsize: int, index: int, sign: int) -> np.ndarray:
    """get_wedge_mask_inplace: (bh, bw) uint8 weights in [0, 64]."""
    from ..normative.enums import BLOCK_WIDTH, BLOCK_HEIGHT
    master = _build_wedge_master()
    cb, sf = WEDGE_PARAMS[bsize]
    direction, x_off, y_off = cb[index]
    bw = int(BLOCK_WIDTH[bsize])
    bh = int(BLOCK_HEIGHT[bsize])
    woff = (x_off * bw) >> 3
    hoff = (y_off * bh) >> 3
    neg = sign ^ sf[index]
    r0 = 32 - hoff
    c0 = 32 - woff
    return master[neg, direction][r0 : r0 + bh, c0 : c0 + bw]


def build_compound_diffwtd_mask_d16(conv0, conv1, inverse: bool,
                                    bd: int = 8) -> np.ndarray:
    """av1_build_compound_diffwtd_mask_d16_c (mask_base = 38)."""
    rnd = 2 * FILTER_BITS - ROUND0 - ROUND1_COMPOUND + (bd - 8)
    diff = np.abs(conv0 - conv1)
    diff = (diff + (1 << (rnd - 1))) >> rnd
    m = np.clip(38 + diff // DIFF_FACTOR, 0, 64)
    return (64 - m if inverse else m).astype(np.uint8)


def blend_a64_d16_mask(conv0, conv1, mask, subw: int, subh: int,
                       bd: int = 8) -> np.ndarray:
    """aom_lowbd_blend_a64_d16_mask_c: blend two CONV_BUF intermediates
    under a (possibly luma-sized) 0..64 mask, then round to pixels."""
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    round_offset = (1 << (offset_bits - ROUND1_COMPOUND)) \
        + (1 << (offset_bits - ROUND1_COMPOUND - 1))
    round_bits = 2 * FILTER_BITS - ROUND0 - ROUND1_COMPOUND
    m = mask.astype(np.int32)
    if subw and subh:
        m = (m[0::2, 0::2] + m[0::2, 1::2] + m[1::2, 0::2]
             + m[1::2, 1::2] + 2) >> 2
    elif subw:
        m = (m[:, 0::2] + m[:, 1::2] + 1) >> 1
    elif subh:
        m = (m[0::2, :] + m[1::2, :] + 1) >> 1
    res = (m * conv0 + (64 - m) * conv1) >> 6
    res = res - round_offset
    res = (res + (1 << (round_bits - 1))) >> round_bits
    return np.clip(res, 0, (1 << bd) - 1)


# ---------------------------------------------------------------------------
# Interintra (reconinter.c:516 ii_weights1d / :532 build_smooth_interintra_mask)
II_WEIGHTS_1D = np.array([
    60, 58, 56, 54, 52, 50, 48, 47, 45, 44, 42, 41, 39, 38, 37, 35, 34, 33,
    32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 22, 21, 20, 19, 19, 18, 18,
    17, 16, 16, 15, 15, 14, 14, 13, 13, 12, 12, 12, 11, 11, 10, 10, 10, 9,
    9, 9, 8, 8, 8, 8, 7, 7, 7, 7, 6, 6, 6, 6, 6, 5, 5, 5, 5, 5, 4, 4, 4, 4,
    4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1], np.uint8)

II_SIZE_SCALES = np.array([32, 16, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2, 1, 1,
                           1, 8, 8, 4, 4, 2, 2], np.int32)

II_DC_PRED, II_V_PRED, II_H_PRED, II_SMOOTH_PRED = range(4)


def smooth_interintra_mask(mode: int, plane_bsize: int) -> np.ndarray:
    """build_smooth_interintra_mask: (bh, bw) 0..64 weights for the intra
    side of a non-wedge interintra blend."""
    from ..normative.enums import BLOCK_WIDTH, BLOCK_HEIGHT
    bw = int(BLOCK_WIDTH[plane_bsize])
    bh = int(BLOCK_HEIGHT[plane_bsize])
    scale = int(II_SIZE_SCALES[plane_bsize])
    if mode == II_V_PRED:
        col = II_WEIGHTS_1D[np.arange(bh) * scale]
        return np.broadcast_to(col[:, None], (bh, bw)).copy()
    if mode == II_H_PRED:
        row = II_WEIGHTS_1D[np.arange(bw) * scale]
        return np.broadcast_to(row[None, :], (bh, bw)).copy()
    if mode == II_SMOOTH_PRED:
        i = np.arange(bh)[:, None]
        j = np.arange(bw)[None, :]
        return II_WEIGHTS_1D[np.minimum(i, j) * scale]
    return np.full((bh, bw), 32, np.uint8)
