"""Inter-prediction convolution kernels — batched, bit-exact.

Replaces the reference's subpel convolve family
(``av1/common/convolve.c``: av1_convolve_2d_sr / x_sr / y_sr / 2d_copy and
the compound dist-wtd variants) with batched array code over ``(B, h, w)``
blocks. The 8/6/4-tap kernels come from the normative filter tables
(``av1/common/filter.h``, extracted in misc_tables.npz).
"""
from __future__ import annotations

import functools

import numpy as np

FILTER_BITS = 7
ROUND0_BITS = 3
COMPOUND_ROUND1_BITS = 7
SUBPEL_BITS = 4
SUBPEL_MASK = 15

EIGHTTAP_REGULAR, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR = 0, 1, 2, 3


@functools.cache
def _misc():
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "normative", "data", "misc_tables.npz")
    return np.load(path)


@functools.cache
def filter_kernels(interp: int, block_dim: int) -> np.ndarray:
    """(16, 8) int32 subpel kernels; 4-tap variants for dims <= 4
    (av1_get_interp_filter_params_with_block_size)."""
    m = _misc()
    if block_dim <= 4:
        # av1_interp_4tap: SHARP falls back to the regular 4-tap (filter.h:243)
        name = {EIGHTTAP_REGULAR: "subpel_filters_4",
                EIGHTTAP_SMOOTH: "subpel_filters_4smooth",
                EIGHTTAP_SHARP: "subpel_filters_4",
                BILINEAR: "bilinear_filters"}[interp]
    else:
        name = {EIGHTTAP_REGULAR: "subpel_filters_8",
                EIGHTTAP_SMOOTH: "subpel_filters_8smooth",
                EIGHTTAP_SHARP: "subpel_filters_8sharp",
                BILINEAR: "bilinear_filters"}[interp]
    return m[name].astype(np.int32)


def _xp(x):
    """numpy, the only array type of the host kernels."""
    if isinstance(x, np.ndarray):
        return np
    raise TypeError(f"numpy array expected, got {type(x).__name__}")


def _round2(v, bits):
    if bits == 0:
        return v
    return (v + (1 << (bits - 1))) >> bits


def convolve_2d_sr(src, w: int, h: int, x_kernel, y_kernel, bd: int = 8):
    """av1_convolve_2d_sr_c. src: (..., h+7, w+7) with the (3,3) filter
    origin offset baked in (src[...,3,3] is the top-left output tap center).
    x_kernel/y_kernel: 8-tap int arrays. Returns (..., h, w) pixels."""
    xp = _xp(src)
    x = src.astype(xp.int32)
    round0, round1 = ROUND0_BITS, 2 * FILTER_BITS - ROUND0_BITS
    bits = 2 * FILTER_BITS - round0 - round1  # == 0 for single-ref
    im = xp.zeros(x.shape[:-2] + (h + 7, w), xp.int32)
    off = 1 << (bd + FILTER_BITS - 1)
    for k in range(8):
        t = int(x_kernel[k])
        if t:
            im = im + t * x[..., :, k : k + w]
    im = _round2(im + off, round0)
    offset_bits = bd + 2 * FILTER_BITS - round0
    out = xp.zeros(x.shape[:-2] + (h, w), xp.int32)
    for k in range(8):
        t = int(y_kernel[k])
        if t:
            out = out + t * im[..., k : k + h, :]
    out = _round2(out + (1 << offset_bits), round1)
    out = out - ((1 << (offset_bits - round1))
                 + (1 << (offset_bits - round1 - 1)))
    out = _round2(out, bits)
    return xp.clip(out, 0, (1 << bd) - 1)


def convolve_x_sr(src, w: int, h: int, x_kernel, bd: int = 8):
    """av1_convolve_x_sr_c. src: (..., h, w+7)."""
    xp = _xp(src)
    x = src.astype(xp.int32)
    out = xp.zeros(x.shape[:-2] + (h, w), xp.int32)
    for k in range(8):
        t = int(x_kernel[k])
        if t:
            out = out + t * x[..., :h, k : k + w]
    out = _round2(out, ROUND0_BITS)
    out = _round2(out, FILTER_BITS - ROUND0_BITS)
    return xp.clip(out, 0, (1 << bd) - 1)


def convolve_y_sr(src, w: int, h: int, y_kernel, bd: int = 8):
    """av1_convolve_y_sr_c. src: (..., h+7, w)."""
    xp = _xp(src)
    x = src.astype(xp.int32)
    out = xp.zeros(x.shape[:-2] + (h, w), xp.int32)
    for k in range(8):
        t = int(y_kernel[k])
        if t:
            out = out + t * x[..., k : k + h, :w]
    out = _round2(out, FILTER_BITS)
    return xp.clip(out, 0, (1 << bd) - 1)


def predict_subpel(ref_padded, w: int, h: int, subpel_x: int, subpel_y: int,
                   interp_x: int = EIGHTTAP_REGULAR,
                   interp_y: int = EIGHTTAP_REGULAR, bd: int = 8):
    """Single-ref subpel motion-compensated prediction dispatch
    (av1_convolve_2d_facade): picks x/y/2d/copy path per subpel phase.

    ref_padded: (..., h+7, w+7) region whose [3,3] origin is the full-pel
    position of the block's top-left pixel."""
    xp = _xp(ref_padded)
    kx = filter_kernels(interp_x, w)[subpel_x & SUBPEL_MASK]
    ky = filter_kernels(interp_y, h)[subpel_y & SUBPEL_MASK]
    if subpel_x and subpel_y:
        return convolve_2d_sr(ref_padded, w, h, kx, ky, bd)
    if subpel_x:
        return convolve_x_sr(ref_padded[..., 3 : 3 + h, :], w, h, kx, bd)
    if subpel_y:
        return convolve_y_sr(ref_padded[..., :, 3 : 3 + w], w, h, ky, bd)
    return ref_padded[..., 3 : 3 + h, 3 : 3 + w].astype(xp.int32)


# ----------------------------------------------------------------------
# scaled-reference convolve (av1/common/convolve.c:371
# av1_convolve_2d_scale_c), single-ref path — the kernel behind inter
# prediction from a reference of a different size (resize / superres GOPs).
# ----------------------------------------------------------------------
SCALE_SUBPEL_BITS = 10                    # aom_dsp/aom_filter.h:28
SCALE_SUBPEL_MASK = (1 << SCALE_SUBPEL_BITS) - 1
SCALE_EXTRA_BITS = SCALE_SUBPEL_BITS - 4  # qn -> 1/16-pel filter index


def convolve_2d_scale(src, oy: int, ox: int, w: int, h: int,
                      x_filters: np.ndarray, y_filters: np.ndarray,
                      subpel_x_qn: int, x_step_qn: int,
                      subpel_y_qn: int, y_step_qn: int, bd: int = 8):
    """Scaled convolve, vectorized: each output column/row selects its own
    integer source position and 1/16-pel kernel from the 1/1024-unit
    position walk (x_qn += x_step_qn). src is the full padded reference
    plane; (oy, ox) is the position of the block's first integer sample.
    x_filters/y_filters: (16, taps) int32. Returns (h, w) uint8.
    """
    # 8-bit only: the round_0/round_1 split below is the bd==8 derivation
    # (get_conv_params adjusts rounds for bd>8 and the return dtype would
    # truncate) — matching the rest of the 8-bit-only ops surface
    assert bd == 8, "convolve_2d_scale implements the 8-bit rounding split"
    src = np.asarray(src, np.int32)
    taps_x, taps_y = x_filters.shape[1], y_filters.shape[1]
    fo_h, fo_v = taps_x // 2 - 1, taps_y // 2 - 1
    round0 = ROUND0_BITS
    round1 = 2 * FILTER_BITS - ROUND0_BITS
    bits = 2 * FILTER_BITS - round0 - round1
    im_h = (((h - 1) * y_step_qn + subpel_y_qn) >> SCALE_SUBPEL_BITS) + taps_y

    # horizontal pass over the im_h source rows
    x_qn = subpel_x_qn + np.arange(w, dtype=np.int64) * x_step_qn
    bx = (x_qn >> SCALE_SUBPEL_BITS).astype(np.int64)
    fx = ((x_qn & SCALE_SUBPEL_MASK) >> SCALE_EXTRA_BITS).astype(np.int64)
    cols = ox + bx[:, None] + np.arange(taps_x)[None, :] - fo_h   # (w, t)
    rows = oy - fo_v + np.arange(im_h)
    slab = src[rows[:, None, None], cols[None]]                   # (im_h,w,t)
    xf = x_filters[fx]                                            # (w, t)
    off = 1 << (bd + FILTER_BITS - 1)
    im = _round2(off + (slab * xf[None]).sum(-1), round0)         # (im_h, w)

    # vertical pass: per-output-row base row and kernel
    y_qn = subpel_y_qn + np.arange(h, dtype=np.int64) * y_step_qn
    by = (y_qn >> SCALE_SUBPEL_BITS).astype(np.int64)
    fy = ((y_qn & SCALE_SUBPEL_MASK) >> SCALE_EXTRA_BITS).astype(np.int64)
    ry = by[:, None] + np.arange(taps_y)[None, :]                 # (h, t)
    slab2 = im[ry]                                                # (h, t, w)
    yf = y_filters[fy]                                            # (h, t)
    offset_bits = bd + 2 * FILTER_BITS - round0
    res = _round2((1 << offset_bits) + (slab2 * yf[:, :, None]).sum(1),
                  round1)
    res = res - ((1 << (offset_bits - round1))
                 + (1 << (offset_bits - round1 - 1)))
    return np.clip(_round2(res, bits), 0, (1 << bd) - 1).astype(np.uint8)
