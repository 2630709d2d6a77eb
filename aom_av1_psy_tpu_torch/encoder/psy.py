"""Psychovisual tuning layer — the fork's delta (SURVEY §2.4/§2.10) plus
the tune-SSIM rdmult machinery it builds on, as batched array code.

- SSIM rdmult scaling: per-16x16 variance-driven factors, geometric-mean
  normalized (av1/encoder/encoder_utils.c:1281), applied per block with a
  geometric mean over covered 16x16 cells (encodeframe_utils.c:20).
- --tune-content=psy behaviors:
  * dark-region variance-AQ bias (partition_search.c:593-615,
    aq_variance.c:143): segments shifted -2..+1 by average luma.
  * subsampling-aware chroma delta-q (av1_quantize.c:870-891):
    4:2:0 -> -1, 4:2:2 -> 0, 4:4:4 -> +6.
  * temporal-filter strength 2 and +2 frame-count for non-KF
    (temporal_filter.c:815-831, :1060-1075) — constants used by the
    temporal filter once inter coding lands.
  * loop restoration restricted to SGRPROJ (pickrst.c:104-111),
    pixel-domain tx distortion (tx_search.c:2112), SB64 at low q
    (encoder_utils.c:786-790) — encoder policy flags.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PsyConfig:
    """Per-frame psy policy derived from --tune-content=psy."""

    enabled: bool = True
    chroma_deltaq: bool = True
    dark_bias: bool = True
    tf_strength: int = 2  # vs default 5
    tf_extra_frames_nonkf: int = 2
    sgr_only_restoration: bool = True
    pixel_domain_distortion: bool = True
    force_sb64_below_q: int = 30 * 4  # cq-level 30 in qindex units


def chroma_delta_q(subsampling_x: int, subsampling_y: int,
                   psy: bool = True) -> int:
    """Chroma dc/ac delta-q (av1_quantize.c:870-891)."""
    if not psy:
        return 6
    ss = subsampling_x + subsampling_y
    if ss == 2:
        return -1
    if ss == 1:
        return 0
    return 6


def dark_bias_adjustment(avg_brightness: int) -> int:
    """Variance-AQ segment shift for dark blocks (partition_search.c:608)."""
    if avg_brightness < 45:
        return -2
    if avg_brightness < 70:
        return -1
    if avg_brightness > 195:
        return 1
    return 0


def block_average(y_plane: np.ndarray, x: int, y: int, w: int, h: int) -> int:
    """av1_log_block_avg: integer mean of the luma block."""
    region = y_plane[y : y + h, x : x + w]
    n = region.size
    return int(region.sum()) // n if n else 0


def perpixel_variance_8x8(y_plane: np.ndarray) -> np.ndarray:
    """Per-pixel variance of every 8x8 block (av1_get_perpixel_variance):
    returns grid of var/64 as float."""
    h, w = y_plane.shape
    h8, w8 = h // 8, w // 8
    b = (y_plane[: h8 * 8, : w8 * 8]
         .reshape(h8, 8, w8, 8).transpose(0, 2, 1, 3)
         .reshape(h8, w8, 64).astype(np.int64))
    s = b.sum(-1)
    ss = (b * b).sum(-1)
    var = ss - (s * s) // 64
    return var.astype(np.float64) / 64.0


def ssim_rdmult_scaling_factors(y_plane: np.ndarray) -> np.ndarray:
    """Per-16x16 SSIM rdmult factors (encoder_utils.c:1281), vectorized.

    Returns (rows, cols) float array, geometric-mean normalized to 1."""
    h, w = y_plane.shape
    mi_rows = (h + 7) // 8 * 2
    mi_cols = (w + 7) // 8 * 2
    rows = (mi_rows + 3) // 4
    cols = (mi_cols + 3) // 4
    # pad to whole 8x8 grid covering the mi area
    ph, pw = mi_rows * 4, mi_cols * 4
    pad = np.zeros((ph, pw), y_plane.dtype)
    pad[:h, :w] = y_plane
    if w < pw:
        pad[:h, w:] = y_plane[:, -1:]
    if h < ph:
        pad[h:, :] = pad[h - 1 : h, :]
    v8 = perpixel_variance_8x8(pad)  # (mi_rows/2, mi_cols/2)
    # average the 8x8 vars within each 16x16 cell, honouring the mi clip
    factors = np.empty((rows, cols), np.float64)
    n8r, n8c = v8.shape
    for r in range(rows):
        for c in range(cols):
            r0, c0 = r * 2, c * 2
            r1 = min(r0 + 2, (mi_rows + 1) // 2)
            c1 = min(c0 + 2, (mi_cols + 1) // 2)
            r1 = min(r1, n8r)
            c1 = min(c1, n8c)
            var = float(v8[r0:r1, c0:c1].mean())
            factors[r, c] = 67.035434 * (1 - np.exp(-0.0021489 * var)) \
                + 17.492222
    geo = np.exp(np.log(factors).mean())
    return factors / geo


def ssim_scaled_rdmult(rdmult: int, factors: np.ndarray, mi_row: int,
                       mi_col: int, bsize_mi_w: int, bsize_mi_h: int) -> int:
    """av1_set_ssim_rdmult: geometric mean of factors covered by the block.

    NB: the reference indexes rows with mi_row/num_mi_w and cols with
    mi_col/num_mi_h (encodeframe_utils.c:38-41); for the square 16x16 base
    those divisors coincide."""
    rows, cols = factors.shape
    nb_c = (bsize_mi_w + 3) // 4
    nb_r = (bsize_mi_h + 3) // 4
    r0 = mi_row // 4
    c0 = mi_col // 4
    logs = []
    for r in range(r0, min(rows, r0 + nb_r)):
        for c in range(c0, min(cols, c0 + nb_c)):
            logs.append(np.log(factors[r, c]))
    if not logs:
        return rdmult
    geo = float(np.exp(np.mean(logs)))
    return max(int(rdmult * geo + 0.5), 0)


def butteraugli_lite_factors(y_plane: np.ndarray) -> np.ndarray:
    """Per-16x16 rdmult factors from a butteraugli-LITE sensitivity model
    (the role of av1_setup_butteraugli_rdmult, tune_butteraugli.c:132,
    without the external libjxl scorer).

    Butteraugli's dominant effects at this granularity are (a) contrast
    masking — high-frequency activity hides coding error, so textured
    blocks can carry a larger lambda — and (b) elevated sensitivity in
    dark regions (the psy fork's dark-bias motivation). The lite model:

        act   = mean |laplacian| of the block (fine-scale activity)
        mask  = (1 + act / A0) ** 0.7          (masking -> larger rdmult)
        dark  = 1 / (1 + D0 * exp(-mean_luma / 40))   (dark -> smaller)
        f     = mask * dark, geometric-mean normalized to 1

    Returns (rows, cols) float factors aligned with
    ssim_rdmult_scaling_factors' grid; apply like the SSIM grid.
    """
    h, w = y_plane.shape
    mi_rows = (h + 7) // 8 * 2
    mi_cols = (w + 7) // 8 * 2
    rows = (mi_rows + 3) // 4
    cols = (mi_cols + 3) // 4
    ph, pw = rows * 16, cols * 16
    pad = np.zeros((ph, pw), np.float64)
    pad[:h, :w] = y_plane.astype(np.float64)
    if w < pw:
        pad[:h, w:] = pad[:h, w - 1 : w]
    if h < ph:
        pad[h:, :] = pad[h - 1 : h, :]
    c = pad[1:-1, 1:-1]
    lap = np.abs(4 * c - pad[:-2, 1:-1] - pad[2:, 1:-1]
                 - pad[1:-1, :-2] - pad[1:-1, 2:])
    lappad = np.zeros_like(pad)
    lappad[1:-1, 1:-1] = lap
    # butteraugli pools WORST-CASE: a 16x16 cell straddling a dark/flat
    # and a textured region must inherit the sensitive part's factor
    # (mean pooling under-codes the sensitive half of boundary cells) —
    # so the per-8x8 factors are min-pooled into the 16 grid
    act8 = lappad.reshape(rows * 2, 8, cols * 2, 8).mean((1, 3))
    lum8 = pad.reshape(rows * 2, 8, cols * 2, 8).mean((1, 3))
    mask8 = (1.0 + act8 / 8.0) ** 0.7
    dark8 = 1.0 / (1.0 + 1.5 * np.exp(-lum8 / 40.0))
    f8 = mask8 * dark8
    f = f8.reshape(rows, 2, cols, 2).min((1, 3))
    f = f / np.exp(np.log(np.maximum(f, 1e-9)).mean())
    return np.clip(f, 0.25, 4.0)
