"""Film grain synthesis — normative AR-model grain generation + blend.

Re-implements the decoder-side film grain pipeline
(``av1/decoder/grain_synthesis.c``: av1_add_film_grain_run) with the
sequential line/column-buffer dance restructured as whole-frame array
ops: the tiny AR template generation stays a host-side scan (it is a
~70x80 recursive filter, once per parameter set), while per-frame work —
patch gather, overlap blending, scaling-LUT application — is batched
over the full block grid and is jit-friendly pointwise math.

Layout of the equivalence (vs grain_synthesis.c:1078 main loop):
for every 32x32 luma block, P = template patch at the per-block random
offset including 2 rows/cols of bottom/right extension; VB = P with its
first 2 columns blended 27/17 and 17/27 against the LEFT neighbour's
extension columns (ver_boundary_overlap :912); final = VB with its first
2 rows blended against the ABOVE neighbour's extension rows
(hor_boundary_overlap :941, using the above block's already-ver-blended
corner). Chroma uses 1-wide/1-tall 23/22 blends per subsampling.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

GAUSS_BITS = 11
LUMA_SUB = 32      # luma subblock size (grain_synthesis.c:221)
AR_PAD = 3         # max AR lag stabilization padding
TOP_PAD = 3
LEFT_PAD = 3
RIGHT_PAD = 3


@dataclasses.dataclass
class FilmGrainParams:
    """aom_film_grain_t analogue (aom_dsp/grain_params.h:32)."""

    apply_grain: int = 1
    update_parameters: int = 1
    scaling_points_y: np.ndarray = None    # (14, 2)
    num_y_points: int = 0
    scaling_points_cb: np.ndarray = None   # (10, 2)
    num_cb_points: int = 0
    scaling_points_cr: np.ndarray = None   # (10, 2)
    num_cr_points: int = 0
    scaling_shift: int = 8
    ar_coeff_lag: int = 3
    ar_coeffs_y: np.ndarray = None         # (24,)
    ar_coeffs_cb: np.ndarray = None        # (25,)
    ar_coeffs_cr: np.ndarray = None        # (25,)
    ar_coeff_shift: int = 6
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap_flag: int = 0
    clip_to_restricted_range: int = 0
    bit_depth: int = 8
    chroma_scaling_from_luma: int = 0
    grain_scale_shift: int = 0
    random_seed: int = 0


@functools.cache
def _gaussian_sequence() -> np.ndarray:
    """Normative 2048-entry Gaussian noise table (spec section 7.18.3;
    extracted by tools/dump_golden_grain.c)."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "normative", "data", "grain_tables.npz")
    return np.load(path)["gaussian_sequence"].astype(np.int64)


class _Lfsr:
    """16-bit Fibonacci LFSR random source (get_random_number :433)."""

    def __init__(self, register: int):
        self.r = register & 0xFFFF

    def bits(self, n: int) -> int:
        r = self.r
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.r = r
        return (r >> (16 - n)) & ((1 << n) - 1)

    def seq(self, count: int, n: int) -> np.ndarray:
        return np.array([self.bits(n) for _ in range(count)], np.int64)

    @staticmethod
    def for_line(luma_line: int, seed: int) -> "_Lfsr":
        """init_random_generator :442 — per-32-row reseed."""
        r = seed & 0xFFFF
        luma_num = luma_line >> 5
        r ^= ((luma_num * 37 + 178) & 255) << 8
        r ^= (luma_num * 173 + 105) & 255
        return _Lfsr(r)


def _grain_bounds(bit_depth: int):
    center = 128 << (bit_depth - 8)
    return -center, center - 1


def _ar_scan(block: np.ndarray, coeffs: np.ndarray, lag: int, shift: int,
             top: int, bottom: int, left: int, right: int,
             gmin: int, gmax: int,
             luma_avg: np.ndarray | None = None,
             luma_coeff: int = 0) -> None:
    """In-place causal AR filtering (generate_luma_grain_block :457).
    The num_pos taps are exactly the first 2*lag*(lag+1) raster entries
    of the (lag+1) x (2*lag+1) causal window."""
    H, W = block.shape
    num_pos = 2 * lag * (lag + 1)
    ro = 1 << (shift - 1)
    c = coeffs[:num_pos].astype(np.int64)
    for i in range(top, H - bottom):
        for j in range(left, W - right):
            win = block[i - lag : i + 1, j - lag : j + lag + 1].ravel()
            wsum = int(win[:num_pos] @ c)
            if luma_avg is not None:
                wsum += luma_coeff * int(luma_avg[i, j])
            v = block[i, j] + ((wsum + ro) >> shift)
            block[i, j] = min(max(v, gmin), gmax)


def generate_grain_templates(p: FilmGrainParams, ss_x: int, ss_y: int):
    """Generate the luma (73x82) and chroma grain templates, bit-exact
    (generate_luma_grain_block / generate_chroma_grain_blocks)."""
    bd = p.bit_depth
    gshift = 12 - bd + p.grain_scale_shift
    gmin, gmax = _grain_bounds(bd)
    gauss = _gaussian_sequence()
    lag = p.ar_coeff_lag

    lh = TOP_PAD + 2 * AR_PAD + LUMA_SUB * 2
    lw = LEFT_PAD + 2 * AR_PAD + LUMA_SUB * 2 + 2 * AR_PAD + RIGHT_PAD
    csub_y = LUMA_SUB >> ss_y
    csub_x = LUMA_SUB >> ss_x
    ch = TOP_PAD + (2 >> ss_y) * AR_PAD + csub_y * 2
    cw = (LEFT_PAD + (2 >> ss_x) * AR_PAD + csub_x * 2
          + (2 >> ss_x) * AR_PAD + RIGHT_PAD)

    rnd = _Lfsr(p.random_seed)
    if p.num_y_points == 0:
        luma = np.zeros((lh, lw), np.int64)
    else:
        raw = gauss[rnd.seq(lh * lw, GAUSS_BITS)]
        luma = ((raw + ((1 << gshift) >> 1)) >> gshift).reshape(lh, lw)
        _ar_scan(luma, p.ar_coeffs_y, lag, p.ar_coeff_shift,
                 TOP_PAD, 0, LEFT_PAD, RIGHT_PAD, gmin, gmax)

    gen_cb = p.num_cb_points or p.chroma_scaling_from_luma
    gen_cr = p.num_cr_points or p.chroma_scaling_from_luma
    cb = np.zeros((ch, cw), np.int64)
    cr = np.zeros((ch, cw), np.int64)
    if gen_cb:
        r = _Lfsr.for_line(7 << 5, p.random_seed)
        cb = ((gauss[r.seq(ch * cw, GAUSS_BITS)]
               + ((1 << gshift) >> 1)) >> gshift).reshape(ch, cw)
    if gen_cr:
        r = _Lfsr.for_line(11 << 5, p.random_seed)
        cr = ((gauss[r.seq(ch * cw, GAUSS_BITS)]
               + ((1 << gshift) >> 1)) >> gshift).reshape(ch, cw)

    if gen_cb or gen_cr:
        # optional last chroma tap predicts from the co-located luma avg
        luma_avg = None
        luma_cb = luma_cr = 0
        if p.num_y_points > 0:
            num_pos = 2 * lag * (lag + 1)
            luma_cb = int(p.ar_coeffs_cb[num_pos])
            luma_cr = int(p.ar_coeffs_cr[num_pos])
            luma_avg = np.zeros((ch, cw), np.int64)
            for i in range(TOP_PAD, ch):
                for j in range(LEFT_PAD, cw - RIGHT_PAD):
                    ly = ((i - TOP_PAD) << ss_y) + TOP_PAD
                    lx = ((j - LEFT_PAD) << ss_x) + LEFT_PAD
                    s = int(luma[ly : ly + ss_y + 1, lx : lx + ss_x + 1].sum())
                    luma_avg[i, j] = \
                        (s + ((1 << (ss_y + ss_x)) >> 1)) >> (ss_y + ss_x)
        if gen_cb:
            _ar_scan(cb, p.ar_coeffs_cb, lag, p.ar_coeff_shift,
                     TOP_PAD, 0, LEFT_PAD, RIGHT_PAD, gmin, gmax,
                     luma_avg, luma_cb)
        if gen_cr:
            _ar_scan(cr, p.ar_coeffs_cr, lag, p.ar_coeff_shift,
                     TOP_PAD, 0, LEFT_PAD, RIGHT_PAD, gmin, gmax,
                     luma_avg, luma_cr)
    return luma, cb, cr


def _block_offsets(p: FilmGrainParams, n_rows: int, n_cols: int):
    """Per-block template offsets, raster order with per-row reseed
    (grain_synthesis.c:1178-1183)."""
    offs = np.zeros((n_rows, n_cols, 2), np.int64)
    for r in range(n_rows):
        rnd = _Lfsr.for_line(r * LUMA_SUB, p.random_seed)
        for c in range(n_cols):
            v = rnd.bits(8)
            offs[r, c, 0] = v & 15          # offset_y
            offs[r, c, 1] = (v >> 4) & 15   # offset_x
    return offs


_BLEND_W = {1: np.array([[23, 22]]), 2: np.array([[27, 17], [17, 27]])}


def _assemble_noise(template: np.ndarray, offs: np.ndarray, base_y: int,
                    base_x: int, sub_y: int, sub_x: int, scale_y: int,
                    scale_x: int, overlap: bool, gmin: int, gmax: int,
                    out_h: int, out_w: int) -> np.ndarray:
    """Tile the template into a frame-sized noise plane with overlap
    blending, fully vectorized over the block grid.

    sub_y/sub_x: subblock dims; scale_* = 2>>ss offset multipliers; the
    overlap extension is scale wide/tall (2 px → 27/17 blend, 1 → 23/22)."""
    R, C = offs.shape[:2]
    ext_y, ext_x = scale_y, scale_x
    oy = base_y + offs[..., 0] * scale_y
    ox = base_x + offs[..., 1] * scale_x
    ky, kx = sub_y + ext_y, sub_x + ext_x
    ir = oy[..., None, None] + np.arange(ky)[None, None, :, None]
    ic = ox[..., None, None] + np.arange(kx)[None, None, None, :]
    P = template[ir, ic]                                      # (R,C,ky,kx)
    if overlap:
        VB = P.copy()
        w = _BLEND_W[ext_x]
        left = P[:, :-1, :, sub_x:]                           # extensions
        for j in range(ext_x):
            VB[:, 1:, :, j] = np.clip(
                (w[j, 0] * left[..., j] + w[j, 1] * P[:, 1:, :, j] + 16) >> 5,
                gmin, gmax)
        HB = VB.copy()
        w = _BLEND_W[ext_y]
        top = VB[:-1, :, sub_y:, :]
        for i in range(ext_y):
            HB[1:, :, i, :] = np.clip(
                (w[i, 0] * top[:, :, i, :] + w[i, 1] * VB[1:, :, i, :] + 16)
                >> 5, gmin, gmax)
        P = HB
    noise = (P[:, :, :sub_y, :sub_x].transpose(0, 2, 1, 3)
             .reshape(R * sub_y, C * sub_x))
    return noise[:out_h, :out_w]


def generate_noise_planes(p: FilmGrainParams, width: int, height: int,
                          ss_x: int, ss_y: int):
    """Frame-sized (Ny, Ncb, Ncr) grain planes (before scaling)."""
    gmin, gmax = _grain_bounds(p.bit_depth)
    luma_t, cb_t, cr_t = generate_grain_templates(p, ss_x, ss_y)
    n_rows = (height + LUMA_SUB - 1) // LUMA_SUB
    n_cols = (width + LUMA_SUB - 1) // LUMA_SUB
    offs = _block_offsets(p, n_rows, n_cols)
    base = LEFT_PAD + 2 * AR_PAD
    ny = _assemble_noise(luma_t, offs, base, base, LUMA_SUB, LUMA_SUB, 2, 2,
                         bool(p.overlap_flag), gmin, gmax, height, width)
    cbase_y = TOP_PAD + (2 >> ss_y) * AR_PAD
    cbase_x = LEFT_PAD + (2 >> ss_x) * AR_PAD
    ch, cw = height >> ss_y, width >> ss_x
    ncb = _assemble_noise(cb_t, offs, cbase_y, cbase_x, LUMA_SUB >> ss_y,
                          LUMA_SUB >> ss_x, 2 >> ss_y, 2 >> ss_x,
                          bool(p.overlap_flag), gmin, gmax, ch, cw)
    ncr = _assemble_noise(cr_t, offs, cbase_y, cbase_x, LUMA_SUB >> ss_y,
                          LUMA_SUB >> ss_x, 2 >> ss_y, 2 >> ss_x,
                          bool(p.overlap_flag), gmin, gmax, ch, cw)
    return ny, ncb, ncr


def _scaling_lut(points: np.ndarray, num_points: int) -> np.ndarray:
    """Piecewise-linear scaling LUT (init_scaling_function :591)."""
    lut = np.zeros(256, np.int64)
    if num_points == 0:
        return lut
    pts = points[:num_points].astype(np.int64)
    lut[: pts[0, 0]] = pts[0, 1]
    for k in range(num_points - 1):
        x0, y0 = pts[k]
        x1, y1 = pts[k + 1]
        dx, dy = int(x1 - x0), int(y1 - y0)
        delta = dy * ((65536 + (dx >> 1)) // dx)
        xs = np.arange(dx)
        lut[x0 : x0 + dx] = y0 + ((xs * delta + 32768) >> 16)
    lut[pts[num_points - 1, 0] :] = pts[num_points - 1, 1]
    return lut


def apply_film_grain(p: FilmGrainParams, y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray, ss_x: int = 1, ss_y: int = 1,
                     mc_identity: bool = False):
    """Add grain to an 8-bit YUV frame (av1_add_film_grain_run :1078).
    Planes must have even dimensions (the iface pads odd frames).
    Returns new (y, cb, cr) uint8 planes."""
    assert p.bit_depth == 8, "HBD grain: round-2"
    height, width = y.shape
    ny, ncb, ncr = generate_noise_planes(p, width, height, ss_x, ss_y)

    lut_y = _scaling_lut(p.scaling_points_y, p.num_y_points)
    if p.chroma_scaling_from_luma:
        lut_cb = lut_cr = lut_y
    else:
        lut_cb = _scaling_lut(p.scaling_points_cb, p.num_cb_points)
        lut_cr = _scaling_lut(p.scaling_points_cr, p.num_cr_points)

    ro = 1 << (p.scaling_shift - 1)
    if p.clip_to_restricted_range:
        min_l, max_l = 16, 235
        min_c, max_c = (16, 235) if mc_identity else (16, 240)
    else:
        min_l = min_c = 0
        max_l = max_c = 255

    y64 = y.astype(np.int64)
    out_y = y
    if p.num_y_points > 0:
        out_y = np.clip(
            y64 + ((lut_y[y64] * ny + ro) >> p.scaling_shift),
            min_l, max_l).astype(np.uint8)

    # chroma: luma-conditioned scaling index (add_noise_to_block :682)
    if ss_x:
        avg = (y64[:: 1 << ss_y, ::2] + y64[:: 1 << ss_y, 1::2] + 1) >> 1
    else:
        avg = y64[:: 1 << ss_y, :]
    avg = avg[: cb.shape[0], : cb.shape[1]]

    def chroma(plane, lut, noise, mult, luma_mult, offset):
        p64 = plane.astype(np.int64)
        if p.chroma_scaling_from_luma:
            mult, luma_mult, offset = 0, 64, 0
        else:
            mult, luma_mult, offset = mult - 128, luma_mult - 128, offset - 256
        idx = np.clip(((avg * luma_mult + mult * p64) >> 6) + offset, 0, 255)
        return np.clip(p64 + ((lut[idx] * noise + ro) >> p.scaling_shift),
                       min_c, max_c).astype(np.uint8)

    out_cb, out_cr = cb, cr
    if p.num_cb_points > 0 or p.chroma_scaling_from_luma:
        out_cb = chroma(cb, lut_cb, ncb, p.cb_mult, p.cb_luma_mult,
                        p.cb_offset)
    if p.num_cr_points > 0 or p.chroma_scaling_from_luma:
        out_cr = chroma(cr, lut_cr, ncr, p.cr_mult, p.cr_luma_mult,
                        p.cr_offset)
    return out_y, out_cb, out_cr
