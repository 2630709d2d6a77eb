"""All-intra plans — torch counterpart of
``aom_av1_psy_tpu/encoder/tpu_intra.py``: the two-level (32 -> 16)
partition plan (``plan_frame_part``; ``plan_tiles_part`` for T equal tile
slabs at once) and the uniform-grid fallback (``plan_frame``).

The reference runs each wavefront as one ``lax.scan`` over the
anti-diagonals of the block grid; here a host loop walks the R+C-1
diagonals and every step is a handful of device ops: kernel KA
(``ops/intra_pred.py``) scores all candidates of the diagonal's cells, the
RD pick is torch ops on the device, KA re-predicts the winner, kernel KB
(``ops/txq.py``) quantizes, reconstructs and (on the partition plan) makes
the skip decision. The cells of a diagonal are known on the host, so only
the valid cells are processed (the reference computes padding lanes and
drops them) and the loop never waits for the device. The partition
wavefronts carry a leading tile axis: tiles are prediction-independent, so
the cells of one diagonal in all T slabs form one batch (a frame without
tile columns is T = 1). The plan reaches the host in one copy.

The building blocks keep the reference's names: ``_predict_all_modes`` is
KA's plain half (``ops/intra_pred.py``); ``_quantize``, ``_dequantize``,
``_coeff_rate_est`` and ``_skip_rd`` are KB's (``ops/txq.py``). The host
cost tables (``_plan_cost_tables*``, ``_rate_tables``,
``_part_rate_scalars``, ``plan_part_supported``) are carried over from the
reference, which cannot be imported here (it imports jax at top level).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from aom_av1_psy_tpu.normative import tables
from aom_av1_psy_tpu.normative.blocks import (INTRA_MODE_CONTEXT,
                                              INTRA_MODE_TO_TX_TYPE)
from aom_av1_psy_tpu.normative.enums import TxSize
from .. import convert
from ..ops import intra_pred as IP
from ..ops import txq as TQ
from . import tpu_intra_dir as DIR

# plan mode set: no top-right/bottom-left extensions, no edge filtering
PLAN_MODES = (0, 1, 2, 9, 10, 11, 12)  # DC V H SMOOTH SMOOTH_V SMOOTH_H PAETH
BS_TO_TX = {4: int(TxSize.TX_4X4), 8: int(TxSize.TX_8X8),
            16: int(TxSize.TX_16X16), 32: int(TxSize.TX_32X32)}
_QUADS = ((0, 0), (0, 1), (1, 0), (1, 1))
_IMC = tuple(int(v) for v in INTRA_MODE_CONTEXT)
_IM2TT = tuple(int(v) for v in INTRA_MODE_TO_TX_TYPE)

_predict_all_modes = IP.predict_all_modes
_quantize = TQ.quantize
_dequantize = TQ.dequantize
_coeff_rate_est = TQ.coeff_rate_est
_skip_rd = TQ.skip_rd


def _uv_adst(uv_mode):
    """(vertical, horizontal) ADST flags of the mode-DERIVED chroma tx type
    (decoder/frame.py:_uv_tx_type: INTRA_MODE_TO_TX_TYPE[uv_mode])."""
    tt = _const(_IM2TT, str(uv_mode.device))[uv_mode.long()]
    return (tt == 1) | (tt == 3), (tt == 2) | (tt == 3)


def _tq_recon(src, pred, dc_q, ac_q, tx_size, scan):
    """(B,bs,bs) src/pred -> (levels (B,n), eob (B,), recon (B,bs,bs)),
    DCT_DCT."""
    assert BS_TO_TX[src.shape[-1]] == tx_size
    return TQ.tq_recon(src, pred, dc_q, ac_q, scan)


def _tq_recon_uv(src, pred, dc_q, ac_q, tx_size, scan, uv_mode):
    """Chroma TQ+recon with the tx type derived from the (B,) uv modes."""
    assert BS_TO_TX[src.shape[-1]] == tx_size
    va, ha = _uv_adst(uv_mode)
    return TQ.tq_recon(src, pred, dc_q, ac_q, scan, va, ha)


def _rd(sse, rate, rdmult):
    # RDCOST scaling (ec/costs.rdcost): (rate*rdmult)>>9 + (sse<<11) in
    # float32, in the reference's order of operations — decision-only
    return sse.to(torch.float32) * 2048.0 + \
        rate.to(torch.float32) * (rdmult / 512.0)


@functools.cache
def _const(values: tuple, device: str):
    return torch.as_tensor(values, device=device)


@functools.cache
def _scan(tx_size: int, device: str):
    return torch.as_tensor(tables.scan_table(tx_size, 0).astype(np.int32),
                           device=device)


# ----------------------------------------------------------------------
# host-side cost tables (carried over from the reference)
# ----------------------------------------------------------------------
def _plan_cost_tables(fc):
    from aom_av1_psy_tpu.ec.costs import cdf_cost_table
    m = len(PLAN_MODES)
    kf = np.zeros((5, 5, m), np.int32)
    for a in range(5):
        for l in range(5):
            t = cdf_cost_table(fc.kf_y_cdf[a][l], 13)
            kf[a, l] = t[list(PLAN_MODES)]
    # angle_delta symbol 3 (delta 0) for directional modes V(1)/H(2)
    angle = np.zeros(m, np.int32)
    for i, mode in enumerate(PLAN_MODES):
        if mode in (1, 2):
            angle[i] = cdf_cost_table(fc.angle_delta_cdf[mode - 1], 7)[3]
    uv = np.zeros((13, m), np.int32)
    for ym in range(13):
        t = cdf_cost_table(fc.uv_mode_cdf[1][ym], 14)
        uv[ym] = t[list(PLAN_MODES)]
        for i, mode in enumerate(PLAN_MODES):
            if mode in (1, 2):
                uv[ym, i] += angle[i]
    return kf, angle, uv


def _plan_cost_tables2(fc):
    """kf (5, 5, K) luma mode cost per neighbour ctx, angle (K,) the
    angle-delta symbol cost (0 for non-directional), uv (13, 7)."""
    from aom_av1_psy_tpu.ec.costs import cdf_cost_table
    cands = DIR.candidates()
    K = len(cands)
    modes = [m for m, _, _ in cands]
    kf = np.zeros((5, 5, K), np.int32)
    for a in range(5):
        for l in range(5):
            t = cdf_cost_table(fc.kf_y_cdf[a][l], 13)
            kf[a, l] = t[modes]
    angle = np.zeros(K, np.int32)
    for i, (mode, delta, _c) in enumerate(cands):
        if 1 <= mode <= 8:
            angle[i] = cdf_cost_table(fc.angle_delta_cdf[mode - 1],
                                      7)[delta + 3]
    _kf7, _a7, uv = _plan_cost_tables(fc)
    return kf, angle, uv


def _rate_tables(fc):
    """Coefficient-rate tables per (tx size, plane) as numpy pairs
    (ec/costs.coeff_rate_tables). The level costs must be half-integers:
    the device sums them exactly in half units."""
    from aom_av1_psy_tpu.ec.costs import coeff_rate_tables

    def pair(tx, pl):
        lvl, eob = coeff_rate_tables(fc, tx, pl)
        if not np.array_equal(lvl * 2, np.round(lvl * 2)):
            raise ValueError("coefficient level costs must be half-integers")
        return lvl, eob

    return {"y32": pair(int(TxSize.TX_32X32), 0),
            "y16": pair(int(TxSize.TX_16X16), 0),
            "uv16": pair(int(TxSize.TX_16X16), 1),
            "uv8": pair(int(TxSize.TX_8X8), 1)}


def _part_rate_scalars(fc):
    """Default-CDF costs of PARTITION_NONE / PARTITION_SPLIT at the
    32x32 bsize (ctx: bsl=2, no-split neighbours) — decision-only."""
    from aom_av1_psy_tpu.ec.costs import cdf_cost_table
    t = cdf_cost_table(fc.partition_cdf[8], 10)
    return float(t[0]), float(t[3])


def plan_part_supported(mi_rows: int, mi_cols: int) -> bool:
    """True when every frame-edge cell has a square-leaf coding (a cell
    that the decoder implies SPLIT must not contain partial 16s)."""
    return mi_rows % 8 != 2 and mi_cols % 8 != 2


def edge_cell_masks(R: int, C: int, mi_rows: int, mi_cols: int):
    """(forced, no_split) (R, C) bool masks of the 32-px cells: splits the
    decoder implies at the frame edge (has_rows/has_cols false), and cells
    that must NOT split because a visited 16 sub-block would be partial
    (no square leaf available there). Shared by the intra and inter
    plans, as in the reference."""
    rr = 8 * np.arange(R)[:, None]
    cc = 8 * np.arange(C)[None, :]
    forced = ((rr + 4 >= mi_rows) | (cc + 4 >= mi_cols))
    no_split = np.zeros((R, C), bool)
    for qr in (0, 1):
        for qc in (0, 1):
            sr, sc = rr + 4 * qr, cc + 4 * qc
            visited = (sr < mi_rows) & (sc < mi_cols)
            partial = visited & ((sr + 2 >= mi_rows) | (sc + 2 >= mi_cols))
            no_split |= partial
    assert not (forced & no_split).any(), "unsupported mi dims for part2"
    return forced, no_split


def shared_inputs(R: int, C: int, q: int, fc) -> dict:
    """The host inputs of the two-level plan that every tile shares: the
    quantizers, mode cost tables, coefficient-rate tables and partition
    rates."""
    kf_cost, angle_cost, uv_cost = _plan_cost_tables2(fc)
    pr_none, pr_split = _part_rate_scalars(fc)
    return {"R": R, "C": C, "dc_q": tables.dc_quant(q),
            "ac_q": tables.ac_quant(q), "kf_cost": kf_cost,
            "angle_cost": angle_cost, "uv_cost": uv_cost,
            "pr_none": pr_none, "pr_split": pr_split,
            "rt": _rate_tables(fc)}


def tile_inputs(R: int, C: int, rdmult, mi_rows: int, mi_cols: int,
                tile_mi_w: int | None = None,
                vis_mi_w: int | None = None) -> dict:
    """The host inputs of the two-level plan that belong to one tile slab:
    the 16/32 lambda grids, the candidate position masks (bounded by the
    tile's actual mi width ``tile_mi_w`` and its visible mi width
    ``vis_mi_w``, both ``mi_cols`` by default) and the forced / no_split
    edge-cell masks (``mi_cols`` is the slab's effective mi width)."""
    masks = DIR.position_masks(
        mi_rows, tile_mi_w if tile_mi_w is not None else mi_cols,
        vis_mi_w if vis_mi_w is not None else mi_cols, R, C)
    rd16 = np.asarray(rdmult, np.float32)
    if rd16.ndim == 0:
        rd16 = np.full((2 * R, 2 * C), float(rdmult), np.float32)
    assert rd16.shape == (2 * R, 2 * C), (rd16.shape, R, C)
    # 32-lambda: geometric mean of the four covered 16 lambdas
    rd32 = np.exp(np.log(rd16).reshape(R, 2, C, 2).mean((1, 3))) \
        .astype(np.float32)
    forced, no_split = edge_cell_masks(R, C, mi_rows, mi_cols)
    return {"rd16": rd16, "rd32": rd32, "forced": forced,
            "no_split": no_split, "masks": masks}


def part_inputs(R: int, C: int, q: int, fc, rdmult, mi_rows: int,
                mi_cols: int, tile_mi_w: int | None = None,
                vis_mi_w: int | None = None) -> dict:
    """Host-side inputs of the two-level plan as numpy, built exactly as the
    reference's ``plan_frame_part`` builds them before its device calls:
    cost and rate tables, candidate position masks, the 16/32 lambda grids
    and the forced / no_split edge-cell masks."""
    return {**shared_inputs(R, C, q, fc),
            **tile_inputs(R, C, rdmult, mi_rows, mi_cols, tile_mi_w,
                          vis_mi_w)}


def stack_tiles(shared: dict, tiles: list) -> dict:
    """One input dict for T equal tile slabs: each ``tile_inputs`` array
    (lambda grids, edge-cell and position masks) gains a leading tile
    axis; the ``shared_inputs`` pass through."""
    out = dict(shared)
    for k in ("rd16", "rd32", "forced", "no_split"):
        out[k] = np.stack([d[k] for d in tiles])
    out["masks"] = {k: np.stack([d["masks"][k] for d in tiles])
                    for k in tiles[0]["masks"]}
    return out


# ----------------------------------------------------------------------
# wavefronts
# ----------------------------------------------------------------------
@functools.cache
def _diagonals(R: int, C: int, T: int = 1):
    """Cells of each anti-diagonal d = r + c of T (R, C) grids, each
    tile's cells in the reference's lane order, tile after tile: flat
    tile/row/col arrays and per-diagonal offsets."""
    tiles, rows, cols, offs = [], [], [], [0]
    for d in range(R + C - 1):
        r = np.arange(max(0, d - (C - 1)), min(R - 1, d) + 1)
        tiles.append(np.repeat(np.arange(T), len(r)))
        rows.append(np.tile(r, T))
        cols.append(np.tile(d - r, T))
        offs.append(offs[-1] + T * len(r))
    return (np.concatenate(tiles), np.concatenate(rows),
            np.concatenate(cols), tuple(offs))


def _walk(R: int, C: int, device, T: int = 1):
    """Yield (tt, rc, cc) int64 device tensors per diagonal (one upload):
    the tile, row and column of every cell of the diagonal in T grids."""
    tiles, rows, cols, offs = _diagonals(R, C, T)
    all_ = [torch.as_tensor(a, device=device) for a in (tiles, rows, cols)]
    for d in range(R + C - 1):
        yield tuple(a[offs[d]:offs[d + 1]] for a in all_)


def _edges(buf, tt, by, bx, bs: int):
    """Above row, left column and corner of blocks at (by, bx) of tile tt
    of a (T, H, W) buffer with a 1-px guard border ((by, bx) are block
    origins + 1)."""
    ar = torch.arange(bs, device=buf.device)
    t1 = tt[:, None]
    above = buf[t1, (by - 1)[:, None], bx[:, None] + ar]
    left = buf[t1, by[:, None] + ar, (bx - 1)[:, None]]
    tl = buf[tt, by - 1, bx - 1]
    return above, left, tl


def _block_index(tt, by, bx, bs: int):
    ar = torch.arange(bs, device=by.device)
    return tt[:, None, None], by[:, None, None] + ar[None, :, None], \
        bx[:, None, None] + ar[None, None, :]


def _smooth(m):
    return (m >= 9) & (m <= 11)


def _luma_wavefront_part(src, t: dict):
    """Two-level luma wavefront over 32px cells with the full candidate set
    (7 plain modes + the directional (mode, delta) pairs), over T tile
    slabs at once: tiles are prediction-independent, so every diagonal
    step runs the cells of all T tiles as one batch.

    src: (T, R*32, C*32) int32 on the device; ``t`` the plan inputs as
    tensors (``convert.inputs_from_numpy`` of ``stack_tiles``). Returns
    (split (T,R,C), m32 (AV1 mode), d32 (angle delta), lv32, eob32, m16,
    d16, lv16, eob16, recon (T, R*32, C*32))."""
    R, C = t["R"], t["C"]
    T = src.shape[0]
    dev = src.device
    dc_q, ac_q = t["dc_q"], t["ac_q"]
    masks = t["masks"]
    K = len(DIR.candidates())
    tab32, tab16 = DIR.tables_on(32, str(dev)), DIR.tables_on(16, str(dev))
    scan32 = _scan(BS_TO_TX[32], str(dev))
    scan16 = _scan(BS_TO_TX[16], str(dev))
    imc = _const(_IMC, str(dev))
    mode_cost, angle_cost = t["kf_cost"], t["angle_cost"]
    rd16, rd32 = t["rd16"], t["rd32"]
    pr_none, pr_split = t["pr_none"], t["pr_split"]
    rt32, rt16 = t["rt"]["y32"], t["rt"]["y16"]
    H, W = R * 32, C * 32
    i32 = dict(dtype=torch.int32, device=dev)
    buf = torch.zeros((T, H + 2 + 32, W + 2 + 32), **i32)
    mode16 = torch.zeros((T, 2 * R, 2 * C), **i32)   # AV1 mode ctx map
    split_out = torch.zeros((T, R, C), **i32)
    m32o = torch.zeros((T, R, C), **i32)
    d32o = torch.zeros((T, R, C), **i32)
    lv32o = torch.zeros((T, R, C, 1024), **i32)
    e32o = torch.zeros((T, R, C), **i32)
    m16o = torch.zeros((T, 2 * R, 2 * C), **i32)
    d16o = torch.zeros((T, 2 * R, 2 * C), **i32)
    lv16o = torch.zeros((T, 2 * R, 2 * C, 256), **i32)
    e16o = torch.zeros((T, 2 * R, 2 * C), **i32)
    src4 = src.view(T, R, 32, C, 32)
    inf = torch.tensor(float("inf"), device=dev)

    def mode_rate(am, lm):
        # am/lm are AV1 mode ids of the neighbours -> (B, K)
        return mode_cost[imc[am.long()], imc[lm.long()]] + angle_cost[None, :]

    for tt, rc, cc in _walk(R, C, dev, T):
        by, bx = rc * 32 + 1, cc * 32 + 1
        have_a, have_l = rc > 0, cc > 0
        above, left, tl = _edges(buf, tt, by, bx, 32)
        src32 = src4[tt, rc, :, cc, :]                         # (B,32,32)
        zero = torch.zeros_like(rc, dtype=torch.int32)

        # ---- 32 path ----
        am = torch.where(have_a, mode16[tt, 2 * rc - 1, 2 * cc], zero)
        lm = torch.where(have_l,
                         mode16[tt, 2 * rc, (2 * cc - 1).clamp(min=0)], zero)
        ef = (_smooth(am) & have_a) | (_smooth(lm) & have_l)
        ssep = IP.intra_pred_sse(above, left, tl, have_a, have_l, src32, K,
                                 ef=ef)                         # (K,B)
        allowed = DIR.allowed_mask(masks["ok1_32"][tt, rc, cc],
                                   masks["ok2_32"][tt, rc, cc],
                                   masks["ok3_32"][tt, rc, cc], 32)
        rate32 = mode_rate(am, lm)                              # (B,K)
        rdm32 = rd32[tt, rc, cc]
        # disallowed candidates are masked in the RD domain: a candidate
        # whose edge model mismatches the decoder's must never win
        best32 = torch.where(allowed, _rd(ssep, rate32.T, rdm32),
                             inf).argmin(0)
        ymode32 = tab32["MODE"][best32]
        ydelta32 = tab32["DELTA"][best32]
        pred32 = IP.intra_pred_one(above, left, tl, have_a, have_l, best32,
                                   K, ef=ef)
        lv32, e32, rec32, sse32, crate32 = TQ.txq_recon_skip(
            src32, pred32, dc_q, ac_q, scan32, rdm32, *rt32)
        mrate32 = rate32.gather(1, best32[:, None])[:, 0]
        cost32 = 2048.0 * sse32 + (rdm32 / 512.0) * (
            mrate32.to(torch.float32) + crate32 + pr_none)

        # ---- 16 path (4 sub-blocks, raster order, local recon) ----
        B = rc.shape[0]
        loc = torch.zeros((B, 34, 34), **i32)
        loc[:, 0, 1:33] = above
        loc[:, 1:33, 0] = left
        loc[:, 0, 0] = tl
        cost16 = torch.zeros((B,), dtype=torch.float32, device=dev)
        sub_modes = {}
        subs = []
        for qr, qc in _QUADS:
            a = loc[:, qr * 16, 1 + qc * 16:17 + qc * 16]
            l = loc[:, 1 + qr * 16:17 + qr * 16, qc * 16]
            tq = loc[:, qr * 16, qc * 16]
            ha = have_a | (qr > 0)
            hl = have_l | (qc > 0)
            i16, j16 = 2 * rc + qr, 2 * cc + qc
            if qr == 0:
                am = torch.where(have_a, mode16[tt, 2 * rc - 1, j16], zero)
            else:
                am = sub_modes[(0, qc)]
            if qc == 0:
                lm = torch.where(have_l, mode16[tt, i16,
                                                (2 * cc - 1).clamp(min=0)],
                                 zero)
            else:
                lm = sub_modes[(qr, 0)]
            ef16 = (_smooth(am) & ha) | (_smooth(lm) & hl)
            # real extension pixels in wavefront+Z order: top-right row =
            # loc row qr*16 cols 17..32, bottom-left col = loc col 0/16
            aext = loc[:, qr * 16, 17:33]
            lext = loc[:, 17:33, qc * 16]
            trr = masks["trreal_16"][tt, i16, j16]
            blr = masks["blreal_16"][tt, i16, j16]
            s16 = src32[:, qr * 16:qr * 16 + 16, qc * 16:qc * 16 + 16]
            sp = IP.intra_pred_sse(a, l, tq, ha, hl, s16, K, trr, blr, aext,
                                   lext, ef16)
            allowed16 = DIR.allowed_mask(masks["ok1_16"][tt, i16, j16],
                                         masks["ok2_16"][tt, i16, j16],
                                         masks["ok3_16"][tt, i16, j16], 16)
            r16 = mode_rate(am, lm)
            rdm16 = rd16[tt, i16, j16]
            b16 = torch.where(allowed16, _rd(sp, r16.T, rdm16),
                              inf).argmin(0)
            ymode16 = tab16["MODE"][b16]
            ydelta16 = tab16["DELTA"][b16]
            pr = IP.intra_pred_one(a, l, tq, ha, hl, b16, K, trr, blr, aext,
                                   lext, ef16)
            lv, e, rec, sse, crate = TQ.txq_recon_skip(
                s16, pr, dc_q, ac_q, scan16, rdm16, *rt16)
            mrate = r16.gather(1, b16[:, None])[:, 0]
            cost16 = cost16 + 2048.0 * sse + (rdm16 / 512.0) * (
                mrate.to(torch.float32) + crate)
            loc[:, 1 + qr * 16:17 + qr * 16, 1 + qc * 16:17 + qc * 16] = rec
            sub_modes[(qr, qc)] = ymode16
            subs.append((ymode16, ydelta16, lv, e))
        cost16 = cost16 + (rdm32 / 512.0) * pr_split

        split = t["forced"][tt, rc, cc] | ((cost16 < cost32)
                                           & ~t["no_split"][tt, rc, cc])
        recon = torch.where(split[:, None, None], loc[:, 1:33, 1:33], rec32)
        buf[_block_index(tt, by, bx, 32)] = recon
        split_out[tt, rc, cc] = split.to(torch.int32)
        m32o[tt, rc, cc] = ymode32
        d32o[tt, rc, cc] = ydelta32
        lv32o[tt, rc, cc] = lv32
        e32o[tt, rc, cc] = e32
        for (qr, qc), (ym16, yd16, lv, e) in zip(_QUADS, subs):
            rq, cq = 2 * rc + qr, 2 * cc + qc
            m16o[tt, rq, cq] = ym16
            d16o[tt, rq, cq] = yd16
            lv16o[tt, rq, cq] = lv
            e16o[tt, rq, cq] = e
            # ctx map: chosen sub mode where split else the 32 mode
            mode16[tt, rq, cq] = torch.where(split, ym16, ymode32)
    return (split_out, m32o, d32o, lv32o, e32o, m16o, d16o, lv16o, e16o,
            buf[:, 1:1 + H, 1:1 + W])


def _chroma_wavefront_part(src_u, src_v, t: dict, split32, y_m32, y_m16):
    """Two-level chroma wavefront over 16px chroma cells (4:2:0 mirror of
    the luma 32/16 partition) of T tile slabs at once. The structure
    follows the luma split map; both alternatives are reconstructed and
    selected by ``split32``. The U and V blocks of a step run as one batch
    of 2B blocks.

    src_u/src_v: (T, R*16, C*16). Returns (uvm16 (T,R,C), uvlv16
    (T,2,R,C,256), uveob16 (T,2,R,C), uvm8 (T,2R,2C), uvlv8 (T,2,2R,2C,64),
    uveob8 (T,2,2R,2C), recon (2,T,H,W))."""
    R, C = t["R"], t["C"]
    T = src_u.shape[0]
    dev = src_u.device
    dc_q, ac_q = t["dc_q"], t["ac_q"]
    uv_cost = t["uv_cost"]
    rd16, rd32 = t["rd16"], t["rd32"]
    rtc16, rtc8 = t["rt"]["uv16"], t["rt"]["uv8"]
    scan16 = _scan(BS_TO_TX[16], str(dev))
    scan8 = _scan(BS_TO_TX[8], str(dev))
    H, W = R * 16, C * 16
    i32 = dict(dtype=torch.int32, device=dev)
    bufs = torch.zeros((2, T, H + 2 + 16, W + 2 + 16), **i32)
    plan_modes = _const(PLAN_MODES, str(dev))
    uvm16o = torch.zeros((T, R, C), **i32)
    uvlv16o = torch.zeros((T, 2, R, C, 256), **i32)
    uve16o = torch.zeros((T, 2, R, C), **i32)
    uvm8o = torch.zeros((T, 2 * R, 2 * C), **i32)
    uvlv8o = torch.zeros((T, 2, 2 * R, 2 * C, 64), **i32)
    uve8o = torch.zeros((T, 2, 2 * R, 2 * C), **i32)
    srcs4 = (src_u.view(T, R, 16, C, 16), src_v.view(T, R, 16, C, 16))

    def both(x):
        return torch.cat([x, x])

    for tt, rc, cc in _walk(R, C, dev, T):
        B = rc.shape[0]
        by, bx = rc * 16 + 1, cc * 16 + 1
        have_a, have_l = both(rc > 0), both(cc > 0)
        split = split32[tt, rc, cc].bool()
        rdm32 = rd32[tt, rc, cc]
        sb = torch.cat([s4[tt, rc, :, cc, :] for s4 in srcs4])  # (2B,16,16)
        edges = [_edges(bufs[p], tt, by, bx, 16) for p in range(2)]
        a, l, tl = (torch.cat([e[i] for e in edges]) for i in range(3))

        # ---- 16 path (single chroma block per plane) ----
        ym32 = y_m32[tt, rc, cc]                    # AV1 mode ids
        s2 = IP.intra_pred_sse(a, l, tl, have_a, have_l, sb, 7)
        sse16 = s2[:, :B] + s2[:, B:]
        best16 = _rd(sse16, uv_cost[ym32.long()].T, rdm32).argmin(0)
        va, ha = _uv_adst(plan_modes[best16])
        pred = IP.intra_pred_one(a, l, tl, have_a, have_l, both(best16), 7)
        lv16, e16, rec16, _, _ = TQ.txq_recon_skip(
            sb, pred, dc_q, ac_q, scan16, both(rdm32), *rtc16,
            vadst=both(va), hadst=both(ha))

        # ---- 8 path (4 sub-blocks per plane, raster, local recon) ----
        locs = torch.zeros((2 * B, 18, 18), **i32)
        locs[:, 0, 1:17] = a
        locs[:, 1:17, 0] = l
        locs[:, 0, 0] = tl
        subs8 = []
        for qr, qc in _QUADS:
            ha8 = have_a | (qr > 0)
            hl8 = have_l | (qc > 0)
            ym = y_m16[tt, 2 * rc + qr, 2 * cc + qc]    # AV1 mode id
            a8 = locs[:, qr * 8, 1 + qc * 8:9 + qc * 8]
            l8 = locs[:, 1 + qr * 8:9 + qr * 8, qc * 8]
            t8 = locs[:, qr * 8, qc * 8]
            sb8 = sb[:, qr * 8:qr * 8 + 8, qc * 8:qc * 8 + 8]
            s2 = IP.intra_pred_sse(a8, l8, t8, ha8, hl8, sb8, 7)
            sse8 = s2[:, :B] + s2[:, B:]
            rdm16 = rd16[tt, 2 * rc + qr, 2 * cc + qc]
            b8 = _rd(sse8, uv_cost[ym.long()].T, rdm16).argmin(0)
            va, ha = _uv_adst(plan_modes[b8])
            pred = IP.intra_pred_one(a8, l8, t8, ha8, hl8, both(b8), 7)
            lv, e, rec, _, _ = TQ.txq_recon_skip(
                sb8, pred, dc_q, ac_q, scan8, both(rdm16), *rtc8,
                vadst=both(va), hadst=both(ha))
            locs[:, 1 + qr * 8:9 + qr * 8, 1 + qc * 8:9 + qc * 8] = rec
            subs8.append((b8, lv, e))

        # ---- select & scatter ----
        rec = torch.where(both(split)[:, None, None], locs[:, 1:17, 1:17],
                          rec16)
        idx = _block_index(tt, by, bx, 16)
        for p in range(2):
            bufs[p][idx] = rec[p * B:(p + 1) * B]
            uvlv16o[tt, p, rc, cc] = lv16[p * B:(p + 1) * B]
            uve16o[tt, p, rc, cc] = e16[p * B:(p + 1) * B]
        uvm16o[tt, rc, cc] = best16.to(torch.int32)
        for (qr, qc), (b8, lv, e) in zip(_QUADS, subs8):
            rq, cq = 2 * rc + qr, 2 * cc + qc
            uvm8o[tt, rq, cq] = b8.to(torch.int32)
            for p in range(2):
                uvlv8o[tt, p, rq, cq] = lv[p * B:(p + 1) * B]
                uve8o[tt, p, rq, cq] = e[p * B:(p + 1) * B]
    return (uvm16o, uvlv16o, uve16o, uvm8o, uvlv8o, uve8o,
            bufs[:, :, 1:1 + H, 1:1 + W])


_LUMA_KEYS = ("split32", "y_mode32", "y_delta32", "y_levels32", "y_eob32",
              "y_mode16", "y_delta16", "y_levels16", "y_eob16")
_CHROMA_KEYS = ("uv_mode16", "uv_levels16", "uv_eob16", "uv_mode8",
                "uv_levels8", "uv_eob8")


def _fetch(named: dict) -> dict:
    """Every plan array to the host in ONE device->host copy: all values
    fit int16 (levels are clipped to +/-32767, the reference's
    ``_shrink_levels`` downcast), so they travel as one int16 buffer."""
    flat = torch.cat([v.reshape(-1).to(torch.int16) for v in named.values()])
    host = flat.cpu().numpy()
    out, off = {}, 0
    for k, v in named.items():
        n = v.numel()
        out[k] = host[off:off + n].reshape(tuple(v.shape)).astype(np.int32)
        off += n
    if "split32" in out:
        out["split32"] = out["split32"].astype(np.uint8)
    return out


def plan_tiles_part(slabs: list, q: int, fc, mi_rows: int, device):
    """Two-level plans of T equal tile slabs in one pair of wavefronts.

    slabs: list of dicts with ``y`` (and ``u``/``v`` unless monochrome)
    int32 numpy planes of one shape, an ``rd`` lambda (scalar or (2R, 2C)
    grid), ``mi_cols_eff`` (the slab's effective mi width for the edge-cell
    masks) and ``tile_mi_w`` / ``vis_mi_w`` (None: ``mi_cols_eff``). The
    only place that stacks the plan inputs of the slabs. Returns T plan
    dicts (the reference's keys and dtypes; ``recon_dev`` on ``device``)
    from one device->host copy."""
    y0 = slabs[0]["y"]
    R, C = y0.shape[0] // 32, y0.shape[1] // 32
    t = stack_tiles(shared_inputs(R, C, q, fc),
                    [tile_inputs(R, C, s["rd"], mi_rows, s["mi_cols_eff"],
                                 s.get("tile_mi_w"), s.get("vis_mi_w"))
                     for s in slabs])
    src_tiles = [np.stack([np.asarray(s[p], np.int32) for s in slabs])
                 for p in (("y", "u", "v") if "u" in slabs[0] else ("y",))]
    t = convert.inputs_from_numpy(t, device)
    ys = torch.as_tensor(np.asarray(src_tiles[0], np.int32), device=device)
    luma = _luma_wavefront_part(ys, t)
    named = dict(zip(_LUMA_KEYS, luma[:9]))
    recons = [luma[9]]
    if len(src_tiles) > 1:
        us, vs = (torch.as_tensor(np.asarray(p, np.int32), device=device)
                  for p in src_tiles[1:])
        chroma = _chroma_wavefront_part(us, vs, t, named["split32"],
                                        named["y_mode32"], named["y_mode16"])
        named.update(zip(_CHROMA_KEYS, chroma[:6]))
        recons += [chroma[6][0], chroma[6][1]]
    host = _fetch(named)
    return [{"part": True, **{k: v[i] for k, v in host.items()},
             "recon_dev": [r[i].contiguous() for r in recons]}
            for i in range(ys.shape[0])]


def plan_frame_part(src_planes, q, fc, rdmult, mi_rows, mi_cols,
                    device="cuda", fetch_recon=False, tile_mi_w=None,
                    vis_mi_w=None):
    """Two-level (32 -> 16) partition plan over one frame (or one tile).

    src_planes: mi-aligned int32 numpy planes padded to multiples of 32
    (luma) / 16 (chroma). ``rdmult`` scalar or (2R, 2C) 16-granularity
    grid. ``tile_mi_w`` / ``vis_mi_w`` (tile columns): the tile's actual
    and visible mi widths, both ``mi_cols`` by default. Returns the plan
    dict consumed by the native part2 pack (the reference's keys and
    dtypes); ``recon_dev`` holds the recon planes as tensors on
    ``device``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    slab = {"rd": rdmult, "mi_cols_eff": mi_cols, "tile_mi_w": tile_mi_w,
            "vis_mi_w": vis_mi_w, **dict(zip("yuv", src_planes))}
    plan = plan_tiles_part([slab], q, fc, mi_rows, dev)[0]
    if fetch_recon:
        plan["recon"] = [r.cpu().numpy() for r in plan["recon_dev"]]
    return plan


# ----------------------------------------------------------------------
# the uniform-grid fallback (7 plain modes, TX == block size, no skip)
# ----------------------------------------------------------------------
def _luma_wavefront(src, mode_cost, angle_cost, dc_q, ac_q, rdmult, bs: int,
                    R: int, C: int):
    """Uniform-grid luma wavefront (the reference's ``_luma_wavefront``):
    per anti-diagonal, KA scores the 7 plain modes of every block, the RD
    argmin runs in torch ops, KA predicts the winner again and KB (no skip
    decision) quantizes and reconstructs it.

    src: (R*bs, C*bs) int32; rdmult (R, C) float32. Returns (mode_idx
    (R,C) PLAN index, levels (R,C,n), eob (R,C), recon (R*bs, C*bs))."""
    dev = src.device
    scan = _scan(BS_TO_TX[bs], str(dev))
    imc = _const(_IMC, str(dev))
    plan_modes = _const(PLAN_MODES, str(dev))
    H, W = R * bs, C * bs
    i32 = dict(dtype=torch.int32, device=dev)
    buf = torch.zeros((1, H + 2 + bs, W + 2 + bs), **i32)
    mode_grid = torch.zeros((R, C), **i32)            # chosen PLAN index
    levels_out = torch.zeros((R, C, bs * bs), **i32)
    eob_out = torch.zeros((R, C), **i32)
    src4 = src.view(R, bs, C, bs)
    for tt, rc, cc in _walk(R, C, dev):
        by, bx = rc * bs + 1, cc * bs + 1
        have_a, have_l = rc > 0, cc > 0
        above, left, tl = _edges(buf, tt, by, bx, bs)
        sb = src4[rc, :, cc, :]                                # (B,bs,bs)
        sse = IP.intra_pred_sse(above, left, tl, have_a, have_l, sb,
                                IP.N_PLAIN)                    # (7,B)
        zero = torch.zeros_like(rc, dtype=torch.int32)
        am = torch.where(have_a, mode_grid[rc - 1, cc], zero)
        lm = torch.where(have_l, mode_grid[rc, (cc - 1).clamp(min=0)], zero)
        actx = imc[plan_modes[am.long()].long()]
        lctx = imc[plan_modes[lm.long()].long()]
        rate = mode_cost[actx, lctx] + angle_cost[None, :]     # (B,7)
        best = _rd(sse, rate.T, rdmult[rc, cc]).argmin(0)
        pred = IP.intra_pred_one(above, left, tl, have_a, have_l, best,
                                 IP.N_PLAIN)
        levels, eob, recon = TQ.txq_recon(sb, pred, dc_q, ac_q, scan)
        buf[_block_index(tt, by, bx, bs)] = recon
        mode_grid[rc, cc] = best.to(torch.int32)
        levels_out[rc, cc] = levels
        eob_out[rc, cc] = eob
    return mode_grid, levels_out, eob_out, buf[0, 1:1 + H, 1:1 + W]


def _chroma_wavefront(src_u, src_v, uv_cost, dc_q, ac_q, rdmult, y_mode_idx,
                      bs: int, R: int, C: int):
    """Uniform-grid joint U/V wavefront (the reference's
    ``_chroma_wavefront``): one mode per block from the summed U+V SSE,
    the U and V blocks of a step as one batch of 2B, the chroma tx type
    derived from the mode (ADST/DCT), no skip decision.

    Returns (mode_idx (R,C), levels (2,R,C,n), eob (2,R,C),
    recon (2, R*bs, C*bs))."""
    dev = src_u.device
    scan = _scan(BS_TO_TX[bs], str(dev))
    plan_modes = _const(PLAN_MODES, str(dev))
    H, W = R * bs, C * bs
    i32 = dict(dtype=torch.int32, device=dev)
    bufs = torch.zeros((2, 1, H + 2 + bs, W + 2 + bs), **i32)
    mode_grid = torch.zeros((R, C), **i32)
    levels_out = torch.zeros((2, R, C, bs * bs), **i32)
    eob_out = torch.zeros((2, R, C), **i32)
    srcs4 = (src_u.view(R, bs, C, bs), src_v.view(R, bs, C, bs))

    def both(x):
        return torch.cat([x, x])

    for tt, rc, cc in _walk(R, C, dev):
        B = rc.shape[0]
        by, bx = rc * bs + 1, cc * bs + 1
        have_a, have_l = both(rc > 0), both(cc > 0)
        sb = torch.cat([s4[rc, :, cc, :] for s4 in srcs4])     # (2B,bs,bs)
        edges = [_edges(bufs[p], tt, by, bx, bs) for p in range(2)]
        a, l, tl = (torch.cat([e[i] for e in edges]) for i in range(3))
        s2 = IP.intra_pred_sse(a, l, tl, have_a, have_l, sb, IP.N_PLAIN)
        sse = s2[:, :B] + s2[:, B:]
        ym = plan_modes[y_mode_idx[rc, cc].long()]
        best = _rd(sse, uv_cost[ym.long()].T, rdmult[rc, cc]).argmin(0)
        va, ha = _uv_adst(plan_modes[best])
        pred = IP.intra_pred_one(a, l, tl, have_a, have_l, both(best),
                                 IP.N_PLAIN)
        levels, eob, recon = TQ.txq_recon(sb, pred, dc_q, ac_q, scan,
                                          both(va), both(ha))
        idx = _block_index(tt, by, bx, bs)
        for p in range(2):
            bufs[p][idx] = recon[p * B:(p + 1) * B]
            levels_out[p, rc, cc] = levels[p * B:(p + 1) * B]
            eob_out[p, rc, cc] = eob[p * B:(p + 1) * B]
        mode_grid[rc, cc] = best.to(torch.int32)
    return mode_grid, levels_out, eob_out, bufs[:, 0, 1:1 + H, 1:1 + W]


def plan_frame(src_planes, q, bs, fc, rdmult, device="cuda",
               fetch_recon=False):
    """Uniform-grid plan over one frame (the reference's ``plan_frame``).

    src_planes: mi-aligned int32 numpy planes (luma dims multiples of
    ``bs``); ``rdmult`` a scalar or a per-block (R, C) grid. Returns the
    plan dict consumed by the native uniform pack (the reference's keys and
    dtypes) from one device->host copy; ``recon_dev`` holds the recon
    planes on ``device``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    kf_cost, angle_cost, uv_cost = _plan_cost_tables(fc)
    y = src_planes[0]
    R, C = y.shape[0] // bs, y.shape[1] // bs
    dc_q, ac_q = tables.dc_quant(q), tables.ac_quant(q)
    rdgrid = np.asarray(rdmult, np.float32)
    if rdgrid.ndim == 0:
        rdgrid = np.full((R, C), float(rdmult), np.float32)
    assert rdgrid.shape == (R, C), (rdgrid.shape, R, C)
    rdgrid = torch.as_tensor(rdgrid, device=dev)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    ym, ylv, yeob, yrec = _luma_wavefront(
        t(y), t(kf_cost), t(angle_cost), dc_q, ac_q, rdgrid, bs, R, C)
    named = {"y_mode": ym, "y_levels": ylv, "y_eob": yeob}
    recon_dev = [yrec.contiguous()]
    if len(src_planes) > 1:
        uvm, uvlv, uveob, uvrec = _chroma_wavefront(
            t(src_planes[1]), t(src_planes[2]), t(uv_cost), dc_q, ac_q,
            rdgrid, ym, bs // 2, R, C)
        named.update(uv_mode=uvm, uv_levels=uvlv, uv_eob=uveob)
        recon_dev += [uvrec[0].contiguous(), uvrec[1].contiguous()]
    plan = {"bs": bs, **_fetch(named), "recon_dev": recon_dev}
    if fetch_recon:
        plan["recon"] = [r.cpu().numpy() for r in recon_dev]
    return plan
