"""Directional intra candidates for the two-level plan — torch counterpart of
``aom_av1_psy_tpu/encoder/tpu_intra_dir.py``.

The host half (candidate list, static gather tables, availability masks) is
numpy and is carried over from that module (``:45-176``, ``:280-354``);
the port imports nothing of the reference. The
device half (``_filter_edge_b``, ``build_edge_buffer``, ``dir_predict``,
``allowed_mask``, ``:179-274``) is written in torch; it is the plain
version that kernel KA (``ops/intra_pred.py``) is held against.

Edge buffer layout per block (concat along axis 1, see ``tables``):
  A1[s] s=0..3 : [corner, above(2bs)]          z1 edges, filter strength s
  A2[s]        : [pad127, corner2, above(bs)]  z2 above
  L2[s]        : [pad129, corner2, left(bs)]   z2 left
  L3[s]        : [corner, left(2bs)]           z3 edges
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import intra as intra_ops
from .. import convert
from ..normative.enums import PredictionMode, MODE_TO_ANGLE

# class ids
PLAIN, Z1, Z2, Z3 = 0, 1, 2, 3

# the 7 extension-free candidates first (same order as PLAN_MODES so ties
# keep preferring cheap modes), then directional (mode, delta) pairs
_PLAIN = ((0, 0), (1, 0), (2, 0), (9, 0), (10, 0), (11, 0), (12, 0))


def _p_angle(mode: int, delta: int) -> int:
    return int(MODE_TO_ANGLE[PredictionMode(mode)]) + 3 * delta


@functools.cache
def candidates():
    """[(mode, delta, cls)] — PLAIN entries first, then directional."""
    out = [(m, d, PLAIN) for (m, d) in _PLAIN]
    for m in range(1, 9):
        for d in (-3, -2, -1, 0, 1, 2, 3):
            if m in (1, 2) and d == 0:
                continue  # V/H delta 0 are in the PLAIN set
            pa = _p_angle(m, d)
            cls = Z1 if pa < 90 else (Z2 if pa < 180 else Z3)
            if pa in (90, 180):
                cls = PLAIN  # cannot happen for d != 0, defensive
            out.append((m, d, cls))
    return tuple(out)


_FILTER_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))


@functools.cache
def tables(bs: int):
    """Static gather tables for one block size (carried over verbatim).

    Returns dict with MODE/DELTA/CLS (K,), and for the directional tail
    IDXa/IDXb/SH of shape (2, Kd, bs, bs) — first axis = edge-filter type
    (smooth-neighbour rule)."""
    assert bs in (16, 32), bs
    cands = candidates()
    K = len(cands)
    nd = sum(1 for c in cands if c[2] != PLAIN)
    n_plain = K - nd

    seg_a1 = 2 * bs + 1
    seg_a2 = bs + 2
    off_a1 = [s * seg_a1 for s in range(4)]
    base = 4 * seg_a1
    off_a2 = [base + s * seg_a2 for s in range(4)]
    base += 4 * seg_a2
    off_l2 = [base + s * seg_a2 for s in range(4)]
    base += 4 * seg_a2
    off_l3 = [base + s * seg_a1 for s in range(4)]
    L = base + 4 * seg_a1

    r = np.arange(bs)[:, None]
    c = np.arange(bs)[None, :]

    idxa = np.zeros((2, nd, bs, bs), np.int64)
    idxb = np.zeros((2, nd, bs, bs), np.int64)
    sh = np.zeros((nd, bs, bs), np.int64)
    k = 0
    for mode, delta, cls in cands:
        if cls == PLAIN:
            continue
        pa = _p_angle(mode, delta)
        dx, dy = intra_ops.get_dx(pa), intra_ops.get_dy(pa)
        sa = [intra_ops.intra_edge_filter_strength(bs, bs, pa - 90, t)
              for t in (0, 1)]
        sl = [intra_ops.intra_edge_filter_strength(bs, bs, pa - 180, t)
              for t in (0, 1)]
        assert not intra_ops.use_intra_edge_upsample(bs, bs, pa - 90, 0)
        assert not intra_ops.use_intra_edge_upsample(bs, bs, pa - 180, 0)
        if cls == Z1:
            x = dx * (r + 1)
            bse = (x >> 6) + c
            shift = (x & 0x3F) >> 1
            mb = 2 * bs - 1
            over = bse >= mb
            b0 = np.where(over, mb, np.minimum(bse, mb))
            b1 = np.where(over, mb, np.minimum(bse + 1, mb))
            shift = np.where(over, 0, shift)
            for t in (0, 1):
                idxa[t, k] = off_a1[sa[t]] + 1 + b0
                idxb[t, k] = off_a1[sa[t]] + 1 + b1
            sh[k] = shift
        elif cls == Z3:
            y = dy * (c + 1)
            bse = (y >> 6) + r
            shift = (y & 0x3F) >> 1
            mb = 2 * bs - 1
            over = bse >= mb
            b0 = np.where(over, mb, np.minimum(bse, mb))
            b1 = np.where(over, mb, np.minimum(bse + 1, mb))
            shift = np.where(over, 0, shift)
            for t in (0, 1):
                idxa[t, k] = off_l3[sl[t]] + 1 + b0
                idxb[t, k] = off_l3[sl[t]] + 1 + b1
            sh[k] = shift
        else:  # Z2
            x = (c << 6) - (r + 1) * dx
            base_x = x >> 6
            use_above = base_x >= -1
            shift_x = (x & 0x3F) >> 1
            bx0 = np.clip(base_x, -2, bs - 1) + 2
            bx1 = np.clip(base_x + 1, -2, bs - 1) + 2
            y2 = (r << 6) - (c + 1) * dy
            base_y = y2 >> 6
            shift_y = (y2 & 0x3F) >> 1
            by0 = np.clip(base_y, -2, bs - 1) + 2
            by1 = np.clip(base_y + 1, -2, bs - 1) + 2
            for t in (0, 1):
                idxa[t, k] = np.where(use_above, off_a2[sa[t]] + bx0,
                                      off_l2[sl[t]] + by0)
                idxb[t, k] = np.where(use_above, off_a2[sa[t]] + bx1,
                                      off_l2[sl[t]] + by1)
            sh[k] = np.where(use_above, shift_x, shift_y)
        k += 1
    assert k == nd

    return {
        "K": K, "nd": nd, "n_plain": n_plain, "L": L,
        "MODE": np.array([m for m, _, _ in cands], np.int32),
        "DELTA": np.array([d for _, d, _ in cands], np.int32),
        "CLS": np.array([cl for _, _, cl in cands], np.int32),
        "IDXa": idxa.astype(np.int32), "IDXb": idxb.astype(np.int32),
        "SH": sh.astype(np.int32),
    }


def dir_consts(bs: int) -> np.ndarray:
    """(nd, 7) int32, one row per directional candidate of ``candidates``:
    dx, dy, the edge-filter strength of the above edge for ef type 0 and 1,
    of the left edge for ef type 0 and 1, and the class (Z1, Z2, Z3). Kernel
    KA's pick keeps these in constant memory and computes every sample
    position from them (``dir_positions``), in place of the gathers."""
    assert bs in (16, 32), bs
    rows = []
    for mode, delta, cls in candidates():
        if cls == PLAIN:
            continue
        pa = _p_angle(mode, delta)
        rows.append([intra_ops.get_dx(pa), intra_ops.get_dy(pa)]
                    + [intra_ops.intra_edge_filter_strength(bs, bs, pa - d, t)
                       for d in (90, 180) for t in (0, 1)] + [cls])
    return np.array(rows, np.int32)


def dir_positions(bs: int):
    """(IDXa, IDXb) (2, nd, bs, bs) and SH (2, nd, bs, bs) from
    ``dir_consts`` by the arithmetic of kernel KA's pick
    (``csrc/intra_pred.cu`` ``dir_pix``): Z1 steps along the above edge
    (``dx * (r + 1)``), Z3 along the left edge (``dy * (c + 1)``), and past
    the last sample both read it with shift 0; Z2 reads the above edge
    where ``((c << 6) - (r + 1) * dx) >> 6 >= -1`` and the left edge
    (``(r << 6) - (c + 1) * dy``) elsewhere, clipped to [-2, bs - 1]. The
    offsets are those of the edge-buffer layout above. Equal to
    ``tables(bs)``'s gathers (the shift for both ef types)."""
    a1, a2 = 2 * bs + 1, bs + 2
    mb = 2 * bs - 1
    r = np.arange(bs)[:, None] + np.zeros(bs, np.int64)[None, :]
    c = np.arange(bs)[None, :] + np.zeros(bs, np.int64)[:, None]
    consts = dir_consts(bs).astype(np.int64)
    shape = (2, len(consts), bs, bs)
    ia, ib, sh = (np.zeros(shape, np.int32) for _ in range(3))
    for k, (dx, dy, sa0, sa1, sl0, sl1, cls) in enumerate(consts):
        for t, (sa, sl) in enumerate(((sa0, sl0), (sa1, sl1))):
            if cls in (Z1, Z3):
                pos = dx * (r + 1) if cls == Z1 else dy * (c + 1)
                base = (pos >> 6) + (c if cls == Z1 else r)
                off = sa * a1 + 1 if cls == Z1 else \
                    4 * a1 + 8 * a2 + sl * a1 + 1
                over = base >= mb
                ia[t, k] = off + np.where(over, mb, base)
                ib[t, k] = off + np.where(over, mb, base + 1)
                sh[t, k] = np.where(over, 0, (pos & 63) >> 1)
            else:
                x = (c << 6) - (r + 1) * dx
                y = (r << 6) - (c + 1) * dy
                above = (x >> 6) >= -1
                pos = np.where(above, x, y)
                base = pos >> 6
                off = np.where(above, 4 * a1 + sa * a2,
                               4 * a1 + 4 * a2 + sl * a2)
                ia[t, k] = off + np.clip(base, -2, bs - 1) + 2
                ib[t, k] = off + np.clip(base + 1, -2, bs - 1) + 2
                sh[t, k] = (pos & 63) >> 1
    return ia, ib, sh


@functools.cache
def tables_on(bs: int, device: str):
    """``tables(bs)`` arrays as tensors on ``device`` (uploaded once)."""
    t = tables(bs)
    return {k: convert.to_device(t[k], device)
            for k in ("MODE", "DELTA", "CLS", "IDXa", "IDXb", "SH")}


# ----------------------------------------------------------------------
# device half (plain torch)
# ----------------------------------------------------------------------
def _filter_edge_b(edge: torch.Tensor, strength: int) -> torch.Tensor:
    """Batched av1_filter_intra_edge_c: edge (B, sz) int32; position 0
    (the corner) is used as a neighbour but never modified."""
    if strength == 0:
        return edge
    sz = edge.shape[1]
    kern = torch.tensor(_FILTER_KERNELS[strength - 1], dtype=torch.int32,
                        device=edge.device)
    idx = np.clip(np.arange(sz)[:, None] + np.arange(-2, 3)[None, :],
                  0, sz - 1)
    idx = torch.as_tensor(idx, device=edge.device)
    s = (edge[:, idx] * kern).sum(-1, dtype=torch.int32)
    out = (s + 8) >> 4
    return torch.cat([edge[:, :1], out[:, 1:]], dim=1)


def effective_edges(above, left, tl, have_a, have_l):
    """Edge fallbacks of build_intra_predictors for absent neighbours:
    missing above <- left[0] (127 if none), missing left <- above[0]
    (129 if none), corner above[0] -> left[0] -> 128."""
    ha = have_a[:, None]
    hl = have_l[:, None]
    c127 = torch.full_like(above, 127)
    c129 = torch.full_like(left, 129)
    above_eff = torch.where(ha, above, torch.where(hl, left[:, :1], c127))
    left_eff = torch.where(hl, left, torch.where(ha, above[:, :1], c129))
    tl_eff = torch.where(have_a & have_l, tl,
                         torch.where(have_a, above[:, 0],
                                     torch.where(have_l, left[:, 0],
                                                 torch.full_like(tl, 128))))
    return above_eff, left_eff, tl_eff


def build_edge_buffer(above, left, tl, have_a, have_l, trreal, blreal,
                      abext, lfext, bs: int) -> torch.Tensor:
    """(B, L) unified edge buffer for the directional gathers.

    above/left: (B, bs) raw gathered recon edges; tl (B,); have_a/have_l
    (B,) bool; trreal/blreal (B,) bool select REAL top-right/bottom-left
    extension pixels (abext/lfext, (B, bs)) over replication."""
    above_eff, left_eff, tl_eff = effective_edges(above, left, tl, have_a,
                                                  have_l)
    trpix = torch.where(trreal[:, None], abext,
                        above_eff[:, bs - 1:].expand(-1, bs))
    blpix = torch.where(blreal[:, None], lfext,
                        left_eff[:, bs - 1:].expand(-1, bs))
    # z2 corner smoothing (reconintra.c: need_above && need_left && wh>=24)
    c2 = (left_eff[:, 0] * 5 + tl_eff * 6 + above_eff[:, 0] * 5 + 8) >> 4

    a1 = torch.cat([tl_eff[:, None], above_eff, trpix], dim=1)
    l3 = torch.cat([tl_eff[:, None], left_eff, blpix], dim=1)
    a2c = torch.cat([c2[:, None], above_eff], dim=1)
    l2c = torch.cat([c2[:, None], left_eff], dim=1)
    pad127 = torch.full_like(tl_eff[:, None], 127)
    pad129 = torch.full_like(tl_eff[:, None], 129)

    segs = [_filter_edge_b(a1, s) for s in range(4)]
    segs += [torch.cat([pad127, _filter_edge_b(a2c, s)], dim=1)
             for s in range(4)]
    segs += [torch.cat([pad129, _filter_edge_b(l2c, s)], dim=1)
             for s in range(4)]
    segs += [_filter_edge_b(l3, s) for s in range(4)]
    return torch.cat(segs, dim=1)


def dir_predict(E: torch.Tensor, ef_type: torch.Tensor, bs: int):
    """Directional predictions (nd, B, bs, bs) int32 from the edge buffer
    E (B, L) and the per-block edge-filter type bit ef_type (B,).

    The per-block index planes are selected by ef_type and gathered once
    (the reference's two static gathers + select give the same values)."""
    tab = tables_on(bs, str(E.device))
    B = E.shape[0]
    nd = tab["SH"].shape[0]
    t = ef_type.long()
    ia = tab["IDXa"][t].reshape(B, -1).long()        # (B, nd*bs*bs)
    ib = tab["IDXb"][t].reshape(B, -1).long()
    va = torch.gather(E, 1, ia).reshape(B, nd, bs, bs)
    vb = torch.gather(E, 1, ib).reshape(B, nd, bs, bs)
    SH = tab["SH"][None]
    pred = (va * (32 - SH) + vb * SH + 16) >> 5
    return pred.transpose(0, 1)


def allowed_mask(okz1, okz2, okz3, bs: int) -> torch.Tensor:
    """(K, B) bool candidate mask from the per-class position masks (B,)."""
    cls = tables_on(bs, str(okz1.device))["CLS"].long()
    per_cls = torch.stack([torch.ones_like(okz1), okz1, okz2, okz3])
    return per_cls[cls]


# ----------------------------------------------------------------------
# host-side availability masks (carried over verbatim)
# ----------------------------------------------------------------------
def position_masks(mi_rows: int, tile_mi_w: int, vis_mi_w: int,
                   R: int, C: int):
    """Per-position candidate-class masks for the two-level plan.

    mi_rows: frame mi rows; tile_mi_w: the tile's ACTUAL mi width (bounds
    right_avail); vis_mi_w: visible mi width in this tile. Returns dict of
    bool grids: ok1_32/ok2_32/ok3_32 (R, C); ok1_16/ok2_16/ok3_16/
    trreal_16/blreal_16 (2R, 2C)."""
    from ..normative import intra_avail as IA
    from ..normative.enums import BlockSize, TxSize
    NONE = 0  # PARTITION_NONE (leaf blocks of the two-level plan)
    b32, t32 = int(BlockSize.BLOCK_32X32), int(TxSize.TX_32X32)
    b16, t16 = int(BlockSize.BLOCK_16X16), int(TxSize.TX_16X16)

    ok1_32 = np.zeros((R, C), bool)
    ok2_32 = np.zeros((R, C), bool)
    ok3_32 = np.zeros((R, C), bool)
    for r in range(R):
        for c in range(C):
            mi_r, mi_c = 8 * r, 8 * c
            align = (vis_mi_w >= mi_c + 8) and (mi_rows >= mi_r + 8)
            top = mi_r > 0
            left = mi_c > 0
            right = mi_c + 8 < tile_mi_w
            bottom = mi_r + 8 < mi_rows
            if not align:
                continue
            htr = IA.has_top_right(16, b32, mi_r, mi_c, top, right, NONE,
                                   t32, 0, 0, 0, 0)
            hbl = IA.has_bottom_left(16, b32, mi_r, mi_c, bottom, left,
                                     NONE, t32, 0, 0, 0, 0)
            # at 32 granularity no real TR/BL pixels exist in wavefront
            # order (same/next anti-diagonal) — only replication positions
            ok1_32[r, c] = top and htr == 0
            ok2_32[r, c] = top and left
            ok3_32[r, c] = left and hbl == 0

    R2, C2 = 2 * R, 2 * C
    ok1_16 = np.zeros((R2, C2), bool)
    ok2_16 = np.zeros((R2, C2), bool)
    ok3_16 = np.zeros((R2, C2), bool)
    trreal = np.zeros((R2, C2), bool)
    blreal = np.zeros((R2, C2), bool)
    for i in range(R2):
        for j in range(C2):
            mi_r, mi_c = 4 * i, 4 * j
            align = (vis_mi_w >= mi_c + 4) and (mi_rows >= mi_r + 4)
            top = mi_r > 0
            left = mi_c > 0
            right = mi_c + 4 < tile_mi_w
            bottom = mi_r + 4 < mi_rows
            if not align:
                continue
            htr = IA.has_top_right(16, b16, mi_r, mi_c, top, right, NONE,
                                   t16, 0, 0, 0, 0)
            hbl = IA.has_bottom_left(16, b16, mi_r, mi_c, bottom, left,
                                     NONE, t16, 0, 0, 0, 0)
            # real TR pixels exist in wavefront+Z order only for left-half
            # quads (qc==0); real BL pixels only for quad (0,0)
            tr_avail = (j % 2 == 0)
            bl_avail = (i % 2 == 0) and (j % 2 == 0)
            ok1_16[i, j] = top and (htr == 0 or tr_avail)
            ok2_16[i, j] = top and left
            ok3_16[i, j] = left and (hbl == 0 or bl_avail)
            trreal[i, j] = bool(htr == 1 and tr_avail)
            blreal[i, j] = bool(hbl == 1 and bl_avail)

    return {"ok1_32": ok1_32, "ok2_32": ok2_32, "ok3_32": ok3_32,
            "ok1_16": ok1_16, "ok2_16": ok2_16, "ok3_16": ok3_16,
            "trreal_16": trreal, "blreal_16": blreal}
