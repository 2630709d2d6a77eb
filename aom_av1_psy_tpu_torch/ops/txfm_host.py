"""Batched AV1 forward/inverse 2-D transforms, bit-exact integer paths, in
numpy: the host half of the transforms (the stage tables and the 2-D
functions of the decoder and ``encoder/frame.py``). The torch stage
interpreter of the device plan is ``ops/txfm.py``.

Design: the per-block scalar butterfly loops of the reference
(``av1/encoder/av1_fwd_txfm1d.c``, ``av1/common/av1_inv_txfm1d.c``,
2-D composition in ``av1_fwd_txfm2d.c`` / ``av1_inv_txfm2d.c``) become
vectorized stage interpreters over a batch axis: every stage is a static
gather + multiply-add + round-shift over ``(batch, N)`` int arrays, so the
whole transform jits into a handful of fused XLA ops per stage, batched over
all blocks of a frame at once.

Stage structure is normative data (AV1 spec §7.13.3) loaded from
``normative/data/txfm_stages.json``.

Layout convention (matches the reference coefficient buffers):
  - pixel/residual blocks: ``(B, H, W)`` row-major
  - coefficient blocks:    ``(B, W, H)`` — flat index ``c*H + r`` like the C
    ``output[c * txfm_size_row + r]``; scan tables index this layout.
"""
from __future__ import annotations

import functools
import json
import os

import numpy as np

from ..normative import tables
from ..normative.enums import TxSize, TxType, TxType1D, TX_TYPE_1D, TX_WIDTH, TX_HEIGHT

NewSqrt2Bits = 12
NewSqrt2 = 5793
NewInvSqrt2 = 2896
INV_COS_BIT = 12

# shift[3] per TxSize (av1_fwd_txfm2d.c:314-340)
FWD_SHIFT = np.array([
    [2, 0, 0], [2, -1, 0], [2, -2, 0], [2, -4, 0], [0, -2, -2],
    [2, -1, 0], [2, -1, 0], [2, -2, 0], [2, -2, 0], [2, -4, 0],
    [2, -4, 0], [0, -2, -2], [2, -4, -2], [2, -1, 0], [2, -1, 0],
    [2, -2, 0], [2, -2, 0], [0, -2, 0], [2, -4, 0]], dtype=np.int32)

# shift[2] per TxSize (av1_inv_txfm2d.c:132-158)
INV_SHIFT = np.array([
    [0, -4], [-1, -4], [-2, -4], [-2, -4], [-2, -4],
    [0, -4], [0, -4], [-1, -4], [-1, -4], [-1, -4],
    [-1, -4], [-1, -4], [-1, -4], [-1, -4], [-1, -4],
    [-2, -4], [-2, -4], [-2, -4], [-2, -4]], dtype=np.int32)

# cos bits indexed [txw_idx][txh_idx] (av1_fwd_txfm2d.c:342-358)
FWD_COS_BIT_COL = np.array([
    [13, 13, 13, 0, 0], [13, 13, 13, 12, 0], [13, 13, 13, 12, 13],
    [0, 13, 13, 12, 13], [0, 0, 13, 12, 13]], dtype=np.int32)
FWD_COS_BIT_ROW = np.array([
    [13, 13, 12, 0, 0], [13, 13, 13, 12, 0], [13, 13, 12, 13, 12],
    [0, 12, 13, 12, 11], [0, 0, 12, 11, 10]], dtype=np.int32)

_STAGES_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "normative", "data", "txfm_stages.json")


@functools.cache
def _stage_data():
    with open(_STAGES_PATH) as f:
        return json.load(f)


@functools.cache
def _compiled_stages(func: str, cos_bit: int):
    """Resolve a stage table into flat numpy arrays with actual weights."""
    cospi = tables.cospi(cos_bit)
    out = []
    for stage in _stage_data()[func]:
        n = len(stage)
        ia = np.empty(n, np.int32)
        ib = np.empty(n, np.int32)
        wa = np.empty(n, np.int64)
        wb = np.empty(n, np.int64)
        is_btf = np.zeros(n, bool)
        clamp = np.zeros(n, bool)
        for i, (kind, a, b, xa, xb, cl) in enumerate(stage):
            ia[i], ib[i] = a, b
            clamp[i] = bool(cl)
            if kind == 1:
                is_btf[i] = True
                wa[i] = int(np.sign(xa)) * cospi[abs(xa) - 1]
                wb[i] = int(np.sign(xb)) * cospi[abs(xb) - 1]
            else:
                wa[i], wb[i] = xa, xb
        out.append((ia, ib, wa, wb, is_btf, clamp))
    return out


def _round_shift(v, bit):
    return (v + (1 << (bit - 1))) >> bit


def _np_like(x):
    """numpy, the only array type of the host transforms."""
    if isinstance(x, np.ndarray):
        return np
    raise TypeError(f"numpy array expected, got {type(x).__name__}")


def _run_stages(x, func: str, cos_bit: int, clamp_bit: int | None):
    """x: (B, N) integer array; returns transformed (B, N)."""
    xp = _np_like(x)
    dt = x.dtype
    rnd = 1 << (cos_bit - 1)
    if clamp_bit is not None:
        cmin, cmax = -(1 << (clamp_bit - 1)), (1 << (clamp_bit - 1)) - 1
    for ia, ib, wa, wb, is_btf, clamp in _compiled_stages(func, cos_bit):
        a = x[:, ia]
        b = x[:, ib]
        v = a * wa.astype(dt) + b * wb.astype(dt)
        shifted = (v + rnd) >> cos_bit
        y = xp.where(is_btf, shifted, v)
        if clamp_bit is not None and clamp.any():
            y = xp.where(clamp, xp.clip(y, cmin, cmax), y)
        x = y
    return x


# ---------------------------------------------------------------------------
# Special 1-D transforms (hand-written; see av1_fwd_txfm1d.c / av1_inv_txfm1d.c)
# ---------------------------------------------------------------------------


def _fadst4(x, cos_bit):
    """av1_fadst4 (sinpi-based)."""
    sp = tables.sinpi(cos_bit)
    dt = x.dtype
    s = [int(v) for v in sp]
    x0, x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    s0 = s[1] * x0
    s1 = s[4] * x0
    s2 = s[2] * x1
    s3 = s[1] * x1
    s4 = s[3] * x2
    s5 = s[4] * x3
    s6 = s[2] * x3
    s7 = (x0 + x1) - x3
    t0 = s0 + s2
    t1 = s[3] * s7
    t2 = s1 - s3
    t3 = s4
    t0 = t0 + s5
    t2 = t2 + s6
    o0 = _round_shift(t0 + t3, cos_bit)
    o1 = _round_shift(t1, cos_bit)
    o2 = _round_shift(t2 - t3, cos_bit)
    o3 = _round_shift((t2 - t0) + t3, cos_bit)
    xp = _np_like(x)
    return xp.stack([o0, o1, o2, o3], axis=1).astype(dt)


def _iadst4(x, cos_bit):
    """av1_iadst4 (sinpi-based)."""
    sp = tables.sinpi(cos_bit)
    s = [int(v) for v in sp]
    x0, x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    s0 = s[1] * x0
    s1 = s[2] * x0
    s2 = s[3] * x1
    s3 = s[4] * x2
    s4 = s[1] * x2
    s5 = s[2] * x3
    s6 = s[4] * x3
    s7 = (x0 - x2) + x3
    t0 = s0 + s3
    t1 = s1 - s4
    t3 = s2
    t2 = s[3] * s7
    t0 = t0 + s5
    t1 = t1 - s6
    o0 = t0 + t3
    o1 = t1 + t3
    o2 = t2
    o3 = (t0 + t1) - t3
    xp = _np_like(x)
    out = xp.stack([o0, o1, o2, o3], axis=1)
    return _round_shift(out, cos_bit).astype(x.dtype)


def _identity(x, n: int, inverse: bool):
    """av1_{f,i}identity{4,8,16,32}: scale by 2^(log2(n)/2), sqrt2-rounded."""
    if n == 4:
        return _round_shift(x * NewSqrt2, NewSqrt2Bits).astype(x.dtype)
    if n == 8:
        return x * 2
    if n == 16:
        return _round_shift(x * (2 * NewSqrt2), NewSqrt2Bits).astype(x.dtype)
    assert n == 32
    return x * 4


def _txfm_1d(x, n: int, type1d: TxType1D, cos_bit: int, inverse: bool,
             clamp_bit: int | None):
    if type1d == TxType1D.IDTX:
        return _identity(x, n, inverse)
    if type1d == TxType1D.DCT:
        return _run_stages(x, f"av1_{'i' if inverse else 'f'}dct{n}", cos_bit,
                           clamp_bit)
    # ADST / FLIPADST use the same kernel; flips are handled in 2-D wrap
    if n == 4:
        return _iadst4(x, cos_bit) if inverse else _fadst4(x, cos_bit)
    return _run_stages(x, f"av1_{'i' if inverse else 'f'}adst{n}", cos_bit,
                       clamp_bit)


def _flips(tx_type: TxType) -> tuple[bool, bool]:
    """(ud_flip, lr_flip) — FLIPADST on the column/row dim (av1_txfm.h
    set_flip_cfg)."""
    v, h = TX_TYPE_1D[TxType(tx_type)]
    return v == TxType1D.FLIPADST, h == TxType1D.FLIPADST


def _round_shift_arr(x, bit):
    """av1_round_shift_array: bit>0 round-shifts down, bit<0 scales up."""
    if bit == 0:
        return x
    if bit > 0:
        return _round_shift(x, bit)
    return x * (1 << -bit)


def fwd_txfm2d(res, tx_size: TxSize, tx_type: TxType, bd: int = 8):
    """Forward 2-D transform of residual blocks.

    res: (B, H, W) int array (int64 recommended for exactness at large sizes).
    Returns coefficients (B, W, H) int32-valued (in input dtype).
    Matches av1_fwd_txfm2d_{W}x{H}_c bit-exactly.
    """
    xp = _np_like(res)
    w, h = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
    b = res.shape[0]
    lw, lh = w.bit_length() - 3, h.bit_length() - 3  # txw_idx, txh_idx
    shift = FWD_SHIFT[tx_size]
    cb_col = int(FWD_COS_BIT_COL[lw][lh])
    cb_row = int(FWD_COS_BIT_ROW[lw][lh])
    vtype, htype = TX_TYPE_1D[TxType(tx_type)]
    ud_flip, lr_flip = _flips(tx_type)

    x = res
    if ud_flip:
        x = x[:, ::-1, :]
    # column pass: transform along H.  (B,H,W) -> (B*W, H)
    xc = xp.transpose(x, (0, 2, 1)).reshape(b * w, h)
    xc = _round_shift_arr(xc, -int(shift[0]))
    xc = _txfm_1d(xc, h, vtype, cb_col, inverse=False, clamp_bit=None)
    xc = _round_shift_arr(xc, -int(shift[1]))
    buf = xp.transpose(xc.reshape(b, w, h), (0, 2, 1))  # (B, H=r, W=c)
    if lr_flip:
        buf = buf[:, :, ::-1]
    # row pass: transform along W.  (B,H,W) -> (B*H, W)
    xr = buf.reshape(b * h, w)
    xr = _txfm_1d(xr, w, htype, cb_row, inverse=False, clamp_bit=None)
    xr = _round_shift_arr(xr, -int(shift[2]))
    rect = abs(lw - lh)
    if rect == 1:
        xr = _round_shift(xr * NewSqrt2, NewSqrt2Bits)
    out = xp.transpose(xr.reshape(b, h, w), (0, 2, 1))  # (B, W=c, H=r)
    return out


def inv_txfm2d_add(coeff, pred, tx_size: TxSize, tx_type: TxType, bd: int = 8):
    """Inverse 2-D transform + add to prediction with pixel clamp.

    coeff: (B, W, H) int32; pred: (B, H, W) integer pixels.
    Returns recon (B, H, W) in pred's dtype. Matches
    av1_inv_txfm2d_add_{W}x{H}_c bit-exactly (int32 internal, stage clamps).
    """
    xp = _np_like(coeff)
    w, h = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
    b = coeff.shape[0]
    lw, lh = w.bit_length() - 3, h.bit_length() - 3
    shift = INV_SHIFT[tx_size]
    vtype, htype = TX_TYPE_1D[TxType(tx_type)]
    ud_flip, lr_flip = _flips(tx_type)
    # 64-point transforms never code coefficients beyond index 31; the
    # reference zero-extends a compact <=32 input (av1_inv_txfm2d.c:348+).
    if w > 32 or h > 32:
        mask = np.zeros((w, h), dtype=bool)
        mask[: min(w, 32), : min(h, 32)] = True
        coeff = coeff * xp.asarray(mask, dtype=coeff.dtype)
    # stage clamp range: 16 bits for bd=8 (av1_gen_inv_stage_range)
    opt_range = {8: 16, 10: 18, 12: 20}[bd]
    clamp_in = bd + 8
    clamp_col_in = max(bd + 6, 16)

    # row pass: vectors over W at each r. coeff (B,W,H) -> (B*H, W)
    xr = xp.transpose(coeff, (0, 2, 1)).reshape(b * h, w)
    if abs(lw - lh) == 1:
        xr = _round_shift(xr * NewInvSqrt2, NewSqrt2Bits)
    xr = xp.clip(xr, -(1 << (clamp_in - 1)), (1 << (clamp_in - 1)) - 1)
    xr = _txfm_1d(xr, w, htype, INV_COS_BIT, inverse=True, clamp_bit=opt_range)
    xr = _round_shift_arr(xr, -int(shift[0]))
    buf = xr.reshape(b, h, w)
    if lr_flip:
        buf = buf[:, :, ::-1]
    # column pass: vectors over H at each c. (B,H,W) -> (B*W, H)
    xc = xp.transpose(buf, (0, 2, 1)).reshape(b * w, h)
    xc = xp.clip(xc, -(1 << (clamp_col_in - 1)), (1 << (clamp_col_in - 1)) - 1)
    xc = _txfm_1d(xc, h, vtype, INV_COS_BIT, inverse=True, clamp_bit=opt_range)
    xc = _round_shift_arr(xc, -int(shift[1]))
    resid = xp.transpose(xc.reshape(b, w, h), (0, 2, 1))  # (B, H, W)
    if ud_flip:
        resid = resid[:, ::-1, :]
    rec = pred.astype(resid.dtype) + resid
    rec = xp.clip(rec, 0, (1 << bd) - 1)
    return rec.astype(pred.dtype)


def fwht4x4(res):
    """Lossless 4x4 Walsh-Hadamard forward transform.

    Bit-exact vs av1_fwht4x4_c (av1/encoder/hybrid_fwd_txfm.c:24):
    column pass, then a pass across the intermediate with a final x4
    (UNIT_QUANT_FACTOR) scale. res: (B,4,4) natural (r,c); returns (B,4,4)
    in the C coefficient layout (flat c*4+r -> shape (B, W, H))."""
    xp = _np_like(res)
    x = res
    # pass 1: butterflies down each column c; result inter[b, c, k]
    a1 = x[:, 0, :] + x[:, 1, :]
    d1 = x[:, 3, :] - x[:, 2, :]
    e1 = (a1 - d1) >> 1
    b1 = e1 - x[:, 1, :]
    c1 = e1 - x[:, 2, :]
    a1 = a1 - c1
    d1 = d1 + b1
    inter = xp.stack([a1, c1, d1, b1], axis=2)  # (B, c, k)
    # pass 2: for each i, butterfly over inter[:, j, i] (flat 4j+i)
    a1 = inter[:, 0, :] + inter[:, 1, :]
    d1 = inter[:, 3, :] - inter[:, 2, :]
    e1 = (a1 - d1) >> 1
    b1 = e1 - inter[:, 1, :]
    c1 = e1 - inter[:, 2, :]
    a1 = a1 - c1
    d1 = d1 + b1
    return xp.stack([a1, c1, d1, b1], axis=1) * 4  # (B, j, i) flat 4j+i


def iwht4x4_add(coeff, pred, bd: int = 8):
    """Lossless 4x4 inverse WHT + add to prediction.

    Bit-exact vs av1_highbd_iwht4x4_16_add_c (av1/common/av1_inv_txfm2d.c:20).
    coeff: (B,4,4) in C layout (flat c*4+r, shape (B, W, H)); pred (B,4,4)."""
    xp = _np_like(coeff)
    x = coeff >> 2  # UNIT_QUANT_SHIFT
    # pass 1: for each r, butterfly over c (flat 4c+r); note a,c,d,b read order
    a1 = x[:, 0, :] + x[:, 1, :]
    d1 = x[:, 2, :] - x[:, 3, :]
    e1 = (a1 - d1) >> 1
    b1 = e1 - x[:, 3, :]
    c1 = e1 - x[:, 1, :]
    a1 = a1 - b1
    d1 = d1 + c1
    inter = xp.stack([a1, b1, c1, d1], axis=1)  # flat 4j+i -> (B, j, i)
    # pass 2: for each i, butterfly over inter flat [i*4 + k] = inter[b, i, k]
    a1 = inter[:, :, 0] + inter[:, :, 1]
    d1 = inter[:, :, 2] - inter[:, :, 3]
    e1 = (a1 - d1) >> 1
    b1 = e1 - inter[:, :, 3]
    c1 = e1 - inter[:, :, 1]
    a1 = a1 - b1
    d1 = d1 + c1
    resid = xp.stack([a1, b1, c1, d1], axis=1)  # dest[row j][col i]
    rec = pred.astype(resid.dtype) + resid
    rec = xp.clip(rec, 0, (1 << bd) - 1)
    return rec.astype(pred.dtype)
