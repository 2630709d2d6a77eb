"""The AV1 2-D transforms on tensors: every tx size (4x4 to 64x64, the
rectangular 1:2 and 1:4 sizes) and every tx type (DCT, ADST, FLIPADST,
IDTX and their V_ / H_ pairs: the 193 valid pairs), forward and inverse at
bd 8 / 10 / 12, and the lossless 4x4 Walsh-Hadamard pair; and the square
per-block DCT/ADST select that kernel KB's plain version runs.

Counterpart of ``aom_av1_psy_tpu/ops/txfm.py`` on device arrays
(``_run_stages`` :105, ``_fadst4`` / ``_iadst4`` :129-182, ``_identity``
:185, ``_txfm_1d`` / ``_flips`` :197-216, ``fwd_txfm2d`` :227,
``inv_txfm2d_add`` :266, ``fwht4x4`` :314, ``iwht4x4_add`` :343). The
normative stage tables, shifts, cos bits and sinpi constants are numpy
data of the port's host transforms (``ops/txfm_host.py``, the port's copy
of the reference module). ADST4 is not a stage program: it is the
sinpi-based ``av1_fadst4`` / ``av1_iadst4``, and like the reference it
takes no stage clamp.

Arithmetic is int32 with two's-complement wraparound, as jnp's int32 is:
every stage is ``a*wa + b*wb`` (+ round-shift for butterflies) over a
``(N, n)`` batch of vectors, and the identity scales, the rectangular
``NewSqrt2`` rescales and the shifts wrap the same way. Layouts follow the
reference: residual/pixel blocks ``(B, H, W)``, coefficient blocks
``(B, W, H)`` (flat ``c*H + r``).

The four public functions take CPU tensors to their plain versions
(``*_plain``, torch ops) and CUDA tensors to kernel KR (``csrc/txfm2d.cu``),
one launch per call, with no fallback between them. KR reads each launch's
two 1-D programs from a table the host builds once per (tx size, tx type,
direction, bd) (``kr_program``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.build import CudaKernel, I, P, need
from ..normative import tables
from ..normative.enums import (TX_HEIGHT, TX_TYPE_1D, TX_WIDTH, TxSize,
                               TxType, TxType1D)
from .txfm_host import (FWD_COS_BIT_COL, FWD_COS_BIT_ROW, FWD_SHIFT,
                         INV_COS_BIT, INV_SHIFT, NewInvSqrt2, NewSqrt2,
                         NewSqrt2Bits, _compiled_stages)

__all__ = ["FWD_COS_BIT_COL", "FWD_COS_BIT_ROW", "FWD_SHIFT", "INV_COS_BIT",
           "INV_SHIFT", "run_stages", "txfm_1d", "fwd_txfm2d",
           "inv_txfm2d_add", "fwht4x4", "iwht4x4_add", "fwd_txfm2d_plain",
           "inv_txfm2d_add_plain", "fwht4x4_plain", "iwht4x4_add_plain",
           "fwd_sel", "inv_sel_add", "SQUARE_TX", "valid_pair", "KR"]

SQUARE_TX = {4: int(TxSize.TX_4X4), 8: int(TxSize.TX_8X8),
             16: int(TxSize.TX_16X16), 32: int(TxSize.TX_32X32)}

# the stage clamp of the inverse transforms per bit depth
# (av1_gen_inv_stage_range)
INV_STAGE_RANGE = {8: 16, 10: 18, 12: 20}

KR = CudaKernel("txfm2d", {
    # res, out, B, w, h, stages, meta
    "kr_fwd": [P, P, I, I, I, P, P],
    # coeff, pred, out, B, w, h, stages, meta
    "kr_inv": [P, P, P, I, I, I, P, P],
    # res, out, B
    "kr_fwht": [P, P, I],
    # coeff, pred, out, B, bd
    "kr_iwht": [P, P, P, I, I],
})


@functools.cache
def _stages_on(func: str, cos_bit: int, device: str):
    out = []
    for ia, ib, wa, wb, is_btf, clamp in _compiled_stages(func, cos_bit):
        out.append((torch.as_tensor(ia.astype(np.int64), device=device),
                    torch.as_tensor(ib.astype(np.int64), device=device),
                    torch.as_tensor(wa.astype(np.int32), device=device),
                    torch.as_tensor(wb.astype(np.int32), device=device),
                    torch.as_tensor(is_btf, device=device),
                    torch.as_tensor(clamp, device=device),
                    bool(clamp.any())))
    return out


def run_stages(x: torch.Tensor, func: str, cos_bit: int,
               clamp_bit: int | None) -> torch.Tensor:
    """x: (N, n) int32; returns the transformed (N, n) int32."""
    rnd = 1 << (cos_bit - 1)
    for ia, ib, wa, wb, is_btf, clamp, any_clamp in _stages_on(
            func, cos_bit, str(x.device)):
        v = x[:, ia] * wa + x[:, ib] * wb
        y = torch.where(is_btf, (v + rnd) >> cos_bit, v)
        if clamp_bit is not None and any_clamp:
            lo, hi = -(1 << (clamp_bit - 1)), (1 << (clamp_bit - 1)) - 1
            y = torch.where(clamp, y.clamp(lo, hi), y)
        x = y
    return x


def _round_shift(v, bit: int):
    return (v + (1 << (bit - 1))) >> bit


def fadst4(x: torch.Tensor, cos_bit: int) -> torch.Tensor:
    """av1_fadst4 (sinpi-based) over (N, 4) int32, in the reference's
    order of int32 operations."""
    s = [int(v) for v in tables.sinpi(cos_bit)]
    x0, x1, x2, x3 = x.unbind(1)
    t0 = s[1] * x0 + s[2] * x1
    t1 = s[3] * ((x0 + x1) - x3)
    t2 = s[4] * x0 - s[1] * x1
    t3 = s[3] * x2
    t0 = t0 + s[4] * x3
    t2 = t2 + s[2] * x3
    return torch.stack([_round_shift(t0 + t3, cos_bit),
                        _round_shift(t1, cos_bit),
                        _round_shift(t2 - t3, cos_bit),
                        _round_shift((t2 - t0) + t3, cos_bit)], dim=1)


def iadst4(x: torch.Tensor, cos_bit: int) -> torch.Tensor:
    """av1_iadst4 (sinpi-based) over (N, 4) int32, in the reference's
    order of int32 operations."""
    s = [int(v) for v in tables.sinpi(cos_bit)]
    x0, x1, x2, x3 = x.unbind(1)
    t0 = s[1] * x0 + s[4] * x2
    t1 = s[2] * x0 - s[1] * x2
    t3 = s[3] * x1
    t2 = s[3] * ((x0 - x2) + x3)
    t0 = t0 + s[2] * x3
    t1 = t1 - s[4] * x3
    out = torch.stack([t0 + t3, t1 + t3, t2, (t0 + t1) - t3], dim=1)
    return _round_shift(out, cos_bit)


def identity(x: torch.Tensor, n: int) -> torch.Tensor:
    """av1_{f,i}identity{4,8,16,32} (the same both ways): a scale by
    2^(log2(n)/2), sqrt2-rounded at 4 and 16, in int32."""
    if n == 4:
        return _round_shift(x * NewSqrt2, NewSqrt2Bits)
    if n == 8:
        return x * 2
    if n == 16:
        return _round_shift(x * (2 * NewSqrt2), NewSqrt2Bits)
    assert n == 32
    return x * 4


def txfm_1d(x, n: int, type1d: TxType1D, cos_bit: int, inverse: bool,
            clamp_bit: int | None):
    """One 1-D transform of kind ``type1d`` over (N, n) int32 vectors
    (FLIPADST is ADST here: the flips are the 2-D functions')."""
    if type1d == TxType1D.IDTX:
        return identity(x, n)
    if type1d == TxType1D.DCT:
        return run_stages(x, f"av1_{'i' if inverse else 'f'}dct{n}", cos_bit,
                          clamp_bit)
    if n == 4:
        return iadst4(x, cos_bit) if inverse else fadst4(x, cos_bit)
    return run_stages(x, f"av1_{'i' if inverse else 'f'}adst{n}", cos_bit,
                      clamp_bit)


def _round_shift_arr(x, bit: int):
    """av1_round_shift_array: bit>0 round-shifts down, bit<0 scales up."""
    if bit == 0:
        return x
    if bit > 0:
        return (x + (1 << (bit - 1))) >> bit
    return x * (1 << -bit)


# ----------------------------------------------------------------------
# KB's plain version: square blocks, a per-block DCT / ADST choice
# ----------------------------------------------------------------------
def _sel_1d(x, n, cos_bit, use_adst, inverse, clamp_bit):
    """Per-vector DCT/ADST select. use_adst: None (all DCT) or (N,) bool."""
    d = txfm_1d(x, n, TxType1D.DCT, cos_bit, inverse, clamp_bit)
    if use_adst is None:
        return d
    a = txfm_1d(x, n, TxType1D.ADST, cos_bit, inverse, clamp_bit)
    return torch.where(use_adst[:, None], a, d)


def _tx_of(bs: int) -> int:
    if bs not in SQUARE_TX:
        raise NotImplementedError(
            f"{bs}x{bs} transform is not on the plan's path")
    return SQUARE_TX[bs]


def fwd_sel(res: torch.Tensor, vadst, hadst) -> torch.Tensor:
    """Forward 2-D transform of (B, bs, bs) int32 residuals with a per-block
    vertical/horizontal ADST choice ((B,) bool each, or None for DCT).
    Returns coefficients (B, W, H) int32 (av1_fwd_txfm2d_{n}x{n}_c)."""
    b, bs = res.shape[0], res.shape[-1]
    tx = _tx_of(bs)
    lw = bs.bit_length() - 3
    cb_col = int(FWD_COS_BIT_COL[lw][lw])
    cb_row = int(FWD_COS_BIT_ROW[lw][lw])
    fsh = FWD_SHIFT[tx]
    va = None if vadst is None else vadst.repeat_interleave(bs)
    ha = None if hadst is None else hadst.repeat_interleave(bs)
    # column pass along H, then row pass along W
    xc = res.transpose(1, 2).reshape(b * bs, bs)
    xc = _round_shift_arr(xc, -int(fsh[0]))
    xc = _sel_1d(xc, bs, cb_col, va, False, None)
    xc = _round_shift_arr(xc, -int(fsh[1]))
    xr = xc.reshape(b, bs, bs).transpose(1, 2).reshape(b * bs, bs)
    xr = _sel_1d(xr, bs, cb_row, ha, False, None)
    xr = _round_shift_arr(xr, -int(fsh[2]))
    return xr.reshape(b, bs, bs).transpose(1, 2).contiguous()


def inv_sel_add(coeff: torch.Tensor, pred: torch.Tensor, vadst,
                hadst) -> torch.Tensor:
    """Inverse 2-D transform of (B, W, H) coefficients + add to (B, bs, bs)
    pred with the 8-bit clamp (av1_inv_txfm2d_add_{n}x{n}_c)."""
    b, bs = coeff.shape[0], coeff.shape[-1]
    tx = _tx_of(bs)
    ish = INV_SHIFT[tx]
    va = None if vadst is None else vadst.repeat_interleave(bs)
    ha = None if hadst is None else hadst.repeat_interleave(bs)
    lo, hi = -(1 << 15), (1 << 15) - 1          # bd + 8 = 16-bit inputs
    xr = coeff.transpose(1, 2).reshape(b * bs, bs).clamp(lo, hi)
    xr = _sel_1d(xr, bs, INV_COS_BIT, ha, True, 16)
    xr = _round_shift_arr(xr, -int(ish[0]))
    xc = xr.reshape(b, bs, bs).transpose(1, 2).reshape(b * bs, bs)
    xc = xc.clamp(lo, hi)
    xc = _sel_1d(xc, bs, INV_COS_BIT, va, True, 16)
    xc = _round_shift_arr(xc, -int(ish[1]))
    resid = xc.reshape(b, bs, bs).transpose(1, 2)
    return (pred.to(resid.dtype) + resid).clamp(0, 255).to(torch.int32)


# ----------------------------------------------------------------------
# The reference's API: every tx size and type (plain versions)
# ----------------------------------------------------------------------
def _coded(n: int, t: TxType1D) -> bool:
    """Whether a 1-D kind exists at length n: all up to 16, DCT and IDTX
    at 32, DCT alone at 64."""
    if n <= 16:
        return True
    if n == 32:
        return t in (TxType1D.DCT, TxType1D.IDTX)
    return t == TxType1D.DCT


def valid_pair(tx_size: int, tx_type: int) -> bool:
    """Whether (tx_size, tx_type) is one of AV1's 193 valid pairs."""
    if not (0 <= int(tx_size) < len(TX_WIDTH) and 0 <= int(tx_type) < 16):
        return False
    v, h = TX_TYPE_1D[TxType(int(tx_type))]
    return (_coded(int(TX_HEIGHT[tx_size]), v)
            and _coded(int(TX_WIDTH[tx_size]), h))


def _pair(tx_size, tx_type):
    """(w, h, lw, lh, vtype, htype, ud_flip, lr_flip) of a valid pair;
    ValueError naming the pair otherwise."""
    if not valid_pair(tx_size, tx_type):
        raise ValueError(f"(tx_size {int(tx_size)}, tx_type {int(tx_type)})"
                         " is not a valid AV1 transform: ADST at 32 or 64 "
                         "points, IDTX at 64, or out of range")
    w, h = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
    v, hh = TX_TYPE_1D[TxType(int(tx_type))]
    return (w, h, w.bit_length() - 3, h.bit_length() - 3, v, hh,
            v == TxType1D.FLIPADST, hh == TxType1D.FLIPADST)


def _blocks(x, shape, what):
    if x.dim() != 3 or tuple(x.shape[1:]) != shape:
        raise ValueError(f"{what}: want (B, {shape[0]}, {shape[1]}), got "
                         f"{tuple(x.shape)}")
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise ValueError(f"{what}: want an integer tensor, got {x.dtype}")


def _inv_bd(bd: int) -> int:
    if bd not in INV_STAGE_RANGE:
        raise ValueError(f"bd must be 8, 10 or 12, got {bd}")
    return INV_STAGE_RANGE[bd]


def fwd_txfm2d_plain(res, tx_size: TxSize, tx_type: TxType, bd: int = 8):
    """Plain version of ``fwd_txfm2d`` (any device)."""
    w, h, lw, lh, vtype, htype, ud_flip, lr_flip = _pair(tx_size, tx_type)
    _blocks(res, (h, w), "fwd_txfm2d residuals")
    b = res.shape[0]
    shift = FWD_SHIFT[tx_size]
    x = res.to(torch.int32)
    if ud_flip:
        x = x.flip(1)
    # column pass: transform along H.  (B,H,W) -> (B*W, H)
    xc = x.transpose(1, 2).reshape(b * w, h)
    xc = _round_shift_arr(xc, -int(shift[0]))
    xc = txfm_1d(xc, h, vtype, int(FWD_COS_BIT_COL[lw][lh]), False, None)
    xc = _round_shift_arr(xc, -int(shift[1]))
    buf = xc.reshape(b, w, h).transpose(1, 2)  # (B, H=r, W=c)
    if lr_flip:
        buf = buf.flip(2)
    # row pass: transform along W.  (B,H,W) -> (B*H, W)
    xr = buf.reshape(b * h, w)
    xr = txfm_1d(xr, w, htype, int(FWD_COS_BIT_ROW[lw][lh]), False, None)
    xr = _round_shift_arr(xr, -int(shift[2]))
    if abs(lw - lh) == 1:
        xr = _round_shift(xr * NewSqrt2, NewSqrt2Bits)
    return xr.reshape(b, h, w).transpose(1, 2).contiguous()  # (B, W, H)


def inv_txfm2d_add_plain(coeff, pred, tx_size: TxSize, tx_type: TxType,
                         bd: int = 8):
    """Plain version of ``inv_txfm2d_add`` (any device)."""
    w, h, lw, lh, vtype, htype, ud_flip, lr_flip = _pair(tx_size, tx_type)
    opt_range = _inv_bd(bd)
    _blocks(coeff, (w, h), "inv_txfm2d_add coefficients")
    _blocks(pred, (h, w), "inv_txfm2d_add prediction")
    b = coeff.shape[0]
    shift = INV_SHIFT[tx_size]
    coeff = coeff.to(torch.int32)
    # 64-point transforms never code coefficients beyond index 31; the
    # reference zero-extends a compact <=32 input (av1_inv_txfm2d.c:348+).
    if w > 32 or h > 32:
        coeff = coeff.clone()
        coeff[:, 32:, :] = 0
        coeff[:, :, 32:] = 0
    clamp_in = bd + 8
    clamp_col_in = max(bd + 6, 16)
    # row pass: vectors over W at each r. coeff (B,W,H) -> (B*H, W)
    xr = coeff.transpose(1, 2).reshape(b * h, w)
    if abs(lw - lh) == 1:
        xr = _round_shift(xr * NewInvSqrt2, NewSqrt2Bits)
    xr = xr.clamp(-(1 << (clamp_in - 1)), (1 << (clamp_in - 1)) - 1)
    xr = txfm_1d(xr, w, htype, INV_COS_BIT, True, opt_range)
    xr = _round_shift_arr(xr, -int(shift[0]))
    buf = xr.reshape(b, h, w)
    if lr_flip:
        buf = buf.flip(2)
    # column pass: vectors over H at each c. (B,H,W) -> (B*W, H)
    xc = buf.transpose(1, 2).reshape(b * w, h)
    xc = xc.clamp(-(1 << (clamp_col_in - 1)), (1 << (clamp_col_in - 1)) - 1)
    xc = txfm_1d(xc, h, vtype, INV_COS_BIT, True, opt_range)
    xc = _round_shift_arr(xc, -int(shift[1]))
    resid = xc.reshape(b, w, h).transpose(1, 2)  # (B, H, W)
    if ud_flip:
        resid = resid.flip(1)
    rec = (pred.to(torch.int32) + resid).clamp(0, (1 << bd) - 1)
    return rec.to(pred.dtype)


def _wht_pass(x0, x1, x2, x3):
    """The forward WHT butterfly (av1_fwht4x4_c's pass): (a, c, d, b)."""
    a1 = x0 + x1
    d1 = x3 - x2
    e1 = (a1 - d1) >> 1
    b1 = e1 - x1
    c1 = e1 - x2
    return a1 - c1, c1, d1 + b1, b1


def _iwht_pass(x0, x1, x2, x3):
    """The inverse WHT butterfly (av1_highbd_iwht4x4_16_add_c's pass):
    (a, b, c, d)."""
    a1 = x0 + x1
    d1 = x2 - x3
    e1 = (a1 - d1) >> 1
    b1 = e1 - x3
    c1 = e1 - x1
    return a1 - b1, b1, c1, d1 + c1


def fwht4x4_plain(res):
    """Plain version of ``fwht4x4`` (any device)."""
    _blocks(res, (4, 4), "fwht4x4 residuals")
    x = res.to(torch.int32)
    # pass 1: butterflies down each column c; result inter[b, c, k]
    inter = torch.stack(_wht_pass(*x.unbind(1)), dim=2)
    # pass 2: for each i, butterfly over inter[:, j, i] (flat 4j+i)
    return torch.stack(_wht_pass(*inter.unbind(1)), dim=1) * 4


def iwht4x4_add_plain(coeff, pred, bd: int = 8):
    """Plain version of ``iwht4x4_add`` (any device)."""
    _blocks(coeff, (4, 4), "iwht4x4_add coefficients")
    _blocks(pred, (4, 4), "iwht4x4_add prediction")
    x = coeff.to(torch.int32) >> 2  # UNIT_QUANT_SHIFT
    # pass 1: for each r, butterfly over c (flat 4c+r)
    inter = torch.stack(_iwht_pass(*x.unbind(1)), dim=1)  # (B, j, i)
    # pass 2: for each i, butterfly over inter flat [i*4 + k]
    resid = torch.stack(_iwht_pass(*inter.unbind(2)), dim=1)
    rec = (pred.to(torch.int32) + resid).clamp(0, (1 << bd) - 1)
    return rec.to(pred.dtype)


# ----------------------------------------------------------------------
# kernel KR: the program table and the entries
# ----------------------------------------------------------------------
KIND_STAGES, KIND_ADST4, KIND_IDTX = 0, 1, 2
PASS_LEN = 10       # csrc/txfm2d.cu kPassLen
META_LEN = 12 + 2 * PASS_LEN


def stage_rows(stages, n: int) -> list:
    """The entries of one 1-D stage program (``_compiled_stages``) as
    kernels KB, KP and KR read them (``csrc/txfm.cuh``): per stage an
    (n, 4) int32 array, one (ia | ib << 8 | is_btf << 16 | clamp << 17,
    wa, wb, 0) per element."""
    rows = []
    for ia, ib, wa, wb, is_btf, clamp in stages:
        assert len(ia) == n and ia.max() < 256 and ib.max() < 256
        assert np.abs(wa).max() < 2**31 and np.abs(wb).max() < 2**31
        head = (ia.astype(np.int64) | ib.astype(np.int64) << 8
                | is_btf.astype(np.int64) << 16
                | clamp.astype(np.int64) << 17)
        rows.append(np.stack([head, wa, wb, np.zeros_like(head)],
                             axis=1).astype(np.int32))
    return rows


def _pass(rows, type1d, n, cos_bit, inverse, clamp_bit):
    """One 1-D program's descriptor (kind, n, n_stages, row offset,
    cos_bit, clamp_bit, sinpi[1..4]); its stage entries, if any, appended
    to ``rows`` (``stage_rows``: stage s at offset + s*n)."""
    if type1d == TxType1D.IDTX:
        return [KIND_IDTX, n, 0, 0, 0, 0, 0, 0, 0, 0]
    if type1d != TxType1D.DCT and n == 4:
        s = [int(v) for v in tables.sinpi(cos_bit)]
        return [KIND_ADST4, n, 0, 0, cos_bit, 0, *s[1:5]]
    kind = "dct" if type1d == TxType1D.DCT else "adst"
    stages = _compiled_stages(f"av1_{'i' if inverse else 'f'}{kind}{n}",
                              cos_bit)
    off = sum(len(r) for r in rows)
    rows += stage_rows(stages, n)
    return [KIND_STAGES, n, len(stages), off, cos_bit, clamp_bit or 0,
            0, 0, 0, 0]


def kr_program(tx_size: int, tx_type: int, inverse: bool, bd: int = 8):
    """The table of one KR launch, as ``csrc/txfm2d.cu`` reads it:
    ``stages`` (rows, 4) int32, the stage entries of the launch's two 1-D
    programs, and ``meta`` (META_LEN,) int32: w, h, ud_flip, lr_flip,
    rect (|log2 w - log2 h| == 1), bd, the three shifts (forward; the
    inverse's two and 0), the clamp of the first pass's input and of the
    second's (inverse: bd + 8, max(bd + 6, 16); forward 0), 0, then the
    descriptors of the first pass (forward: the columns, n = h; inverse:
    the rows, n = w) and of the second (``_pass``)."""
    w, h, lw, lh, vtype, htype, ud_flip, lr_flip = _pair(tx_size, tx_type)
    rows = []
    if inverse:
        opt = _inv_bd(bd)
        sh = [int(v) for v in INV_SHIFT[tx_size]] + [0]
        clamps = [bd + 8, max(bd + 6, 16)]
        first = _pass(rows, htype, w, INV_COS_BIT, True, opt)
        second = _pass(rows, vtype, h, INV_COS_BIT, True, opt)
    else:
        sh = [int(v) for v in FWD_SHIFT[tx_size]]
        clamps = [0, 0]
        first = _pass(rows, vtype, h, int(FWD_COS_BIT_COL[lw][lh]), False,
                      None)
        second = _pass(rows, htype, w, int(FWD_COS_BIT_ROW[lw][lh]), False,
                       None)
    meta = [w, h, int(ud_flip), int(lr_flip), int(abs(lw - lh) == 1), bd,
            *sh, *clamps, 0, *first, *second]
    assert len(meta) == META_LEN
    stages = np.concatenate(rows, 0) if rows else np.zeros((1, 4), np.int32)
    return stages, np.asarray(meta, np.int32)


@functools.cache
def _kr_tables(tx_size: int, tx_type: int, inverse: bool, bd: int,
               device: str):
    """``kr_program`` on ``device`` (stages, meta), uploaded once."""
    stages, meta = kr_program(tx_size, tx_type, inverse, bd)
    return (torch.as_tensor(stages, device=device).contiguous(),
            torch.as_tensor(meta, device=device))


def _on_card(x, shape, what):
    """x as a contiguous int32 tensor of ``shape`` on its card."""
    _blocks(x, shape[1:], what)
    return x.to(torch.int32).contiguous()


def fwd_txfm2d(res, tx_size: TxSize, tx_type: TxType, bd: int = 8):
    """Forward 2-D transform of residual blocks (av1_fwd_txfm2d_{W}x{H}_c).

    res: (B, H, W) integer tensor, taken as int32. Returns coefficients
    (B, W, H) int32, full size (a 64-point transform's coefficients beyond
    index 31 are computed, not zeroed). ``bd`` is accepted and ignored, as
    in the reference. CPU tensors: ``fwd_txfm2d_plain``; CUDA tensors: one
    KR launch."""
    if res.device.type == "cpu":
        return fwd_txfm2d_plain(res, tx_size, tx_type, bd)
    w, h = _pair(tx_size, tx_type)[:2]
    b = res.shape[0]
    x = _on_card(res, (b, h, w), "fwd_txfm2d residuals")
    out = torch.empty((b, w, h), dtype=torch.int32, device=x.device)
    if b:
        stages, meta = _kr_tables(int(tx_size), int(tx_type), False, 8,
                                  str(x.device))
        KR.launch("kr_fwd", x.data_ptr(), out.data_ptr(), b, w, h,
                  stages.data_ptr(), meta.data_ptr(), device=x.device.index,
                  variant="fwd")
    return out


def inv_txfm2d_add(coeff, pred, tx_size: TxSize, tx_type: TxType,
                   bd: int = 8):
    """Inverse 2-D transform + add to prediction with the pixel clamp
    (av1_inv_txfm2d_add_{W}x{H}_c: int32 internal, the stage clamps of
    ``bd``).

    coeff: (B, W, H) integer tensor (int32); pred: (B, H, W) integer
    pixels. Returns the recon (B, H, W) in pred's dtype. CPU tensors:
    ``inv_txfm2d_add_plain``; CUDA tensors: one KR launch."""
    if coeff.device.type == "cpu":
        return inv_txfm2d_add_plain(coeff, pred, tx_size, tx_type, bd)
    w, h = _pair(tx_size, tx_type)[:2]
    _inv_bd(bd)
    b = coeff.shape[0]
    c = _on_card(coeff, (b, w, h), "inv_txfm2d_add coefficients")
    p = _on_card(pred, (b, h, w), "inv_txfm2d_add prediction")
    need(p, torch.int32, (b, h, w), c.device.index, "inv_txfm2d_add pred")
    out = torch.empty((b, h, w), dtype=torch.int32, device=c.device)
    if b:
        stages, meta = _kr_tables(int(tx_size), int(tx_type), True, bd,
                                  str(c.device))
        KR.launch("kr_inv", c.data_ptr(), p.data_ptr(), out.data_ptr(), b,
                  w, h, stages.data_ptr(), meta.data_ptr(),
                  device=c.device.index, variant="inv")
    return out.to(pred.dtype)


def fwht4x4(res):
    """Lossless 4x4 Walsh-Hadamard forward transform (av1_fwht4x4_c).
    res: (B, 4, 4) natural (r, c), taken as int32; returns (B, 4, 4) int32
    in the C coefficient layout (flat c*4+r, shape (B, W, H)). CPU
    tensors: ``fwht4x4_plain``; CUDA tensors: one KR launch."""
    if res.device.type == "cpu":
        return fwht4x4_plain(res)
    b = res.shape[0]
    x = _on_card(res, (b, 4, 4), "fwht4x4 residuals")
    out = torch.empty((b, 4, 4), dtype=torch.int32, device=x.device)
    if b:
        KR.launch("kr_fwht", x.data_ptr(), out.data_ptr(), b,
                  device=x.device.index, variant="fwht")
    return out


def iwht4x4_add(coeff, pred, bd: int = 8):
    """Lossless 4x4 inverse WHT + add to prediction
    (av1_highbd_iwht4x4_16_add_c). coeff: (B, 4, 4) in the C layout (flat
    c*4+r, shape (B, W, H)); pred (B, 4, 4). Returns the recon in pred's
    dtype. CPU tensors: ``iwht4x4_add_plain``; CUDA tensors: one KR
    launch."""
    if coeff.device.type == "cpu":
        return iwht4x4_add_plain(coeff, pred, bd)
    b = coeff.shape[0]
    c = _on_card(coeff, (b, 4, 4), "iwht4x4_add coefficients")
    p = _on_card(pred, (b, 4, 4), "iwht4x4_add prediction")
    need(p, torch.int32, (b, 4, 4), c.device.index, "iwht4x4_add pred")
    out = torch.empty((b, 4, 4), dtype=torch.int32, device=c.device)
    if b:
        KR.launch("kr_iwht", c.data_ptr(), p.data_ptr(), out.data_ptr(), b,
                  bd, device=c.device.index, variant="iwht")
    return out.to(pred.dtype)
