"""Torch stage interpreter for the AV1 square 2-D transforms the intra plan
uses: DCT 4/8/16/32 and ADST 4/8/16, forward and inverse.

Counterpart of ``aom_av1_psy_tpu/ops/txfm.py`` (``_run_stages`` :105,
``_fadst4`` / ``_iadst4`` :129-182, ``fwd_txfm2d`` :227,
``inv_txfm2d_add`` :266). The normative stage tables, shifts, cos bits and
sinpi constants are numpy data of the port's host transforms
(``ops/txfm_host.py``, the port's copy of the reference module:
``_compiled_stages``, ``FWD_SHIFT``, ``INV_SHIFT``, ``FWD_COS_BIT_*``,
``INV_COS_BIT``, ``tables.sinpi``). ADST4
is not a stage program: it is the sinpi-based ``av1_fadst4`` /
``av1_iadst4``, and like the reference it takes no stage clamp.

Arithmetic is int32 with two's-complement wraparound, as jnp's int32 is:
every stage is ``a*wa + b*wb`` (+ round-shift for butterflies) over a
``(N, n)`` batch of vectors. Layouts follow the reference: residual/pixel
blocks ``(B, H, W)``, coefficient blocks ``(B, W, H)`` (flat ``c*H + r``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..normative import tables
from ..normative.enums import TxSize, TX_WIDTH
from .txfm_host import (FWD_COS_BIT_COL, FWD_COS_BIT_ROW, FWD_SHIFT,
                         INV_COS_BIT, INV_SHIFT, _compiled_stages)

__all__ = ["FWD_COS_BIT_COL", "FWD_COS_BIT_ROW", "FWD_SHIFT", "INV_COS_BIT",
           "INV_SHIFT", "run_stages", "txfm_1d", "fwd_txfm2d",
           "inv_txfm2d_add", "fwd_sel", "inv_sel_add", "SQUARE_TX"]

SQUARE_TX = {4: int(TxSize.TX_4X4), 8: int(TxSize.TX_8X8),
             16: int(TxSize.TX_16X16), 32: int(TxSize.TX_32X32)}
# tx types the plan produces: (vertical ADST?, horizontal ADST?)
_TX_TYPE_FLAGS = {0: (False, False), 1: (True, False), 2: (False, True),
                  3: (True, True)}


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


def txfm_1d(x, n: int, adst: bool, cos_bit: int, inverse: bool,
            clamp_bit: int | None):
    if adst and n == 4:
        return iadst4(x, cos_bit) if inverse else fadst4(x, cos_bit)
    if adst and n not in (8, 16):
        raise NotImplementedError(f"ADST{n} is not on the plan's path")
    kind = "adst" if adst else "dct"
    return run_stages(x, f"av1_{'i' if inverse else 'f'}{kind}{n}", cos_bit,
                      clamp_bit)


def _round_shift_arr(x, bit: int):
    """av1_round_shift_array: bit>0 round-shifts down, bit<0 scales up."""
    if bit == 0:
        return x
    if bit > 0:
        return (x + (1 << (bit - 1))) >> bit
    return x * (1 << -bit)


def _sel_1d(x, n, cos_bit, use_adst, inverse, clamp_bit):
    """Per-vector DCT/ADST select. use_adst: None (all DCT) or (N,) bool."""
    d = txfm_1d(x, n, False, cos_bit, inverse, clamp_bit)
    if use_adst is None:
        return d
    a = txfm_1d(x, n, True, cos_bit, inverse, clamp_bit)
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


def _flags(n: int, tx_type: int, device):
    if tx_type not in _TX_TYPE_FLAGS:
        raise NotImplementedError(
            f"tx_type {tx_type} is not on the plan's path")
    v, h = _TX_TYPE_FLAGS[tx_type]
    if not (v or h):
        return None, None
    return (torch.full((n,), v, dtype=torch.bool, device=device),
            torch.full((n,), h, dtype=torch.bool, device=device))


def fwd_txfm2d(res: torch.Tensor, tx_size: int, tx_type: int = 0):
    """Square counterpart of the reference ``fwd_txfm2d`` (int32 input)."""
    if int(TX_WIDTH[tx_size]) != res.shape[-1]:
        raise ValueError("tx_size does not match the block")
    va, ha = _flags(res.shape[0], tx_type, res.device)
    return fwd_sel(res.to(torch.int32), va, ha)


def inv_txfm2d_add(coeff: torch.Tensor, pred: torch.Tensor, tx_size: int,
                   tx_type: int = 0):
    """Square counterpart of the reference ``inv_txfm2d_add`` (bd 8)."""
    if int(TX_WIDTH[tx_size]) != coeff.shape[-1]:
        raise ValueError("tx_size does not match the block")
    va, ha = _flags(coeff.shape[0], tx_type, coeff.device)
    return inv_sel_add(coeff.to(torch.int32), pred, va, ha)
