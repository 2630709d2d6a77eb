"""Kernel KB ``txq_recon_skip``: residual -> forward 2-D transform ->
zbin-dead-zone quantize -> eob -> dequantize -> inverse transform + recon,
then the skip-RD decision, for a batch of square blocks (4, 8, 16, 32).

Replaces, inside the wavefronts, the reference's ``tpu_intra._quantize`` /
``_dequantize`` / ``_tq_recon`` / ``_tq_recon_uv`` (``tpu_intra.py:129-250``,
with the jnp path of ``ops/txfm._run_stages``) and ``_coeff_rate_est`` /
``_skip_rd`` (``tpu_intra.py:525-567``). ``txq_recon`` is the same kernel
with the skip decision off (the uniform-grid wavefronts never call
``_skip_rd``): it returns ``_tq_recon``'s levels, eob and recon.

Luma blocks are DCT_DCT; chroma blocks take the (vertical, horizontal)
ADST choice derived from their uv mode (``INTRA_MODE_TO_TX_TYPE``), given
per block as two bool vectors (``None`` = DCT). ADST4 is the sinpi-based
``av1_fadst4`` / ``av1_iadst4``, not a stage program.

Exactness notes shared with the kernel:
- the coefficient rate's per-level sum is taken exactly (the table values
  are half-integers: medians of integer costs), so it equals the
  reference's float32 sum whenever that sum is exact (below 2**23);
- ``floor(log2(x))`` is the integer bit length, not a float log; on the
  golomb tail it reproduces the reference's float32 mis-floors
  (``golomb_floor_log2``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..normative import tables
from ..normative import txsize as TS
from .txfm_host import _compiled_stages
from .txfm import (FWD_COS_BIT_COL, FWD_COS_BIT_ROW, FWD_SHIFT, INV_COS_BIT,
                   INV_SHIFT, SQUARE_TX, fwd_sel, inv_sel_add)
from ..kernels.build import CudaKernel, I, P

KB = CudaKernel("txq", {
    # src, pred, vadst, hadst, B, bs, dc_q, ac_q, shift, scan, skip,
    # lvl_tbl, eob_tbl, neob, rdm, progs, meta, levels, eob, recon, sse,
    # rate
    "txq_recon_skip": [P, P, P, P, I, I, I, I, I, P, I, P, P, I, P, P, P,
                       P, P, P, P, P],
})


def quantize(flat, dc_q: int, ac_q: int, shift: int):
    """av1_quantize_b-domain levels (B, n) int32: zbin dead zone of
    (84|80)/128 * q and 48/128 rounding (av1_quantize.c:590)."""
    n = flat.shape[-1]
    dqv = torch.full((n,), ac_q, dtype=torch.int32, device=flat.device)
    dqv[0] = dc_q
    zf = 84 if dc_q < 148 else 80
    rnd = (48 * dqv) >> 7
    zbin = (zf * dqv + 64) >> 7
    scaled = flat.abs() << shift
    lv = flat.sign() * torch.div(scaled + rnd, dqv, rounding_mode="floor")
    lv = torch.where(scaled < zbin, torch.zeros_like(lv), lv)
    return lv.clamp(-(1 << 15), (1 << 15) - 1).to(torch.int32)


def dequantize(levels, dc_q: int, ac_q: int, shift: int):
    n = levels.shape[-1]
    dqv = torch.full((n,), ac_q, dtype=torch.int32, device=levels.device)
    dqv[0] = dc_q
    mag = ((levels.abs() * dqv) & 0xFFFFFF) >> shift
    out = torch.where(levels < 0, -mag, mag)
    return out.clamp(-(1 << 15), (1 << 15) - 1).to(torch.int32)


def tq_recon(src, pred, dc_q: int, ac_q: int, scan, vadst=None, hadst=None):
    """(B,bs,bs) src/pred -> (levels (B,n), eob (B,), recon (B,bs,bs)),
    with a per-block ADST choice (``None`` = DCT_DCT)."""
    B, bs = src.shape[0], src.shape[-1]
    shift = TS.tx_scale(SQUARE_TX[bs])
    res = (src - pred).to(torch.int32)
    coeffs = fwd_sel(res, vadst, hadst)
    levels = quantize(coeffs.reshape(B, -1), dc_q, ac_q, shift)
    ls = levels[:, scan]
    idx = torch.arange(1, ls.shape[-1] + 1, dtype=torch.int32,
                       device=src.device)
    eob = torch.where(ls != 0, idx, torch.zeros_like(idx)).amax(-1)
    dq = dequantize(levels, dc_q, ac_q, shift)
    recon = inv_sel_add(dq.reshape(-1, bs, bs), pred, vadst, hadst)
    return levels, eob, recon


def floor_log2(x):
    """floor(log2(x)) of a positive integer tensor: bit length - 1."""
    return torch.frexp(x.to(torch.float64))[1] - 1


# The reference floors ``log2(big)`` of the golomb tail in float32
# (tpu_intra.py:538-541), and XLA's float32 log2 of 8192.0 and 32768.0
# comes out just below 13 and 15: there the reference charges one bit
# length less. Every other integer up to 2**21 floors exactly.
GOLOMB_MISFLOORS = (8192, 32768)


def golomb_floor_log2(big):
    """The reference's ``floor(log2(big))`` of the golomb tail (big >= 1):
    the bit length - 1, one less at big in GOLOMB_MISFLOORS."""
    fl = floor_log2(big)
    for m in GOLOMB_MISFLOORS:
        fl = fl - (big == m).to(fl.dtype)
    return fl


def coeff_rate_est(levels, eob, lvl_tbl, eob_tbl):
    """(B, n) levels + (B,) eob -> (B,) float32 estimated coefficient rate
    in 1/512-bit units (per-|level| base+br+sign cost, golomb tail, eob
    token + extra bits; tables of ec/costs.coeff_rate_tables)."""
    al = levels.abs()
    nz = al > 0
    lvl2 = (lvl_tbl * 2).to(torch.int64)              # exact half-units
    s2 = torch.where(nz, lvl2[al.clamp(0, 15).long()],
                     torch.zeros_like(al, dtype=torch.int64)).sum(-1)
    rate = (s2.to(torch.float64) * 0.5).to(torch.float32)
    nnz = nz.sum(-1)
    # zeros before the scan eob each cost the base-0 symbol
    rate = rate + (eob - nnz).to(torch.float32) * lvl_tbl[0]
    fl = golomb_floor_log2((al - 14).clamp(min=1))
    gol = torch.where(al >= 15, (2 * fl + 1) * 512,
                      torch.zeros_like(fl)).sum(-1)
    rate = rate + gol.to(torch.float32)
    # eob_pt = 1, 2, then 2 + floor(log2(eob - 1)) (eob_group_start)
    ptf = 2 + floor_log2((eob - 1).clamp(min=1))
    pt = torch.where(eob <= 2, eob.to(ptf.dtype), ptf)
    pt = pt.clamp(1, eob_tbl.shape[0])
    rate = rate + eob_tbl[pt.long() - 1]
    return torch.where(eob > 0, rate, torch.zeros_like(rate))


def skip_rd(levels, eob, recon, pred, src, rdm, lvl_tbl, eob_tbl):
    """Zero the block's residual when RD prefers prediction-only: compares
    2048*sse against the lambda-scaled estimated coefficient rate."""
    ssep = ((pred - src) ** 2).sum((-1, -2)).to(torch.float32)
    ssec = ((recon - src) ** 2).sum((-1, -2)).to(torch.float32)
    rate = coeff_rate_est(levels, eob, lvl_tbl, eob_tbl)
    skip = 2048.0 * (ssep - ssec) < (rdm / 512.0) * rate
    keep = eob > 0
    skip = skip & keep  # already-skipped blocks stay skipped
    levels = torch.where(skip[:, None], torch.zeros_like(levels), levels)
    eob = torch.where(skip, torch.zeros_like(eob), eob)
    recon = torch.where(skip[:, None, None], pred, recon)
    pred_only = skip | ~keep
    sse = torch.where(pred_only, ssep, ssec)
    rate = torch.where(pred_only, torch.zeros_like(rate), rate)
    return levels, eob, recon, sse, rate


def txq_recon_skip_plain(src, pred, dc_q, ac_q, scan, rdm, lvl_tbl, eob_tbl,
                         vadst=None, hadst=None):
    """Plain version of kernel KB: tq_recon followed by skip_rd."""
    lv, e, rec = tq_recon(src, pred, dc_q, ac_q, scan, vadst, hadst)
    return skip_rd(lv, e, rec, pred, src, rdm, lvl_tbl, eob_tbl)


# ----------------------------------------------------------------------
# kernel KB
# ----------------------------------------------------------------------
_PROG_ORDER = (("f", "dct", "col"), ("f", "adst", "col"),
               ("f", "dct", "row"), ("f", "adst", "row"),
               ("i", "dct", "row"), ("i", "adst", "row"),
               ("i", "dct", "col"), ("i", "adst", "col"))


@functools.cache
def _programs(bs: int, device: str):
    """Stage programs of the 8 1-D passes as one int32 table.

    ``progs``: per stage entry (ia, ib, wa, wb, is_btf | clamp << 1).
    ``meta``: 8 x (offset, n_stages, cos_bit, clamp_bit), then the forward
    shifts (3) and inverse shifts (2) of this tx size, then 8 x 5 sinpi
    constants. ``n_stages`` is -1 for ADST4, which the kernel computes
    from its pass's sinpi constants, and for ADST32 (not coded)."""
    tx = SQUARE_TX[bs]
    lw = bs.bit_length() - 3
    cos = {("f", "col"): int(FWD_COS_BIT_COL[lw][lw]),
           ("f", "row"): int(FWD_COS_BIT_ROW[lw][lw]),
           ("i", "col"): INV_COS_BIT, ("i", "row"): INV_COS_BIT}
    rows, meta, sinpi = [], [], []
    off = 0
    for d, kind, axis in _PROG_ORDER:
        cb = cos[(d, axis)]
        if kind == "adst" and bs not in (8, 16):
            meta += [0, -1, cb, 0]
            sinpi += [int(v) for v in tables.sinpi(cb)] if bs == 4 \
                else [0] * 5
            continue
        sinpi += [0] * 5
        stages = _compiled_stages(f"av1_{d}{kind}{bs}", cb)
        meta += [off, len(stages), cb, 16 if d == "i" else 0]
        for ia, ib, wa, wb, is_btf, clamp in stages:
            assert len(ia) == bs
            assert np.abs(wa).max() < 2**31 and np.abs(wb).max() < 2**31
            ent = np.stack([ia, ib, wa, wb,
                            is_btf.astype(np.int64)
                            | (clamp.astype(np.int64) << 1)], axis=1)
            rows.append(ent.astype(np.int32))
            off += bs
    meta += [int(v) for v in FWD_SHIFT[tx]] + [int(v) for v in INV_SHIFT[tx]]
    meta += sinpi
    progs = torch.as_tensor(np.concatenate(rows, 0), device=device)
    return progs.contiguous(), torch.as_tensor(np.asarray(meta, np.int32),
                                               device=device)


def _launch_kb(src, pred, dc_q, ac_q, scan, vadst, hadst, rd=None):
    """One KB launch; ``rd`` = (rdm, lvl_tbl, eob_tbl) turns the skip-RD
    decision on. Returns (levels, eob, recon, sse, rate); sse and rate are
    None without ``rd``."""
    B, bs = src.shape[0], src.shape[-1]
    if bs not in SQUARE_TX or (vadst is not None and bs == 32):
        raise ValueError(f"KB: unsupported bs={bs} / ADST at 32")
    n = bs * bs
    spec = ((src, (B, bs, bs), torch.int32), (pred, (B, bs, bs), torch.int32),
            (scan, (n,), torch.int32))
    if vadst is not None:
        spec += ((vadst, (B,), torch.bool), (hadst, (B,), torch.bool))
    if rd is not None:
        rdm, lvl_tbl, eob_tbl = rd
        spec += ((rdm, (B,), torch.float32), (lvl_tbl, (16,), torch.float32),
                 (eob_tbl, (eob_tbl.shape[0],), torch.float32))
    args = []
    for t, shape, dt in spec:
        if t.device.type != "cuda" or t.dtype != dt or \
                tuple(t.shape) != shape:
            raise ValueError(f"KB input: want {dt} {shape} on cuda, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        args.append(t.contiguous())
    src, pred, scan = args[:3]
    va, ha = (args[3].data_ptr(), args[4].data_ptr()) if vadst is not None \
        else (0, 0)
    dev = src.device
    progs, meta = _programs(bs, str(dev))
    levels = torch.empty((B, n), dtype=torch.int32, device=dev)
    eob = torch.empty((B,), dtype=torch.int32, device=dev)
    recon = torch.empty((B, bs, bs), dtype=torch.int32, device=dev)
    sse = rate = None
    ptrs = (0, 0, 0, 0, 0, 0)          # lvl_tbl, eob_tbl, neob, rdm, sse, rate
    if rd is not None:
        rdm, lvl_tbl, eob_tbl = args[-3:]
        sse = torch.empty((B,), dtype=torch.float32, device=dev)
        rate = torch.empty((B,), dtype=torch.float32, device=dev)
        ptrs = (lvl_tbl.data_ptr(), eob_tbl.data_ptr(), eob_tbl.shape[0],
                rdm.data_ptr(), sse.data_ptr(), rate.data_ptr())
    KB.launch("txq_recon_skip", src.data_ptr(), pred.data_ptr(), va, ha, B,
              bs, dc_q, ac_q, TS.tx_scale(SQUARE_TX[bs]), scan.data_ptr(),
              int(rd is not None), *ptrs[:4], progs.data_ptr(),
              meta.data_ptr(), levels.data_ptr(), eob.data_ptr(),
              recon.data_ptr(), *ptrs[4:],
              variant=f"bs{bs}" + ("" if rd is not None else " no-skip"))
    return levels, eob, recon, sse, rate


def txq_recon_skip(src, pred, dc_q: int, ac_q: int, scan, rdm, lvl_tbl,
                   eob_tbl, vadst=None, hadst=None):
    """(levels (B,n) int32, eob (B,) int32, recon (B,bs,bs) int32,
    sse (B,) f32, rate (B,) f32) as ``skip_rd(*tq_recon(...))`` returns
    them. CPU tensors: plain version; CUDA tensors: kernel KB."""
    if src.device.type == "cpu":
        return txq_recon_skip_plain(src, pred, dc_q, ac_q, scan, rdm,
                                    lvl_tbl, eob_tbl, vadst, hadst)
    return _launch_kb(src, pred, dc_q, ac_q, scan, vadst, hadst,
                      (rdm, lvl_tbl, eob_tbl))


def txq_recon(src, pred, dc_q: int, ac_q: int, scan, vadst=None,
              hadst=None):
    """(levels (B,n) int32, eob (B,) int32, recon (B,bs,bs) int32) as
    ``tq_recon`` returns them: KB with the skip decision off. CPU tensors:
    plain version (``tq_recon``); CUDA tensors: kernel KB."""
    if src.device.type == "cpu":
        return tq_recon(src, pred, dc_q, ac_q, scan, vadst, hadst)
    return _launch_kb(src, pred, dc_q, ac_q, scan, vadst, hadst)[:3]
