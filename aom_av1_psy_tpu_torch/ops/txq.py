"""Kernel KB: residual -> forward 2-D transform -> zbin-dead-zone quantize
-> eob -> dequantize -> inverse transform + recon, then the skip-RD
decision, for square blocks (4, 8, 16, 32). Two entries over one body
(``csrc/txq.cu``): the batched ``txq_recon_skip`` / ``txq_recon`` on
``(B, bs, bs)`` tensors (the P-frame's), and ``TxqStep``, the wavefronts'
in-place entry, which reads a diagonal's blocks where they lie and writes
its results into the plan's maps.

Replaces, inside the wavefronts, the reference's ``tpu_intra._quantize`` /
``_dequantize`` / ``_tq_recon`` / ``_tq_recon_uv`` (``tpu_intra.py:129-250``,
with the jnp path of ``ops/txfm._run_stages``) and ``_coeff_rate_est`` /
``_skip_rd`` (``tpu_intra.py:525-567``). ``txq_recon`` is the same kernel
with the skip decision off (the uniform-grid wavefronts never call
``_skip_rd``): it returns ``_tq_recon``'s levels, eob and recon.

Luma blocks are DCT_DCT; chroma blocks take the (vertical, horizontal)
ADST choice derived from their uv mode (``INTRA_MODE_TO_TX_TYPE``,
``uv_adst``), given per block as two bool vectors (``None`` = DCT). ADST4
is the sinpi-based ``av1_fadst4`` / ``av1_iadst4``, not a stage program.

Exactness notes shared with the kernel:
- the coefficient rate's per-level sum is taken exactly (the table values
  are half-integers: medians of integer costs), so it equals the
  reference's float32 sum whenever that sum is exact (below 2**23);
- ``floor(log2(x))`` is the integer bit length, not a float log; on the
  golomb tail it reproduces the reference's float32 mis-floors
  (``golomb_floor_log2``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..normative import tables
from ..normative import txsize as TS
from ..normative.blocks import INTRA_MODE_TO_TX_TYPE
from .txfm_host import _compiled_stages
from .txfm import (FWD_COS_BIT_COL, FWD_COS_BIT_ROW, FWD_SHIFT, INV_COS_BIT,
                   INV_SHIFT, SQUARE_TX, fwd_sel, inv_sel_add, stage_rows)
from ..kernels.build import CudaKernel, F, I, P, need


class _StepArgs(ctypes.Structure):
    """``csrc/txq.cu``'s ``StepArgs``, field for field."""
    _fields_ = ([(f, P) for f in (
        "tt", "rc", "cc", "src", "src_v", "pick", "pred", "tx_type", "rd",
        "rd_cell", "lvl_tbl", "eob_tbl", "stages", "meta", "scan", "levels",
        "eob", "buf", "loc", "stage", "cost", "forced", "no_split", "split",
        "m32", "m16", "mode16")]
        + [(f, F) for f in ("pr_none", "pr_split")]
        + [(f, I) for f in (
            "B", "bmax", "bs", "P", "T", "SH", "SW", "Hb", "Wb", "MR", "MC",
            "R", "C", "role", "qr", "qc", "dc_q", "ac_q", "shift", "skip",
            "neob", "luma")])


KB = CudaKernel("txq", {
    # src, pred, vadst, hadst, B, bs, dc_q, ac_q, shift, scan, skip,
    # lvl_tbl, eob_tbl, neob, rdm, stages, meta, levels, eob, recon, sse,
    # rate
    "txq_recon_skip": [P, P, P, P, I, I, I, I, I, P, I, P, P, I, P, P, P,
                       P, P, P, P, P],
    "txq_step": [ctypes.POINTER(_StepArgs)],
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
# kernel KB: the stage table and the batched entry
# ----------------------------------------------------------------------
_PROG_ORDER = (("f", "dct", "col"), ("f", "adst", "col"),
               ("f", "dct", "row"), ("f", "adst", "row"),
               ("i", "dct", "row"), ("i", "adst", "row"),
               ("i", "dct", "col"), ("i", "adst", "col"))
META_LEN = 77          # csrc/txfm.cuh kMetaLen


def stage_table(bs: int):
    """The stage programs of the 8 1-D passes at ``bs`` as kernels KB and
    KP copy them into shared memory (``csrc/txfm.cuh``): ``stages``
    (rows, 4) int32, one entry per stage and lane (ia | ib << 8 | is_btf <<
    16 | clamp << 17, wa, wb, 0), stage s of a pass at row offset + s*bs;
    ``meta`` (META_LEN,) int32: 8 x (offset, n_stages, cos_bit, clamp_bit),
    then the forward shifts (3) and inverse shifts (2) of this tx size,
    then 8 x 5 sinpi constants. ``n_stages`` is -1 for ADST4, which the
    kernel computes from its pass's sinpi constants, and for ADST32 (not
    coded)."""
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
        rows += stage_rows(stages, bs)
        off += bs * len(stages)
    meta += [int(v) for v in FWD_SHIFT[tx]] + [int(v) for v in INV_SHIFT[tx]]
    meta += sinpi
    assert len(meta) == META_LEN
    return np.concatenate(rows, 0), np.asarray(meta, np.int32)


@functools.cache
def _programs(bs: int, device: str):
    """``stage_table(bs)`` on ``device`` (stages, meta), uploaded once."""
    stages, meta = stage_table(bs)
    return (torch.as_tensor(stages, device=device).contiguous(),
            torch.as_tensor(meta, device=device))


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
        if t.device.type != "cuda" or t.device != src.device or \
                t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"KB input: want {dt} {shape} on {src.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        args.append(t.contiguous())
    src, pred, scan = args[:3]
    va, ha = (args[3].data_ptr(), args[4].data_ptr()) if vadst is not None \
        else (0, 0)
    dev = src.device
    stages, meta = _programs(bs, str(dev))
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
              int(rd is not None), *ptrs[:4], stages.data_ptr(),
              meta.data_ptr(), levels.data_ptr(), eob.data_ptr(),
              recon.data_ptr(), *ptrs[4:], device=dev.index,
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


# ----------------------------------------------------------------------
# kernel KB: the wavefronts' in-place entry
# ----------------------------------------------------------------------
@functools.cache
def _tx_types(device: str):
    return torch.as_tensor(INTRA_MODE_TO_TX_TYPE.astype(np.int32),
                           device=device)


def uv_adst(uv_mode):
    """(vertical, horizontal) ADST flags of the mode-DERIVED chroma tx type
    (decoder/frame.py:_uv_tx_type: INTRA_MODE_TO_TX_TYPE[uv_mode])."""
    tt = _tx_types(str(uv_mode.device))[uv_mode.long()]
    return (tt == 1) | (tt == 3), (tt == 2) | (tt == 3)


UNIFORM, CELL, QUAD = 0, 1, 2


class TxqStep:
    """Kernel KB's in-place entry for one call site of a wavefront: per
    diagonal step, one launch over the step's blocks that reads them where
    they lie and writes the results into the plan's own maps. Made once
    per wavefront by one of the factories below (its maps are checked and
    its argument block filled then); each call sets only the step's cells
    and KA's outputs. CPU tensors: the plain version (``_plain``:
    ``tq_recon`` + ``skip_rd`` and the same reads and writes); CUDA
    tensors: one KB launch.

    The call sites (``role``), each made by its factory:
    - ``UNIFORM`` (``uniform_step``): the uniform grid; no skip decision;
      block (rc, cc) of size ``bs``; its recon goes straight into ``buf``.
    - ``CELL`` (``luma_cell_step``, ``chroma_cell_step``): a partition cell
      (luma 32, chroma 16) with the skip decision; its recon goes to
      ``stage`` (b), and the cell's local window (``loc`` (b), side bs + 2)
      is first filled from ``buf``. Luma: ``cost[0, b]`` = the 32 path's
      float32 RD cost.
    - ``QUAD`` (``luma_quad_step``, ``chroma_quad_step``): quad (qr, qc) of
      a partition cell (luma 16, chroma 8); its recon goes into the cell's
      local window. Luma: the 16 path's cost accumulates in ``cost[1, b]``.
      Quad (1, 1) finishes the cell: the split (luma: forced | (cost16 <
      cost32) & ~no_split, written to ``split``; chroma: read from
      ``split``), the chosen recon (the local window or ``stage``) into
      ``buf``, and (luma) the four ``mode16`` context entries (``m16``
      where split, else ``m32``).

    Maps (contiguous, int32 unless named): ``src`` (T, SH, SW) the luma
    source plane, or ``src`` / ``src_v`` the U and V planes of a chroma
    pair (P = 2, the tx type derived from KA's mode); ``buf`` (P*T, Hb,
    Wb) recon planes with a 1-px guard border (plane p*T + t); ``levels``
    (T, P, MR, MC, bs*bs) and ``eob`` (T, P, MR, MC) at the block's
    position (rc, cc) or, for a quad, (2rc + qr, 2cc + qc); ``rd`` (T, MR,
    MC) float32 lambdas with ``rt`` = (lvl_tbl, eob_tbl); ``loc`` (P*Bmax,
    L, L) and ``stage`` (P*Bmax, cs, cs) (cs the cell side) scratch shared
    by a cell's launches; ``cost`` (2, Bmax) float32; ``rd_cell`` (T, R, C)
    float32 lambdas, ``forced`` / ``no_split`` (T, R, C) bool, ``split``
    (T, R, C), ``m32`` (T, R, C), ``m16`` / ``mode16`` (T, 2R, 2C).

    A call takes the step's cells ``tt``, ``rc``, ``cc`` (int64 (B,)), KA's
    ``pick`` (4, B) (its mode and rate rows) and ``pred`` (P*B, bs, bs)
    (block p*B + j is plane p of cell j)."""

    # the optional maps and scalars a factory may give, with their defaults
    _OPTIONAL = dict(rd=None, rt=None, loc=None, stage=None, cost=None,
                     rd_cell=None, forced=None, no_split=None, split=None,
                     m32=None, m16=None, mode16=None, pr_none=0.0,
                     pr_split=0.0)

    def __init__(self, role, bs, luma, srcs, buf, levels, eob, *, dc_q,
                 ac_q, scan, **maps):
        if bs not in SQUARE_TX or len(srcs) != (1 if luma else 2) or (
                not luma and bs == 32):
            raise ValueError(f"KB step: unsupported site (role {role}, bs "
                             f"{bs}, luma {luma}, planes {len(srcs)})")
        self.role, self.bs, self.luma = role, bs, luma
        self.srcs, self.P, self.T = srcs, len(srcs), srcs[0].shape[0]
        self.buf, self.levels, self.eob = buf, levels, eob
        self.dc_q, self.ac_q, self.scan = dc_q, ac_q, scan
        for k, v in self._OPTIONAL.items():
            setattr(self, k, maps.pop(k, v))
        assert not maps, f"KB step: unknown maps {sorted(maps)}"
        MR, MC = levels.shape[2:4]
        self.R, self.C = (MR // 2, MC // 2) if role == QUAD else (MR, MC)
        self._args = None
        if buf.device.type == "cuda":
            self._args = self._kernel_args(MR, MC)

    def _kernel_args(self, MR, MC):
        """The argument block, every map checked once."""
        bs, P, T, R, C = self.bs, self.P, self.T, self.R, self.C
        src = self.srcs[0]
        i32, f32, b8 = torch.int32, torch.float32, torch.bool
        self._di = src.get_device()
        chk = self._chk
        n = bs * bs
        cs = 2 * bs if self.role == QUAD else bs
        Hb, Wb = self.buf.shape[1:]
        stages, meta = _programs(bs, str(src.device))
        lvl = eobt = None
        if self.rd is not None:
            lvl, eobt = self.rt
            chk(eobt, f32, eobt.shape, "eob_tbl")
        bmax = (self.loc.shape[0] if self.loc is not None else 0) // P
        a = _StepArgs(
            src=chk(src, i32, src.shape, "src"),
            src_v=chk(self.srcs[1] if P == 2 else None, i32, src.shape,
                      "src_v"),
            tx_type=0 if self.luma else _tx_types(str(src.device)).data_ptr(),
            rd=chk(self.rd, f32, (T, MR, MC), "rd"),
            rd_cell=chk(self.rd_cell, f32, (T, R, C), "rd_cell"),
            lvl_tbl=chk(lvl, f32, (16,), "lvl_tbl"),
            eob_tbl=0 if eobt is None else eobt.data_ptr(),
            stages=stages.data_ptr(), meta=meta.data_ptr(),
            scan=chk(self.scan, i32, (n,), "scan"),
            levels=chk(self.levels, i32, (T, P, MR, MC, n), "levels"),
            eob=chk(self.eob, i32, (T, P, MR, MC), "eob"),
            buf=chk(self.buf, i32, (P * T, Hb, Wb), "buf"),
            loc=chk(self.loc, i32, (P * bmax, cs + 2, cs + 2), "loc"),
            stage=chk(self.stage, i32, (P * bmax, cs, cs), "stage"),
            cost=chk(self.cost, f32, (2, bmax), "cost"),
            forced=chk(self.forced, b8, (T, R, C), "forced"),
            no_split=chk(self.no_split, b8, (T, R, C), "no_split"),
            split=chk(self.split, i32, (T, R, C), "split"),
            m32=chk(self.m32, i32, (T, R, C), "m32"),
            m16=chk(self.m16, i32, (T, 2 * R, 2 * C), "m16"),
            mode16=chk(self.mode16, i32, (T, 2 * R, 2 * C), "mode16"),
            pr_none=self.pr_none, pr_split=self.pr_split, bmax=bmax,
            bs=bs, P=P, T=T, SH=src.shape[1], SW=src.shape[2], Hb=Hb, Wb=Wb,
            MR=MR, MC=MC, R=R, C=C, role=self.role, dc_q=self.dc_q,
            ac_q=self.ac_q, shift=TS.tx_scale(SQUARE_TX[bs]),
            skip=int(self.rd is not None),
            neob=0 if eobt is None else eobt.shape[0], luma=int(self.luma))
        self._bmax = bmax
        self._variant = f"step bs{bs}" + ("" if self.rd is not None
                                          else " no-skip")
        # the tables the block points at stay alive with it
        self._keep = (stages, meta)
        return a

    def _chk(self, t, dtype, shape, name):
        return need(t, dtype, shape, self._di, f"KB step {name}")

    def __call__(self, tt, rc, cc, pick, pred, qr=0, qc=0):
        if self._args is None:
            return self._plain(tt, rc, cc, pick, pred, qr, qc)
        B, bs, chk = rc.shape[0], self.bs, self._chk
        if (self.role != QUAD and (qr or qc)) or (
                self.role != UNIFORM and B > self._bmax):
            raise ValueError(f"KB step: B {B} > {self._bmax} or quad "
                             f"{qr},{qc} at role {self.role}")
        a = self._args
        a.tt = chk(tt, torch.int64, (B,), "tt")
        a.rc = chk(rc, torch.int64, (B,), "rc")
        a.cc = chk(cc, torch.int64, (B,), "cc")
        a.pick = chk(pick, torch.int32, (4, B), "pick")
        a.pred = chk(pred, torch.int32, (self.P * B, bs, bs), "pred")
        a.B, a.qr, a.qc = B, qr, qc
        KB.launch("txq_step", ctypes.byref(a), device=self._di,
                  variant=self._variant)

    # ------------------------------------------------------------------
    def _plain(self, tt, rc, cc, pick, pred, qr, qc):
        """Plain version: the wavefronts' former composition (gathers,
        ``txq_recon_skip_plain`` or ``tq_recon``, the float32 costs, the
        split and the scatters) on the same maps."""
        bs, P, T, B = self.bs, self.P, self.T, rc.shape[0]
        quad = self.role == QUAD
        cs = 2 * bs if quad else bs
        mi, mj = (2 * rc + qr, 2 * cc + qc) if quad else (rc, cc)

        def at(t, r0, c0, n):
            """Index of each (n, n) block at (r0, c0) of plane t."""
            a = torch.arange(n, device=rc.device)
            return (t[:, None, None], (r0[:, None] + a)[:, :, None],
                    (c0[:, None] + a)[:, None, :])

        def both(x):
            return torch.cat([x] * P)

        src = torch.cat([s[at(tt, rc * cs + qr * bs, cc * cs + qc * bs, bs)]
                         for s in self.srcs])
        va = ha = None
        if not self.luma:            # chroma: ADST from KA's mode
            va, ha = (both(f) for f in uv_adst(pick[1]))
        if self.rd is not None:
            rdm = self.rd[tt, mi, mj]
            lv, e, rec, sse, crate = txq_recon_skip_plain(
                src, pred, self.dc_q, self.ac_q, self.scan, both(rdm),
                *self.rt, va, ha)
        else:
            lv, e, rec = tq_recon(src, pred, self.dc_q, self.ac_q,
                                  self.scan, va, ha)
        for p in range(P):
            self.levels[tt, p, mi, mj] = lv[p * B:(p + 1) * B]
            self.eob[tt, p, mi, mj] = e[p * B:(p + 1) * B]
        planes = torch.cat([tt + p * T for p in range(P)])
        rcs, ccs = rc.repeat(P), cc.repeat(P)
        if self.role == UNIFORM:
            self.buf[at(planes, 1 + rcs * bs, 1 + ccs * bs, bs)] = rec
            return
        if self.role == CELL:
            self.stage[:P * B] = rec
            self.loc[:P * B] = self.buf[at(planes, rcs * bs, ccs * bs,
                                           bs + 2)]
        else:
            self.loc[:P * B, 1 + qr * bs:1 + qr * bs + bs,
                     1 + qc * bs:1 + qc * bs + bs] = rec
        if self.luma:
            mrate = pick[3].to(torch.float32)
            if not quad:
                self.cost[0, :B] = 2048.0 * sse + (rdm / 512.0) * (
                    mrate + crate + self.pr_none)
            else:
                prev = self.cost[1, :B] if (qr, qc) != (0, 0) else \
                    torch.zeros_like(sse)
                self.cost[1, :B] = prev + 2048.0 * sse + (rdm / 512.0) * (
                    mrate + crate)
        if not quad or (qr, qc) != (1, 1):
            return
        if self.luma:
            cost16 = self.cost[1, :B] + (self.rd_cell[tt, rc, cc] / 512.0) \
                * self.pr_split
            split = self.forced[tt, rc, cc] | (
                (cost16 < self.cost[0, :B]) & ~self.no_split[tt, rc, cc])
            self.split[tt, rc, cc] = split.to(torch.int32)
            for a in (0, 1):
                for b in (0, 1):
                    i, j = 2 * rc + a, 2 * cc + b
                    self.mode16[tt, i, j] = torch.where(
                        split, self.m16[tt, i, j], self.m32[tt, rc, cc])
        else:
            split = self.split[tt, rc, cc].bool()
        chosen = torch.where(both(split)[:, None, None],
                             self.loc[:P * B, 1:1 + cs, 1:1 + cs],
                             self.stage[:P * B])
        self.buf[at(planes, 1 + rcs * cs, 1 + ccs * cs, cs)] = chosen


# ----------------------------------------------------------------------
# the call sites of the wavefronts
# ----------------------------------------------------------------------
def uniform_step(bs, src, buf, levels, eob, *, dc_q, ac_q, scan, src_v=None):
    """The uniform grid's step (no skip decision): luma, or with ``src_v``
    the chroma U/V pair."""
    srcs = (src,) if src_v is None else (src, src_v)
    return TxqStep(UNIFORM, bs, src_v is None, srcs, buf, levels, eob,
                   dc_q=dc_q, ac_q=ac_q, scan=scan)


def luma_cell_step(src, buf, levels, eob, *, dc_q, ac_q, scan, rd, rt, loc,
                   stage, cost, pr_none):
    """The luma 32 cell of a partition step: its recon into ``stage``, the
    32 path's cost into ``cost[0]``."""
    return TxqStep(CELL, 32, True, (src,), buf, levels, eob, dc_q=dc_q,
                   ac_q=ac_q, scan=scan, rd=rd, rt=rt, loc=loc, stage=stage,
                   cost=cost, pr_none=pr_none)


def luma_quad_step(src, buf, levels, eob, *, dc_q, ac_q, scan, rd, rt, loc,
                   stage, cost, rd_cell, forced, no_split, split, m32, m16,
                   mode16, pr_split):
    """A luma 16 quad of a partition step; quad (1, 1) takes the split,
    writes it, the chosen recon and the mode context."""
    return TxqStep(QUAD, 16, True, (src,), buf, levels, eob, dc_q=dc_q,
                   ac_q=ac_q, scan=scan, rd=rd, rt=rt, loc=loc, stage=stage,
                   cost=cost, rd_cell=rd_cell, forced=forced,
                   no_split=no_split, split=split, m32=m32, m16=m16,
                   mode16=mode16, pr_split=pr_split)


def chroma_cell_step(src_u, src_v, buf, levels, eob, *, dc_q, ac_q, scan, rd,
                     rt, loc, stage):
    """The chroma 16 cell (the U/V pair) of a partition step."""
    return TxqStep(CELL, 16, False, (src_u, src_v), buf, levels, eob,
                   dc_q=dc_q, ac_q=ac_q, scan=scan, rd=rd, rt=rt, loc=loc,
                   stage=stage)


def chroma_quad_step(src_u, src_v, buf, levels, eob, *, dc_q, ac_q, scan, rd,
                     rt, loc, stage, split):
    """A chroma 8 quad (the U/V pair) of a partition step; quad (1, 1)
    writes the recon that the luma ``split`` chose."""
    return TxqStep(QUAD, 8, False, (src_u, src_v), buf, levels, eob,
                   dc_q=dc_q, ac_q=ac_q, scan=scan, rd=rd, rt=rt, loc=loc,
                   stage=stage, split=split)
