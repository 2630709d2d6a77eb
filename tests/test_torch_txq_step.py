"""Kernel KB's in-place entry (``ops/txq.TxqStep``): its plain version,
call by call, against the composition the wavefronts ran before it
(``txq_recon_skip_plain`` / ``tq_recon`` with the source and window
gathers, the float32 costs, the split and the scatters of
``encoder/tpu_intra.py``), written out here as the wavefronts had it; the
shared-memory stage table against ``txfm_host._compiled_stages``; the
argument block against the C struct. Tolerance: exact equality.

Every partition case is a T = 2 tiled step (two tile slabs of 3 x 4
cells, diagonal 2: B = 6 cells), with a random recon buffer as the
neighbours, forced and no_split cells, and blocks that are flat 0, flat
255 and a 0/255 checkerboard against extreme predictions.

The ``gpu``-marked tests hold the kernel against the plain version on a
CUDA device (every call site above, the P-frame's batches, KP) and skip
without one::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_txq_step.py
"""
import os
import re

import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.ec.context import FrameContext
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.normative.blocks import INTRA_MODE_TO_TX_TYPE
from aom_av1_psy_tpu_torch.ops import analyze as AN
from aom_av1_psy_tpu_torch.ops import txfm_host
from aom_av1_psy_tpu_torch.ops import txq as TQ
from aom_av1_psy_tpu_torch.ops.txfm import SQUARE_TX
from torch_threads import one_torch_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "aom_av1_psy_tpu_torch", "csrc")
R, C, T, D = 3, 4, 2, 2
Q = 100
DC_Q, AC_Q = tables.dc_quant(Q), tables.ac_quant(Q)
PR_NONE, PR_SPLIT = TTI._part_rate_scalars(FrameContext(Q))


# ----------------------------------------------------------------------
# seeded inputs
# ----------------------------------------------------------------------
def _cells(dev="cpu", t=T, r=R, c=C, d=D):
    tiles, rows, cols, offs = TTI._diagonals(r, c, t)
    return tuple(torch.as_tensor(a[offs[d]:offs[d + 1]], device=dev)
                 for a in (tiles, rows, cols))


def _patterned(plane, cells, bs):
    """Flat 0, flat 255 and a 0/255 checkerboard in the cells' blocks."""
    out = plane.copy()
    chk = (np.add.outer(np.arange(bs), np.arange(bs)) % 2) * 255
    for j, (t, r, c) in enumerate(zip(*(x.numpy() for x in cells))):
        blk = out[t, r * bs:r * bs + bs, c * bs:c * bs + bs]
        blk[...] = (0, 255, chk)[j % 3]
    return out


def _case(seed, pattern=False):
    rng = np.random.default_rng(seed)
    cells = _cells()

    def u8(*shape):
        return rng.integers(0, 256, shape).astype(np.int32)

    def smooth(*shape):
        # gradients with a little noise, so that residuals are small
        y, x = np.meshgrid(np.arange(shape[-2]), np.arange(shape[-1]),
                           indexing="ij")
        g, h = rng.uniform(-1, 1, (2,) + shape[:-2] + (1, 1))
        v = 128 + g * y + h * x + rng.integers(-6, 7, shape)
        return np.clip(v, 0, 255).astype(np.int32)

    def f32(*shape):
        return rng.uniform(2e3, 6e4, shape).astype(np.float32)

    c = {"y": smooth(T, 32 * R, 32 * C), "u": smooth(T, 16 * R, 16 * C),
         "v": smooth(T, 16 * R, 16 * C),
         "buf": u8(T, 32 * R + 34, 32 * C + 34),
         "bufs": u8(2, T, 16 * R + 18, 16 * C + 18),
         "rd32": f32(T, R, C), "rd16": f32(T, 2 * R, 2 * C),
         "m32": rng.integers(0, 13, (T, R, C)).astype(np.int32),
         "m16": rng.integers(0, 13, (T, 2 * R, 2 * C)).astype(np.int32),
         "mode16": rng.integers(0, 13, (T, 2 * R, 2 * C)).astype(np.int32),
         "split32": rng.integers(0, 2, (T, R, C)).astype(np.int32)}
    forced = np.zeros((T, R, C), bool)
    no_split = np.zeros((T, R, C), bool)
    tt, rc, cc = (x.numpy() for x in cells)
    forced[tt[0], rc[0], cc[0]] = True        # one forced, one no_split
    no_split[tt[1], rc[1], cc[1]] = True      # cell on the diagonal
    c["forced"], c["no_split"] = forced, no_split
    c["split32"][tt[:2], rc[:2], cc[:2]] = (1, 0)
    if pattern:
        c["y"] = _patterned(c["y"], cells, 32)
        c["u"] = _patterned(c["u"], cells, 16)
        c["v"] = _patterned(c["v"], cells, 16)
    out = {k: torch.as_tensor(v) for k, v in c.items()}
    out["rt"] = {k: tuple(torch.as_tensor(x) for x in v)
                 for k, v in TTI._rate_tables(FrameContext(Q)).items()}
    return out, cells, rng


def _pick_pred(rng, src, pattern):
    """KA's prediction for a call: per block the source plus +-1 noise, or
    plus a smooth offset (a few low coefficients: where the skip decision
    is close), or plus +-25 noise, or far from it; against the patterned
    blocks, the opposite extreme."""
    P_B, bs = src.shape[0], src.shape[-1]
    s = src.numpy().astype(np.int64)
    y, x = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    kind = rng.integers(0, 4, P_B)[:, None, None]
    off = (rng.uniform(-4, 4, (P_B, 1, 1))
           + rng.uniform(-.15, .15, (P_B, 1, 1)) * y
           + rng.uniform(-.15, .15, (P_B, 1, 1)) * x)
    noise = rng.uniform(-1, 1, s.shape)
    pred = np.where(kind == 0, s + np.round(noise),
                    np.where(kind == 1, s + np.round(off + noise),
                             np.where(kind == 2, s + np.round(25 * noise),
                                      rng.integers(0, 256, s.shape))))
    pred = np.clip(pred, 0, 255)
    if pattern:
        flat = s.reshape(P_B, -1)
        pred = np.where(flat.max(1)[:, None, None] == 0, 255,
                        np.where(flat.min(1)[:, None, None] == 255, 0,
                                 np.full_like(s, 128)))
    return pred.astype(np.int32)


def _pick(rng, B):
    pick = np.zeros((4, B), np.int32)
    pick[0] = rng.integers(0, 61, B)
    pick[1] = rng.integers(0, 13, B)
    pick[3] = rng.integers(0, 3000, B)
    return torch.as_tensor(pick)


def _blocks(planes, tt, r0, c0, bs):
    """The former source gather: plane tt's (bs, bs) block at (r0, c0)."""
    a = torch.arange(bs)
    return planes[tt[:, None, None], (r0[:, None] + a)[:, :, None],
                  (c0[:, None] + a)[:, None, :]]


def _both(x):
    return torch.cat([x, x])


# ----------------------------------------------------------------------
# the former composition, as the wavefronts ran it
# ----------------------------------------------------------------------
class OldLuma:
    """``_luma_wavefront_part``'s step (tpu_intra.py before KB's step
    entry): the 32 path, then the 16 quads in a local window copy."""

    def __init__(self, c):
        self.c = c
        self.buf = c["buf"].clone()
        self.lv32o = torch.zeros((T, R, C, 1024), dtype=torch.int32)
        self.e32o = torch.zeros((T, R, C), dtype=torch.int32)
        self.lv16o = torch.zeros((T, 2 * R, 2 * C, 256), dtype=torch.int32)
        self.e16o = torch.zeros((T, 2 * R, 2 * C), dtype=torch.int32)
        self.split_out = torch.zeros((T, R, C), dtype=torch.int32)
        self.mode16 = c["mode16"].clone()

    def step32(self, tt, rc, cc, pick32, pred32):
        c = self.c
        src4 = c["y"].view(T, R, 32, C, 32)
        src32 = src4[tt, rc, :, cc, :]
        rdm32 = c["rd32"][tt, rc, cc]
        lv32, e32, rec32, sse32, crate32 = TQ.txq_recon_skip_plain(
            src32, pred32, DC_Q, AC_Q, TTI._scan(TTI.BS_TO_TX[32], "cpu"),
            rdm32, *c["rt"]["y32"])
        self.cost32 = 2048.0 * sse32 + (rdm32 / 512.0) * (
            pick32[3].to(torch.float32) + crate32 + PR_NONE)
        self.rec32, self.rdm32, self.ymode32 = rec32, rdm32, pick32[1]
        windows = self.buf.unfold(1, 34, 32).unfold(2, 34, 32)
        self.loc = windows[tt, rc, cc]
        self.cost16 = torch.zeros_like(self.cost32)
        self.subs = []
        self.lv32, self.e32 = lv32, e32

    def quad(self, tt, rc, cc, qr, qc, pick16, pr):
        c = self.c
        src32 = c["y"].view(T, R, 32, C, 32)[tt, rc, :, cc, :]
        s16 = src32[:, qr * 16:qr * 16 + 16, qc * 16:qc * 16 + 16]
        rdm16 = c["rd16"][tt, 2 * rc + qr, 2 * cc + qc]
        lv, e, rec, sse, crate = TQ.txq_recon_skip_plain(
            s16, pr, DC_Q, AC_Q, TTI._scan(TTI.BS_TO_TX[16], "cpu"), rdm16,
            *c["rt"]["y16"])
        self.cost16 = self.cost16 + 2048.0 * sse + (rdm16 / 512.0) * (
            pick16[3].to(torch.float32) + crate)
        self.loc[:, 1 + qr * 16:17 + qr * 16, 1 + qc * 16:17 + qc * 16] = rec
        self.subs.append((pick16[1], lv, e))
        if (qr, qc) == (1, 1):
            self.finish(tt, rc, cc)

    def finish(self, tt, rc, cc):
        c = self.c
        self.cost16 = self.cost16 + (self.rdm32 / 512.0) * PR_SPLIT
        split = c["forced"][tt, rc, cc] | (
            (self.cost16 < self.cost32) & ~c["no_split"][tt, rc, cc])
        cells = self.buf[:, 1:1 + 32 * R, 1:1 + 32 * C].unfold(
            1, 32, 32).unfold(2, 32, 32)
        cells[tt, rc, cc] = torch.where(split[:, None, None],
                                        self.loc[:, 1:33, 1:33], self.rec32)
        self.split_out[tt, rc, cc] = split.to(torch.int32)
        self.lv32o[tt, rc, cc] = self.lv32
        self.e32o[tt, rc, cc] = self.e32
        ymode32 = self.ymode32
        for (qr, qc), (ym16, lv, e) in zip(TTI._QUADS, self.subs):
            rq, cq = 2 * rc + qr, 2 * cc + qc
            self.lv16o[tt, rq, cq] = lv
            self.e16o[tt, rq, cq] = e
            self.mode16[tt, rq, cq] = torch.where(split, ym16, ymode32)
        self.split = split


class OldChroma:
    """``_chroma_wavefront_part``'s step: the 16 pair, the 8 quad pairs in
    local window copies, the split from the luma map."""

    def __init__(self, c):
        self.c = c
        self.bufs = c["bufs"].clone()
        self.uvlv16o = torch.zeros((T, 2, R, C, 256), dtype=torch.int32)
        self.uve16o = torch.zeros((T, 2, R, C), dtype=torch.int32)
        self.uvlv8o = torch.zeros((T, 2, 2 * R, 2 * C, 64),
                                  dtype=torch.int32)
        self.uve8o = torch.zeros((T, 2, 2 * R, 2 * C), dtype=torch.int32)

    def src(self, tt, rc, cc):
        return torch.cat([self.c[p].view(T, R, 16, C, 16)[tt, rc, :, cc, :]
                          for p in "uv"])

    def step16(self, tt, rc, cc, pick16, pred):
        c = self.c
        sb = self.src(tt, rc, cc)
        va, ha = TTI._uv_adst(pick16[1])
        self.lv16, self.e16, self.rec16, _, _ = TQ.txq_recon_skip_plain(
            sb, pred, DC_Q, AC_Q, TTI._scan(TTI.BS_TO_TX[16], "cpu"),
            _both(c["rd32"][tt, rc, cc]), *c["rt"]["uv16"],
            vadst=_both(va), hadst=_both(ha))
        windows = self.bufs.unfold(2, 18, 16).unfold(3, 18, 16)
        self.locs = windows[:, tt, rc, cc].reshape(2 * rc.shape[0], 18, 18)
        self.subs8 = []

    def quad(self, tt, rc, cc, qr, qc, p8, pred):
        c = self.c
        sb8 = self.src(tt, rc, cc)[:, qr * 8:qr * 8 + 8, qc * 8:qc * 8 + 8]
        va, ha = TTI._uv_adst(p8[1])
        rdm16 = c["rd16"][tt, 2 * rc + qr, 2 * cc + qc]
        lv, e, rec, _, _ = TQ.txq_recon_skip_plain(
            sb8, pred, DC_Q, AC_Q, TTI._scan(TTI.BS_TO_TX[8], "cpu"),
            _both(rdm16), *c["rt"]["uv8"], vadst=_both(va),
            hadst=_both(ha))
        self.locs[:, 1 + qr * 8:9 + qr * 8, 1 + qc * 8:9 + qc * 8] = rec
        self.subs8.append((lv, e))
        if (qr, qc) == (1, 1):
            self.finish(tt, rc, cc)

    def finish(self, tt, rc, cc):
        B = rc.shape[0]
        split = self.c["split32"][tt, rc, cc].bool()
        rec = torch.where(_both(split)[:, None, None],
                          self.locs[:, 1:17, 1:17], self.rec16)
        cells = self.bufs[:, :, 1:1 + 16 * R, 1:1 + 16 * C].unfold(
            2, 16, 16).unfold(3, 16, 16)
        for p in range(2):
            cells[p, tt, rc, cc] = rec[p * B:(p + 1) * B]
            self.uvlv16o[tt, p, rc, cc] = self.lv16[p * B:(p + 1) * B]
            self.uve16o[tt, p, rc, cc] = self.e16[p * B:(p + 1) * B]
        for (qr, qc), (lv, e) in zip(TTI._QUADS, self.subs8):
            rq, cq = 2 * rc + qr, 2 * cc + qc
            for p in range(2):
                self.uvlv8o[tt, p, rq, cq] = lv[p * B:(p + 1) * B]
                self.uve8o[tt, p, rq, cq] = e[p * B:(p + 1) * B]


# ----------------------------------------------------------------------
# the new entry on the same inputs
# ----------------------------------------------------------------------
def _luma_sites(c, dev="cpu"):
    on = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in c.items()}
    rt = {k: tuple(x.to(dev) for x in v) for k, v in c["rt"].items()}
    i32 = dict(dtype=torch.int32, device=dev)
    m = {"buf": on["buf"].clone(), "mode16": on["mode16"].clone(),
         "m32": on["m32"].clone(), "m16": on["m16"].clone(),
         "split": torch.zeros((T, R, C), **i32),
         "lv32o": torch.zeros((T, R, C, 1024), **i32),
         "e32o": torch.zeros((T, R, C), **i32),
         "lv16o": torch.zeros((T, 2 * R, 2 * C, 256), **i32),
         "e16o": torch.zeros((T, 2 * R, 2 * C), **i32),
         "loc": torch.zeros((T * 3, 34, 34), **i32),
         "stage": torch.zeros((T * 3, 32, 32), **i32),
         "cost": torch.zeros((2, T * 3), dtype=torch.float32, device=dev)}
    common = dict(dc_q=DC_Q, ac_q=AC_Q, loc=m["loc"], stage=m["stage"],
                  cost=m["cost"])
    kb32 = TQ.luma_cell_step(on["y"], m["buf"], m["lv32o"][:, None],
                             m["e32o"][:, None],
                             scan=TTI._scan(TTI.BS_TO_TX[32], str(dev)),
                             rd=on["rd32"], rt=rt["y32"], pr_none=PR_NONE,
                             **common)
    kb16 = TQ.luma_quad_step(on["y"], m["buf"], m["lv16o"][:, None],
                             m["e16o"][:, None],
                             scan=TTI._scan(TTI.BS_TO_TX[16], str(dev)),
                             rd=on["rd16"], rt=rt["y16"], rd_cell=on["rd32"],
                             forced=on["forced"], no_split=on["no_split"],
                             split=m["split"], m32=m["m32"], m16=m["m16"],
                             mode16=m["mode16"], pr_split=PR_SPLIT, **common)
    return m, kb32, kb16


def _chroma_sites(c, dev="cpu"):
    on = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in c.items()}
    rt = {k: tuple(x.to(dev) for x in v) for k, v in c["rt"].items()}
    i32 = dict(dtype=torch.int32, device=dev)
    m = {"bufs": on["bufs"].clone(),
         "uvlv16o": torch.zeros((T, 2, R, C, 256), **i32),
         "uve16o": torch.zeros((T, 2, R, C), **i32),
         "uvlv8o": torch.zeros((T, 2, 2 * R, 2 * C, 64), **i32),
         "uve8o": torch.zeros((T, 2, 2 * R, 2 * C), **i32),
         "loc": torch.zeros((2 * T * 3, 18, 18), **i32),
         "stage": torch.zeros((2 * T * 3, 16, 16), **i32)}
    planes = m["bufs"].view(2 * T, 16 * R + 18, 16 * C + 18)
    common = dict(dc_q=DC_Q, ac_q=AC_Q, loc=m["loc"], stage=m["stage"])
    kb16 = TQ.chroma_cell_step(on["u"], on["v"], planes, m["uvlv16o"],
                               m["uve16o"],
                               scan=TTI._scan(TTI.BS_TO_TX[16], str(dev)),
                               rd=on["rd32"], rt=rt["uv16"], **common)
    kb8 = TQ.chroma_quad_step(on["u"], on["v"], planes, m["uvlv8o"],
                              m["uve8o"],
                              scan=TTI._scan(TTI.BS_TO_TX[8], str(dev)),
                              rd=on["rd16"], rt=rt["uv8"],
                              split=on["split32"], **common)
    return m, kb16, kb8


def _pick_writes(m, tt, rc, cc, qr, qc, pick):
    """What KA's pick writes before KB runs: its mode into ``m32`` (the 32
    call) or ``m16`` (quad (qr, qc))."""
    if qr is None:
        m["m32"][tt, rc, cc] = pick[1]
    else:
        m["m16"][tt, 2 * rc + qr, 2 * cc + qc] = pick[1]


def _luma_calls(c, rng, pattern):
    """The step's KA outputs, call by call: (qr, qc, pick, pred) with
    (None, None) for the 32 call."""
    tt, rc, cc = _cells()
    B = rc.shape[0]
    out = [(None, None, _pick(rng, B), torch.as_tensor(_pick_pred(
        rng, _blocks(c["y"], tt, rc * 32, cc * 32, 32), pattern)))]
    for qr, qc in TTI._QUADS:
        s16 = _blocks(c["y"], tt, rc * 32 + qr * 16, cc * 32 + qc * 16, 16)
        out.append((qr, qc, _pick(rng, B),
                    torch.as_tensor(_pick_pred(rng, s16, pattern))))
    return out


def _chroma_calls(c, rng, pattern):
    tt, rc, cc = _cells()
    B = rc.shape[0]

    def src(r0, c0, bs):
        return torch.cat([_blocks(c[p], tt, r0, c0, bs) for p in "uv"])

    out = [(None, None, _pick(rng, B), torch.as_tensor(_pick_pred(
        rng, src(rc * 16, cc * 16, 16), pattern)))]
    for qr, qc in TTI._QUADS:
        s8 = src(rc * 16 + qr * 8, cc * 16 + qc * 8, 8)
        out.append((qr, qc, _pick(rng, B),
                    torch.as_tensor(_pick_pred(rng, s8, pattern))))
    return out


def _eq(got, want, what):
    assert torch.equal(got.cpu(), want.cpu()), what


def _check_luma(m, old, B, upto):
    """The new maps against the old composition after call ``upto`` (0:
    the 32 call, 1-4: the quads)."""
    tt, rc, cc = _cells()
    if upto == 0:
        _eq(m["lv32o"][tt, rc, cc], old.lv32, "lv32")
        _eq(m["e32o"][tt, rc, cc], old.e32, "e32")
        _eq(m["stage"][:B], old.rec32, "rec32")
        _eq(m["cost"][0, :B], old.cost32, "cost32")
    if upto < 4:
        _eq(m["loc"][:B], old.loc, "local window")
        if upto > 0:
            _eq(m["cost"][1, :B], old.cost16, "cost16")
        for (qr, qc), (_, lv, e) in zip(TTI._QUADS[:upto], old.subs):
            rq, cq = 2 * rc + qr, 2 * cc + qc
            _eq(m["lv16o"][tt, rq, cq], lv, f"lv16 {qr}{qc}")
            _eq(m["e16o"][tt, rq, cq], e, f"e16 {qr}{qc}")
        return
    for k in ("buf", "mode16", "lv32o", "e32o", "lv16o", "e16o"):
        _eq(m[k], getattr(old, k), k)
    _eq(m["split"], old.split_out, "split")


@pytest.mark.parametrize("seed,pattern", [(2, False), (3, False),
                                          (6, True)])
def test_luma_step_equals_old_composition(seed, pattern):
    """Luma 32, then each 16 quad (quad (1, 1) with the epilogue), state
    compared after every call."""
    c, (tt, rc, cc), rng = _case(seed, pattern)
    B = rc.shape[0]
    m, kb32, kb16 = _luma_sites(c)
    old = OldLuma(c)
    for k, (qr, qc, pick, pred) in enumerate(_luma_calls(c, rng, pattern)):
        _pick_writes(m, tt, rc, cc, qr, qc, pick)
        if qr is None:
            kb32(tt, rc, cc, pick, pred)
            old.step32(tt, rc, cc, pick, pred)
        else:
            kb16(tt, rc, cc, pick, pred, qr, qc)
            old.quad(tt, rc, cc, qr, qc, pick, pred)
        _check_luma(m, old, B, k)
    # the case reaches both choices, a forced and a no_split cell
    assert old.split.any() and not old.split.all()
    assert old.split[0] and not old.split[1]


def test_luma_cases_reach_skips_and_codes():
    """The luma cases code blocks, code nothing, and skip coded blocks."""
    eobs, skipped = [], 0
    c, (tt, rc, cc), rng = _case(3)
    for qr, qc, pick, pred in _luma_calls(c, rng, False):
        bs, key = (32, "y32") if qr is None else (16, "y16")
        r0, c0 = rc * 32 + (qr or 0) * 16, cc * 32 + (qc or 0) * 16
        s = _blocks(c["y"], tt, r0, c0, bs)
        rd = c["rd32"][tt, rc, cc] if qr is None else \
            c["rd16"][tt, 2 * rc + qr, 2 * cc + qc]
        scan = TTI._scan(TTI.BS_TO_TX[bs], "cpu")
        e = TQ.txq_recon_skip_plain(s, pred, DC_Q, AC_Q, scan, rd,
                                    *c["rt"][key])[1]
        e_all = TQ.tq_recon(s, pred, DC_Q, AC_Q, scan)[1]
        eobs.append(e)
        skipped += int((e != e_all).sum())
    eobs = torch.cat(eobs)
    assert (eobs == 0).any() and (eobs > 0).any() and skipped > 0


@pytest.mark.parametrize("seed,pattern", [(4, False), (5, True)])
def test_chroma_step_equals_old_composition(seed, pattern):
    """The chroma 16 pair (ADST from the mode), then each 8 quad pair
    (quad (1, 1) selects by the luma split), compared after every call."""
    c, (tt, rc, cc), rng = _case(seed, pattern)
    B = rc.shape[0]
    m, kb16, kb8 = _chroma_sites(c)
    old = OldChroma(c)
    calls = _chroma_calls(c, rng, pattern)
    for qr, qc, pick, pred in calls:
        if qr is None:
            kb16(tt, rc, cc, pick, pred)
            old.step16(tt, rc, cc, pick, pred)
            _eq(m["stage"][:2 * B], old.rec16, "rec16")
            for p in range(2):
                _eq(m["uvlv16o"][tt, p, rc, cc],
                    old.lv16[p * B:(p + 1) * B], "uvlv16")
                _eq(m["uve16o"][tt, p, rc, cc],
                    old.e16[p * B:(p + 1) * B], "uve16")
        else:
            kb8(tt, rc, cc, pick, pred, qr, qc)
            old.quad(tt, rc, cc, qr, qc, pick, pred)
        if (qr, qc) != (1, 1):
            _eq(m["loc"][:2 * B], old.locs, "local windows")
    for k in ("bufs", "uvlv16o", "uve16o", "uvlv8o", "uve8o"):
        _eq(m[k], getattr(old, k), k)
    split = c["split32"][tt, rc, cc]
    assert split.any() and not split.all()
    tx = INTRA_MODE_TO_TX_TYPE[np.concatenate([p[1].numpy()
                                               for _, _, p, _ in calls])]
    assert all((tx == k).any() for k in range(4))


# ----------------------------------------------------------------------
# the uniform grid: luma bs 8, chroma bs 4 pairs
# ----------------------------------------------------------------------
UR, UC = 4, 5


def _uniform_case(seed, bs, pattern):
    rng = np.random.default_rng(seed)
    cells = _cells(t=1, r=UR, c=UC, d=3)
    planes = [rng.integers(0, 256, (1, UR * bs, UC * bs)).astype(np.int32)
              for _ in range(2)]
    if pattern:
        planes = [_patterned(p, cells, bs) for p in planes]
    buf = rng.integers(0, 256, (2, UR * bs + bs + 2,
                                UC * bs + bs + 2)).astype(np.int32)
    return [torch.as_tensor(p) for p in planes], torch.as_tensor(buf), \
        cells, rng


def _old_uniform(planes, bufs, tt, rc, cc, pick, pred, bs, chroma):
    """``_luma_wavefront`` / ``_chroma_wavefront``'s step."""
    n = bs * bs
    P = 2 if chroma else 1
    levels_out = torch.zeros((P, UR, UC, n), dtype=torch.int32)
    eob_out = torch.zeros((P, UR, UC), dtype=torch.int32)
    B = rc.shape[0]
    sb = torch.cat([pl[0].view(UR, bs, UC, bs)[rc, :, cc, :]
                    for pl in planes[:P]])
    va = ha = None
    if chroma:
        va, ha = (_both(f) for f in TTI._uv_adst(pick[1]))
    levels, eob, recon = TQ.txq_recon(sb, pred, DC_Q, AC_Q,
                                      TTI._scan(TTI.BS_TO_TX[bs], "cpu"),
                                      va, ha)
    cells = bufs[:, 1:1 + UR * bs, 1:1 + UC * bs].unfold(1, bs, bs).unfold(
        2, bs, bs)
    for p in range(P):
        cells[p, rc, cc] = recon[p * B:(p + 1) * B]
        levels_out[p, rc, cc] = levels[p * B:(p + 1) * B]
        eob_out[p, rc, cc] = eob[p * B:(p + 1) * B]
    return levels_out, eob_out


def _new_uniform(planes, bufs, tt, rc, cc, pick, pred, bs, chroma,
                 dev="cpu"):
    n = bs * bs
    P = 2 if chroma else 1
    levels_out = torch.zeros((P, UR, UC, n), dtype=torch.int32, device=dev)
    eob_out = torch.zeros((P, UR, UC), dtype=torch.int32, device=dev)
    kb = TQ.uniform_step(bs, planes[0].to(dev), bufs[:P], levels_out[None],
                         eob_out[None],
                         src_v=planes[1].to(dev) if chroma else None,
                         dc_q=DC_Q, ac_q=AC_Q,
                         scan=TTI._scan(TTI.BS_TO_TX[bs], str(dev)))
    kb(*(x.to(dev) for x in (tt, rc, cc, pick, pred)))
    return levels_out, eob_out


@pytest.mark.parametrize("bs,chroma,pattern", [(8, False, False),
                                               (8, False, True),
                                               (4, True, False),
                                               (4, True, True)])
def test_uniform_step_equals_old_composition(bs, chroma, pattern):
    planes, buf, (tt, rc, cc), rng = _uniform_case(10 + bs, bs, pattern)
    P = 2 if chroma else 1
    src = torch.cat([_blocks(pl, tt, rc * bs, cc * bs, bs)
                     for pl in planes[:P]])
    pick = _pick(rng, rc.shape[0])
    pred = torch.as_tensor(_pick_pred(rng, src, pattern))
    old_buf, new_buf = buf.clone(), buf.clone()
    want = _old_uniform(planes, old_buf, tt, rc, cc, pick, pred, bs, chroma)
    got = _new_uniform(planes, new_buf, tt, rc, cc, pick, pred, bs, chroma)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(new_buf[:P], old_buf[:P])
    assert (want[1] > 0).any()


def test_step_refuses_unsupported_sites():
    c, _, _ = _case(1)
    i32 = torch.int32
    with pytest.raises(TypeError):        # a quad needs its local window
        TQ.luma_quad_step(c["y"], c["buf"],
                          torch.zeros((T, 1, 2 * R, 2 * C, 256), dtype=i32),
                          torch.zeros((T, 1, 2 * R, 2 * C), dtype=i32),
                          dc_q=DC_Q, ac_q=AC_Q,
                          scan=TTI._scan(TTI.BS_TO_TX[16], "cpu"),
                          rd=c["rd16"], rt=c["rt"]["y16"])
    with pytest.raises(ValueError):       # ADST does not exist at 32
        TQ.uniform_step(32, c["y"], c["buf"],
                        torch.zeros((T, 2, R, C, 1024), dtype=i32),
                        torch.zeros((T, 2, R, C), dtype=i32), src_v=c["y"],
                        dc_q=DC_Q, ac_q=AC_Q,
                        scan=TTI._scan(TTI.BS_TO_TX[32], "cpu"))
    with pytest.raises(ValueError):       # no such block size
        TQ.uniform_step(64, c["y"], c["buf"],
                        torch.zeros((T, 1, R, C, 4096), dtype=i32),
                        torch.zeros((T, 1, R, C), dtype=i32), dc_q=DC_Q,
                        ac_q=AC_Q, scan=TTI._scan(TTI.BS_TO_TX[32], "cpu"))


# ----------------------------------------------------------------------
# the stage table and the argument block
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_stage_table_layout(bs):
    stages, meta = TQ.stage_table(bs)
    assert stages.dtype == np.int32 and stages.shape[1] == 4
    assert meta.shape == (TQ.META_LEN,)
    rows = {4: 48, 8: 384, 16: 1024, 32: 1152}[bs]     # txfm.cuh stage_rows
    assert stages.shape[0] == rows
    lw = bs.bit_length() - 3
    cos = {("f", "col"): txfm_host.FWD_COS_BIT_COL[lw][lw],
           ("f", "row"): txfm_host.FWD_COS_BIT_ROW[lw][lw],
           ("i", "col"): txfm_host.INV_COS_BIT,
           ("i", "row"): txfm_host.INV_COS_BIT}
    for k, (d, kind, axis) in enumerate(TQ._PROG_ORDER):
        off, nst, cb, clamp_bit = meta[4 * k:4 * k + 4]
        assert cb == cos[(d, axis)]
        sinpi = meta[37 + 5 * k:42 + 5 * k]
        if kind == "adst" and bs not in (8, 16):
            assert nst == -1
            want = tables.sinpi(cb) if bs == 4 else np.zeros(5)
            np.testing.assert_array_equal(sinpi, want)
            continue
        assert clamp_bit == (16 if d == "i" else 0)
        assert not sinpi.any()
        prog = txfm_host._compiled_stages(f"av1_{d}{kind}{bs}", int(cb))
        assert nst == len(prog)
        for s, (ia, ib, wa, wb, is_btf, clamp) in enumerate(prog):
            e = stages[off + s * bs:off + (s + 1) * bs]
            np.testing.assert_array_equal(e[:, 0] & 0xff, ia)
            np.testing.assert_array_equal((e[:, 0] >> 8) & 0xff, ib)
            np.testing.assert_array_equal((e[:, 0] >> 16) & 1, is_btf)
            np.testing.assert_array_equal((e[:, 0] >> 17) & 1, clamp)
            np.testing.assert_array_equal(e[:, 1], wa)
            np.testing.assert_array_equal(e[:, 2], wb)
            assert not e[:, 3].any()
    tx = SQUARE_TX[bs]
    np.testing.assert_array_equal(meta[32:35], txfm_host.FWD_SHIFT[tx])
    np.testing.assert_array_equal(meta[35:37], txfm_host.INV_SHIFT[tx])


def _c_fields(source, struct):
    """Field names of ``struct`` in a csrc file, in order."""
    text = open(os.path.join(CSRC, source)).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.split(r"[\s*]+", part.strip())[-1]
                      for part in decl.split(",")]
    return names


def test_step_arguments_match_the_c_struct():
    assert _c_fields("txq.cu", "StepArgs") == \
        [f for f, _ in TQ._StepArgs._fields_]


def test_stage_rows_match_the_header():
    text = open(os.path.join(CSRC, "txfm.cuh")).read()
    got = re.search(r"return BS == 4 \? (\d+) : BS == 8 \? (\d+) : "
                    r"BS == 16 \? (\d+) : (\d+);", text).groups()
    assert [int(x) for x in got] == [TQ.stage_table(bs)[0].shape[0]
                                     for bs in (4, 8, 16, 32)]
    assert f"kMetaLen = {TQ.META_LEN};" in text


# ----------------------------------------------------------------------
# on the card: kernel == plain version
# ----------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_maps(a, b):
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


@pytest.mark.gpu
@pytest.mark.parametrize("seed,pattern", [(2, False), (3, False),
                                          (6, True)])
def test_step_kernel_matches_plain(dev, seed, pattern):
    """Every partition call site (luma 32, the 16 quads with the epilogue,
    the chroma 16 pair, the 8 quad pairs) on the card and on the CPU."""
    n0 = TQ.KB.launches
    c, _, _ = _case(seed, pattern)
    maps = []
    for where in ("cpu", dev):
        tt, rc, cc = _cells(where)
        rng = np.random.default_rng(seed)
        m, kb32, kb16 = _luma_sites(c, where)
        for qr, qc, pick, pred in _luma_calls(c, rng, pattern):
            pick, pred = pick.to(where), pred.to(where)
            _pick_writes(m, tt, rc, cc, qr, qc, pick)
            if qr is None:
                kb32(tt, rc, cc, pick, pred)
            else:
                kb16(tt, rc, cc, pick, pred, qr, qc)
        mc, kc16, kc8 = _chroma_sites(c, where)
        for qr, qc, pick, pred in _chroma_calls(c, rng, pattern):
            pick, pred = pick.to(where), pred.to(where)
            if qr is None:
                kc16(tt, rc, cc, pick, pred)
            else:
                kc8(tt, rc, cc, pick, pred, qr, qc)
        maps.append({**m, **mc})
    _same_maps(maps[0], maps[1])
    assert TQ.KB.launches - n0 == 10


@pytest.mark.gpu
def test_step_kernel_is_repeatable(dev):
    """The luma partition step, 20 times on the card from the same maps:
    every run writes the same maps (each block's split is taken once and
    shared with all its warps, so no warp sees a half-written cost)."""
    c, _, _ = _case(3)
    tt, rc, cc = _cells(dev)
    runs = []
    for _ in range(20):
        rng = np.random.default_rng(3)
        m, kb32, kb16 = _luma_sites(c, dev)
        for qr, qc, pick, pred in _luma_calls(c, rng, False):
            pick, pred = pick.to(dev), pred.to(dev)
            _pick_writes(m, tt, rc, cc, qr, qc, pick)
            if qr is None:
                kb32(tt, rc, cc, pick, pred)
            else:
                kb16(tt, rc, cc, pick, pred, qr, qc)
        runs.append(m)
    for m in runs[1:]:
        _same_maps(runs[0], m)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,chroma", [(8, False), (4, True), (16, False),
                                       (8, True), (32, False), (16, True)])
def test_uniform_step_kernel_matches_plain(dev, bs, chroma):
    planes, buf, cells, rng = _uniform_case(20 + bs, bs, False)
    P = 2 if chroma else 1
    src = torch.cat([_blocks(pl, cells[0], cells[1] * bs, cells[2] * bs, bs)
                     for pl in planes[:P]])
    pick = _pick(rng, cells[1].shape[0])
    pred = torch.as_tensor(_pick_pred(rng, src, False))
    out = []
    for where in ("cpu", dev):
        b = buf.clone().to(where)
        out.append((*_new_uniform(planes, b, *cells, pick, pred, bs, chroma,
                                  where), b))
    for g, w in zip(out[1], out[0]):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,B,key,adst", [(16, 8160, "y16", False),
                                           (32, 2040, "y32", False),
                                           (8, 8160, "uv8", True),
                                           (16, 2040, "uv16", True),
                                           (4, 1000, "uv8", True)])
def test_batched_kernel_matches_plain_at_p_frame_batches(dev, bs, B, key,
                                                         adst):
    rng = np.random.default_rng(bs * 7 + B)
    src = rng.integers(0, 256, (B, bs, bs)).astype(np.int32)
    pred = np.clip(src + rng.integers(-30, 31, src.shape), 0,
                   255).astype(np.int32)
    pred[:B // 8] = rng.integers(0, 256, (B // 8, bs, bs))
    lvl, eobt = TTI._rate_tables(FrameContext(Q))[key]
    flags = {}
    if adst:
        flags = dict(vadst=torch.as_tensor(rng.random(B) < .5, device=dev),
                     hadst=torch.as_tensor(rng.random(B) < .5, device=dev))

    def on(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    a = (on(src), on(pred), DC_Q, AC_Q,
         on(tables.scan_table(SQUARE_TX[bs], 0).astype(np.int32)),
         on(rng.uniform(2e3, 8e4, B).astype(np.float32)), on(lvl), on(eobt))
    for g, w in zip(TQ.txq_recon_skip(*a, **flags),
                    TQ.txq_recon_skip_plain(*a, **flags)):
        assert torch.equal(g, w)
    for g, w in zip(TQ.txq_recon(*a[:5], **flags),
                    TQ.tq_recon(*a[:5], **flags)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_kp_on_the_shared_pass_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    plane = torch.as_tensor(rng.integers(0, 256, (96, 128)).astype(np.int32),
                            device=dev)
    plane[:n, :2 * n] = 0
    plane[n:2 * n, :n] = 255
    for q in (20, 100, 255):
        a = (plane, tables.dc_quant(q), tables.ac_quant(q), n, SQUARE_TX[n])
        got = AN.analyze_plane(*a)
        want = AN.analyze_plane_plain(*a)
        for k in want:
            assert torch.equal(got[k], want[k]), (k, q)
