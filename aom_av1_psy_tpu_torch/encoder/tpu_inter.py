"""Batched inter-frame plan — torch counterpart of
``aom_av1_psy_tpu/encoder/tpu_inter.py``.

Inter prediction reads only the reference frame, so the whole frame is one
batch at every stage and the plan is a straight line of device work with
no host loop: the half-resolution pyramid, the two-stage full-pel search
(kernel KE, ``ops/fullpel.py``), two subpel refinements (kernel KD with a
candidate axis, ``ops/mc.py``), the dominant-MV vote, the RD pick of
{searched, dominant, zero}, the frame-level interpolation-filter pick (KD
with the three families as candidates), 16 and 32 TQ + skip-RD (kernel KB,
``ops/txq.py``), the 32 path's best of 4 sub-MVs + zero (KD + KB), the split
and the MV / recon assembly; then chroma with the luma MVs (KD + KB). The
plan reaches the host in ONE device->host copy.

Exactness notes (JAX on the CPU is the oracle):
- the MV-rate proxy is the committed table ``mv_rate_proxy.MV_RATE_PROXY``
  (float32 ``log2`` is not portable); a device flag records any index past
  ``S_MAX`` and the host raises after the copy;
- every argmin / argmax keeps the reference's first-index tie rule;
- ``(mv + 4 * sign(mv)) // 8`` is floor division;
- the frame-level filter SSE is summed exactly in int64 where the
  reference sums ~2M float32 terms; ``cost16``'s 2x2 sum adds the four
  float32 values in XLA's row-major order;
- RD lines ``2048 * sse + lam * rate`` are separate float32 ops (no FMA).

The host pieces (``SEARCH_RAD``, ``RATE_ZEROMV``, ``_edge_grids``) are
carried over from the reference; the port imports nothing of it. The
plan's other inputs (quantizers, rate tables, lambda grids, the forced /
no_split masks), their upload and the one-copy fetch are
``encoder/plan_inputs``', as the intra plans' are.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ec.context import FrameContext
from ..ops import convolve as CONV
from ..device import resolve_device
from ..ops import fullpel as FP
from ..ops import mc as MC
from ..ops import txq as TQ
from . import plan_inputs as PI
from .mv_rate_proxy import MV_RATE_PROXY, S_MAX
from .tpu_intra import BS_TO_TX

SEARCH_RAD = FP.SEARCH_RAD     # full-pel +/- range, px
AOM_INTERP_EXTEND = 4
RATE_ZEROMV = 1024.0           # ~2 bits: the GLOBALMV-class mode cost


def _clamp_mv_q4(mv8_r, mv8_c, lo_r, hi_r, lo_c, hi_c, ss: int):
    """clamp_mv_to_umv_border_sb: 1/8-pel -> clamped q4 (1/16 plane)."""
    row = mv8_r * (1 << (1 - ss))
    col = mv8_c * (1 << (1 - ss))
    return (torch.minimum(torch.maximum(row, lo_r), hi_r),
            torch.minimum(torch.maximum(col, lo_c), hi_c))


def _edge_grids(R2, C2, mi_rows, mi_cols, bs, ss):
    """Per-block q4 MV clamp bounds (clamp_mv_to_umv_border_sb).

    For bs=16 the grid is (R2, C2); for bs=32 it is (R2/2, C2/2).
    ss applies the chroma subsampling scaling of the PLANE (block dims
    halve, 1/8-pel -> 1/16 via the <<(1-ss) in _clamp_mv_q4)."""
    n4 = bs // 4
    nr = R2 if bs == 16 else R2 // 2
    nc = C2 if bs == 16 else C2 // 2
    rr = n4 * np.arange(nr)
    cc = n4 * np.arange(nc)
    mb_top = -(rr * 4 * 8)
    mb_bottom = (mi_rows - n4 - rr) * 4 * 8
    mb_left = -(cc * 4 * 8)
    mb_right = (mi_cols - n4 - cc) * 4 * 8
    cw = bs >> ss
    spel_lo = (AOM_INTERP_EXTEND + cw) << 4
    spel_hi = spel_lo - 16
    sh = 1 - ss
    z_c = np.zeros(nc, np.int64)[None, :]
    z_r = np.zeros(nr, np.int64)[:, None]
    lo_r = (mb_top[:, None] << sh) - spel_lo + z_c
    hi_r = (mb_bottom[:, None] << sh) + spel_hi + z_c
    lo_c = (mb_left[None, :] << sh) - spel_lo + z_r
    hi_c = (mb_right[None, :] << sh) + spel_hi + z_r
    return (lo_r.astype(np.int32), hi_r.astype(np.int32),
            lo_c.astype(np.int32), hi_c.astype(np.int32))


@functools.cache
def _table(device: str):
    return torch.as_tensor(MV_RATE_PROXY, device=device)


@functools.cache
def _all_kernels(device: str):
    """(3, 16, 8) int32 taps of REGULAR / SMOOTH / SHARP."""
    return torch.as_tensor(np.stack([CONV.filter_kernels(f, 16)
                                     for f in (0, 1, 2)]).astype(np.int32),
                           device=device)


@functools.cache
def _origins(n: int, ncols: int, step: int, device: str):
    """Raster block origins (y, x) of an n-block grid, int32."""
    b = torch.arange(n, dtype=torch.int32, device=device)
    return step * (b // ncols), step * (b % ncols)


@functools.cache
def _steps(step: int, device: str):
    """(dr, dc) of the 9 refinement candidates, dr-major (the reference's
    loop order)."""
    d = torch.tensor([-step, 0, step], dtype=torch.int32, device=device)
    return d.repeat_interleave(3), d.repeat(3)


def _up(m, n: int):
    """Nearest-neighbour upsample of a 2-D map by n on both axes."""
    R, C = m.shape
    return m[:, None, :, None].expand(R, n, C, n).reshape(R * n, C * n)


def _pick(t, i):
    """t[i] for a 0-d device index without a host read."""
    return t.index_select(0, i.reshape(1))[0]


def _blocks(plane, bs: int):
    """(H, W) plane -> (H/bs * W/bs, bs, bs) raster blocks."""
    H, W = plane.shape
    return plane.reshape(H // bs, bs, W // bs, bs).permute(0, 2, 1, 3) \
        .reshape(-1, bs, bs)


def _unblocks(blocks, R: int, C: int, bs: int):
    return blocks.reshape(R, C, bs, bs).permute(0, 2, 1, 3) \
        .reshape(R * bs, C * bs)


class _RateProxy:
    """``_mv_rate_proxy`` as a table lookup; remembers whether any index
    ran past S_MAX (a device-side flag, read after the plan's copy)."""

    def __init__(self, device):
        self.table = _table(str(device))
        self.over = torch.zeros((), dtype=torch.bool, device=device)

    def __call__(self, mv8_r, mv8_c):
        s = mv8_r.abs() + mv8_c.abs()
        self.over = self.over | (s > S_MAX).any()
        return self.table[s.clamp(max=S_MAX).long()]


def _floor_div8_round(mv):
    """(mv + 4 * sign(mv)) // 8 with floor division (C++ '/' truncates)."""
    return torch.div(mv + 4 * torch.sign(mv), 8, rounding_mode="floor")


def _subpel_refine(src16, ref, by, bx, mv8_r, mv8_c, lo_r, hi_r, lo_c, hi_c,
                   crop_h, crop_w, kernels):
    """Half- then quarter-pel refine with exact-MC SAD: each step is ONE
    KD call over the 9 candidates (the reference's dr-major loop order)."""
    for step in (4, 2):
        drs, dcs = _steps(step, str(ref.device))
        r8 = mv8_r[None] + drs[:, None]
        c8 = mv8_c[None] + dcs[:, None]
        qr, qc = _clamp_mv_q4(r8, c8, lo_r, hi_r, lo_c, hi_c, 0)
        _, sad, _ = MC.mc_8tap(ref, by, bx, qr, qc, 16, crop_h, crop_w,
                               kernels, src=src16, want_pred=False)
        k = sad.argmin(0)
        mv8_r = mv8_r + drs[k]
        mv8_c = mv8_c + dcs[k]
    return mv8_r, mv8_c


def _luma_inter(src, ref, dc_q, ac_q, rd16, rd32, forced, no_split,
                all_kernels, c16, c32, rt32, rt16, *, R, C, crop_h, crop_w):
    """src/ref: (R*32, C*32) int32 padded planes on the device. Returns
    (split (R,C), mv8 (2R,2C,2), lv32, e32, lv16, e16, recon, interp_sel,
    proxy-overflow flag)."""
    dev = src.device
    scan32 = PI.scan_order(BS_TO_TX[32], str(dev))
    scan16 = PI.scan_order(BS_TO_TX[16], str(dev))
    R2, C2 = 2 * R, 2 * C
    B = R2 * C2
    proxy = _RateProxy(dev)

    # ---- 16-level motion field: two-stage full-pel search ----
    gy, gx = _origins(B, C2, 16, str(dev))
    s16 = _blocks(src, 16)
    kernels = all_kernels[0]      # REGULAR during the search stages
    half = (src[0::2, 0::2] + src[1::2, 0::2] + src[0::2, 1::2]
            + src[1::2, 1::2] + 2) >> 2
    rhalf = (ref[0::2, 0::2] + ref[1::2, 0::2] + ref[0::2, 1::2]
             + ref[1::2, 1::2] + 2) >> 2
    gy_h, gx_h = _origins(B, C2, 8, str(dev))
    s8 = _blocks(half, 8)
    cdy, cdx = FP.fullpel_search(s8, rhalf, gy_h, gx_h, crop_h // 2,
                                 crop_w // 2, bw=8)
    fdy, fdx = FP.fullpel_search(s16, ref, gy, gx, crop_h, crop_w,
                                 cy=2 * cdy, cx=2 * cdx)
    mv8_r, mv8_c = 8 * fdy, 8 * fdx
    lo_r, hi_r, lo_c, hi_c = [x.reshape(-1) for x in c16]
    mv8_r, mv8_c = _subpel_refine(s16, ref, gy, gx, mv8_r, mv8_c,
                                  lo_r, hi_r, lo_c, hi_c, crop_h, crop_w,
                                  kernels)

    # ---- dominant-MV candidate: texture-confident blocks vote ----
    rdf16 = rd16.reshape(-1)
    z = torch.zeros_like(mv8_r)
    qr, qc = _clamp_mv_q4(torch.stack([mv8_r, z]), torch.stack([mv8_c, z]),
                          lo_r, hi_r, lo_c, hi_c, 0)
    _, sad, sse = MC.mc_8tap(ref, gy, gx, qr, qc, 16, crop_h, crop_w,
                             kernels, src=s16, want_pred=False)
    sse_srch = sse[0].to(torch.float32)
    sse0 = sse[1].to(torch.float32)
    conf = (sad[1] - sad[0]).clamp(min=0)
    fr = _floor_div8_round(mv8_r).clamp(-SEARCH_RAD, SEARCH_RAD)
    fc_ = _floor_div8_round(mv8_c).clamp(-SEARCH_RAD, SEARCH_RAD)
    nbin = 2 * SEARCH_RAD + 1
    bins = (fr + SEARCH_RAD) * nbin + (fc_ + SEARCH_RAD)
    votes = torch.zeros((nbin * nbin,), dtype=torch.int32, device=dev) \
        .index_add_(0, bins.long(), conf)
    gbin = votes.argmax().to(torch.int32)
    g_r = 8 * (torch.div(gbin, nbin, rounding_mode="floor") - SEARCH_RAD)
    g_c = 8 * (gbin % nbin - SEARCH_RAD)
    gv_r, gv_c = _subpel_refine(s16, ref, gy, gx, g_r.expand(B), g_c.expand(B),
                                lo_r, hi_r, lo_c, hi_c, crop_h, crop_w,
                                kernels)
    gqr, gqc = _clamp_mv_q4(gv_r, gv_c, lo_r, hi_r, lo_c, hi_c, 0)
    _, _, sse = MC.mc_8tap(ref, gy, gx, gqr[None], gqc[None], 16, crop_h,
                           crop_w, kernels, src=s16, want_pred=False)
    sse_g = sse[0].to(torch.float32)

    # pick {searched, dominant, zero} in the RD domain
    lam = rdf16 / 512.0
    rd_srch = 2048.0 * sse_srch + lam * proxy(mv8_r, mv8_c)
    rd_g = 2048.0 * sse_g + lam * proxy(gv_r, gv_c)
    rd_0 = 2048.0 * sse0 + lam * RATE_ZEROMV
    choice = torch.stack([rd_srch, rd_g, rd_0]).argmin(0)
    mv8_r = torch.where(choice == 1, gv_r, torch.where(choice == 2, z, mv8_r))
    mv8_c = torch.where(choice == 1, gv_c, torch.where(choice == 2, z, mv8_c))

    # ---- frame-level interpolation filter: the 3 families as candidates,
    # each family's SSE summed exactly ----
    qr, qc = _clamp_mv_q4(mv8_r, mv8_c, lo_r, hi_r, lo_c, hi_c, 0)
    F = all_kernels.shape[0]
    preds_f, _, sse_f = MC.mc_8tap(ref, gy, gx, qr.expand(F, B),
                                   qc.expand(F, B), 16, crop_h, crop_w,
                                   all_kernels, src=s16)
    interp_sel = sse_f.to(torch.int64).sum(1).argmin()
    kernels = _pick(all_kernels, interp_sel)
    pred16 = _pick(preds_f, interp_sel)

    # ---- 16 TQ + skip-RD ----
    lv16, e16, rec16, sse16, crate16 = TQ.txq_recon_skip(
        s16, pred16, dc_q, ac_q, scan16, rdf16, *rt16)
    cost16b = 2048.0 * sse16 + (rdf16 / 512.0) * (
        crate16 + proxy(mv8_r, mv8_c))
    # XLA's reduce of the 2x2 quads: 0 + a00, + a01, + a10, + a11
    q = cost16b.reshape(R, 2, C, 2)
    cost16 = ((q[:, 0, :, 0] + q[:, 0, :, 1]) + q[:, 1, :, 0]) + q[:, 1, :, 1]

    # ---- 32 path: best of the 4 sub-MVs + zero at 32x32 ----
    Bc = R * C
    cy, cx = _origins(Bc, C, 32, str(dev))
    s32 = _blocks(src, 32)
    lo32 = [x.reshape(-1) for x in c32]
    mvr2 = mv8_r.reshape(R, 2, C, 2)
    mvc2 = mv8_c.reshape(R, 2, C, 2)
    zc = torch.zeros(Bc, dtype=torch.int32, device=dev)
    cand_r = torch.stack([mvr2[:, a, :, b].reshape(-1)
                          for a in (0, 1) for b in (0, 1)] + [zc])
    cand_c = torch.stack([mvc2[:, a, :, b].reshape(-1)
                          for a in (0, 1) for b in (0, 1)] + [zc])
    qr, qc = _clamp_mv_q4(cand_r, cand_c, *lo32, 0)
    preds, _, sse = MC.mc_8tap(ref, cy, cx, qr, qc, 32, crop_h, crop_w,
                               kernels, src=s32)
    rdf32 = rd32.reshape(-1)
    nc = cand_r.shape[0]
    rds = [2048.0 * sse[ci].to(torch.float32) + (rdf32 / 512.0) * (
        RATE_ZEROMV if ci == nc - 1 else proxy(cand_r[ci], cand_c[ci]))
        for ci in range(nc)]
    k32 = torch.stack(rds).argmin(0)
    ar = torch.arange(Bc, device=dev)
    pred32 = preds[k32, ar]
    mv32_r = cand_r[k32, ar]
    mv32_c = cand_c[k32, ar]

    lv32, e32, rec32, sse32, crate32 = TQ.txq_recon_skip(
        s32, pred32, dc_q, ac_q, scan32, rdf32, *rt32)
    cost32 = (2048.0 * sse32 + (rdf32 / 512.0) * (
        crate32 + proxy(mv32_r, mv32_c))).reshape(R, C)

    split = forced | ((cost16 < cost32) & ~no_split)
    # the 32 block's mv replaces all four sub mvs when NONE is chosen
    mvs = torch.stack([mv8_r.reshape(R2, C2), mv8_c.reshape(R2, C2)], -1)
    mv32_up = torch.stack([_up(mv32_r.reshape(R, C), 2),
                           _up(mv32_c.reshape(R, C), 2)], -1)
    mv_out = torch.where(_up(split, 2)[:, :, None], mvs, mv32_up)

    # recon assembly
    recon = torch.where(_up(split, 32), _unblocks(rec16, R2, C2, 16),
                        _unblocks(rec32, R, C, 32))
    return (split.to(torch.int32), mv_out, lv32.reshape(R, C, 1024),
            e32.reshape(R, C), lv16.reshape(R2, C2, 256), e16.reshape(R2, C2),
            recon, interp_sel, proxy.over)


def _chroma_inter(src_u, src_v, ref_u, ref_v, dc_q, ac_q, rd16, rd32,
                  split, mv8, kernels, cc16, cc32, rtc16, rtc8,
                  *, R, C, crop_h, crop_w):
    """Chroma (4:2:0) follows the luma structure: 16px blocks for NONE
    cells, 8px for split subs, same MVs. Returns per-plane levels/eobs at
    both granularities + recon (2, H, W)."""
    dev = src_u.device
    scan16 = PI.scan_order(BS_TO_TX[16], str(dev))
    scan8 = PI.scan_order(BS_TO_TX[8], str(dev))
    R2, C2 = 2 * R, 2 * C
    B8, Bc = R2 * C2, R * C
    gy8, gx8 = _origins(B8, C2, 8, str(dev))
    cy16, cx16 = _origins(Bc, C, 16, str(dev))
    mvr = mv8[:, :, 0].reshape(-1)
    mvc = mv8[:, :, 1].reshape(-1)
    # 32-cell mv = TL sub's mv (all four equal when NONE was chosen)
    mvr32 = mv8[::2, ::2, 0].reshape(-1)
    mvc32 = mv8[::2, ::2, 1].reshape(-1)
    q8 = _clamp_mv_q4(mvr, mvc, *[x.reshape(-1) for x in cc16], 1)
    q16 = _clamp_mv_q4(mvr32, mvc32, *[x.reshape(-1) for x in cc32], 1)
    pix_mask = _up(split.bool(), 16)
    outs = []
    for srcp, refp in ((src_u, ref_u), (src_v, ref_v)):
        s8 = _blocks(srcp, 8)
        p8 = MC.mc_8tap(refp, gy8, gx8, q8[0][None], q8[1][None], 8, crop_h,
                        crop_w, kernels)[0][0]
        lv8, e8, rec8, _, _ = TQ.txq_recon_skip(
            s8, p8, dc_q, ac_q, scan8, rd16.reshape(-1), *rtc8)
        s16 = _blocks(srcp, 16)
        p16 = MC.mc_8tap(refp, cy16, cx16, q16[0][None], q16[1][None], 16,
                         crop_h, crop_w, kernels)[0][0]
        lv16, e16, rec16, _, _ = TQ.txq_recon_skip(
            s16, p16, dc_q, ac_q, scan16, rd32.reshape(-1), *rtc16)
        recon = torch.where(pix_mask, _unblocks(rec8, R2, C2, 8),
                            _unblocks(rec16, R, C, 16))
        outs.append((lv16.reshape(R, C, 256), e16.reshape(R, C),
                     lv8.reshape(R2, C2, 64), e8.reshape(R2, C2), recon))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(5))


def plan_inter_frame(src_planes, ref_planes, q, rdmult, mi_rows, mi_cols,
                     crop_w, crop_h, fetch_recon=False, device="cuda"):
    """Batched inter plan for one frame vs one LAST reference.

    src_planes: mi-aligned int32 numpy planes padded to 32 (luma) / 16
    (chroma) multiples; ref_planes: same-dims reference recon as int32
    tensors on ``device``; crop_w/crop_h: TRUE frame dims (border
    replication clamp bounds). Returns the plan dict for the inter
    symbol-script pack (the reference's keys and dtypes); ``recon_dev``
    holds the recon planes on ``device``."""
    dev = resolve_device(device)
    assert PI.plan_part_supported(mi_rows, mi_cols)
    y = src_planes[0]
    R, C = y.shape[0] // 32, y.shape[1] // 32
    dc_q, ac_q = PI.quantizers(q)
    rd16, rd32 = PI.lambda_grids(rdmult, R, C)
    forced, no_split = PI.edge_cell_masks(R, C, mi_rows, mi_cols)
    # every upload counts in the frame's ``syncs``; the chroma planes go
    # up after the luma half is queued
    t = PI.upload({
        "rt": PI.rate_tables(FrameContext(q)),
        "grids": [_edge_grids(2 * R, 2 * C, mi_rows, mi_cols, bs, ss)
                  for bs, ss in ((16, 0), (32, 0), (16, 1), (32, 1))],
        "rd16": rd16, "rd32": rd32, "y": y, "forced": forced,
        "no_split": no_split}, dev)
    rt, grids = t["rt"], t["grids"]
    all_kernels = _all_kernels(str(dev))

    split, mv8, lv32, e32, lv16, e16, yrec, interp_sel, over = _luma_inter(
        t["y"], ref_planes[0], dc_q, ac_q, t["rd16"], t["rd32"], t["forced"],
        t["no_split"], all_kernels, grids[0], grids[1], rt["y32"], rt["y16"],
        R=R, C=C, crop_h=crop_h, crop_w=crop_w)
    named = {"split32": split, "mv8": mv8, "y_levels32": lv32,
             "y_levels16": lv16, "y_eob32": e32, "y_eob16": e16,
             "interp_filter": interp_sel, "proxy_over": over}
    recon_dev = [yrec]
    if len(src_planes) > 1:
        uv = _chroma_inter(
            *PI.upload(src_planes[1:3], dev), ref_planes[1], ref_planes[2],
            dc_q, ac_q, t["rd16"], t["rd32"], split, mv8,
            _pick(all_kernels, interp_sel), grids[2], grids[3], rt["uv16"],
            rt["uv8"], R=R, C=C, crop_h=(crop_h + 1) >> 1,
            crop_w=(crop_w + 1) >> 1)
        named.update(zip(("uv_levels16", "uv_eob16", "uv_levels8",
                          "uv_eob8"), uv[:4]))
        recon_dev += [uv[4][0], uv[4][1]]
    host = PI.fetch(named, PI.pack16(named))   # the plan's one copy
    if host.pop("proxy_over"):
        raise RuntimeError(f"MV-rate proxy index past S_MAX={S_MAX}")
    plan = {"inter": True, "interp_filter": int(host.pop("interp_filter")),
            **host, "recon_dev": recon_dev}
    if fetch_recon:
        plan["recon"] = [r.cpu().numpy() for r in recon_dev]
    return plan
