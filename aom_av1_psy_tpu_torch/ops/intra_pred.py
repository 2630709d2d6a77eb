"""Kernel KA: the intra pick of a batch of square blocks (``intra_pick``:
predict every candidate from the recon buffer, price it, choose the RD
argmin and predict the winner, in one launch), and its two older entries
``intra_pred_sse`` (every candidate's SSE against the source) and
``intra_pred_one`` (one chosen candidate's prediction per block).

Replaces, inside the luma/chroma wavefronts, the reference's
``tpu_intra._predict_all_modes`` (``tpu_intra.py:64``), the directional
edge pipeline ``tpu_intra_dir._filter_edge_b`` / ``build_edge_buffer`` /
``dir_predict`` (``tpu_intra_dir.py:179-265``) and the SSE lines
``tpu_intra.py:645, :710, :817, :859``.

Candidates: K = 61 at luma 32/16 (the 7 plain modes DC, V, H, SMOOTH,
SMOOTH_V, SMOOTH_H, PAETH, then the 54 directional (mode, delta) pairs of
``tpu_intra_dir.candidates``), K = 7 (plain only) at chroma 16/8 and on
the uniform grid (``tpu_intra.py:282-411``: luma 8/16/32, chroma 4/8/16).

The pick also replaces the RD choice around those lines: the mode rate
(``tpu_intra.py:344-358``, ``:506``, ``:529``, ``:670-674``), the
candidate mask (``tpu_intra_dir.allowed_mask``), ``_rd`` and the
first-index argmin.

``predict_all_modes`` here is the torch counterpart of the reference's
``_predict_all_modes``; ``intra_pick_plain``, ``intra_pred_sse_plain`` and
``intra_pred_one_plain`` are the plain versions of the kernel, used for
CPU tensors and held against the kernel on the card.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import intra as intra_ops
from .. import convert
from ..encoder import tpu_intra_dir as DIR
from ..kernels.build import CudaKernel, I, P, need
from ..normative.blocks import INTRA_MODE_CONTEXT

N_PLAIN = 7
# the plain candidates' AV1 modes (DC V H SMOOTH SMOOTH_V SMOOTH_H PAETH)
PLAN_MODES = tuple(m for m, _, _ in DIR.candidates()[:N_PLAIN])


class _PickArgs(ctypes.Structure):
    """``csrc/intra_pred.cu``'s ``PickArgs``, field for field."""
    _fields_ = ([(f, P) for f in (
        "buf", "tt", "rc", "cc", "src", "src_v", "rd", "ok1", "ok2", "ok3",
        "trreal", "blreal", "cost", "angle", "nbr", "mode_out", "delta_out",
        "pick", "pred")]
        + [(f, I) for f in (
            "B", "K", "bs", "P", "pstride", "Hb", "Wb", "local", "qr", "qc",
            "SH", "SW", "T", "MR", "MC", "scale", "NR", "NC",
            "nscale", "nbr_plan", "luma")])


KA = CudaKernel("intra_pred", {
    # above, left, tl, have_a, have_l, trreal, blreal, abext, lfext, ef,
    # src, smooth_w, idxa, idxb, sh, B, bs, K, sse_out
    "intra_pred_sse": [P] * 15 + [I, I, I, P],
    # ... same inputs without src, cand, B, bs, K, pred_out
    "intra_pred_one": [P] * 10 + [P] * 4 + [P, I, I, I, P],
    "intra_pick": [ctypes.POINTER(_PickArgs)],
    # the constant table (pick_table) and its length
    "intra_pick_init": [P, I],
})


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def predict_all_modes(above, left, tl, have_a, have_l, bs: int):
    """(B, bs) above/left, (B,) tl/have flags -> (7, B, bs, bs) int32 in
    PLAN order (DC V H SMOOTH SMOOTH_V SMOOTH_H PAETH)."""
    B = above.shape[0]
    above_eff, left_eff, tl_eff = DIR.effective_edges(above, left, tl,
                                                      have_a, have_l)
    lg = bs.bit_length() - 1

    s_a = above_eff.sum(1, dtype=torch.int32)
    s_l = left_eff.sum(1, dtype=torch.int32)
    c128 = torch.full_like(s_a, 128)
    dc = torch.where(
        have_a & have_l, (s_a + s_l + bs) >> (lg + 1),
        torch.where(have_a, (s_a + (bs >> 1)) >> lg,
                    torch.where(have_l, (s_l + (bs >> 1)) >> lg, c128)))
    p_dc = dc[:, None, None].expand(B, bs, bs)
    p_v = above_eff[:, None, :].expand(B, bs, bs)
    p_h = left_eff[:, :, None].expand(B, bs, bs)

    a2 = above_eff[:, None, :]
    l2 = left_eff[:, :, None]
    t2 = tl_eff[:, None, None]
    base = l2 + a2 - t2
    pl = (base - l2).abs()
    pt = (base - a2).abs()
    ptl = (base - t2).abs()
    take_l = (pl <= pt) & (pl <= ptl)
    take_t = pt <= ptl
    p_paeth = torch.where(take_l, l2.expand(B, bs, bs),
                          torch.where(take_t, a2.expand(B, bs, bs),
                                      t2.expand(B, bs, bs)))

    ww = _smooth_weights(bs, str(above.device))
    lsc = intra_ops.SMOOTH_WEIGHT_LOG2_SCALE
    scale = 1 << lsc
    below = left_eff[:, bs - 1:bs]
    right = above_eff[:, bs - 1:bs]
    wr = ww[None, :, None]
    wc = ww[None, None, :]
    p = (wr * a2 + (scale - wr) * below[:, :, None]
         + wc * l2 + (scale - wc) * right[:, :, None])
    p_smooth = _round2(p, 1 + lsc)
    p_sv = _round2(wr * a2 + (scale - wr) * below[:, :, None], lsc)
    p_sh = _round2(wc * l2 + (scale - wc) * right[:, :, None], lsc)
    return torch.stack([p_dc, p_v, p_h, p_smooth, p_sv, p_sh,
                        p_paeth]).to(torch.int32)


@functools.cache
def _smooth_weights(bs: int, device: str):
    return convert.to_device(intra_ops.smooth_weights(bs).astype("int32"),
                             device)


def _defaults(above, trreal, blreal, abext, lfext, ef):
    B = above.shape[0]
    no = torch.zeros(B, dtype=torch.bool, device=above.device)
    zero = torch.zeros_like(above)
    return (no if trreal is None else trreal, no if blreal is None else blreal,
            zero if abext is None else abext, zero if lfext is None else lfext,
            no if ef is None else ef)


def _all_preds(above, left, tl, have_a, have_l, K, trreal, blreal, abext,
               lfext, ef):
    bs = above.shape[1]
    preds = predict_all_modes(above, left, tl, have_a, have_l, bs)
    if K == N_PLAIN:
        return preds
    E = DIR.build_edge_buffer(above, left, tl, have_a, have_l, trreal,
                              blreal, abext, lfext, bs)
    return torch.cat([preds, DIR.dir_predict(E, ef, bs)], dim=0)


def intra_pred_sse_plain(above, left, tl, have_a, have_l, src, K,
                         trreal=None, blreal=None, abext=None, lfext=None,
                         ef=None):
    """(K, B) int32 SSE of each candidate against src (B, bs, bs)."""
    tr, bl, ae, le, e = _defaults(above, trreal, blreal, abext, lfext, ef)
    preds = _all_preds(above, left, tl, have_a, have_l, K, tr, bl, ae, le, e)
    return ((preds - src[None]) ** 2).sum((-1, -2), dtype=torch.int32)


def intra_pred_one_plain(above, left, tl, have_a, have_l, cand, K,
                         trreal=None, blreal=None, abext=None, lfext=None,
                         ef=None):
    """(B, bs, bs) int32 prediction of candidate cand[b] for each block."""
    tr, bl, ae, le, e = _defaults(above, trreal, blreal, abext, lfext, ef)
    preds = _all_preds(above, left, tl, have_a, have_l, K, tr, bl, ae, le, e)
    return preds[cand, torch.arange(above.shape[0], device=above.device)]


# ----------------------------------------------------------------------
# wrappers: plain version for CPU tensors, kernel KA for CUDA tensors
# ----------------------------------------------------------------------
def _cuda_args(above, left, tl, have_a, have_l, K, trreal, blreal, abext,
               lfext, ef, last, last_shape):
    """Validate the CUDA inputs; returns them contiguous, in C order."""
    B, bs = above.shape
    if bs not in (4, 8, 16, 32) or K not in (N_PLAIN, len(DIR.candidates())):
        raise ValueError(f"unsupported bs={bs} K={K}")
    if K != N_PLAIN and bs not in (16, 32):
        raise ValueError("directional candidates exist at 16/32 only")
    tr, bl, ae, le, e = _defaults(above, trreal, blreal, abext, lfext, ef)
    spec = ((above, (B, bs), torch.int32), (left, (B, bs), torch.int32),
            (tl, (B,), torch.int32), (have_a, (B,), torch.bool),
            (have_l, (B,), torch.bool), (tr, (B,), torch.bool),
            (bl, (B,), torch.bool), (ae, (B, bs), torch.int32),
            (le, (B, bs), torch.int32), (e, (B,), torch.bool),
            (last, last_shape, torch.int32))
    out = []
    for t, shape, dt in spec:
        if t.device.type != "cuda" or t.dtype != dt or \
                tuple(t.shape) != shape:
            raise ValueError(f"KA input: want {dt} {shape} on cuda, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        out.append(t.contiguous())
    return B, bs, out


def _table_ptrs(bs, K, device):
    sw = _smooth_weights(bs, str(device)).data_ptr()
    if K == N_PLAIN:
        return sw, 0, 0, 0
    tab = DIR.tables_on(bs, str(device))
    return (sw, tab["IDXa"].data_ptr(), tab["IDXb"].data_ptr(),
            tab["SH"].data_ptr())


def intra_pred_sse(above, left, tl, have_a, have_l, src, K, trreal=None,
                   blreal=None, abext=None, lfext=None, ef=None):
    """SSE (K, B) int32 of all K candidates against src (B, bs, bs). CPU
    tensors: plain version; CUDA tensors: kernel KA."""
    if above.device.type == "cpu":
        return intra_pred_sse_plain(above, left, tl, have_a, have_l, src, K,
                                    trreal, blreal, abext, lfext, ef)
    B, bs, args = _cuda_args(above, left, tl, have_a, have_l, K, trreal,
                             blreal, abext, lfext, ef, src,
                             (above.shape[0], above.shape[1],
                              above.shape[1]))
    out = torch.empty((K, B), dtype=torch.int32, device=above.device)
    KA.launch("intra_pred_sse", *(a.data_ptr() for a in args),
              *_table_ptrs(bs, K, above.device), B, bs, K, out.data_ptr(),
              device=out.get_device(), variant=f"bs{bs}")
    return out


def intra_pred_one(above, left, tl, have_a, have_l, cand, K, trreal=None,
                   blreal=None, abext=None, lfext=None, ef=None):
    """Prediction (B, bs, bs) int32 of candidate cand[b] per block. CPU
    tensors: plain version; CUDA tensors: kernel KA."""
    if above.device.type == "cpu":
        return intra_pred_one_plain(above, left, tl, have_a, have_l, cand, K,
                                    trreal, blreal, abext, lfext, ef)
    B, bs, args = _cuda_args(above, left, tl, have_a, have_l, K, trreal,
                             blreal, abext, lfext, ef,
                             cand.to(torch.int32), (above.shape[0],))
    out = torch.empty((B, bs, bs), dtype=torch.int32, device=above.device)
    *edges, cand = args
    KA.launch("intra_pred_one", *(a.data_ptr() for a in edges),
              *_table_ptrs(bs, K, above.device), cand.data_ptr(), B, bs, K,
              out.data_ptr(), device=out.get_device(), variant=f"bs{bs}")
    return out


# ----------------------------------------------------------------------
# the pick: predict, price, choose (one launch per batch of blocks)
# ----------------------------------------------------------------------
def rd_cost(sse, rate, rdmult):
    """RDCOST scaling (ec/costs.rdcost): (rate*rdmult)>>9 + (sse<<11) in
    float32, in the reference's order of operations (``tpu_intra._rd``) —
    decision-only."""
    return sse.to(torch.float32) * 2048.0 + \
        rate.to(torch.float32) * (rdmult / 512.0)


def _smooth(m):
    return (m >= 9) & (m <= 11)


@functools.cache
def _pick_consts(device: str):
    """MODE, DELTA (K = 61), PLAN_MODES and INTRA_MODE_CONTEXT on device."""
    tab = DIR.tables(16)
    return tuple(torch.as_tensor(np.asarray(v, np.int64), device=device)
                 for v in (tab["MODE"], tab["DELTA"], PLAN_MODES,
                           INTRA_MODE_CONTEXT))


def pick_table() -> np.ndarray:
    """Kernel KA's constant table (``csrc/intra_pred.cu`` ``kTab``): MODE,
    DELTA and CLS of the 61 candidates, the 7 PLAN modes, the 13
    INTRA_MODE_CONTEXT entries, the smooth weights at bs 4, 8, 16 and 32,
    then ``DIR.dir_consts`` at bs 16 and at bs 32, each row padded to 8."""
    tab = DIR.tables(16)
    parts = [tab["MODE"], tab["DELTA"], tab["CLS"], PLAN_MODES,
             INTRA_MODE_CONTEXT]
    parts += [intra_ops.smooth_weights(bs) for bs in (4, 8, 16, 32)]
    for bs in (16, 32):
        d = DIR.dir_consts(bs)
        parts.append(np.concatenate([d, np.zeros((len(d), 1), d.dtype)], 1))
    out = np.concatenate([np.asarray(p, np.int64).reshape(-1)
                          for p in parts]).astype(np.int32)
    assert out.size == 61 * 3 + 7 + 13 + 60 + 2 * 54 * 8, out.size
    return out


def intra_pick_plain(buf, tt, rc, cc, src, bs, K, rd, *, local=False, qr=0,
                     qc=0, scale=1, mode_cost=None, angle_cost=None,
                     uv_cost=None, nbr=None, nbr_scale=1, nbr_plan=False,
                     ok=None, trreal=None, blreal=None, mode_out=None,
                     delta_out=None):
    """Plain version of ``intra_pick``: the wavefronts' former composition
    (edge gathers, ``intra_pred_sse_plain``, the rate, the candidate mask,
    ``rd_cost``, the first-index argmin, ``intra_pred_one_plain``)."""
    dev = buf.device
    B, npl = rc.shape[0], len(src)
    zero = torch.zeros_like(rc)
    plane = torch.arange(B, device=dev) if local else tt
    oy = (zero if local else rc) * bs + (qr * bs + 1)
    ox = (zero if local else cc) * bs + (qc * bs + 1)
    planes = torch.cat([plane + p * (buf.shape[0] // npl)
                        for p in range(npl)])
    oy, ox = oy.repeat(npl), ox.repeat(npl)
    ar = torch.arange(bs, device=dev)
    above = buf[planes[:, None], (oy - 1)[:, None], ox[:, None] + ar]
    left = buf[planes[:, None], oy[:, None] + ar, (ox - 1)[:, None]]
    tl = buf[planes, oy - 1, ox - 1]
    have_a, have_l = (rc > 0) | (qr > 0), (cc > 0) | (qc > 0)
    i, j = rc * scale + qr, cc * scale + qc
    blocks = torch.cat([s[tt[:, None, None], (i * bs)[:, None, None]
                          + ar[:, None], (j * bs)[:, None, None] + ar]
                        for s in src])
    ni, nj = rc * nbr_scale + qr, cc * nbr_scale + qc
    modes, deltas, plan, imc = _pick_consts(str(dev))

    def nb(m):
        return plan[m.long()] if nbr_plan else m.long()

    if mode_cost is not None:
        am = mode_out[tt, i - 1, j] if qr > 0 else torch.where(
            rc > 0, nbr[tt, (ni - 1).clamp(min=0), nj], zero)
        lm = mode_out[tt, i, j - 1] if qc > 0 else torch.where(
            cc > 0, nbr[tt, ni, (nj - 1).clamp(min=0)], zero)
        am, lm = nb(am), nb(lm)
        rate = mode_cost[imc[am], imc[lm]] + angle_cost[None, :]
        ef = (_smooth(am) & have_a) | (_smooth(lm) & have_l)
    else:
        rate = uv_cost[nb(nbr[tt, ni, nj])]
        ef = None
    ext = {}
    if K != N_PLAIN:
        w = buf.shape[-1] - 1
        h = buf.shape[-2] - 1
        ext = dict(
            trreal=trreal[tt, i, j] if trreal is not None else None,
            blreal=blreal[tt, i, j] if blreal is not None else None,
            abext=buf[planes[:, None], (oy - 1)[:, None],
                      (ox[:, None] + bs + ar).clamp(max=w)],
            lfext=buf[planes[:, None], (oy[:, None] + bs + ar).clamp(max=h),
                      (ox - 1)[:, None]],
            ef=ef)
    both = (lambda x: x.repeat(npl)) if npl > 1 else (lambda x: x)
    ha2, hl2 = both(have_a), both(have_l)
    sse = intra_pred_sse_plain(above, left, tl, ha2, hl2, blocks, K, **ext)
    if npl > 1:
        sse = sse[:, :B] + sse[:, B:]
    cost = rd_cost(sse, rate.T, rd[tt, i, j])
    if ok is not None:
        allowed = DIR.allowed_mask(ok[0][tt, i, j], ok[1][tt, i, j],
                                   ok[2][tt, i, j], bs)
        cost = torch.where(allowed, cost, torch.full_like(cost,
                                                          float("inf")))
    best = cost.argmin(0)
    pred = intra_pred_one_plain(above, left, tl, ha2, hl2, both(best), K,
                                **ext)
    mode, delta = modes[best], deltas[best]
    if mode_out is not None:
        mode_out[tt, i, j] = (mode if K != N_PLAIN else best).to(
            mode_out.dtype)
    if delta_out is not None:
        delta_out[tt, i, j] = delta.to(delta_out.dtype)
    pick = torch.stack([best, mode, delta,
                        rate.gather(1, best[:, None])[:, 0].long()])
    return pick.to(torch.int32), pred


_PICK_READY = set()


def _pick_init(di: int):
    """Upload ``pick_table`` to CUDA device ``di``'s constant memory, once
    (a copy, not a kernel launch)."""
    if di not in _PICK_READY:
        tab = pick_table()
        with torch.cuda.device(di):
            KA.call("intra_pick_init", tab.ctypes.data, tab.size, device=di)
        _PICK_READY.add(di)


def intra_pick(buf, tt, rc, cc, src, bs, K, rd, *, local=False, qr=0, qc=0,
               scale=1, mode_cost=None, angle_cost=None, uv_cost=None,
               nbr=None, nbr_scale=1, nbr_plan=False, ok=None, trreal=None,
               blreal=None, mode_out=None, delta_out=None):
    """One intra pick per block: predict the K candidates (K = 61 at luma
    32/16, else the 7 plain modes) from the recon buffer, price them, mask
    the disallowed ones, take the float32 RD argmin (first index on ties)
    and predict the winner. CPU tensors: plain version; CUDA tensors:
    kernel KA, one launch.

    Block b is cell (tt[b], rc[b], cc[b]) (int64, (B,)) of the wavefront,
    of size ``bs``, at position (i, j) = (rc*scale + qr, cc*scale + qc) on
    the maps. Its edges are read from ``buf`` (int32 planes with a 1-px
    guard border): plane tt[b] at origin (rc*bs + 1, cc*bs + 1), or with
    ``local`` plane b of a per-cell buffer at (qr*bs + 1, qc*bs + 1)
    (quad (qr, qc) of the cell). ``src`` holds the source planes, each
    (T, SH, SW) int32 and contiguous: (luma,) or (U, V), a pair scored
    together (the SSEs summed before pricing), the V edges read from the
    plane ``buf.shape[0] // 2`` further on. The block's source is read
    where it lies, the (i*bs, j*bs) block of plane tt[b]. The above edge
    is there when rc > 0 or qr > 0, the left when cc > 0 or qc > 0.

    Per-position maps (T, MR, MC) are read at (tt, i, j): the float32
    lambdas ``rd``, the bool class masks
    ``ok`` = (ok1, ok2, ok3) and ``trreal`` / ``blreal`` (K = 61). Pricing:
    luma (``mode_cost`` (5, 5, K), ``angle_cost`` (K,)): the neighbours'
    modes, from ``mode_out`` inside the cell (qr / qc > 0), else from
    ``nbr`` (T, NR, NC) at scale ``nbr_scale`` (0 where absent), give the
    context and the edge-filter type; chroma (``uv_cost`` (13, K)): the
    luma mode at the block's position of ``nbr``. ``nbr_plan``: ``nbr``
    holds PLAN indices (the uniform grid), not AV1 modes. The choice is
    written into ``mode_out`` (the AV1 mode at K = 61, else the index) and
    ``delta_out`` at the block's position.

    Returns (pick (4, B) int32: candidate, AV1 mode, angle delta, mode
    rate; pred (P*B, bs, bs) int32)."""
    kw = dict(local=local, qr=qr, qc=qc, scale=scale, mode_cost=mode_cost,
              angle_cost=angle_cost, uv_cost=uv_cost, nbr=nbr,
              nbr_scale=nbr_scale, nbr_plan=nbr_plan, ok=ok, trreal=trreal,
              blreal=blreal, mode_out=mode_out, delta_out=delta_out)
    if buf.device.type == "cpu":
        return intra_pick_plain(buf, tt, rc, cc, src, bs, K, rd, **kw)
    B, npl = rc.shape[0], len(src)
    luma = mode_cost is not None
    if bs not in (4, 8, 16, 32) or K not in (N_PLAIN, len(DIR.candidates())) \
            or npl not in (1, 2) or src[0].dim() != 3 \
            or luma == (uv_cost is not None) \
            or (K != N_PLAIN and (bs < 16 or npl != 1 or not luma)) \
            or (not local and (qr or qc)) \
            or ((qr or qc) and scale != 2) \
            or (luma and (qr or qc) and (mode_out is None
                                          or nbr_scale != scale)) \
            or buf.dim() != 3 or rd.dim() != 3 or nbr is None \
            or nbr.dim() != 3:
        raise ValueError(f"KA pick: unsupported call (bs {bs}, K {K}, "
                         f"{npl} source planes, B {B}, local {local}, quad "
                         f"{qr},{qc}, scale {scale})")
    T, MR, MC = rd.shape
    di, i32, maps, vec = buf.get_device(), torch.int32, rd.shape, (B,)
    i64, b8 = torch.int64, torch.bool
    oks = ok if ok is not None else (None, None, None)

    def chk(t, dtype, shape, name):
        return need(t, dtype, shape, di, f"KA pick {name}")

    if luma:
        cost = chk(mode_cost, i32, (5, 5, K), "mode_cost")
        angle = chk(angle_cost, i32, (K,), "angle_cost")
    else:
        cost, angle = chk(uv_cost, i32, (13, K), "uv_cost"), 0
    ptrs = (chk(buf, i32, buf.shape, "buf"),
            chk(tt, i64, vec, "tt"), chk(rc, i64, vec, "rc"),
            chk(cc, i64, vec, "cc"), chk(src[0], i32, src[0].shape, "src"),
            chk(src[1] if npl == 2 else None, i32, src[0].shape, "src_v"),
            chk(rd, torch.float32, maps, "rd"),
            chk(oks[0], b8, maps, "ok1"),
            chk(oks[1], b8, maps, "ok2"),
            chk(oks[2], b8, maps, "ok3"),
            chk(trreal, b8, maps, "trreal"),
            chk(blreal, b8, maps, "blreal"), cost, angle,
            chk(nbr, i32, nbr.shape, "nbr"),
            chk(mode_out, i32, maps, "mode_out"),
            chk(delta_out, i32, maps, "delta_out"))
    pick = torch.empty((4, B), dtype=i32, device=buf.device)
    pred = torch.empty((npl * B, bs, bs), dtype=i32, device=buf.device)
    _pick_init(di)
    args = _PickArgs(*ptrs, pick.data_ptr(), pred.data_ptr(), B, K, bs, npl,
                     buf.shape[0] // npl, buf.shape[1], buf.shape[2],
                     int(local), qr, qc, src[0].shape[1], src[0].shape[2], T,
                     MR, MC, scale, nbr.shape[1], nbr.shape[2], nbr_scale,
                     int(nbr_plan), int(luma))
    KA.launch("intra_pick", ctypes.byref(args), device=di,
              variant=f"pick bs{bs}")
    return pick, pred
