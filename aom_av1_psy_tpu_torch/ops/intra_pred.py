"""Kernel KA ``intra_pred_sse``: every intra candidate of a batch of square
blocks and its SSE against the source, plus the prediction of one chosen
candidate per block.

Replaces, inside the luma/chroma wavefronts, the reference's
``tpu_intra._predict_all_modes`` (``tpu_intra.py:64``), the directional
edge pipeline ``tpu_intra_dir._filter_edge_b`` / ``build_edge_buffer`` /
``dir_predict`` (``tpu_intra_dir.py:179-265``) and the SSE lines
``tpu_intra.py:645, :710, :817, :859``.

Candidates: K = 61 at luma 32/16 (the 7 plain modes DC, V, H, SMOOTH,
SMOOTH_V, SMOOTH_H, PAETH, then the 54 directional (mode, delta) pairs of
``tpu_intra_dir.candidates``), K = 7 (plain only) at chroma 16/8 and on
the uniform grid (``tpu_intra.py:282-411``: luma 8/16/32, chroma 4/8/16).

``predict_all_modes`` here is the torch counterpart of the reference's
``_predict_all_modes``; ``intra_pred_sse_plain`` / ``intra_pred_one_plain``
are the plain versions of the kernel, used for CPU tensors and held
against the kernel on the card.
"""
from __future__ import annotations

import functools

import torch

from . import intra as intra_ops
from ..encoder import tpu_intra_dir as DIR
from ..kernels.build import CudaKernel, I, P

N_PLAIN = 7

KA = CudaKernel("intra_pred", {
    # above, left, tl, have_a, have_l, trreal, blreal, abext, lfext, ef,
    # src, smooth_w, idxa, idxb, sh, B, bs, K, sse_out
    "intra_pred_sse": [P] * 15 + [I, I, I, P],
    # ... same inputs without src, cand, B, bs, K, pred_out
    "intra_pred_one": [P] * 10 + [P] * 4 + [P, I, I, I, P],
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
    return torch.as_tensor(intra_ops.smooth_weights(bs).astype("int32"),
                           device=device)


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
              variant=f"bs{bs}")
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
              out.data_ptr(), variant=f"bs{bs}")
    return out
