"""Kernel KD ``mc_8tap``: batched single-reference motion compensation with
the bit-exact 8-tap 2-D convolve, and the per-block SAD / SSE against the
source blocks that follows every call in the reference.

Replaces ``tpu_inter._gather_region`` / ``_conv2d_batched`` / ``_mc_blocks``
(``aom_av1_psy_tpu/encoder/tpu_inter.py:47-93``) and the reductions after
each call (``:174``, ``:251``, ``:255-256``, ``:275-276``, ``:301``,
``:335``).

A call takes K candidate MV sets for the same B blocks: ``qr``/``qc`` are
(K, B) CLAMPED 1/16-pel MVs, and ``kernels`` is one (16, 8) filter family
or one per candidate (K, 16, 8). The plain version is a transcription of
the reference; the kernel equals it exactly (integer arithmetic only).

Exactness notes shared with the kernel:
- ``pos >> 4`` and ``pos & 15`` are an arithmetic shift and a two's
  complement mask, so MVs that point above or left of the frame split into
  a negative integer position and a phase in 0..15;
- the region indices clamp to the TRUE crop (``crop_h``, ``crop_w``), not
  to the padded plane.
"""
from __future__ import annotations

import torch

from . import convolve as CONV
from ..kernels.build import CudaKernel, I, P

KD = CudaKernel("mc", {
    # ref, H, W, crop_h, crop_w, by, bx, qr, qc, K, B, bw, kernels, src,
    # pred, sad, sse
    "mc_8tap": [P, I, I, I, I, P, P, P, P, I, I, I, P, P, P, P, P],
})

_ROUND0 = CONV.ROUND0_BITS
_ROUND1 = 2 * CONV.FILTER_BITS - _ROUND0


def conv2d_batched(region, kx, ky, bw: int, bd: int = 8):
    """av1_convolve_2d_sr with per-block kernels (``_conv2d_batched``):
    region (N, bw+7, bw+7) int32, kx/ky (N, 8) int32 -> (N, bw, bw)."""
    x = region.to(torch.int32)
    off = 1 << (bd + CONV.FILTER_BITS - 1)
    im = torch.zeros(x.shape[:-1] + (bw,), dtype=torch.int32,
                     device=x.device)
    for k in range(8):
        im = im + kx[:, k, None, None] * x[:, :, k:k + bw]
    im = (im + off + (1 << (_ROUND0 - 1))) >> _ROUND0
    offset_bits = bd + 2 * CONV.FILTER_BITS - _ROUND0
    out = torch.zeros(x.shape[:-2] + (bw, bw), dtype=torch.int32,
                      device=x.device)
    for k in range(8):
        out = out + ky[:, k, None, None] * im[:, k:k + bw, :]
    out = (out + (1 << offset_bits) + (1 << (_ROUND1 - 1))) >> _ROUND1
    out = out - ((1 << (offset_bits - _ROUND1))
                 + (1 << (offset_bits - _ROUND1 - 1)))
    return out.clamp(0, (1 << bd) - 1)


def mc_blocks_plain(ref, by, bx, qr, qc, bw: int, crop_h: int, crop_w: int,
                    kernels):
    """``_mc_blocks``: by/bx (B,) plane px; qr/qc (B,) clamped 1/16-pel;
    kernels (16, 8). Returns (B, bw, bw) int32."""
    pos_y = (by.to(torch.int32) << 4) + qr
    pos_x = (bx.to(torch.int32) << 4) + qc
    y0 = (pos_y >> 4) - 3
    x0 = (pos_x >> 4) - 3
    spy = (pos_y & 15).long()
    spx = (pos_x & 15).long()
    ar = torch.arange(bw + 7, dtype=torch.int32, device=ref.device)
    ys = (y0[:, None] + ar[None, :]).clamp(0, crop_h - 1).long()
    xs = (x0[:, None] + ar[None, :]).clamp(0, crop_w - 1).long()
    region = ref[ys[:, :, None], xs[:, None, :]]
    return conv2d_batched(region, kernels[spx], kernels[spy], bw)


def _per_candidate(kernels, K: int):
    return kernels.expand(K, 16, 8) if kernels.dim() == 2 else kernels


def mc_8tap_plain(ref, by, bx, qr, qc, bw: int, crop_h: int, crop_w: int,
                  kernels, src=None):
    """Plain version of KD: (pred (K, B, bw, bw), sad (K, B), sse (K, B))
    int32; sad/sse are None without ``src`` (B, bw, bw)."""
    K, B = qr.shape
    kern = _per_candidate(kernels, K)
    pred = torch.stack([mc_blocks_plain(ref, by, bx, qr[k], qc[k], bw, crop_h,
                                        crop_w, kern[k]) for k in range(K)])
    if src is None:
        return pred, None, None
    d = pred - src[None]
    return pred, d.abs().sum((-1, -2)).to(torch.int32), \
        (d * d).sum((-1, -2)).to(torch.int32)


def mc_8tap(ref, by, bx, qr, qc, bw: int, crop_h: int, crop_w: int, kernels,
            src=None, want_pred: bool = True):
    """Motion-compensate B blocks under K candidate MV sets.

    ref (H, W) int32 plane; by/bx (B,) int32 block origins; qr/qc (K, B)
    int32 clamped 1/16-pel MVs; kernels (16, 8) or (K, 16, 8) int32;
    src (B, bw, bw) int32 or None. Returns (pred (K, B, bw, bw) or None
    when not ``want_pred``, sad (K, B), sse (K, B)); sad/sse are None
    without ``src``. CPU tensors: plain version; CUDA tensors: kernel KD."""
    if ref.device.type == "cpu":
        pred, sad, sse = mc_8tap_plain(ref, by, bx, qr, qc, bw, crop_h,
                                       crop_w, kernels, src)
        return (pred if want_pred else None), sad, sse
    K, B = qr.shape
    if bw not in (8, 16, 32) or (src is None and not want_pred):
        raise ValueError(f"KD: unsupported bw={bw} / nothing to return")
    kern = _per_candidate(kernels, K)
    spec = [(ref, (ref.shape[0], ref.shape[1])), (by, (B,)), (bx, (B,)),
            (qr, (K, B)), (qc, (K, B)), (kern, (K, 16, 8))]
    if src is not None:
        spec.append((src, (B, bw, bw)))
    args = []
    for t, shape in spec:
        if t.device.type != "cuda" or t.dtype != torch.int32 or \
                tuple(t.shape) != shape:
            raise ValueError(f"KD input: want int32 {shape} on cuda, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        args.append(t.contiguous())
    ref, by, bx, qr, qc, kern = args[:6]
    if kern.data_ptr() % 16:
        kern = kern.clone()        # KD reads each phase's taps as 2 x int4
    dev = ref.device
    pred = torch.empty((K, B, bw, bw), dtype=torch.int32, device=dev) \
        if want_pred else None
    sad = sse = None
    if src is not None:
        sad = torch.empty((K, B), dtype=torch.int32, device=dev)
        sse = torch.empty((K, B), dtype=torch.int32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    KD.launch("mc_8tap", ref.data_ptr(), ref.shape[0], ref.shape[1], crop_h,
              crop_w, by.data_ptr(), bx.data_ptr(), qr.data_ptr(),
              qc.data_ptr(), K, B, bw, kern.data_ptr(),
              ptr(args[6] if src is not None else None), ptr(pred), ptr(sad),
              ptr(sse), device=dev.index)
    return pred, sad, sse
