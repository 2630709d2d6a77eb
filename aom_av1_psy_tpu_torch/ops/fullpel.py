"""Kernel KE ``fullpel_ssd``: exhaustive full-pel motion search over
+/-SEARCH_RAD with the reference's argmin.

Replaces ``tpu_inter._fullpel_search``
(``aom_av1_psy_tpu/encoder/tpu_inter.py:106-159``), which scores the 33 x 33
offsets of every block as ``sum(win^2) - 2 * corr(win, src)`` with two
grouped float32 convolutions. That score is exact in float32 (every
partial sum is a non-negative integer below 2**24), and it differs from the
integer SSD by the per-block constant ``sum(src^2)``. So the port scores the
integer SSD: same order, same ties. Ties go to the lowest flat index
(dy-major), as ``jnp.argmin``'s and ``torch.argmin``'s do.

No convolution library is used: the plain version sums squared
differences with elementwise torch ops, chunked over blocks so that a
1080p frame fits on the card and on the CPU; the kernel stages the window
in shared memory and scores strips of 12 offsets in registers, on 8-bit
words where the staged values allow (``csrc/fullpel.cu``, the strip engine
``csrc/strips.cuh`` it shares with KJ).
"""
from __future__ import annotations

import torch

from ..kernels.build import CudaKernel, I, P

SEARCH_RAD = 16

KE = CudaKernel("fullpel", {
    # src, plane, H, W, crop_h, crop_w, by, bx, cy, cx, B, bw, dy, dx
    "fullpel_ssd": [P, P, I, I, I, I, P, P, P, P, I, I, P, P],
})

# blocks per chunk of the plain version: (chunk, bw, 33, bw) int32 per dy
_CHUNK = 1024


def _windows(plane, oy, ox, bw: int, crop_h: int, crop_w: int):
    """(B, bw+2r, bw+2r) windows around origins oy/ox, clamped to the
    crop (``_gather_region`` of the reference's window indices)."""
    r = SEARCH_RAD
    ar = torch.arange(bw + 2 * r, dtype=torch.int32, device=plane.device)
    ys = (oy[:, None] - r + ar[None, :]).clamp(0, crop_h - 1).long()
    xs = (ox[:, None] - r + ar[None, :]).clamp(0, crop_w - 1).long()
    return plane[ys[:, :, None], xs[:, None, :]]


def fullpel_search_plain(src, plane, by, bx, crop_h: int, crop_w: int,
                         bw: int = 16, cy=None, cx=None):
    """Plain version of KE: src (B, bw, bw), block origins by/bx (B,),
    optional window centres cy/cx (B,). Returns full-pel (dy, dx) (B,)
    int32 each, centres included."""
    r = SEARCH_RAD
    n = 2 * r + 1
    oy = by if cy is None else by + cy
    ox = bx if cx is None else bx + cx
    best = []
    for i in range(0, src.shape[0], _CHUNK):
        win = _windows(plane, oy[i:i + _CHUNK], ox[i:i + _CHUNK], bw, crop_h,
                       crop_w)
        s = src[i:i + _CHUNK, :, None, :]                     # (b, bw, 1, bw)
        ssd = []
        for dy in range(n):
            w = win[:, dy:dy + bw, :].unfold(2, bw, 1)        # (b, bw, n, bw)
            d = w - s
            ssd.append((d * d).sum((1, 3)))                   # (b, n)
        best.append(torch.stack(ssd, 1).reshape(-1, n * n).argmin(1))
    best = torch.cat(best)
    dy = (best // n).to(torch.int32) - r
    dx = (best % n).to(torch.int32) - r
    if cy is not None:
        dy = dy + cy
        dx = dx + cx
    return dy, dx


def fullpel_search(src, plane, by, bx, crop_h: int, crop_w: int,
                   bw: int = 16, cy=None, cx=None):
    """(dy, dx) of ``fullpel_search_plain``. CPU tensors: plain version;
    CUDA tensors: kernel KE."""
    if plane.device.type == "cpu":
        return fullpel_search_plain(src, plane, by, bx, crop_h, crop_w, bw,
                                    cy, cx)
    B = src.shape[0]
    if bw not in (8, 16) or (cy is None) != (cx is None):
        raise ValueError(f"KE: unsupported bw={bw} / half-given centres")
    spec = [(src, (B, bw, bw)), (plane, tuple(plane.shape[-2:])),
            (by, (B,)), (bx, (B,))]
    if cy is not None:
        spec += [(cy, (B,)), (cx, (B,))]
    args = []
    for t, shape in spec:
        if t.device.type != "cuda" or t.dtype != torch.int32 or \
                tuple(t.shape) != shape:
            raise ValueError(f"KE input: want int32 {shape} on cuda, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        args.append(t.contiguous())
    src, plane, by, bx = args[:4]
    cptr = (args[4].data_ptr(), args[5].data_ptr()) if cy is not None \
        else (0, 0)
    dy = torch.empty((B,), dtype=torch.int32, device=plane.device)
    dx = torch.empty((B,), dtype=torch.int32, device=plane.device)
    KE.launch("fullpel_ssd", src.data_ptr(), plane.data_ptr(),
              plane.shape[0], plane.shape[1], crop_h, crop_w, by.data_ptr(),
              bx.data_ptr(), *cptr, B, bw, dy.data_ptr(),
              dx.data_ptr(), device=dx.get_device(), variant=f"bw{bw}")
    return dy, dx
