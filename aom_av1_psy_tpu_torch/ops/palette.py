"""Palette / k-means kernels (``av1/encoder/k_means_template.h``:
av1_calc_indices_dim1/dim2 + av1_k_means iterations), batched — torch
counterpart of ``aom_av1_psy_tpu/ops/palette.py``.

The nearest-centroid assignment is a (N, K) distance matrix argmin; the
Lloyd iteration on top is a segment mean.

numpy arrays take the host branch (the reference's numpy code, int64).
Torch tensors take the tensor branch, the counterpart of the reference's
jnp branch: on CPU tensors the plain PyTorch version
(``calc_indices_plain``), on CUDA tensors kernel KQ ``palette_indices``
(``csrc/palette.cu``), with no fallback between them. Both sum the total
exactly in int64, as the numpy branch does (the jnp branch sums in int32,
since JAX runs without x64; it cannot wrap at 8-bit samples and N <= 4096).
The tensor branch raises for K > 256, where a uint8 index cannot hold the
centroid (the numpy branch casts and wraps, as the reference does).
``k_means`` is host numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.build import CudaKernel, I, P

KQ = CudaKernel("palette", {
    # data, centroids, N, K, dim, indices, total
    "palette_indices": [P, P, I, I, I, P, P],
})

MAX_K = 256


def _xp(x):
    """numpy for the host branch, torch for the tensor branch."""
    if isinstance(x, np.ndarray):
        return np
    if torch.is_tensor(x):
        return torch
    raise TypeError(f"numpy array or torch tensor expected, got "
                    f"{type(x).__name__}")


def calc_indices(data, centroids, dim: int):
    """av1_calc_indices_dim{1,2}_c. data: (N*dim,) or (N, dim);
    centroids: (K*dim,) or (K, dim). Returns (indices uint8 (N,),
    total_dist int). dim==1 uses |d| for the argmin (squared for the
    total), dim==2 squared L2 throughout — matching the reference. Ties go
    to the first centroid."""
    xp = _xp(data)
    if xp is torch:
        d, c = _tensor_inputs(data, centroids, dim)
        if d.device.type == "cpu":
            return calc_indices_plain(d, c, dim)
        return _launch_kq(d, c, dim)
    d = xp.asarray(data).reshape(-1, dim).astype(xp.int64)
    c = xp.asarray(centroids).reshape(-1, dim).astype(xp.int64)
    diff = d[:, None, :] - c[None, :, :]
    if dim == 1:
        dist = xp.abs(diff[..., 0])
        idx = xp.argmin(dist, axis=1)
        best = xp.min(dist, axis=1)
        total = int((best.astype(xp.int64) ** 2).sum())
    else:
        dist = (diff * diff).sum(-1)
        idx = xp.argmin(dist, axis=1)
        total = int(xp.min(dist, axis=1).sum())
    return idx.astype(xp.uint8), total


def _tensor_inputs(data, centroids, dim: int):
    """(N, dim) and (K, dim) int64 tensors on data's device."""
    if dim not in (1, 2):
        raise ValueError(f"dim must be 1 or 2, got {dim}")
    if not torch.is_tensor(centroids):
        centroids = torch.as_tensor(np.asarray(centroids), device=data.device)
    if centroids.device != data.device:
        raise ValueError(f"centroids on {centroids.device}, data on "
                         f"{data.device}")
    d = data.reshape(-1, dim).to(torch.int64)
    c = centroids.reshape(-1, dim).to(torch.int64)
    if not 0 < c.shape[0] <= MAX_K:
        raise ValueError(f"K = {c.shape[0]}: a uint8 index holds 1..{MAX_K} "
                         "centroids")
    return d, c


def calc_indices_plain(d, c, dim: int):
    """Plain version of kernel KQ: (N, dim), (K, dim) int64 tensors ->
    (indices uint8 (N,), total int), the numpy branch's arithmetic."""
    diff = d[:, None, :] - c[None, :, :]
    dist = diff[..., 0].abs() if dim == 1 else (diff * diff).sum(-1)
    idx = dist.argmin(1)                 # ties: the first centroid
    best = dist.gather(1, idx[:, None])[:, 0]
    total = int((best * best).sum() if dim == 1 else best.sum())
    return idx.to(torch.uint8), total


def _launch_kq(d, c, dim: int):
    """Kernel KQ: one thread per point, the centroids in shared memory,
    the total summed per CTA and added with one int64 atomic."""
    d, c = d.contiguous(), c.contiguous()
    n = d.shape[0]
    idx = torch.empty((n,), dtype=torch.uint8, device=d.device)
    total = torch.zeros((1,), dtype=torch.int64, device=d.device)
    if n:
        KQ.launch("palette_indices", d.data_ptr(), c.data_ptr(), n,
                  c.shape[0], dim, idx.data_ptr(), total.data_ptr(),
                  variant=f"dim{dim}")
    return idx, int(total)


def k_means(data, k: int, dim: int, max_itr: int = 50):
    """Lloyd iterations (av1_k_means_template): centroids seeded evenly
    over the value range, nearest-assign + segment-mean update."""
    d = np.asarray(data).reshape(-1, dim).astype(np.int64)
    lo, hi = d.min(0), d.max(0)
    cents = np.stack([lo + (hi - lo) * (2 * i + 1) // (2 * k)
                      for i in range(k)]).astype(np.int64)
    prev = None
    for _ in range(max_itr):
        idx, total = calc_indices(d, cents, dim)
        if prev is not None and total >= prev:
            break
        prev = total
        for j in range(k):
            sel = d[idx == j]
            if len(sel):
                cents[j] = (sel.sum(0) + len(sel) // 2) // len(sel)
    idx, total = calc_indices(d, cents, dim)
    return cents, idx, total
