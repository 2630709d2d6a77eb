"""Palette / k-means kernels (``av1/encoder/k_means_template.h``:
av1_calc_indices_dim1/dim2 + av1_k_means iterations), batched — torch
counterpart of ``aom_av1_psy_tpu/ops/palette.py``.

The nearest-centroid assignment is a (N, K) distance matrix argmin; the
Lloyd iteration on top is a segment mean.

numpy arrays take the host branch (the reference's numpy code, int64).
Torch tensors take the tensor branch, the counterpart of the reference's
jnp branch: on CPU tensors the plain PyTorch version
(``calc_indices_plain``), on CUDA tensors kernel KQ ``palette_indices``
(``csrc/palette.cu``), with no fallback between them. Both read uint8,
int16, int32 or int64 data and centroids (``KQ_DTYPES``; another dtype
raises) and sum the total exactly in int64, as the numpy branch does (the
jnp branch sums in int32, since JAX runs without x64; it cannot wrap at
8-bit samples and N <= 4096). The tensor branch raises for K > 256, where
a uint8 index cannot hold the centroid (the numpy branch casts and wraps,
as the reference does). On the card one call is one KQ launch, which
reads the data in its own type and stores the total into a mapped pinned
host slot that the entry watches: no cast, no fill, no copy and no stream
synchronisation.
``k_means`` is host numpy, as in the reference.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels.build import CudaKernel, I, P

KQ = CudaKernel("palette", {
    # data, dtype, vec, centroids, ctype, N, K, dim, indices, slot,
    # scratch
    "palette_indices": [P, I, I, P, I, ctypes.c_longlong, I, I, P, P, P],
    # an array of two pointers: the slot and the scratch area
    "palette_setup": [P],
})

MAX_K = 256
# the integer types the tensor branch reads, by KQ's type code
KQ_DTYPES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3}
_VARIANT = (None, "dim1", "dim2")
_SLOTS = {}     # device index -> (the total's view, the slot, scratch)


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
        c = _tensor_inputs(data, centroids, dim)
        if data.device.type == "cpu":
            return calc_indices_plain(data, c, dim)
        return _launch_kq(data, c, dim)
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
    """``centroids`` as a tensor on data's device, after the checks that
    guard a launch: dim, device, dtype (``KQ_DTYPES``), whole points and
    the number of centroids (1..256)."""
    if dim not in (1, 2):
        raise ValueError(f"dim must be 1 or 2, got {dim}")
    if not torch.is_tensor(centroids):
        centroids = torch.as_tensor(np.asarray(centroids), device=data.device)
    if centroids.device != data.device:
        raise ValueError(f"centroids on {centroids.device}, data on "
                         f"{data.device}")
    _check_points(data, centroids, dim)
    return centroids


def _check_points(data, centroids, dim: int) -> None:
    for t, what in ((data, "data"), (centroids, "centroids")):
        if t.dtype not in KQ_DTYPES:
            raise ValueError(f"KQ {what}: dtype {t.dtype}, want one of "
                             "uint8, int16, int32, int64")
        if t.numel() % dim:
            raise ValueError(f"KQ {what}: {t.numel()} values are not whole "
                             f"points of dim {dim}")
    if not 0 < centroids.numel() // dim <= MAX_K:
        raise ValueError(f"K = {centroids.numel() // dim}: a uint8 index "
                         f"holds 1..{MAX_K} centroids")


def calc_indices_plain(data, centroids, dim: int):
    """Plain version of kernel KQ on tensors of any device: data (N*dim,)
    or (N, dim), centroids (K*dim,) or (K, dim), each of a ``KQ_DTYPES``
    type -> (indices uint8 (N,), total int), the numpy branch's int64
    arithmetic."""
    _check_points(data, centroids, dim)
    d = data.reshape(-1, dim).to(torch.int64)
    c = centroids.reshape(-1, dim).to(torch.int64)
    diff = d[:, None, :] - c[None, :, :]
    dist = diff[..., 0].abs() if dim == 1 else (diff * diff).sum(-1)
    idx = dist.argmin(1)                 # ties: the first centroid
    best = dist.gather(1, idx[:, None])[:, 0]
    total = int((best * best).sum() if dim == 1 else best.sum())
    return idx.to(torch.uint8), total


def _slot(di: int):
    """The device's mapped pinned slot for KQ's total (a ctypes view of the
    total, the slot's address) and KQ's scratch area, made once per
    device."""
    s = _SLOTS.get(di)
    if s is None:
        buf = (ctypes.c_void_p * 2)()
        KQ.call("palette_setup", ctypes.addressof(buf))
        s = _SLOTS[di] = (ctypes.c_longlong.from_address(buf[0]), buf[0],
                          buf[1])
    return s


def _launch_kq(data, cents, dim: int):
    """Kernel KQ: one launch on the data as it is (16-byte vectors where it
    is aligned and whole vectors); the kernel stores the total into the
    device's pinned slot, and the entry returns once it is there."""
    if not data.is_contiguous():
        data = data.contiguous()
    if not cents.is_contiguous():
        cents = cents.contiguous()
    n = data.numel() // dim
    idx = data.new_empty((n,), dtype=torch.uint8)
    if not n:
        return idx, 0
    host, slot, scratch = _slot(data.get_device())
    ptr = data.data_ptr()
    vec = int(ptr % 16 == 0 and data.numel() * data.element_size() % 16 == 0)
    KQ.launch("palette_indices", ptr, KQ_DTYPES[data.dtype], vec,
              cents.data_ptr(), KQ_DTYPES[cents.dtype], n,
              cents.numel() // dim, dim, idx.data_ptr(), slot, scratch,
              variant=_VARIANT[dim])
    return idx, host.value


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
