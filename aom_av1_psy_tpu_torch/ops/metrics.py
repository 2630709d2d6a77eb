"""Batched distortion/metric kernel zoo — torch counterpart of
``aom_av1_psy_tpu/ops/metrics.py``.

A replacement for the ``aom_dsp`` SAD/variance/SSE/SATD RTCD families
(aom_dsp_rtcd_defs.pl: ~103 sad/variance protos): instead of one function
per block size per arch, a handful of batched reducers over ``(..., h, w)``
arrays.

numpy arrays take the host branch (the reference's numpy code, int64
sums). Torch tensors take the tensor branch, the counterpart of the
reference's jnp branch: on CPU tensors the plain PyTorch versions
(``*_plain``, any device), on CUDA tensors kernel KN ``block_reduce``
(every reducer but the Hadamard) and kernel KO ``satd8x8``
(``hadamard8x8``, ``satd``), both in ``csrc/metrics.cu``, with no fallback
between them. Sums are int64 on both, as the numpy branch's are (the jnp
branch sums in int32, since JAX runs without x64, and wraps where they do
not fit). The kernels take integer tensors of at most 32 bits and read
them in their own type (inputs of different types go to the kernel as
int32). ``psnr``,
``ssim`` and ``psnr_hvs`` are host numpy only, as in the reference.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels.build import CudaKernel, I, P


class _KNArgs(ctypes.Structure):
    """``csrc/metrics.cu``'s ``KNArgs``, field for field."""
    _fields_ = ([(f, P) for f in ("a", "b", "c", "d", "s0", "s1", "out")]
                + [(f, I) for f in ("op", "dtype", "B", "n", "w", "bdiv",
                                    "a_rows", "a_w", "t0", "t1", "u0", "u1",
                                    "avg")])


KN = CudaKernel("block_reduce", {
    "block_reduce": [ctypes.POINTER(_KNArgs)],
}, source="metrics")
KO = CudaKernel("satd8x8", {
    # x, dtype, B, transform, satd
    "satd8x8": [P, I, I, P, P],
}, source="metrics")

# KN's ops (csrc/metrics.cu enum Op)
_SAD, _SSE, _VAR, _BLOCK_ERROR, _OBMC_SAD, _OBMC_VAR, _MASKED_SAD, \
    _SUBPEL_VAR, _PROJECT = range(9)
_I64 = torch.int64


def _xp(x):
    """numpy, the array type of the host branches."""
    if isinstance(x, np.ndarray):
        return np
    raise TypeError(f"numpy array expected, got {type(x).__name__}")


def _on_cpu(t) -> bool:
    return t.is_cpu


def sad(a, b):
    """Sum of absolute differences over trailing 2 dims (aom_sad{W}x{H})."""
    if torch.is_tensor(a):
        return sad_plain(a, b) if _on_cpu(a) else _kn(_SAD, a, b)
    xp = _xp(a)
    return xp.abs(a.astype(xp.int32) - b.astype(xp.int32)).sum((-1, -2))


def sad_x4(src, refs):
    """One source block vs N candidate refs (aom_sadWxHx4d analogue).
    src: (..., h, w); refs: (..., N, h, w)."""
    if torch.is_tensor(src):
        return sad_x4_plain(src, refs) if _on_cpu(src) else _kn_x4(src, refs)
    xp = _xp(src)
    return xp.abs(refs.astype(xp.int32)
                  - src[..., None, :, :].astype(xp.int32)).sum((-1, -2))


def sse(a, b):
    """Sum of squared error (aom_sse)."""
    if torch.is_tensor(a):
        return sse_plain(a, b) if _on_cpu(a) else _kn(_SSE, a, b)
    xp = _xp(a)
    d = a.astype(xp.int64) - b.astype(xp.int64)
    return (d * d).sum((-1, -2))


def variance(src, ref):
    """(sse, se) pair like aom_variance{W}x{H}: returns
    sse - se^2/n (the variance proper) plus raw terms."""
    if torch.is_tensor(src):
        if _on_cpu(src):
            return variance_plain(src, ref)
        s, ss = _kn(_VAR, src, ref)
        return ss - (s * s) // (src.shape[-1] * src.shape[-2]), ss, s
    xp = _xp(src)
    d = src.astype(xp.int64) - ref.astype(xp.int64)
    s = d.sum((-1, -2))
    ss = (d * d).sum((-1, -2))
    n = src.shape[-1] * src.shape[-2]
    return ss - (s * s) // n, ss, s


def block_error(coeff, dqcoeff, shift: int = 0):
    """av1_block_error: SSE between tx coeffs and dequantized coeffs,
    plus |ssz| of the source coeffs; >> 2*shift normalization."""
    if torch.is_tensor(coeff):
        if _on_cpu(coeff):
            return block_error_plain(coeff, dqcoeff, shift)
        err, ssz = _kn(_BLOCK_ERROR, coeff, dqcoeff, dims=1)
        return err >> (2 * shift), ssz >> (2 * shift)
    xp = _xp(coeff)
    d = coeff.astype(xp.int64) - dqcoeff.astype(xp.int64)
    err = (d * d).sum(-1) >> (2 * shift)
    ssz = (coeff.astype(xp.int64) ** 2).sum(-1) >> (2 * shift)
    return err, ssz


def hadamard8x8(x):
    """Batched 8x8 Hadamard transform (aom_hadamard_8x8 semantics:
    row pass then column pass of length-8 WHT butterflies)."""
    if torch.is_tensor(x):
        return hadamard8x8_plain(x) if _on_cpu(x) else _ko(x, True)[0]
    xp = _xp(x)

    def wht8(v, axis):
        # one stage structure matching aom_hadamard: b = a0±a1 pairs thrice
        def pairs(t, stride):
            idx0 = []
            idx1 = []
            for base in range(0, 8, stride * 2):
                for k in range(stride):
                    idx0.append(base + k)
                    idx1.append(base + k + stride)
            return idx0, idx1

        out = v
        for stride in (1, 2, 4):
            i0, i1 = pairs(out, stride)
            a = xp.take(out, xp.asarray(i0), axis=axis)
            b = xp.take(out, xp.asarray(i1), axis=axis)
            plus = a + b
            minus = a - b
            # interleave back in the i0/i1 positions
            res = [None] * 8
            for n, (p, q) in enumerate(zip(i0, i1)):
                res[p] = xp.take(plus, xp.asarray([n]), axis=axis)
                res[q] = xp.take(minus, xp.asarray([n]), axis=axis)
            out = xp.concatenate(res, axis=axis)
        return out

    y = wht8(x.astype(xp.int32), -1)
    return wht8(y, -2)


def satd(x):
    """Sum of absolute Hadamard-transformed differences (aom_satd)."""
    if torch.is_tensor(x):
        return satd_plain(x) if _on_cpu(x) else _ko(x, False)[1]
    xp = _xp(x)
    return xp.abs(hadamard8x8(x)).sum((-1, -2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    if mse <= 1e-12:
        return 100.0
    return float(10.0 * np.log10(peak * peak / mse))


# SSIM per aom_dsp/ssim.c (8x8 windows on a 4px grid, integer moments)
_CC1 = 26634
_CC2 = 239708


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """aom_ssim2 for 8-bit planes (reference aom_dsp/ssim.c:101)."""
    h, w = img1.shape
    a = img1.astype(np.int64)
    b = img2.astype(np.int64)
    total = 0.0
    count = 0
    n = 64
    c1 = (_CC1 * n * n) >> 12
    c2 = (_CC2 * n * n) >> 12
    # vectorized over all 8x8 windows at stride 4
    ys = np.arange(0, h - 7, 4)
    xs = np.arange(0, w - 7, 4)
    from numpy.lib.stride_tricks import sliding_window_view
    wa = sliding_window_view(a, (8, 8))[::4, ::4]
    wb = sliding_window_view(b, (8, 8))[::4, ::4]
    sum_s = wa.sum((-1, -2)).astype(np.float64)
    sum_r = wb.sum((-1, -2)).astype(np.float64)
    sum_sq_s = (wa * wa).sum((-1, -2)).astype(np.float64)
    sum_sq_r = (wb * wb).sum((-1, -2)).astype(np.float64)
    sum_sxr = (wa * wb).sum((-1, -2)).astype(np.float64)
    ssim_n = (2 * sum_s * sum_r + c1) * (2 * n * sum_sxr - 2 * sum_s * sum_r + c2)
    ssim_d = (sum_s ** 2 + sum_r ** 2 + c1) * \
        (n * sum_sq_s - sum_s ** 2 + n * sum_sq_r - sum_r ** 2 + c2)
    v = ssim_n / ssim_d
    return float(v.mean())


# ---------------------------------------------------------------------------
# Sub-pixel / OBMC / masked variants (aom_dsp/variance.c:91+, sad_av1.c)
# ---------------------------------------------------------------------------

_BIL_2T = np.array([[128, 0], [112, 16], [96, 32], [80, 48],
                    [64, 64], [48, 80], [32, 96], [16, 112]], np.int64)


def _bil_pass(a, taps, vertical: bool):
    """aom_var_filter_block2d_bil_*_pass_c: 2-tap bilinear, round 7."""
    xp = _xp(a)
    t0, t1 = int(taps[0]), int(taps[1])
    if vertical:
        s = a[..., :-1, :] * t0 + a[..., 1:, :] * t1
    else:
        s = a[..., :, :-1] * t0 + a[..., :, 1:] * t1
    return (s + 64) >> 7


def subpel_project(src_ext, w: int, h: int, xoffset: int, yoffset: int):
    """The bilinear-projected prediction used by sub_pixel_variance:
    src_ext: (..., h+1, w+1) region (one extra row/col)."""
    if torch.is_tensor(src_ext):
        if _on_cpu(src_ext):
            return subpel_project_plain(src_ext, w, h, xoffset, yoffset)
        return _kn_bil(_PROJECT, src_ext, None, h, xoffset, yoffset)
    xp = _xp(src_ext)
    a = src_ext.astype(xp.int64)
    f = _bil_pass(a[..., : h + 1, :], _BIL_2T[xoffset], False)  # (h+1, w)
    return _bil_pass(f, _BIL_2T[yoffset], True)                 # (h, w)


def sub_pixel_variance(src_ext, ref, xoffset: int, yoffset: int):
    """aom_sub_pixel_variance{W}x{H}_c: returns (variance, sse)."""
    if torch.is_tensor(src_ext):
        if _on_cpu(src_ext):
            return sub_pixel_variance_plain(src_ext, ref, xoffset, yoffset)
        h, w = ref.shape[-2:]
        s, sse = _kn_bil(_SUBPEL_VAR, src_ext, ref, h, xoffset, yoffset)
        return sse - (s * s) // (w * h), sse
    xp = _xp(src_ext)
    h, w = ref.shape[-2:]
    pred = subpel_project(src_ext, w, h, xoffset, yoffset)
    d = pred - ref.astype(xp.int64)
    sse = (d * d).sum((-1, -2))
    s = d.sum((-1, -2))
    return sse - (s * s) // (w * h), sse


def sub_pixel_avg_variance(src_ext, ref, xoffset: int, yoffset: int,
                           second_pred):
    """aom_sub_pixel_avg_variance{W}x{H}_c: bilinear pred averaged with
    second_pred before the variance."""
    if torch.is_tensor(src_ext):
        if _on_cpu(src_ext):
            return sub_pixel_avg_variance_plain(src_ext, ref, xoffset,
                                                yoffset, second_pred)
        h, w = ref.shape[-2:]
        s, sse = _kn_bil(_SUBPEL_VAR, src_ext, ref, h, xoffset, yoffset,
                         second_pred)
        return sse - (s * s) // (w * h), sse
    xp = _xp(src_ext)
    h, w = ref.shape[-2:]
    pred = subpel_project(src_ext, w, h, xoffset, yoffset)
    pred = (pred + second_pred.astype(xp.int64) + 1) >> 1
    d = pred - ref.astype(xp.int64)
    sse = (d * d).sum((-1, -2))
    s = d.sum((-1, -2))
    return sse - (s * s) // (w * h), sse


def _round2_signed(v, bits):
    """ROUND_POWER_OF_TWO_SIGNED: round magnitude, keep sign."""
    xp = _xp(v)
    mag = (xp.abs(v) + (1 << (bits - 1))) >> bits
    return xp.where(v < 0, -mag, mag)


def obmc_sad(pre, wsrc, mask):
    """aom_obmc_sad{W}x{H}_c: |round2s(wsrc - pre*mask, 12)| summed."""
    if torch.is_tensor(pre):
        if _on_cpu(pre):
            return obmc_sad_plain(pre, wsrc, mask)
        return _kn(_OBMC_SAD, pre, wsrc, mask)
    xp = _xp(pre)
    diff = wsrc.astype(xp.int64) - pre.astype(xp.int64) * mask.astype(xp.int64)
    r = _round2_signed(diff, 12)
    return xp.abs(r).sum((-1, -2))


def obmc_variance(pre, wsrc, mask):
    """aom_obmc_variance{W}x{H}_c: returns (variance, sse)."""
    if torch.is_tensor(pre):
        if _on_cpu(pre):
            return obmc_variance_plain(pre, wsrc, mask)
        h, w = pre.shape[-2:]
        s, sse = _kn(_OBMC_VAR, pre, wsrc, mask)
        return sse - (s * s) // (w * h), sse
    xp = _xp(pre)
    h, w = pre.shape[-2:]
    diff = wsrc.astype(xp.int64) - pre.astype(xp.int64) * mask.astype(xp.int64)
    r = _round2_signed(diff, 12)
    sse = (r * r).sum((-1, -2))
    s = r.sum((-1, -2))
    return sse - (s * s) // (w * h), sse


def masked_sad(src, a, b, mask, invert: bool = False):
    """aom_masked_sad{W}x{H}_c: SAD against the a64 mask blend of a/b."""
    if torch.is_tensor(src):
        if invert:
            a, b = b, a
        if _on_cpu(src):
            return masked_sad_plain(src, a, b, mask)
        return _kn(_MASKED_SAD, a, b, mask, src)
    xp = _xp(src)
    m = mask.astype(xp.int64)
    if invert:
        a, b = b, a
    pred = (m * a.astype(xp.int64) + (64 - m) * b.astype(xp.int64) + 32) >> 6
    return xp.abs(pred - src.astype(xp.int64)).sum((-1, -2))


# ---------------------------------------------------------------------------
# The tensor branch: plain PyTorch versions (any device; int64 sums as the
# numpy branch's) and the wrappers of kernels KN and KO
# ---------------------------------------------------------------------------

def sad_plain(a, b):
    return (a.to(_I64) - b.to(_I64)).abs().sum((-1, -2))


def sad_x4_plain(src, refs):
    return (refs.to(_I64) - src[..., None, :, :].to(_I64)).abs().sum((-1, -2))


def sse_plain(a, b):
    d = a.to(_I64) - b.to(_I64)
    return (d * d).sum((-1, -2))


def variance_plain(src, ref):
    d = src.to(_I64) - ref.to(_I64)
    s = d.sum((-1, -2))
    ss = (d * d).sum((-1, -2))
    return ss - (s * s) // (src.shape[-1] * src.shape[-2]), ss, s


def block_error_plain(coeff, dqcoeff, shift: int = 0):
    c = coeff.to(_I64)
    d = c - dqcoeff.to(_I64)
    return (d * d).sum(-1) >> (2 * shift), (c * c).sum(-1) >> (2 * shift)


def _wht8_plain(v, dim):
    """The reference's ``wht8``: strides 1, 2, 4, each pair (j, j + stride)
    becoming (sum, difference) in place; int32 wraps as numpy's does."""
    for stride in (1, 2, 4):
        i0 = [b + k for b in range(0, 8, 2 * stride) for k in range(stride)]
        i1 = [j + stride for j in i0]
        a = v.index_select(dim, torch.tensor(i0, device=v.device))
        b = v.index_select(dim, torch.tensor(i1, device=v.device))
        out = torch.empty_like(v)
        out.index_copy_(dim, torch.tensor(i0, device=v.device), a + b)
        out.index_copy_(dim, torch.tensor(i1, device=v.device), a - b)
        v = out
    return v


def hadamard8x8_plain(x):
    x = x.to(torch.int32)
    return _wht8_plain(_wht8_plain(x, x.dim() - 1), x.dim() - 2)


def satd_plain(x):
    return hadamard8x8_plain(x).abs().to(_I64).sum((-1, -2))


def _bil_plain(a, taps, vertical: bool):
    t0, t1 = int(taps[0]), int(taps[1])
    if vertical:
        s = a[..., :-1, :] * t0 + a[..., 1:, :] * t1
    else:
        s = a[..., :, :-1] * t0 + a[..., :, 1:] * t1
    return (s + 64) >> 7


def subpel_project_plain(src_ext, w: int, h: int, xoffset: int,
                         yoffset: int):
    a = src_ext.to(_I64)
    f = _bil_plain(a[..., :h + 1, :], _BIL_2T[xoffset], False)
    return _bil_plain(f, _BIL_2T[yoffset], True)


def sub_pixel_variance_plain(src_ext, ref, xoffset: int, yoffset: int):
    h, w = ref.shape[-2:]
    d = subpel_project_plain(src_ext, w, h, xoffset, yoffset) - ref.to(_I64)
    sse = (d * d).sum((-1, -2))
    s = d.sum((-1, -2))
    return sse - (s * s) // (w * h), sse


def sub_pixel_avg_variance_plain(src_ext, ref, xoffset: int, yoffset: int,
                                 second_pred):
    h, w = ref.shape[-2:]
    pred = subpel_project_plain(src_ext, w, h, xoffset, yoffset)
    pred = (pred + second_pred.to(_I64) + 1) >> 1
    d = pred - ref.to(_I64)
    sse = (d * d).sum((-1, -2))
    s = d.sum((-1, -2))
    return sse - (s * s) // (w * h), sse


def _obmc_r_plain(pre, wsrc, mask):
    diff = wsrc.to(_I64) - pre.to(_I64) * mask.to(_I64)
    mag = (diff.abs() + (1 << 11)) >> 12
    return torch.where(diff < 0, -mag, mag)


def obmc_sad_plain(pre, wsrc, mask):
    return _obmc_r_plain(pre, wsrc, mask).abs().sum((-1, -2))


def obmc_variance_plain(pre, wsrc, mask):
    h, w = pre.shape[-2:]
    r = _obmc_r_plain(pre, wsrc, mask)
    sse = (r * r).sum((-1, -2))
    s = r.sum((-1, -2))
    return sse - (s * s) // (w * h), sse


def masked_sad_plain(src, a, b, mask):
    """``masked_sad`` with ``a`` and ``b`` already swapped for ``invert``."""
    m = mask.to(_I64)
    pred = (m * a.to(_I64) + (64 - m) * b.to(_I64) + 32) >> 6
    return (pred - src.to(_I64)).abs().sum((-1, -2))


# the kernels' element types (csrc/metrics.cu enum Dtype)
_DTYPES = {torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3}
# ops that write a second sum
_TWO_SUMS = frozenset((_VAR, _BLOCK_ERROR, _OBMC_VAR, _SUBPEL_VAR))


def _kernel_inputs(ts):
    """The inputs as KN / KO read them, and their type code: one integer
    type of at most 32 bits on one device (int32 where the inputs' types
    differ), contiguous. An input already in that form is not copied."""
    d, dt = ts[0].get_device(), ts[0].dtype
    for t in ts:
        if t.get_device() != d or t.dtype not in _DTYPES:
            raise ValueError(f"KN/KO input: want an integer tensor of at "
                             f"most 32 bits on {ts[0].device}, got "
                             f"{t.dtype} on {t.device}")
        if t.dtype != dt:
            dt = None
    if dt is None:
        ts, dt = [t.to(torch.int32) for t in ts], torch.int32
    return [t if t.is_contiguous() else t.contiguous() for t in ts], \
        _DTYPES[dt]


def _launch_kn(op, ts, code, shape, B, n, w, bdiv=1, a_rows=0, a_w=0,
               taps=(0, 0, 0, 0), avg=0):
    """One KN launch into a new int64 tensor of ``shape``: the B items'
    sums (with a leading 2 for the ops with two sums), or the
    projection."""
    out = torch.empty(shape, dtype=_I64, device=ts[0].device)
    p = out.data_ptr()
    if op == _PROJECT:
        sums = (0, 0, p)
    else:
        sums = (p, p + 8 * B if op in _TWO_SUMS else 0, 0)
    ptrs = [t.data_ptr() for t in ts] + [0] * (4 - len(ts))
    KN.launch("block_reduce", ctypes.byref(_KNArgs(
        *ptrs, *sums, op, code, B, n, w, bdiv, a_rows, a_w, *taps, avg)),
        device=out.get_device(), variant=_OP_NAMES[op])
    return out


_OP_NAMES = ("sad", "sse", "variance", "block_error", "obmc_sad",
             "obmc_variance", "masked_sad", "sub_pixel_variance",
             "subpel_project")


def _kn(op, *ts, dims: int = 2):
    """KN over ``ts`` (broadcast only where their shapes differ) with items
    of the last ``dims`` axes: each item's int64 sum, of the batch shape
    (with a leading 2 for the ops with two sums)."""
    shape = ts[0].shape
    if any(t.shape != shape for t in ts[1:]):
        ts = torch.broadcast_tensors(*ts)
        shape = ts[0].shape
    lead = shape[:len(shape) - dims]
    n = shape[-1] * shape[-2] if dims == 2 else shape[-1]
    ts, code = _kernel_inputs(ts)
    B = ts[0].numel() // n if n else 0
    return _launch_kn(op, ts, code, (2, *lead) if op in _TWO_SUMS else lead,
                      B, n, shape[-1])


def _kn_x4(src, refs):
    """sad_x4 through KN: item (i, k) reads refs[i, k] and src[i]."""
    N, h, w = refs.shape[-3:]
    lead = torch.broadcast_shapes(src.shape[:-2], refs.shape[:-3])
    (r, s), code = _kernel_inputs([refs.expand(*lead, N, h, w),
                                   src.expand(*lead, h, w)])
    B = s.numel() // (h * w) if h * w else 0
    return _launch_kn(_SAD, [r, s], code, (*lead, N), B * N, h * w, w,
                      bdiv=N)


def _kn_bil(op, src_ext, ref, h, xoffset, yoffset, second_pred=None):
    """The bilinear ops through KN: the projection of src_ext[..., :h+1, :]
    is (h, W - 1); ``ref`` (and ``second_pred``) are (..., h, W - 1)."""
    wo = src_ext.shape[-1] - 1
    taps = (*(int(v) for v in _BIL_2T[xoffset]),
            *(int(v) for v in _BIL_2T[yoffset]))
    others = [t for t in (ref, second_pred) if t is not None]
    for t in others:
        if t.shape[-2:] != (h, wo):
            raise ValueError(f"KN: {tuple(t.shape)} against a projection of "
                             f"{h}x{wo}")
    lead = torch.broadcast_shapes(src_ext.shape[:-2],
                                  *(t.shape[:-2] for t in others))
    ts, code = _kernel_inputs(
        [src_ext[..., :h + 1, :].expand(*lead, h + 1, wo + 1)]
        + [t.expand(*lead, h, wo) for t in others])
    B = ts[0].numel() // ((h + 1) * (wo + 1))
    shape = (*lead, h, wo) if op == _PROJECT else (2, *lead)
    out = _launch_kn(op, ts, code, shape, B, h * wo, wo, a_rows=h + 1,
                     a_w=wo + 1, taps=taps,
                     avg=int(second_pred is not None))
    return out if op == _PROJECT else (out[0], out[1])


def _ko(x, want_transform: bool):
    """KO over (..., 8, 8) blocks: (transform int32 or None, satd int64)."""
    if tuple(x.shape[-2:]) != (8, 8):
        raise ValueError(f"KO: blocks {tuple(x.shape)}, want (..., 8, 8)")
    lead = x.shape[:-2]
    (xi,), code = _kernel_inputs([x])
    B = xi.numel() // 64
    t = torch.empty((*lead, 8, 8), dtype=torch.int32, device=x.device) \
        if want_transform else None
    s = torch.empty(lead, dtype=_I64, device=x.device)
    KO.launch("satd8x8", xi.data_ptr(), code, B,
              t.data_ptr() if t is not None else 0, s.data_ptr(),
              device=s.get_device(),
              variant="transform" if want_transform else "satd")
    return t, s


# ---------------------------------------------------------------------------
# PSNR-HVS(-M) — aom_dsp/psnrhvs.c (aom_psnrhvs), vectorized
# ---------------------------------------------------------------------------
_CSF_Y = np.array([
    [1.6193873005, 2.2901594831, 2.08509755623, 1.48366094411, 1.00227514334,
     0.678296995242, 0.466224900598, 0.3265091542],
    [2.2901594831, 1.94321815382, 2.04793073064, 1.68731108984, 1.2305666963,
     0.868920337363, 0.61280991668, 0.436405793551],
    [2.08509755623, 2.04793073064, 1.34329019223, 1.09205635862,
     0.875748795257, 0.670882927016, 0.501731932449, 0.372504254596],
    [1.48366094411, 1.68731108984, 1.09205635862, 0.772819797575,
     0.605636379554, 0.48309405692, 0.380429446972, 0.295774038565],
    [1.00227514334, 1.2305666963, 0.875748795257, 0.605636379554,
     0.448996256676, 0.352889268808, 0.283006984131, 0.226951348204],
    [0.678296995242, 0.868920337363, 0.670882927016, 0.48309405692,
     0.352889268808, 0.27032073436, 0.215017739696, 0.17408067321],
    [0.466224900598, 0.61280991668, 0.501731932449, 0.380429446972,
     0.283006984131, 0.215017739696, 0.168869545842, 0.136153931001],
    [0.3265091542, 0.436405793551, 0.372504254596, 0.295774038565,
     0.226951348204, 0.17408067321, 0.136153931001, 0.109083846276]])
_CSF_CB = np.array([
    [1.91113096927, 2.46074210438, 1.18284184739, 1.14982565193,
     1.05017074788, 0.898018824055, 0.74725392039, 0.615105596242],
    [2.46074210438, 1.58529308355, 1.21363250036, 1.38190029285,
     1.33100189972, 1.17428548929, 0.996404342439, 0.830890433625],
    [1.18284184739, 1.21363250036, 0.978712413627, 1.02624506078,
     1.03145147362, 0.960060382087, 0.849823426169, 0.731221236837],
    [1.14982565193, 1.38190029285, 1.02624506078, 0.861317501629,
     0.801821139099, 0.751437590932, 0.685398513368, 0.608694761374],
    [1.05017074788, 1.33100189972, 1.03145147362, 0.801821139099,
     0.676555426187, 0.605503172737, 0.55002013668, 0.495804539034],
    [0.898018824055, 1.17428548929, 0.960060382087, 0.751437590932,
     0.605503172737, 0.514674450957, 0.454353482512, 0.407050308965],
    [0.74725392039, 0.996404342439, 0.849823426169, 0.685398513368,
     0.55002013668, 0.454353482512, 0.389234902883, 0.342353999733],
    [0.615105596242, 0.830890433625, 0.731221236837, 0.608694761374,
     0.495804539034, 0.407050308965, 0.342353999733, 0.295530605237]])
_CSF_CR = np.array([
    [2.03871978502, 2.62502345193, 1.26180942886, 1.11019789803,
     1.01397751469, 0.867069376285, 0.721500455585, 0.593906509971],
    [2.62502345193, 1.69112867013, 1.17180569821, 1.3342742857,
     1.28513006198, 1.13381474809, 0.962064122248, 0.802254508198],
    [1.26180942886, 1.17180569821, 0.944981930573, 0.990876405848,
     0.995903384143, 0.926972725286, 0.820534991409, 0.706020324706],
    [1.11019789803, 1.3342742857, 0.990876405848, 0.831632933426,
     0.77418706195, 0.725539939514, 0.661776842059, 0.587716619023],
    [1.01397751469, 1.28513006198, 0.995903384143, 0.77418706195,
     0.653238524286, 0.584635025748, 0.531064164893, 0.478717061273],
    [0.867069376285, 1.13381474809, 0.926972725286, 0.725539939514,
     0.584635025748, 0.496936637883, 0.438694579826, 0.393021669543],
    [0.721500455585, 0.962064122248, 0.820534991409, 0.661776842059,
     0.531064164893, 0.438694579826, 0.375820256136, 0.330555063063],
    [0.593906509971, 0.802254508198, 0.706020324706, 0.587716619023,
     0.478717061273, 0.393021669543, 0.330555063063, 0.285345396658]])

def _fdct8_1d(s):
    """aom_fdct8x8_c's 1-D stage on (..., 8) int64 (fwd_txfm.c)."""
    # cospi_N_64 = round(16384 * cos(N*pi/64)) (aom_dsp/txfm_common.h)
    c16, c8, c24 = 11585, 15137, 6270
    c28, c4, c12, c20 = 3196, 16069, 13623, 9102

    def rs(v):
        return (v + (1 << 13)) >> 14

    s0 = s[..., 0] + s[..., 7]
    s1 = s[..., 1] + s[..., 6]
    s2 = s[..., 2] + s[..., 5]
    s3 = s[..., 3] + s[..., 4]
    s4 = s[..., 3] - s[..., 4]
    s5 = s[..., 2] - s[..., 5]
    s6 = s[..., 1] - s[..., 6]
    s7 = s[..., 0] - s[..., 7]
    x0 = s0 + s3
    x1 = s1 + s2
    x2 = s1 - s2
    x3 = s0 - s3
    o0 = rs((x0 + x1) * c16)
    o4 = rs((x0 - x1) * c16)
    o2 = rs(x2 * c24 + x3 * c8)
    o6 = rs(-x2 * c8 + x3 * c24)
    t2 = rs((s6 - s5) * c16)
    t3 = rs((s6 + s5) * c16)
    x0 = s4 + t2
    x1 = s4 - t2
    x2 = s7 - t3
    x3 = s7 + t3
    o1 = rs(x0 * c28 + x3 * c4)
    o3 = rs(x2 * c12 + x1 * -c20)
    o5 = rs(x1 * c12 + x2 * c20)
    o7 = rs(x3 * c28 + x0 * -c4)
    return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=-1)


def _od_fdct8x8(blocks):
    """od_bin_fdct8x8 (psnrhvs.c:26): aom_fdct8x8 then (x+4)>>3.

    blocks (B, 8, 8) int64 (row-major, [row, col]). aom_fdct8x8: column
    pass on *4 input, then row pass, then /2 (C truncation toward 0)."""
    b = blocks.astype(np.int64)
    # pass 0: intermediate row i = fdct8 of input column i (*4)
    inter = _fdct8_1d(np.swapaxes(b * 4, -1, -2))
    # pass 1: final row i = fdct8 of INTERMEDIATE column i
    out = _fdct8_1d(np.swapaxes(inter, -1, -2))
    out = np.where(out >= 0, out // 2, -((-out) // 2))  # C /2 truncates
    return (out + 4) >> 3


def _calc_psnrhvs_plane(src, dst, csf, luma: bool, pix_max: int = 255):
    """calc_psnrhvs (psnrhvs.c:114) for one 8-bit plane, vectorized."""
    h, w = src.shape
    s = src.astype(np.float32)
    d = dst.astype(np.float32)
    delt = np.float32(0.0)
    if luma:
        # the reference accumulates float sums in raster order; the order-
        # independent mean is equal within float tolerance
        delt = np.float32((np.float32(s.sum()) - np.float32(d.sum()))
                          / (w * h))
    mask = (csf / csf[1][0]) ** 2

    ys = np.arange(0, h - 7, 7)
    xs = np.arange(0, w - 7, 7)
    if len(ys) == 0 or len(xs) == 0:
        return 0.0
    # (Ny, Nx, 8, 8) block gathers
    yy = ys[:, None, None, None] + np.arange(8)[None, None, :, None]
    xx = xs[None, :, None, None] + np.arange(8)[None, None, None, :]
    bs = src.astype(np.int64)[yy, xx]
    bd_ = dst.astype(np.int64)[yy, xx] + int(np.float32(delt) + 0.5)

    # spatial masking activity on the source block (3/10/3 gradients)
    sf = bs.astype(np.float64)
    i = slice(1, 7)
    gx = (sf[:, :, 0:6, 0:6] * 3 - sf[:, :, 0:6, 2:8] * 3
          + sf[:, :, 1:7, 0:6] * 10 - sf[:, :, 1:7, 2:8] * 10
          + sf[:, :, 2:8, 0:6] * 3 - sf[:, :, 2:8, 2:8] * 3) \
        / (pix_max * np.float64(np.float32(16.0)))
    gy = (sf[:, :, 0:6, 0:6] * 3 - sf[:, :, 2:8, 0:6] * 3
          + sf[:, :, 0:6, 1:7] * 10 - sf[:, :, 2:8, 1:7] * 10
          + sf[:, :, 0:6, 2:8] * 3 - sf[:, :, 2:8, 2:8] * 3) \
        / (pix_max * np.float64(np.float32(16.0)))
    g = np.sqrt(gx * gx + gy * gy)
    n = (g > 0.1).sum((-1, -2))
    s_gmean = g.sum((-1, -2))
    s_gvar = 1.0 / (36 - n + 1) * s_gmean / 36.0

    cs = _od_fdct8x8(bs.reshape(-1, 8, 8)).reshape(bs.shape)
    cd = _od_fdct8x8(bd_.reshape(-1, 8, 8)).reshape(bs.shape)
    m_ac = mask.copy()
    w_sum = (cs.astype(np.float64) ** 2) * mask
    w_sum[:, :, 0, 0] = 0.0
    s_mask = np.sqrt(w_sum.sum((-1, -2)) * s_gvar) / 8.0

    err = np.abs((cs - cd).astype(np.float64))
    thr = s_mask[:, :, None, None] / mask
    red = np.maximum(err - thr, 0.0)
    red = np.where(err < thr, 0.0, red)
    red[:, :, 0, 0] = err[:, :, 0, 0]  # DC not masked
    ret = ((red * csf) ** 2).sum()
    pixels = bs.size
    ret /= pixels
    ret += 0.04 * float(delt) * float(delt)
    return float(ret)


def psnr_hvs(src_planes, dst_planes, bd: int = 8):
    """aom_psnrhvs (aom_dsp/psnrhvs.c:266): returns (total_db, y, u, v)
    scores; total = -10log10(0.8*y_score + 0.1*(u+v))."""
    assert bd == 8
    pix_max = 255
    y = _calc_psnrhvs_plane(src_planes[0], dst_planes[0], _CSF_Y, True)
    u = _calc_psnrhvs_plane(src_planes[1], dst_planes[1], _CSF_CB, False)
    v = _calc_psnrhvs_plane(src_planes[2], dst_planes[2], _CSF_CR, False)
    total = 0.8 * y + 0.1 * (u + v)

    def db(score):
        if score < pix_max * pix_max * 1e-10:
            return 100.0
        return 10 * (np.log10(pix_max * pix_max) - np.log10(score))

    return db(total), db(y), db(u), db(v)
