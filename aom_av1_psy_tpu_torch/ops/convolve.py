"""Inter-prediction convolution kernels — batched, bit-exact.

Replaces the reference's subpel convolve family
(``av1/common/convolve.c``: av1_convolve_2d_sr / x_sr / y_sr / 2d_copy and
the compound dist-wtd variants) with batched array code over ``(B, h, w)``
blocks. The 8/6/4-tap kernels come from the normative filter tables
(``av1/common/filter.h``, extracted in misc_tables.npz).

numpy arrays take the host branch (the reference's numpy code). Torch
tensors take the tensor branch, the counterpart of the reference's jnp
branch (``aom_av1_psy_tpu/ops/convolve.py:51-136``): on CPU tensors the
plain PyTorch version (``*_plain``, the reference's arithmetic in int32 on
any device), on CUDA tensors kernel KL ``subpel_predict``
(``csrc/convolve.cu``), with no fallback between them. KL takes a batch of
(h+7, w+7) regions that each carry their own phases
(``subpel_predict``); ``predict_subpel`` keeps the reference's scalar
phases and broadcasts them. On the card KL takes every w and h in
2..``KL_MAX`` = 128 (``check_kl_block``: AV1's blocks, the 2-wide chroma
blocks of 4:2:0 and sizes that are not powers of two, as the reference
does); a larger block raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.build import CudaKernel, I, P

KL = CudaKernel("convolve", {
    # regions, B, w, h, subpel_x, subpel_y, tabx, taby, bd, out
    "subpel_predict": [P, I, I, I, P, P, P, P, I, P],
})

FILTER_BITS = 7
ROUND0_BITS = 3
COMPOUND_ROUND1_BITS = 7
SUBPEL_BITS = 4
SUBPEL_MASK = 15

EIGHTTAP_REGULAR, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR = 0, 1, 2, 3
KL_MAX = 128      # AV1's largest block side


def check_kl_block(w: int, h: int) -> None:
    """Raise ``ValueError`` unless kernel KL takes (w, h) blocks on the
    card: every w and h in 2..128."""
    if not (2 <= w <= KL_MAX and 2 <= h <= KL_MAX):
        raise ValueError(f"KL: block {w}x{h}: the card takes w and h in "
                         f"2..{KL_MAX} (AV1 has no block above {KL_MAX})")


@functools.cache
def _misc():
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "normative", "data", "misc_tables.npz")
    return np.load(path)


@functools.cache
def filter_kernels(interp: int, block_dim: int) -> np.ndarray:
    """(16, 8) int32 subpel kernels; 4-tap variants for dims <= 4
    (av1_get_interp_filter_params_with_block_size)."""
    m = _misc()
    if block_dim <= 4:
        # av1_interp_4tap: SHARP falls back to the regular 4-tap (filter.h:243)
        name = {EIGHTTAP_REGULAR: "subpel_filters_4",
                EIGHTTAP_SMOOTH: "subpel_filters_4smooth",
                EIGHTTAP_SHARP: "subpel_filters_4",
                BILINEAR: "bilinear_filters"}[interp]
    else:
        name = {EIGHTTAP_REGULAR: "subpel_filters_8",
                EIGHTTAP_SMOOTH: "subpel_filters_8smooth",
                EIGHTTAP_SHARP: "subpel_filters_8sharp",
                BILINEAR: "bilinear_filters"}[interp]
    return m[name].astype(np.int32)


def _xp(x):
    """numpy, the only array type of the host kernels."""
    if isinstance(x, np.ndarray):
        return np
    raise TypeError(f"numpy array expected, got {type(x).__name__}")


def _round2(v, bits):
    if bits == 0:
        return v
    return (v + (1 << (bits - 1))) >> bits


def convolve_2d_sr(src, w: int, h: int, x_kernel, y_kernel, bd: int = 8):
    """av1_convolve_2d_sr_c. src: (..., h+7, w+7) with the (3,3) filter
    origin offset baked in (src[...,3,3] is the top-left output tap center).
    x_kernel/y_kernel: 8-tap int arrays. Returns (..., h, w) pixels."""
    if torch.is_tensor(src):
        if src.device.type == "cpu":
            return _conv_2d_plain(src, w, h, x_kernel, y_kernel, bd)
        return _kl_taps(src, w, h, x_kernel, y_kernel, bd)
    xp = _xp(src)
    x = src.astype(xp.int32)
    round0, round1 = ROUND0_BITS, 2 * FILTER_BITS - ROUND0_BITS
    bits = 2 * FILTER_BITS - round0 - round1  # == 0 for single-ref
    im = xp.zeros(x.shape[:-2] + (h + 7, w), xp.int32)
    off = 1 << (bd + FILTER_BITS - 1)
    for k in range(8):
        t = int(x_kernel[k])
        if t:
            im = im + t * x[..., :, k : k + w]
    im = _round2(im + off, round0)
    offset_bits = bd + 2 * FILTER_BITS - round0
    out = xp.zeros(x.shape[:-2] + (h, w), xp.int32)
    for k in range(8):
        t = int(y_kernel[k])
        if t:
            out = out + t * im[..., k : k + h, :]
    out = _round2(out + (1 << offset_bits), round1)
    out = out - ((1 << (offset_bits - round1))
                 + (1 << (offset_bits - round1 - 1)))
    out = _round2(out, bits)
    return xp.clip(out, 0, (1 << bd) - 1)


def convolve_x_sr(src, w: int, h: int, x_kernel, bd: int = 8):
    """av1_convolve_x_sr_c. src: (..., h, w+7)."""
    if torch.is_tensor(src):
        if src.device.type == "cpu":
            return _conv_x_plain(src, w, h, x_kernel, bd)
        reg = torch.nn.functional.pad(src[..., :h, :w + 7], (0, 0, 3, 4))
        return _kl_taps(reg, w, h, x_kernel, None, bd)
    xp = _xp(src)
    x = src.astype(xp.int32)
    out = xp.zeros(x.shape[:-2] + (h, w), xp.int32)
    for k in range(8):
        t = int(x_kernel[k])
        if t:
            out = out + t * x[..., :h, k : k + w]
    out = _round2(out, ROUND0_BITS)
    out = _round2(out, FILTER_BITS - ROUND0_BITS)
    return xp.clip(out, 0, (1 << bd) - 1)


def convolve_y_sr(src, w: int, h: int, y_kernel, bd: int = 8):
    """av1_convolve_y_sr_c. src: (..., h+7, w)."""
    if torch.is_tensor(src):
        if src.device.type == "cpu":
            return _conv_y_plain(src, w, h, y_kernel, bd)
        reg = torch.nn.functional.pad(src[..., :h + 7, :w], (3, 4))
        return _kl_taps(reg, w, h, None, y_kernel, bd)
    xp = _xp(src)
    x = src.astype(xp.int32)
    out = xp.zeros(x.shape[:-2] + (h, w), xp.int32)
    for k in range(8):
        t = int(y_kernel[k])
        if t:
            out = out + t * x[..., k : k + h, :w]
    out = _round2(out, FILTER_BITS)
    return xp.clip(out, 0, (1 << bd) - 1)


def predict_subpel(ref_padded, w: int, h: int, subpel_x: int, subpel_y: int,
                   interp_x: int = EIGHTTAP_REGULAR,
                   interp_y: int = EIGHTTAP_REGULAR, bd: int = 8):
    """Single-ref subpel motion-compensated prediction dispatch
    (av1_convolve_2d_facade): picks x/y/2d/copy path per subpel phase.

    ref_padded: (..., h+7, w+7) region whose [3,3] origin is the full-pel
    position of the block's top-left pixel. A CPU tensor takes the plain
    version, a CUDA tensor kernel KL (int32 (..., h, w) either way)."""
    if torch.is_tensor(ref_padded):
        if ref_padded.device.type == "cpu":
            return predict_subpel_plain(ref_padded, w, h, subpel_x, subpel_y,
                                        interp_x, interp_y, bd)
        for v in (subpel_x, subpel_y):
            if not 0 <= v <= SUBPEL_MASK:
                raise ValueError(f"KL: subpel phase {v} outside 0..15")
        check_kl_block(w, h)
        lead = ref_padded.shape[:-2]
        reg = ref_padded[..., :h + 7, :w + 7].reshape(-1, h + 7, w + 7)
        B = reg.shape[0]
        ph = torch.tensor([[subpel_x], [subpel_y]], dtype=torch.int32,
                          device=reg.device).expand(2, B)
        out = subpel_predict(reg, w, h, ph[0], ph[1], interp_x, interp_y, bd)
        return out.reshape(*lead, h, w)
    xp = _xp(ref_padded)
    kx = filter_kernels(interp_x, w)[subpel_x & SUBPEL_MASK]
    ky = filter_kernels(interp_y, h)[subpel_y & SUBPEL_MASK]
    if subpel_x and subpel_y:
        return convolve_2d_sr(ref_padded, w, h, kx, ky, bd)
    if subpel_x:
        return convolve_x_sr(ref_padded[..., 3 : 3 + h, :], w, h, kx, bd)
    if subpel_y:
        return convolve_y_sr(ref_padded[..., :, 3 : 3 + w], w, h, ky, bd)
    return ref_padded[..., 3 : 3 + h, 3 : 3 + w].astype(xp.int32)


# ----------------------------------------------------------------------
# The tensor branch: plain PyTorch versions and kernel KL
# ----------------------------------------------------------------------

def _conv_2d_plain(src, w, h, x_kernel, y_kernel, bd):
    x = src.to(torch.int32)
    round0, round1 = ROUND0_BITS, 2 * FILTER_BITS - ROUND0_BITS
    im = torch.zeros(x.shape[:-2] + (h + 7, w), dtype=torch.int32,
                     device=x.device)
    for k in range(8):
        t = int(x_kernel[k])
        if t:
            im = im + t * x[..., :, k:k + w]
    im = _round2(im + (1 << (bd + FILTER_BITS - 1)), round0)
    offset_bits = bd + 2 * FILTER_BITS - round0
    out = torch.zeros(x.shape[:-2] + (h, w), dtype=torch.int32,
                      device=x.device)
    for k in range(8):
        t = int(y_kernel[k])
        if t:
            out = out + t * im[..., k:k + h, :]
    out = _round2(out + (1 << offset_bits), round1)
    out = out - ((1 << (offset_bits - round1))
                 + (1 << (offset_bits - round1 - 1)))
    return out.clamp(0, (1 << bd) - 1)


def _conv_x_plain(src, w, h, x_kernel, bd):
    x = src.to(torch.int32)
    out = torch.zeros(x.shape[:-2] + (h, w), dtype=torch.int32,
                      device=x.device)
    for k in range(8):
        t = int(x_kernel[k])
        if t:
            out = out + t * x[..., :h, k:k + w]
    out = _round2(_round2(out, ROUND0_BITS), FILTER_BITS - ROUND0_BITS)
    return out.clamp(0, (1 << bd) - 1)


def _conv_y_plain(src, w, h, y_kernel, bd):
    x = src.to(torch.int32)
    out = torch.zeros(x.shape[:-2] + (h, w), dtype=torch.int32,
                      device=x.device)
    for k in range(8):
        t = int(y_kernel[k])
        if t:
            out = out + t * x[..., k:k + h, :w]
    return _round2(out, FILTER_BITS).clamp(0, (1 << bd) - 1)


def predict_subpel_plain(ref_padded, w: int, h: int, subpel_x: int,
                         subpel_y: int, interp_x: int = EIGHTTAP_REGULAR,
                         interp_y: int = EIGHTTAP_REGULAR, bd: int = 8):
    """Plain version of ``predict_subpel`` on a tensor, whatever its device:
    the reference's dispatch and arithmetic (int32)."""
    kx = filter_kernels(interp_x, w)[subpel_x & SUBPEL_MASK]
    ky = filter_kernels(interp_y, h)[subpel_y & SUBPEL_MASK]
    if subpel_x and subpel_y:
        return _conv_2d_plain(ref_padded, w, h, kx, ky, bd)
    if subpel_x:
        return _conv_x_plain(ref_padded[..., 3:3 + h, :], w, h, kx, bd)
    if subpel_y:
        return _conv_y_plain(ref_padded[..., :, 3:3 + w], w, h, ky, bd)
    return ref_padded[..., 3:3 + h, 3:3 + w].to(torch.int32)


def subpel_predict_plain(regions, w: int, h: int, subpel_x, subpel_y,
                         interp_x: int = EIGHTTAP_REGULAR,
                         interp_y: int = EIGHTTAP_REGULAR, bd: int = 8):
    """Plain version of KL: regions (B, h+7, w+7), per-item phases
    subpel_x / subpel_y (B,) in 0..15; each item predicted as
    ``predict_subpel_plain`` predicts it (the items of one phase pair
    together). Returns (B, h, w) int32."""
    B = regions.shape[0]
    out = torch.empty((B, h, w), dtype=torch.int32, device=regions.device)
    pair = (subpel_x.to(torch.int64) * 16 + subpel_y.to(torch.int64)).cpu()
    for key in torch.unique(pair).tolist():
        idx = torch.nonzero(pair == key)[:, 0].to(regions.device)
        out[idx] = predict_subpel_plain(regions[idx], w, h, key // 16,
                                        key % 16, interp_x, interp_y, bd)
    return out


@functools.cache
def _tap_table(interp: int, dim: int, device: str):
    """``filter_kernels(interp, dim)`` as a contiguous (16, 8) int32 tensor
    on ``device`` (kept for the process's life: 512 bytes each)."""
    return torch.as_tensor(filter_kernels(interp, dim), device=device)


def subpel_predict(regions, w: int, h: int, subpel_x, subpel_y,
                   interp_x: int = EIGHTTAP_REGULAR,
                   interp_y: int = EIGHTTAP_REGULAR, bd: int = 8):
    """Per-item subpel prediction, ``subpel_predict_plain``'s result. CPU
    tensors: the plain version; CUDA tensors: kernel KL, one launch for
    the batch (int32 regions (B, h+7, w+7), w and h in 2..128, phases (B,)
    int32 in 0..15 on the same card)."""
    if regions.device.type == "cpu":
        return subpel_predict_plain(regions, w, h, subpel_x, subpel_y,
                                    interp_x, interp_y, bd)
    dev = str(regions.device)
    return _launch_kl(regions, w, h, subpel_x, subpel_y,
                      _tap_table(interp_x, w, dev),
                      _tap_table(interp_y, h, dev), bd)


def _kl_taps(src, w, h, x_kernel, y_kernel, bd):
    """KL with the caller's own 8-tap kernels (``convolve_*_sr`` on a CUDA
    tensor): each kernel given becomes phase 1 of a one-row table, so the
    path is 2-D with both, x only with ``x_kernel`` alone, y only with
    ``y_kernel`` alone. src (..., h+7, w+7) -> (..., h, w)."""
    lead = src.shape[:-2]
    reg = src[..., :h + 7, :w + 7].reshape(-1, h + 7, w + 7)
    B = reg.shape[0]
    tabs, ph = [], []
    for k in (x_kernel, y_kernel):
        tab = np.zeros((16, 8), np.int32)
        if k is not None:
            tab[1] = np.asarray(k, np.int32)
        tabs.append(torch.as_tensor(tab, device=src.device))
        ph.append(int(k is not None))
    phases = torch.tensor([[ph[0]], [ph[1]]], dtype=torch.int32,
                          device=src.device).expand(2, B)
    out = _launch_kl(reg.to(torch.int32), w, h, phases[0], phases[1],
                     tabs[0], tabs[1], bd)
    return out.reshape(*lead, h, w)


def _launch_kl(regions, w, h, subpel_x, subpel_y, tabx, taby, bd):
    B = regions.shape[0]
    check_kl_block(w, h)
    if tuple(regions.shape) != (B, h + 7, w + 7):
        raise ValueError(f"KL: regions {tuple(regions.shape)}, want "
                         f"{(B, h + 7, w + 7)}")
    for t in (regions, subpel_x, subpel_y):
        if t.device != regions.device or t.dtype != torch.int32:
            raise ValueError(f"KL input: want int32 on {regions.device}, got "
                             f"{t.dtype} on {t.device}")
    if subpel_x.shape != (B,) or subpel_y.shape != (B,):
        raise ValueError(f"KL: phases {tuple(subpel_x.shape)} / "
                         f"{tuple(subpel_y.shape)}, want ({B},)")
    regions = regions.contiguous()
    sx, sy = subpel_x.contiguous(), subpel_y.contiguous()
    out = torch.empty((B, h, w), dtype=torch.int32, device=regions.device)
    KL.launch("subpel_predict", regions.data_ptr(), B, w, h, sx.data_ptr(),
              sy.data_ptr(), tabx.data_ptr(), taby.data_ptr(), bd,
              out.data_ptr(), device=regions.get_device(),
              variant=f"{w}x{h}")
    return out


# ----------------------------------------------------------------------
# scaled-reference convolve (av1/common/convolve.c:371
# av1_convolve_2d_scale_c), single-ref path — the kernel behind inter
# prediction from a reference of a different size (resize / superres GOPs).
# ----------------------------------------------------------------------
SCALE_SUBPEL_BITS = 10                    # aom_dsp/aom_filter.h:28
SCALE_SUBPEL_MASK = (1 << SCALE_SUBPEL_BITS) - 1
SCALE_EXTRA_BITS = SCALE_SUBPEL_BITS - 4  # qn -> 1/16-pel filter index


def convolve_2d_scale(src, oy: int, ox: int, w: int, h: int,
                      x_filters: np.ndarray, y_filters: np.ndarray,
                      subpel_x_qn: int, x_step_qn: int,
                      subpel_y_qn: int, y_step_qn: int, bd: int = 8):
    """Scaled convolve, vectorized: each output column/row selects its own
    integer source position and 1/16-pel kernel from the 1/1024-unit
    position walk (x_qn += x_step_qn). src is the full padded reference
    plane; (oy, ox) is the position of the block's first integer sample.
    x_filters/y_filters: (16, taps) int32. Returns (h, w) uint8.
    """
    # 8-bit only: the round_0/round_1 split below is the bd==8 derivation
    # (get_conv_params adjusts rounds for bd>8 and the return dtype would
    # truncate) — matching the rest of the 8-bit-only ops surface
    assert bd == 8, "convolve_2d_scale implements the 8-bit rounding split"
    src = np.asarray(src, np.int32)
    taps_x, taps_y = x_filters.shape[1], y_filters.shape[1]
    fo_h, fo_v = taps_x // 2 - 1, taps_y // 2 - 1
    round0 = ROUND0_BITS
    round1 = 2 * FILTER_BITS - ROUND0_BITS
    bits = 2 * FILTER_BITS - round0 - round1
    im_h = (((h - 1) * y_step_qn + subpel_y_qn) >> SCALE_SUBPEL_BITS) + taps_y

    # horizontal pass over the im_h source rows
    x_qn = subpel_x_qn + np.arange(w, dtype=np.int64) * x_step_qn
    bx = (x_qn >> SCALE_SUBPEL_BITS).astype(np.int64)
    fx = ((x_qn & SCALE_SUBPEL_MASK) >> SCALE_EXTRA_BITS).astype(np.int64)
    cols = ox + bx[:, None] + np.arange(taps_x)[None, :] - fo_h   # (w, t)
    rows = oy - fo_v + np.arange(im_h)
    slab = src[rows[:, None, None], cols[None]]                   # (im_h,w,t)
    xf = x_filters[fx]                                            # (w, t)
    off = 1 << (bd + FILTER_BITS - 1)
    im = _round2(off + (slab * xf[None]).sum(-1), round0)         # (im_h, w)

    # vertical pass: per-output-row base row and kernel
    y_qn = subpel_y_qn + np.arange(h, dtype=np.int64) * y_step_qn
    by = (y_qn >> SCALE_SUBPEL_BITS).astype(np.int64)
    fy = ((y_qn & SCALE_SUBPEL_MASK) >> SCALE_EXTRA_BITS).astype(np.int64)
    ry = by[:, None] + np.arange(taps_y)[None, :]                 # (h, t)
    slab2 = im[ry]                                                # (h, t, w)
    yf = y_filters[fy]                                            # (h, t)
    offset_bits = bd + 2 * FILTER_BITS - round0
    res = _round2((1 << offset_bits) + (slab2 * yf[:, :, None]).sum(1),
                  round1)
    res = res - ((1 << (offset_bits - round1))
                 + (1 << (offset_bits - round1 - 1)))
    return np.clip(_round2(res, bits), 0, (1 << bd) - 1).astype(np.uint8)
