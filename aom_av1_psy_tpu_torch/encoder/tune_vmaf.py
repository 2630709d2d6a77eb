"""VMAF-style perceptual tuning on the port — torch counterpart of
``aom_av1_psy_tpu/encoder/tune_vmaf.py`` (the analogue of
``av1/encoder/tune_vmaf.c``).

``frame_preprocessing`` unsharp-masks the source luma with the reference's
Gaussian kernel and unsharp arithmetic, by an amount that servos the
frame's high-frequency energy ratio toward a target (the reference's module
docstring says why the libvmaf amount search is not reproduced). ``vif_lite``
is the multi-scale VIF that ``tools/quality.py`` reports; ``motion_score`` /
``vmaf_motion_dq`` are the motion-score q model.

Kernels (``csrc/tune_vmaf.cu``), each with its plain PyTorch version here;
a CPU tensor takes the plain version, a CUDA tensor the kernel:
- KG ``gauss_blur``: the 8-tap blur, exact integers, optionally with the
  int64 sums that ``hf`` needs; a CTA per band of ``KG_BAND`` columns, a
  warp per strip of ``KG_ROWS`` rows of it, each strip blurred from its own
  edge-replicated halo;
- KH ``unsharp_apply``: ``clip(floor(fl32(s + fl32(a * (s - b))) + 0.5))``;
- KI ``vif_scale`` (one VIF scale's two log2 sums, the box sums separable
  and unscaled in float64) and ``vif_down2``.

Parity with the reference. The blur and the sharpened plane are exact.
``hf`` is the reference's float32 ratio of two ``jnp.var``, whose reduction
order cannot be reproduced; here it is exact, from the int64 sums
(s, s^2, d, d^2 with d = s - blur), the amount is formed in double as the
reference forms it, and ``_unsharp`` rounds it to float32 once, as JAX's
weak typing does; the amounts agree within 1e-5 and the sharpened planes
are equal on the tested frames. ``vif_lite``'s box means are summed in float64
and rounded to float32 once (within an ulp of the reference's float32
convolution); the rest is float32, with torch's or CUDA's ``log2``: it is
held to a relative tolerance of 1e-4; it reports a number and decides
nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as TF

from ..device import resolve_device
from ..kernels.build import CudaKernel, I, P
from ..ops import convolve as CONV
from ..utils.frame import Frame

# tune_vmaf.c:248 — the frame preprocessing blur (sum 128, applied with the
# standard convolve rounding)
GAUSS_KERNEL = (0, 8, 30, 52, 30, 8, 0, 0)
HF_TARGET = 0.03       # Gaussian-residual energy ratio of "sharp enough"
MAX_AMOUNT = 0.3       # the reference search's practical ceiling
VIF_WIN = 9
# KG's partition (csrc/tune_vmaf.cu kBand, kRows): a CTA's band of columns
# and a warp's strip of rows in it
KG_BAND = 128
KG_ROWS = 8

TV = CudaKernel("tune_vmaf", {
    # src, src_u8, H, W, out, moments (or null)
    "gauss_blur": [P, I, I, I, P, P],
    # src, blur, amount, n, out
    "unsharp_apply": [P, P, ctypes.c_float, ctypes.c_longlong, P],
    # ref, dist, H, W, sums (num, den)
    "vif_scale": [P, P, I, I, P],
    # x, H, W, out
    "vif_down2": [P, I, I, P],
})


def _require(t, dtypes, shape=None):
    if t.device.type != "cuda" or t.dtype not in dtypes or t.dim() != 2 \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"tune_vmaf kernel input: want {dtypes} 2-D "
                         f"{shape or ''} on cuda, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


# ---- KG: the Gaussian blur ----------------------------------------------

def _pad_for_conv(y):
    """Edge-replicate (3, 4) rows and columns: the 8-tap kernel's phase
    centre sits at tap 3."""
    H, W = y.shape
    r = torch.arange(-3, H + 4, device=y.device).clamp(0, H - 1)
    c = torch.arange(-3, W + 4, device=y.device).clamp(0, W - 1)
    return y[r][:, c]


def gaussian_blur_plain(y):
    """Plain version of KG: (H, W) integer pixels -> int32 blur, av1
    convolve rounding (FILTER_BITS = 7, round0 = 3, round1 = 11, bd 8)."""
    H, W = y.shape
    x = _pad_for_conv(y.to(torch.int32))
    round0 = CONV.ROUND0_BITS
    round1 = 2 * CONV.FILTER_BITS - round0
    off = 1 << (8 + CONV.FILTER_BITS - 1)
    im = torch.zeros((H + 7, W), dtype=torch.int32, device=y.device)
    for t, k in enumerate(GAUSS_KERNEL):
        im = im + k * x[:, t:t + W]
    im = (im + off + (1 << (round0 - 1))) >> round0
    offset_bits = 8 + 2 * CONV.FILTER_BITS - round0
    out = torch.zeros((H, W), dtype=torch.int32, device=y.device)
    for t, k in enumerate(GAUSS_KERNEL):
        out = out + k * im[t:t + H, :]
    out = (out + (1 << offset_bits) + (1 << (round1 - 1))) >> round1
    out = out - ((1 << (offset_bits - round1))
                 + (1 << (offset_bits - round1 - 1)))
    return out.clamp(0, 255)


def blur_moments_plain(y, blur):
    """(4,) int64: sum s, sum s^2, sum d, sum d^2 with d = s - blur."""
    s = y.to(torch.int64)
    d = s - blur.to(torch.int64)
    return torch.stack([s.sum(), (s * s).sum(), d.sum(), (d * d).sum()])


def gaussian_blur(y, moments: bool = False):
    """The blur of ``y`` ((H, W) uint8 or int32 pixels in [0, 255]) as int32;
    with ``moments``, also :func:`blur_moments_plain`'s four int64 sums.
    CPU tensors: the plain version; CUDA tensors: kernel KG."""
    if y.device.type == "cpu":
        out = gaussian_blur_plain(y)
        return (out, blur_moments_plain(y, out)) if moments else out
    y = _require(y, (torch.uint8, torch.int32))
    H, W = y.shape
    out = torch.empty((H, W), dtype=torch.int32, device=y.device)
    mom = torch.zeros(4, dtype=torch.int64, device=y.device) \
        if moments else None
    TV.launch("gauss_blur", y.data_ptr(), int(y.dtype == torch.uint8), H, W,
              out.data_ptr(), mom.data_ptr() if moments else None,
              variant="gauss_blur moments" if moments else "gauss_blur")
    return (out, mom) if moments else out


# ---- KH: the unsharp mask -----------------------------------------------

def unsharp_plain(src, blur, amount: float):
    """Plain version of KH (``_unsharp``, tune_vmaf.c unsharp_rect): in
    float32, ``a * (s - b)`` and ``s + that`` rounded separately (the
    reference runs one op at a time), then floor(v + 0.5), clip, uint8."""
    a = torch.tensor(amount, dtype=torch.float32, device=src.device)
    d = (src.to(torch.int32) - blur).to(torch.float32)
    val = src.to(torch.float32) + a * d
    return torch.floor(val + 0.5).clamp(0, 255).to(torch.uint8)


def unsharp(src, blur, amount: float):
    """``unsharp_plain``'s result; ``src`` uint8, ``blur`` int32, both
    (H, W). CPU tensors: the plain version; CUDA tensors: kernel KH."""
    if src.device.type == "cpu":
        return unsharp_plain(src, blur, amount)
    src = _require(src, (torch.uint8,))
    blur = _require(blur, (torch.int32,), src.shape)
    out = torch.empty_like(src)
    TV.launch("unsharp_apply", src.data_ptr(), blur.data_ptr(), amount,
              src.numel(), out.data_ptr(), variant="unsharp_apply")
    return out


def frame_preprocessing(y_plane, device="cuda", max_amount: float = MAX_AMOUNT,
                        hf_target: float = HF_TARGET):
    """av1_vmaf_frame_preprocessing analogue: unsharp the 8-bit source luma.

    amount = max_amount * clip(1 - hf / hf_target, 0, 1) with hf =
    var(src - gaussian_blur(src)) / max(var(src), 1), computed exactly from
    the blur's int64 sums. Returns (amount, sharpened uint8 numpy plane),
    the source itself when the amount is 0. ``device`` is where the blur
    and the unsharp run (the card unless the caller asks for the CPU)."""
    src = torch.as_tensor(np.ascontiguousarray(y_plane, np.uint8),
                          device=resolve_device(device))
    blurred, mom = gaussian_blur(src, moments=True)
    ss, ss2, sd, sd2 = (int(v) for v in mom.cpu().tolist())
    n = src.numel()
    # n^2 var(.) as exact integers; max(var(src), 1) -> max(., n^2)
    vs, vd = n * ss2 - ss * ss, n * sd2 - sd * sd
    hf = vd / max(vs, n * n)
    amount = max_amount * min(max(1.0 - hf / hf_target, 0.0), 1.0)
    if amount <= 0.0:
        return 0.0, np.asarray(y_plane, np.uint8)
    sharp = unsharp(src, blurred, amount)
    return float(amount), sharp.cpu().numpy()


def preprocess_frame(frame: Frame, device="cuda"):
    """The encoders' tune_vmaf step: (amount, the frame with its luma
    replaced by :func:`frame_preprocessing`'s)."""
    amount, sharp_y = frame_preprocessing(frame.planes()[0], device)
    if frame.monochrome:
        return amount, Frame(sharp_y, None, None)
    return amount, Frame(sharp_y, frame.planes()[1], frame.planes()[2])


def motion_score(cur_y, last_y, device="cuda") -> float:
    """Blurred-frame mean absolute difference (the role of
    calc_vmaf_motion_score's blurred motion-search error), the mean taken
    exactly over the integer differences; the blurs run on ``device``."""
    dev = resolve_device(device)
    b0 = gaussian_blur(torch.as_tensor(np.asarray(cur_y, np.int32),
                                       device=dev))
    b1 = gaussian_blur(torch.as_tensor(np.asarray(last_y, np.int32),
                                       device=dev))
    return int((b0 - b1).abs().sum(dtype=torch.int64)) / b0.numel()


def vmaf_motion_dq(motion: float, qindex: int, last_ysse: float,
                   last_dvmaf: float, num_pels: int) -> int:
    """av1_get_vmaf_base_qindex's fitted model (tune_vmaf.c:896): when
    motion is high the same SSE hurts VMAF less, so q can rise.
    Returns the adjusted qindex."""
    sse_threshold = 0.01 * num_pels
    if last_ysse < sse_threshold or last_dvmaf < 0.01:
        return qindex
    dvmaf = 26.11 * (1.0 - np.exp(-0.06 * motion))
    dsse = dvmaf * last_ysse / last_dvmaf
    beta = last_ysse / (dsse + last_ysse)
    # the reference maps beta to a delta-q via the qstep ratio
    from ..normative import tables
    qstep = tables.ac_quant(max(qindex, 1))
    want = qstep / max(beta, 1e-6) ** 0.5
    lo, hi = 1, 255
    while lo < hi:
        mid = (lo + hi) // 2
        if tables.ac_quant(mid) < want:
            lo = mid + 1
        else:
            hi = mid
    return int(np.clip(lo, 1, 255))


# ---- KI: the VIF pyramid ------------------------------------------------

def _conv64(x, k, **kw):
    """2-D convolution of a float32 plane with float32 taps, summed in
    float64 and rounded to float32 once (float64 takes no TF32 path)."""
    return TF.conv2d(x.to(torch.float64)[None, None],
                     k.to(torch.float64)[None, None],
                     **kw)[0, 0].to(torch.float32)


def _box(x):
    """The 9x9 VALID box mean of float32 ``x``: the taps ``x * f32(1/81)``
    summed in float64, within an ulp of any float32 order of the
    reference's convolution."""
    return _conv64(x, torch.full((VIF_WIN, VIF_WIN), 1.0 / 81.0,
                                 dtype=torch.float32, device=x.device))


def _moments(x):
    """Box-window mean / variance maps (VALID)."""
    mu = _box(x)
    musq = _box(x * x)
    return mu, torch.clamp(musq - mu * mu, min=0.0)


def vif_scale_plain(ref, dist):
    """Plain version of KI: one VIF scale's (num, den) float32 sums,
    sigma_n^2 = 2 (libvmaf convention); 0 for a plane smaller than the
    window (an empty VALID map)."""
    if min(ref.shape) < VIF_WIN:
        return torch.zeros(2, dtype=torch.float32, device=ref.device)
    sigma_n = 2.0
    mu_r, var_r = _moments(ref)
    mu_d, var_d = _moments(dist)
    cov = _box(ref * dist) - mu_r * mu_d
    g = cov / (var_r + 1e-10)
    sv = torch.clamp(var_d - g * cov, min=0.0)
    num = torch.log2(1.0 + g * g * var_r / (sv + sigma_n)).sum()
    den = torch.log2(1.0 + var_r / sigma_n).sum()
    return torch.stack([num, den])


def vif_scale_sums(ref, dist):
    """(2,) float32 (num, den) of one scale; ref, dist (H, W) float32.
    CPU tensors: the plain version; CUDA tensors: kernel KI."""
    if ref.device.type == "cpu":
        return vif_scale_plain(ref, dist)
    ref = _require(ref, (torch.float32,))
    dist = _require(dist, (torch.float32,), ref.shape)
    H, W = ref.shape
    sums = torch.zeros(2, dtype=torch.float32, device=ref.device)
    TV.launch("vif_scale", ref.data_ptr(), dist.data_ptr(), H, W,
              sums.data_ptr(), variant="vif_scale")
    return sums


def down2_plain(x):
    """Plain version of KI's ``vif_down2``: the 3x3 [1 2 1]^2 / 16 SAME
    blur (zero padding), then ``[::2, ::2]``."""
    k = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=torch.float32,
                     device=x.device) / 16.0
    return _conv64(x, k, padding=1)[::2, ::2]


def down2(x):
    """The next VIF scale of ``x`` ((H, W) float32). CPU tensors: the
    plain version; CUDA tensors: KI's ``vif_down2`` entry."""
    if x.device.type == "cpu":
        return down2_plain(x)
    x = _require(x, (torch.float32,))
    H, W = x.shape
    out = torch.empty(((H + 1) // 2, (W + 1) // 2), dtype=torch.float32,
                      device=x.device)
    TV.launch("vif_down2", x.data_ptr(), H, W, out.data_ptr(),
              variant="vif_down2")
    return out


def vif_lite(ref, dist, scales: int = 4, device="cuda") -> float:
    """Multi-scale VIF of two planes (numpy arrays, put on ``device``, or
    tensors, used where they are): 1.0 at identity, decreasing toward 0
    with information loss. A fidelity reporting metric."""
    if not (torch.is_tensor(ref) and torch.is_tensor(dist)):
        device = resolve_device(device)
    r, d = (x.to(torch.float32) if torch.is_tensor(x) else
            torch.as_tensor(np.asarray(x, np.float32), device=device)
            for x in (ref, dist))
    total = 0.0
    for s in range(scales):
        num, den = vif_scale_sums(r, d).tolist()
        total += float(np.float32(num) / np.float32(max(den, 1e-10)))
        if s != scales - 1:
            r, d = down2(r), down2(d)
    return total / scales
