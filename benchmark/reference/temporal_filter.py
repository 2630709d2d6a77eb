"""libaom's temporal filter (``av1/encoder/temporal_filter.c``) in plain
PyTorch, over whole frames: the simplified driver the encoder runs (32 x 32
blocks, a dense full-pel search of radius 16 on luma against a window that
reads 128 outside the frame, the first minimum in row-major offset order,
the prediction read at the block's clamped position, per-quadrant MSEs)
and the weighting of ``av1_apply_temporal_filter_c`` (:905): the 5 x 5
windowed squared error with the window clamped to the block, the co-located
luma error added to chroma, the q, strength, noise and distance decays, the
weight ``int(exp(-scaled) * 1000)``, int64 accumulation and the rounded
division.

``dtype`` is the precision of the weighting (float64 as the encoder has
it; float32 is the control's). Nothing here imports the program: the
quantizer step comes from the frozen decoder's tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .av1.normative import tables

WINDOW = 5
WEIGHT_SCALE = 1000
BLOCK_BALANCE = 5
Q_DECAY_THRESHOLD = 20
ERROR_NORM_WEIGHT = 20
STRENGTH_THRESHOLD = 4
DISTANCE_THRESHOLD = 0.1
QINDEX_CUTOFF = 128
RADIUS = 16
MB = 32


def noise_level(plane: np.ndarray) -> float:
    """av1_estimate_noise_from_single_plane (temporal_filter.c:1150) at 8
    bits: mean |Laplacian| over Sobel-smooth pixels times sqrt(pi/2)/6;
    -1.0 where fewer than 16 pixels are smooth."""
    m = plane.astype(np.int64)
    c = m[1:-1, 1:-1]
    tl, t, tr = m[:-2, :-2], m[:-2, 1:-1], m[:-2, 2:]
    l, r = m[1:-1, :-2], m[1:-1, 2:]
    bl, b, br = m[2:, :-2], m[2:, 1:-1], m[2:, 2:]
    gx = (tl - tr) + (bl - br) + 2 * (l - r)
    gy = (tl - bl) + (tr - br) + 2 * (t - b)
    smooth = (np.abs(gx) + np.abs(gy)) < 50
    lap = np.abs(4 * c - 2 * (t + b + l + r) + (tl + tr + bl + br))
    cnt = int(smooth.sum())
    if cnt < 16:
        return -1.0
    return float(lap[smooth].sum()) / (6 * cnt) * 1.25331413732


def q_factor(qindex: int) -> int:
    """The filter's quantizer step: ac_quant / 4 at ``qindex``."""
    return max(1, tables.ac_quant(max(qindex, 1)) // 4)


def _decays(noise, qf: int, strength: int) -> list:
    q_decay = min(max((qf / Q_DECAY_THRESHOLD) ** 2, 1e-5), 1.0)
    if qf >= QINDEX_CUTOFF:
        q_decay = 0.5 * (qf / 64) ** 2
    s_decay = min(max((strength / STRENGTH_THRESHOLD) ** 2, 1e-5), 1.0)
    return [1.0 / ((0.5 + np.log(2 * n + 5.0)) * q_decay * s_decay)
            for n in noise]


def _block_grid(H: int, W: int):
    """Rows and columns of the 32 x 32 blocks: (origins, sizes) per axis."""
    ys = list(range(0, H, MB))
    xs = list(range(0, W, MB))
    return ys, [min(MB, H - y) for y in ys], xs, [min(MB, W - x) for x in xs]


def _search(src, ref):
    """Per-block full-pel motion of ``ref`` against ``src`` (int64 (H, W)
    luma): (dy, dx) int64 (nby, nbx), the first minimum of the SAD over
    the 33 x 33 offsets in row-major order, 128 read outside the frame."""
    H, W = src.shape
    n = 2 * RADIUS + 1
    Hp, Wp = -(-H // MB) * MB, -(-W // MB) * MB
    pad = torch.nn.functional.pad(ref.to(torch.int32)[None, None],
                                  (RADIUS, RADIUS, RADIUS, RADIUS),
                                  value=128)[0, 0]
    s32 = src.to(torch.int32)
    sads = torch.empty((n * n, Hp // MB, Wp // MB), dtype=torch.int64,
                       device=src.device)
    for dy in range(n):
        for dx in range(n):
            d = (pad[dy:dy + H, dx:dx + W] - s32).abs_()
            d = torch.nn.functional.pad(d, (0, Wp - W, 0, Hp - H))
            sads[dy * n + dx] = d.view(Hp // MB, MB, Wp // MB, MB) \
                .sum((1, 3), dtype=torch.int64)
    best = sads.argmin(0)
    return best // n - RADIUS, best % n - RADIUS


def _apply_blocks(ref, pred, sub_mse, d_factor, decay, weight_factor,
                  inv_factor, num_ref, luma_sse, dtype):
    """The weighting of one plane over a batch of equal blocks: ref and
    pred (B, h, w) int64; sub_mse (B, 4) int64; d_factor (B,) float64;
    luma_sse (B, h, w) float64 or None. Every float step runs in ``dtype``
    (the squared-error sums are exact in either). Returns (weight,
    weight * pred)."""
    B, h, w = ref.shape
    sq = ((ref - pred) ** 2).to(dtype)
    half = WINDOW >> 1
    p = torch.nn.functional.pad(sq[:, None], (half, half, half, half),
                                mode="replicate")[:, 0]
    win = torch.zeros_like(sq)
    for wi in range(WINDOW):
        for wj in range(WINDOW):
            win += p[:, wi:wi + h, wj:wj + w]
    total = win + luma_sse.to(dtype) if luma_sse is not None else win
    window_error = total / num_ref
    iy = (torch.arange(h, device=ref.device)[:, None] >= h // 2) * 2
    jx = (torch.arange(w, device=ref.device)[None, :] >= w // 2) * 1
    sub = (iy + jx).expand(B, h, w)
    block_error = torch.gather(sub_mse.to(dtype), 1,
                               sub.reshape(B, -1)).reshape(B, h, w)
    combined = torch.tensor(weight_factor, dtype=dtype) * window_error \
        + block_error * torch.tensor(inv_factor, dtype=dtype)
    scaled = combined * d_factor.to(dtype)[:, None, None] \
        * torch.tensor(decay, dtype=dtype)
    scaled = torch.minimum(scaled, torch.tensor(7.0, dtype=dtype,
                                                device=ref.device))
    weight = (torch.exp(-scaled) * WEIGHT_SCALE).to(torch.int64)
    return weight, weight * pred


def _row(plane, y0: int, h: int, x0: int, n: int, w: int):
    """n consecutive (h, w) blocks of ``plane`` from (y0, x0): (n, h, w)."""
    return plane[y0:y0 + h, x0:x0 + n * w].reshape(h, n, w).permute(1, 0, 2)


def filter_frames(frames, center: int, qf: int, strength: int, noise,
                  device, dtype=torch.float64):
    """Filter ``frames[center]`` (each frame three uint8 numpy planes,
    4:2:0) against the others: the filtered (y, u, v) uint8 numpy
    planes."""
    planes = [[torch.as_tensor(np.ascontiguousarray(p), device=device)
               .to(torch.int64) for p in f] for f in frames]
    cen = planes[center]
    H, W = cen[0].shape
    ys, hs, xs, ws = _block_grid(H, W)
    inv_factor = 1.0 / ((BLOCK_BALANCE + 1) * ERROR_NORM_WEIGHT)
    weight_factor = BLOCK_BALANCE * inv_factor
    decay = _decays(noise, qf, strength)
    dt = max(min(W, H) * DISTANCE_THRESHOLD, 1)
    accum = [torch.zeros_like(p) for p in cen]
    count = [torch.zeros_like(p) for p in cen]
    for fi, fr in enumerate(planes):
        if fi == center:
            dy = dx = torch.zeros((len(ys), len(xs)), dtype=torch.int64,
                                  device=device)
        else:
            dy, dx = _search(cen[0], fr[0])
        dist = torch.tensor(np.hypot(8 * dy.cpu().numpy(),
                                     8 * dx.cpu().numpy()).astype(np.float64),
                            device=device)
        d_factor = torch.clamp(dist / dt, min=1.0)
        for bi, (y0, h) in enumerate(zip(ys, hs)):
            # the blocks of a row: a run of full-width ones, then a
            # narrower last one where MB does not divide W
            runs = [(0, len(xs) - 1 if ws[-1] != MB else len(xs), MB)]
            if ws[-1] != MB:
                runs.append((len(xs) - 1, 1, ws[-1]))
            for j0, n, w in runs:
                if n == 0:
                    continue
                x0 = xs[j0]
                sel = slice(j0, j0 + n)
                xo = torch.arange(n, device=device) * w + x0
                preds, refs = [], []
                for pl in range(3):
                    s = 1 if pl else 0
                    ph, pw = h >> s, w >> s
                    Hp, Wp = fr[pl].shape
                    py = torch.clamp((y0 + dy[bi, sel]) >> s, 0, Hp - ph)
                    px = torch.clamp((xo + dx[bi, sel]) >> s, 0, Wp - pw)
                    rr = py[:, None, None] + torch.arange(
                        ph, device=device)[None, :, None]
                    cc = px[:, None, None] + torch.arange(
                        pw, device=device)[None, None, :]
                    preds.append(fr[pl][rr, cc])
                    refs.append(_row(cen[pl], y0 >> s, ph, x0 >> s, n, pw))
                if fi == center:
                    mse = torch.zeros((n, 4), dtype=torch.int64,
                                      device=device)
                else:
                    dsq = (preds[0] - refs[0]) ** 2
                    hh, hw = max(h // 2, 1), max(w // 2, 1)
                    mse = torch.stack(
                        [dsq[:, r:r + hh, c:c + hw].sum((1, 2)) // (hh * hw)
                         for r, c in ((0, 0), (0, hw), (hh, 0), (hh, hw))], 1)
                luma_sse = ((refs[0] - preds[0]) ** 2).reshape(
                    n, h // 2, 2, w // 2, 2).sum((2, 4)).to(torch.float64)
                for pl in range(3):
                    s = 1 if pl else 0
                    wgt, wp = _apply_blocks(
                        refs[pl], preds[pl], mse, d_factor[bi, sel],
                        decay[pl], weight_factor, inv_factor,
                        WINDOW ** 2 + (4 if pl else 0),
                        luma_sse if pl else None, dtype)
                    _row(accum[pl], y0 >> s, h >> s, x0 >> s, n,
                         w >> s).add_(wp)
                    _row(count[pl], y0 >> s, h >> s, x0 >> s, n,
                         w >> s).add_(wgt)
    out = []
    for pl in range(3):
        c = torch.clamp(count[pl], min=1)
        out.append(((accum[pl] + (c >> 1)) // c).clamp(0, 255)
                   .to(torch.uint8).cpu().numpy())
    return out


def filter_key(frames, qindex: int, device, dtype=torch.float64,
               lookahead: int = 2):
    """The KEY frame's filter: ``frames[0]`` against the next
    ``lookahead``, strength 1, the noise of ``frames[0]``."""
    span = frames[:1 + lookahead]
    noise = [max(noise_level(p), 0.0) for p in span[0]]
    return filter_frames(span, 0, q_factor(qindex), 1, noise, device, dtype)


def filter_arf(span, center: int, group_qindex: int, strength: int, device,
               dtype=torch.float64):
    """An ARF's filter: ``span[center]`` against the rest of its span, at
    the group's quantizer step, the noise of the centre frame."""
    noise = [max(noise_level(p), 0.0) for p in span[center]]
    return filter_frames(span, center, q_factor(group_qindex), strength,
                         noise, device, dtype)
