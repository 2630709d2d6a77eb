"""Temporal filtering (ARF/KF multi-frame denoise) on the device — torch
counterpart of ``aom_av1_psy_tpu/encoder/temporal_filter.py``: the
non-local-mean weighted accumulation of ``av1/encoder/temporal_filter.c``
(av1_apply_temporal_filter_c :905), the frame loop with its full-pel
motion search, the noise estimate and the KEY-frame filter.
--tune-content=psy forces filter strength 2 and +2 frames for non-KF
(temporal_filter.c:815-831, :1060-1075; see encoder/psy.PsyConfig).

Per non-centre frame of a span, everything is batched over the 32x32 luma
blocks: one full-pel search (``ops/mvsearch.full_pel_grid_search``, kernel
KJ; one launch per block shape), the clamped gather of the prediction,
the per-subblock integer MSEs (torch), then one launch of kernel KK
``tf_weight_accum`` (``csrc/temporal_filter.cu``), which replaces the
reference's host ``apply_temporal_filter`` (``:33-94``) over every block of
the frame. The centre frame takes KK with zero MVs and MSEs.

Exactness (each held by ``tests/test_torch_temporal_filter.py``):
- the 5x5 window clamps at the BLOCK's border (``_window_sum`` pads the
  block's squared errors, ``:22-30``), never reading a neighbouring block;
- chroma adds the 2x2 sums of the same block's luma squared errors and
  divides by 25 + 4; the subblock index uses each plane's own h//2, w//2;
- the weight is float64 in the reference's order, no FMA, up to the
  truncation of ``exp(-scaled) * 1000``, which is a lookup in the host's
  ``np.exp`` thresholds (``weight_thresholds``) on both versions: CUDA's
  ``exp`` gave another integer than numpy's at 276 of the 101002 values
  within 50 ulp of the 1000 truncation boundaries (on an H100);
  ``weight_factor``, ``inv_factor`` and ``decay[plane]`` (``np.log``) are
  made on the host as ``:46-55`` makes them, and ``d_factor`` comes from
  the host's ``np.hypot`` (``:57-62``) as a per-frame table indexed by the
  full-pel MV, never from a device ``hypot`` or ``sqrt``;
- the search windows hold 128 outside the frame (``:131-137``); the
  prediction's origin is clamped with an arithmetic ``>>`` (``:145-148``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import CudaKernel, D, I, P

TF_WINDOW_LENGTH = 5
TF_WEIGHT_SCALE = 1000
TF_WINDOW_BLOCK_BALANCE_WEIGHT = 5
TF_Q_DECAY_THRESHOLD = 20
TF_SEARCH_ERROR_NORM_WEIGHT = 20
TF_STRENGTH_THRESHOLD = 4
TF_SEARCH_DISTANCE_THRESHOLD = 0.1
TF_QINDEX_CUTOFF = 128

SEARCH_RAD = 16          # full-pel radius of the per-block search (:129)
FILL = 128               # the search window outside the frame (:131)

KK = CudaKernel("temporal_filter", {
    # ref0..2, pred0..2, accum0..2, count0..2, H, W, Hc, Wc, B, nbx, mb,
    # ss_x, ss_y, org, mses, dfac, decay0..2, weight_factor, inv_factor
    # ..., thresholds
    "tf_weight_accum": [P] * 12 + [I] * 9 + [P, P, P] + [D] * 5 + [P],
    # scaled, n, thresholds, weight
    "tf_weight_sweep": [P, I, P, P],
})


def filter_params(q_factor: int, filter_strength: int, noise_levels):
    """(weight_factor, inv_factor, decay per plane): the host float64
    constants of av1_apply_temporal_filter_c, computed as the reference's
    ``apply_temporal_filter`` computes them (``:46-55``)."""
    inv_factor = 1.0 / ((TF_WINDOW_BLOCK_BALANCE_WEIGHT + 1)
                        * TF_SEARCH_ERROR_NORM_WEIGHT)
    weight_factor = TF_WINDOW_BLOCK_BALANCE_WEIGHT * inv_factor
    q_decay = min(max((q_factor / TF_Q_DECAY_THRESHOLD) ** 2, 1e-5), 1.0)
    if q_factor >= TF_QINDEX_CUTOFF:
        q_decay = 0.5 * (q_factor / 64) ** 2
    s_decay = min(max((filter_strength / TF_STRENGTH_THRESHOLD) ** 2,
                      1e-5), 1.0)
    decay = [float(1.0 / ((0.5 + np.log(2 * noise_levels[p] + 5.0))
                          * q_decay * s_decay)) for p in range(3)]
    return weight_factor, inv_factor, decay


def d_factor(mvr, mvc, frame_width: int, frame_height: int) -> float:
    """The motion-distance factor of one subblock MV (1/8 pel), with the
    host's ``np.hypot`` (``:57-62``)."""
    distance = float(np.hypot(mvr, mvc))
    dt = max(min(frame_width, frame_height) * TF_SEARCH_DISTANCE_THRESHOLD,
             1)
    return max(distance / dt, 1.0)


def distance_table(radius: int, frame_width: int, frame_height: int):
    """(n, n) float64 ``d_factor`` of every full-pel MV (8 dy, 8 dx),
    |dy|, |dx| <= radius: the frame loop indexes it with the searched MVs."""
    n = 2 * radius + 1
    out = np.empty((n, n), np.float64)
    for i in range(n):
        for j in range(n):
            out[i, j] = d_factor(np.int64(8 * (i - radius)),
                                 np.int64(8 * (j - radius)), frame_width,
                                 frame_height)
    return out


# ---------------------------------------------------------------------------
# Kernel KK and its plain version
# ---------------------------------------------------------------------------

def _grid(H: int, W: int, mb: int):
    """Per-block origins by/bx and sizes h/w (numpy), block b at row
    b // nbx, column b % nbx of the ceil(H / mb) x ceil(W / mb) grid."""
    nbx = -(-W // mb)
    b = np.arange(-(-H // mb) * nbx)
    by, bx = (b // nbx) * mb, (b % nbx) * mb
    return by, bx, np.minimum(mb, H - by), np.minimum(mb, W - bx)


def _shape_groups(H: int, W: int, mb: int):
    """[((h, w), block ids)]: the blocks of one size together (the full
    ones, then the partial bottom row, right column and corner)."""
    _, _, hs, ws = _grid(H, W, mb)
    out = []
    for h in sorted(set(hs.tolist()), reverse=True):
        for w in sorted(set(ws.tolist()), reverse=True):
            ids = np.nonzero((hs == h) & (ws == w))[0]
            if ids.size:
                out.append(((int(h), int(w)), ids))
    return out


def _cut(plane, r0, c0, h: int, w: int):
    """(G, h, w) patches of ``plane`` at origins r0/c0 (G,)."""
    ar_h = torch.arange(h, device=plane.device)
    ar_w = torch.arange(w, device=plane.device)
    return plane[(r0[:, None] + ar_h[None])[:, :, None],
                 (c0[:, None] + ar_w[None])[:, None, :]]


def _window_sum(sq, half: int):
    """Sum over a (2*half+1)^2 window with the BLOCK's edge clamped:
    sq (G, h, w) -> (G, h, w)."""
    _, h, w = sq.shape
    ri = (torch.arange(-half, h + half, device=sq.device)).clamp(0, h - 1)
    ci = (torch.arange(-half, w + half, device=sq.device)).clamp(0, w - 1)
    pad = sq[:, ri][:, :, ci]
    out = torch.zeros_like(sq)
    for wi in range(2 * half + 1):
        for wj in range(2 * half + 1):
            out += pad[:, wi:wi + h, wj:wj + w]
    return out


@functools.cache
def weight_thresholds() -> np.ndarray:
    """(1000,) float64, ascending: entry 1000 - k is the largest ``scaled``
    whose weight ``np.exp(-scaled) * 1000`` (``:92``) is still >= k, found
    by bisection over the float64 bit patterns with the host's ``np.exp``.
    The weight of ``scaled`` in [0, 7] is then the count of entries >= it,
    on the host, in the plain version and in KK alike."""
    k = np.arange(1, TF_WEIGHT_SCALE + 1, dtype=np.float64)

    def holds(bits):
        return np.exp(-bits.view(np.float64)) * TF_WEIGHT_SCALE >= k

    # + 0.0: k = 1000 starts at +0, whose bit pattern orders with the rest
    lo = (-np.log(k / TF_WEIGHT_SCALE) + 0.0).view(np.int64).copy()
    for _ in range(64):                  # step down to a value that holds
        bad = ~holds(lo)
        if not bad.any():
            break
        lo[bad] -= 1
    # exp(-hi) * 1000 is about k - 1/2 < k: the weight is below k there
    hi = (-np.log((k - 0.5) / TF_WEIGHT_SCALE)).view(np.int64).copy()
    if not holds(lo).all() or holds(hi).any():
        raise ArithmeticError("np.exp brackets no truncation boundary")
    while (hi - lo > 1).any():
        mid = lo + (hi - lo) // 2
        ok = holds(mid)
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid)
    return lo.view(np.float64)[::-1].copy()


@functools.cache
def _thresholds_on(device: str):
    return torch.as_tensor(weight_thresholds(), device=device)


def tf_weight_plain(scaled):
    """The int64 weight of float64 ``scaled`` values in [0, 7], the
    reference's ``(np.exp(-scaled) * 1000).astype(np.int64)`` (``:92``):
    the count of ``weight_thresholds`` at or above each value."""
    t = _thresholds_on(str(scaled.device))
    return TF_WEIGHT_SCALE - torch.searchsorted(t, scaled.contiguous())


def tf_weight(scaled):
    """``tf_weight_plain``'s weights. CPU tensors: the plain version; CUDA
    tensors: KK's own weight function (entry ``tf_weight_sweep``), which
    the tests hold against ``np.exp`` at every truncation boundary."""
    if scaled.device.type == "cpu":
        return tf_weight_plain(scaled)
    scaled = scaled.to(torch.float64).contiguous()
    out = torch.empty(scaled.shape, dtype=torch.int64, device=scaled.device)
    KK.launch("tf_weight_sweep", scaled.data_ptr(), scaled.numel(),
              _thresholds_on(str(scaled.device)).data_ptr(), out.data_ptr(),
              variant="sweep")
    return out


def weight_boundary_values(ulps: int = 50) -> np.ndarray:
    """float64 ``scaled`` values at every truncation boundary of the
    weight: for k = 1..1000 the 2 * ulps + 1 values within ``ulps`` ulp of
    -log(k / 1000), and the end points 0 and 7 (the sweep that holds KK's
    weight against numpy's)."""
    vals = [np.array([0.0, 7.0])]
    for k in range(1, 1001):
        v = -np.log(k / 1000.0)
        for _ in range(ulps):
            v = np.nextafter(v, -np.inf)
        run = [v]
        for _ in range(2 * ulps):
            run.append(np.nextafter(run[-1], np.inf))
        vals.append(np.array(run))
    return np.concatenate(vals)


def tf_weight_accum_plain(ref, pred, org, mses, dfac, params, ss_x: int,
                          ss_y: int, mb: int, accum, count) -> None:
    """Plain version of KK: every block of one frame's weighted
    accumulation (``apply_temporal_filter`` of each block).

    ref / pred: the centre frame's and this frame's three planes (integer
    tensors); org (B, 3, 2): each block's prediction origin (row, col) in
    each plane, which keeps the block inside the plane; mses (B, 4) int64 subblock MSEs; dfac (B, 4) float64
    subblock distance factors; params: ``filter_params``'s triple;
    accum / count: three int64 planes, accumulated in place. Block b is at
    ((b // nbx) * mb, (b % nbx) * mb) of the luma plane, cut to the frame.
    """
    weight_factor, inv_factor, decay = params
    H, W = ref[0].shape
    by_all, bx_all, _, _ = _grid(H, W, mb)
    half = TF_WINDOW_LENGTH >> 1
    dev = ref[0].device
    org = org.to(dev, torch.int64)
    mses = mses.to(dev, torch.int64)
    dfac = dfac.to(dev, torch.float64)
    for (h, w), ids in _shape_groups(H, W, mb):
        idx = torch.as_tensor(ids, device=dev)
        by = torch.as_tensor(by_all[ids], device=dev)
        bx = torch.as_tensor(bx_all[ids], device=dev)
        sq_l = None
        for p in range(3):
            sy, sx = (ss_y, ss_x) if p else (0, 0)
            ph, pw = h >> sy, w >> sx
            refb = _cut(ref[p], by >> sy, bx >> sx, ph, pw).to(torch.int64)
            predb = _cut(pred[p], org[idx, p, 0], org[idx, p, 1], ph,
                         pw).to(torch.int64)
            sq = (refb - predb) ** 2
            total = _window_sum(sq, half).to(torch.float64)
            if p == 0:
                sq_l = sq
            else:
                # co-located luma squared errors of the same block (:76-84)
                lum = sq_l[:, :ph << sy, :pw << sx].reshape(
                    -1, ph, 1 << sy, pw, 1 << sx).sum((2, 4))
                total = total + lum.to(torch.float64)
            num_ref_pixels = TF_WINDOW_LENGTH ** 2 + \
                ((1 << (sx + sy)) if p else 0)
            window_error = total / num_ref_pixels
            iy = (torch.arange(ph, device=dev)[:, None] >= ph // 2) * 2
            jx = (torch.arange(pw, device=dev)[None, :] >= pw // 2) * 1
            sub = (iy + jx).reshape(-1)
            block_error = mses[idx][:, sub].to(torch.float64) \
                .reshape(-1, ph, pw)
            combined = weight_factor * window_error + block_error * inv_factor
            scaled = (combined * dfac[idx][:, sub].reshape(-1, ph, pw)
                      * decay[p]).clamp(max=7.0)
            weight = tf_weight_plain(scaled)
            rows = ((by >> sy)[:, None]
                    + torch.arange(ph, device=dev)[None])[:, :, None]
            cols = ((bx >> sx)[:, None]
                    + torch.arange(pw, device=dev)[None])[:, None, :]
            accum[p][rows, cols] += weight * predb
            count[p][rows, cols] += weight


def tf_weight_accum(ref, pred, org, mses, dfac, params, ss_x: int,
                    ss_y: int, mb: int, accum, count) -> None:
    """``tf_weight_accum_plain``'s accumulation. CPU tensors: the plain
    version; CUDA tensors: kernel KK (int32 planes, int64 accum / count,
    one launch for every block of the frame)."""
    if ref[0].device.type == "cpu":
        tf_weight_accum_plain(ref, pred, org, mses, dfac, params, ss_x, ss_y,
                              mb, accum, count)
        return
    weight_factor, inv_factor, decay = params
    H, W = ref[0].shape
    Hc, Wc = ref[1].shape
    nby, nbx = -(-H // mb), -(-W // mb)
    B = nby * nbx
    if not 0 < mb <= 32:
        raise ValueError(f"KK: block size {mb} above 32")
    for t, dt in [(t, torch.int32) for t in (*ref, *pred)] + \
            [(t, torch.int64) for t in (*accum, *count)]:
        if t.device.type != "cuda" or t.dtype != dt or \
                not t.is_contiguous():
            raise ValueError(f"KK plane: want contiguous {dt} on cuda, got "
                             f"{t.dtype} on {t.device}")
    for t, shape in ((ref[0], (H, W)), (pred[0], (H, W)), (accum[0], (H, W)),
                     (count[0], (H, W))) + tuple(
            (t, (Hc, Wc)) for t in (*ref[1:], *pred[1:], *accum[1:],
                                    *count[1:])):
        if tuple(t.shape) != shape:
            raise ValueError(f"KK plane {tuple(t.shape)}, want {shape}")
    org = org.to(torch.int32).contiguous()
    mses = mses.to(torch.int64).contiguous()
    dfac = dfac.to(torch.float64).contiguous()
    for t, shape in ((org, (B, 3, 2)), (mses, (B, 4)), (dfac, (B, 4))):
        if t.device.type != "cuda" or tuple(t.shape) != shape:
            raise ValueError(f"KK input {tuple(t.shape)} on {t.device}, "
                             f"want {shape} on cuda")
    KK.launch("tf_weight_accum",
              *(t.data_ptr() for t in (*ref, *pred, *accum, *count)),
              H, W, Hc, Wc, B, nbx, mb, ss_x, ss_y, org.data_ptr(),
              mses.data_ptr(), dfac.data_ptr(), *decay, weight_factor,
              inv_factor, _thresholds_on(str(ref[0].device)).data_ptr())


# ---------------------------------------------------------------------------
# The frame loop
# ---------------------------------------------------------------------------

def upload(frames, device):
    """Each frame's planes (numpy or tensors) as int32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return [[torch.as_tensor(p, device=dev).to(torch.int32) for p in f]
            for f in frames]


class SpanGrid:
    """The 32x32 block grid of one span on the device, with the centre
    frame's luma blocks grouped by shape, and the inputs of KJ and KK for
    each frame of the span."""

    def __init__(self, center, mb: int = 32, ss_x: int = 1, ss_y: int = 1):
        self.center, self.mb = center, mb
        self.ss_x, self.ss_y = ss_x, ss_y
        dev = center[0].device
        self.H, self.W = H, W = center[0].shape
        by, bx, hs, ws = _grid(H, W, mb)
        self.by, self.bx, self.hs, self.ws = (
            torch.as_tensor(a, device=dev) for a in (by, bx, hs, ws))
        self.B = self.by.numel()
        self.groups = [((h, w), torch.as_tensor(ids, device=dev))
                       for (h, w), ids in _shape_groups(H, W, mb)]
        self.src = {hw: _cut(center[0], self.by[ids], self.bx[ids], *hw)
                    for hw, ids in self.groups}
        self.dtab = torch.as_tensor(distance_table(SEARCH_RAD, W, H),
                                    device=dev)
        self.shifts = [(0, 0), (ss_y, ss_x), (ss_y, ss_x)]

    def centre_inputs(self):
        """(org, mses, dfac) of the centre frame: zero MVs and MSEs."""
        org = torch.stack([torch.stack([self.by >> sy, self.bx >> sx], 1)
                           for sy, sx in self.shifts], 1)
        mses = torch.zeros((self.B, 4), dtype=torch.int64,
                           device=org.device)
        return org, mses, self.dtab[SEARCH_RAD, SEARCH_RAD].expand(self.B, 4)

    def windows(self, frame_y):
        """[(ids, src, win)] per block shape: the centre's luma blocks and
        this frame's (h + 32, w + 32) search windows, 128 outside the
        frame (``:129-137``)."""
        rad = SEARCH_RAD
        padded = torch.full((self.H + 2 * rad, self.W + 2 * rad), FILL,
                            dtype=torch.int32, device=frame_y.device)
        padded[rad:rad + self.H, rad:rad + self.W] = frame_y
        return [(ids, self.src[(h, w)],
                 _cut(padded, self.by[ids], self.bx[ids], h + 2 * rad,
                      w + 2 * rad))
                for (h, w), ids in self.groups]

    def motion_inputs(self, f):
        """(org, mses, dfac) of a non-centre frame ``f`` (three planes):
        the search (KJ, one launch per block shape), the prediction's
        clamped origin in each plane and the subblock MSEs."""
        from ..ops import mvsearch as MV
        dy = torch.empty(self.B, dtype=torch.int64, device=f[0].device)
        dx = torch.empty_like(dy)
        for ids, src, win in self.windows(f[0]):
            mv, _ = MV.full_pel_grid_search(src, win, SEARCH_RAD)
            dy[ids] = mv[:, 0].long()
            dx[ids] = mv[:, 1].long()
        # the prediction's origin in each plane, clamped to the plane
        org = []
        for p, (sy, sx) in enumerate(self.shifts):
            ph, pw = f[p].shape
            r = torch.minimum(((self.by + dy) >> sy).clamp(min=0),
                              ph - (self.hs >> sy))
            c = torch.minimum(((self.bx + dx) >> sx).clamp(min=0),
                              pw - (self.ws >> sx))
            org.append(torch.stack([r, c], 1))
        org = torch.stack(org, 1)
        # per-subblock MSE of the chosen luma prediction (:156-162)
        mses = torch.empty((self.B, 4), dtype=torch.int64, device=dy.device)
        for (h, w), ids in self.groups:
            pred = _cut(f[0], org[ids, 0, 0], org[ids, 0, 1], h, w)
            dsq = (pred.to(torch.int64) - self.src[(h, w)]) ** 2
            hh, hw = max(h // 2, 1), max(w // 2, 1)
            for si, (r0, c0) in enumerate(((0, 0), (0, hw), (hh, 0),
                                           (hh, hw))):
                sub = dsq[:, r0:r0 + hh, c0:c0 + hw]
                size = sub.shape[1] * sub.shape[2]
                mses[ids, si] = sub.sum((1, 2)) // max(size, 1)
        dfac = self.dtab[dy + SEARCH_RAD, dx + SEARCH_RAD][:, None] \
            .expand(self.B, 4)
        return org, mses, dfac


def temporal_filter_frames(frames, center_idx: int, q_factor: int,
                           strength: int, noise_levels=(1.0, 1.0, 1.0),
                           ss_x: int = 1, ss_y: int = 1, mb: int = 32,
                           device="cuda"):
    """Simplified av1_temporal_filter: filter frames[center_idx]
    against its neighbors with full-pel 32x32 motion compensation
    (dense-grid search) and the normative weighting kernel. ``frames``
    holds each frame's (y, u, v) planes, numpy or tensors (``upload``).
    Returns the filtered (y, u, v) planes (uint8 numpy)."""
    planes = upload(frames, device)
    center = planes[center_idx]
    grid = SpanGrid(center, mb, ss_x, ss_y)
    accum = [torch.zeros(p.shape, dtype=torch.int64, device=p.device)
             for p in center]
    count = [torch.zeros_like(a) for a in accum]
    params = filter_params(q_factor, strength, noise_levels)
    for fi, f in enumerate(planes):
        inputs = grid.centre_inputs() if fi == center_idx else \
            grid.motion_inputs(f)
        tf_weight_accum(center, f, *inputs, params, ss_x, ss_y, mb, accum,
                        count)
    out = []
    for a, n in zip(accum, count):
        c = n.clamp(min=1)
        out.append(((a + (c >> 1)) // c).clamp(0, 255).to(torch.uint8)
                   .cpu().numpy())
    return out


def estimate_noise_level(plane, edge_thresh: int = 50, bd: int = 8,
                         device="cuda") -> float:
    """av1_estimate_noise_from_single_plane (temporal_filter.c:1150):
    mean |Laplacian| over Sobel-smooth pixels * sqrt(pi/2)/6. The two
    sums are int64 on the device (a tensor stays where it lies, a numpy
    plane goes to ``device``); the ratio is taken on the host in the
    reference's order. Returns -1.0 when too few smooth pixels
    (unreliable)."""
    if not torch.is_tensor(plane):
        plane = torch.as_tensor(np.asarray(plane),
                                device=resolve_device(device))
    m = plane.to(torch.int64)
    c = m[1:-1, 1:-1]
    tl, t, tr = m[:-2, :-2], m[:-2, 1:-1], m[:-2, 2:]
    l, r = m[1:-1, :-2], m[1:-1, 2:]
    bl, b, br = m[2:, :-2], m[2:, 1:-1], m[2:, 2:]
    gx = (tl - tr) + (bl - br) + 2 * (l - r)
    gy = (tl - bl) + (tr - br) + 2 * (t - b)
    ga = gx.abs() + gy.abs()
    if bd > 8:
        ga = (ga + (1 << (bd - 9))) >> (bd - 8)
    smooth = ga < edge_thresh
    lap = (4 * c - 2 * (t + b + l + r) + (tl + tr + bl + br)).abs()
    if bd > 8:
        lap = (lap + (1 << (bd - 9))) >> (bd - 8)
    cnt, total = torch.stack([smooth.sum(), (lap * smooth).sum()]).tolist()
    if cnt < 16:
        return -1.0
    return float(total) / (6 * cnt) * 1.25331413732


def filter_key_frame(frames, idx: int, q_kf: int, n_lookahead: int = 2,
                     strength: int = 1, device="cuda"):
    """KEY-frame temporal filtering (enable_keyframe_filtering semantics):
    filter frames[idx] against up to ``n_lookahead`` FUTURE frames with
    the golden-tested kernel; strength defaults to 1 per the reference's
    KF rule (temporal_filter.c:833-841; psy tuning uses 2 for non-KF,
    :815-831). Returns a new Frame (or the original when there is no
    future frame / estimation says the content is clean and static).

    q_kf is the KEY frame's base_q_idx; the kernel's q_factor is the
    real-valued quantizer step (av1_get_q analogue: ac_quant/4). The span
    is uploaded once to ``device``.
    """
    from ..utils.frame import Frame
    from ..normative import tables
    span = [frames[j] for j in range(idx, min(idx + 1 + n_lookahead,
                                              len(frames)))]
    if len(span) < 2:
        return frames[idx]
    planes_list = upload([f.planes() for f in span], device)
    noise = [max(estimate_noise_level(p), 0.0) for p in planes_list[0]]
    q_factor = max(1, tables.ac_quant(max(q_kf, 1)) // 4)
    y, u, v = temporal_filter_frames(planes_list, 0, q_factor, strength,
                                     noise_levels=tuple(noise),
                                     device=device)
    return Frame(y, u, v)
