"""Temporal filtering (ARF/KF multi-frame denoise) on the device — torch
counterpart of ``aom_av1_psy_tpu/encoder/temporal_filter.py``: the
non-local-mean weighted accumulation of ``av1/encoder/temporal_filter.c``
(av1_apply_temporal_filter_c :905), the frame loop with its full-pel
motion search, the noise estimate and the KEY-frame filter.
--tune-content=psy forces filter strength 2 and +2 frames for non-KF
(temporal_filter.c:815-831, :1060-1075; see encoder/psy.PsyConfig).

Per span, everything is batched over the 32x32 luma blocks: per
non-centre frame one full-pel search (``ops/mvsearch.full_pel_plane_search``,
kernel KJ's plane entry, which reads each block's window where it lies in
the frame padded with 128; one launch per block shape), then one launch of
kernel KK ``tf_span_filter`` (``csrc/temporal_filter.cu``) for the whole
span, which replaces the reference's host ``apply_temporal_filter``
(``:33-94``) over every block of every frame, with the clamped prediction
origins, the per-subblock integer MSEs and the final rounding around it
(``:145-181``), and writes the filtered uint8 planes. The centre frame
takes MV 0.

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
  prediction's origin is clamped with an arithmetic ``>>`` (``:145-148``);
- the subblock MSEs keep the reference's windows (``max(h // 2, 1)`` rows,
  ``max(w // 2, 1)`` columns; an odd last row or column is left out) and
  its floor division (``:156-162``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import CudaKernel, D, I, P, need
from ..ops import mvsearch as MV

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

MAX_FRAMES = 16           # the span kernel's frames (csrc kKKMaxFrames)


class _KKArgs(ctypes.Structure):
    """``csrc/temporal_filter.cu``'s ``KKArgs``, field for field."""
    _fields_ = ([("planes", P * (3 * MAX_FRAMES)), ("out", P * 3)]
                + [(f, P) for f in ("mvs", "dtab", "thresholds")]
                + [("decay", D * 3), ("wf", D), ("inv", D)]
                + [(f, I) for f in ("n", "center", "H", "W", "Hc", "Wc",
                                    "nbx", "mb", "rad", "ss_x", "ss_y")])


KK = CudaKernel("temporal_filter", {
    "tf_span_filter": [ctypes.POINTER(_KKArgs)],
    # scaled, n, thresholds, weight
    "tf_weight_sweep": [P, I, P, P],
    # n, out
    "tf_div_sweep": [I, P],
})
# the largest window total the span pass divides: 25 luma and 4 co-located
# luma squared errors of 8-bit samples (a chroma pixel at 4:2:0)
MAX_TOTAL = 29 * 255 * 255


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


@functools.cache
def _dtab_on(frame_width: int, frame_height: int, device: str):
    """``distance_table`` at SEARCH_RAD on ``device``, made once per frame
    size and device."""
    return torch.as_tensor(distance_table(SEARCH_RAD, frame_width,
                                          frame_height), device=device)


# ---------------------------------------------------------------------------
# The weighting (KK's plain version works frame by frame through it)
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
              device=out.get_device(), variant="sweep")
    return out


def divide_totals(n: int, device):
    """(MAX_TOTAL + 1,) float64: t / n for every window total t, as the span
    pass divides it. CPU: the IEEE quotient (numpy's ``/``, the reference's
    ``total / num_ref_pixels``); CUDA: KK's own division (a product by
    1 / n corrected by its exact residual, entry ``tf_div_sweep``), which
    the tests hold against the quotient at every total and n."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return torch.arange(MAX_TOTAL + 1, dtype=torch.float64) / n
    out = torch.empty(MAX_TOTAL + 1, dtype=torch.float64, device=dev)
    KK.launch("tf_div_sweep", n, out.data_ptr(), device=out.get_device(),
              variant="div sweep")
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
    """Every block of one frame's weighted accumulation
    (``apply_temporal_filter`` of each block), the step of
    ``tf_span_filter_plain`` for each frame of a span.

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
            refb = MV.cut(ref[p], by >> sy, bx >> sx, ph,
                          pw).to(torch.int64)
            predb = MV.cut(pred[p], org[idx, p, 0], org[idx, p, 1], ph,
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


# ---------------------------------------------------------------------------
# The span's block grid and search
# ---------------------------------------------------------------------------

class SpanGrid:
    """The 32x32 block grid of one span on the device, with the centre
    frame's luma blocks grouped by shape: KJ's inputs for each frame of the
    span, and the per-block inputs of the weighting."""

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
        self.src = {hw: MV.cut(center[0], self.by[ids], self.bx[ids], *hw)
                    for hw, ids in self.groups}
        # each group's window origins in the padded frame (int32, KJ's)
        self.origins = {hw: (self.by[ids].to(torch.int32),
                             self.bx[ids].to(torch.int32))
                        for hw, ids in self.groups}
        self.dtab = _dtab_on(W, H, str(dev))
        self.shifts = [(0, 0), (ss_y, ss_x), (ss_y, ss_x)]

    def centre_inputs(self):
        """(org, mses, dfac) of the centre frame: zero MVs and MSEs."""
        org = torch.stack([torch.stack([self.by >> sy, self.bx >> sx], 1)
                           for sy, sx in self.shifts], 1)
        mses = torch.zeros((self.B, 4), dtype=torch.int64,
                           device=org.device)
        return org, mses, self.dtab[SEARCH_RAD, SEARCH_RAD].expand(self.B, 4)

    def padded(self, frame_y):
        """This frame's luma with SEARCH_RAD rows and columns of 128
        around it (``:129-137``): block b's search window is the (h + 32,
        w + 32) patch at (by[b], bx[b]) of it."""
        rad = SEARCH_RAD
        padded = torch.full((self.H + 2 * rad, self.W + 2 * rad), FILL,
                            dtype=torch.int32, device=frame_y.device)
        padded[rad:rad + self.H, rad:rad + self.W] = frame_y
        return padded

    def motion_inputs(self, f):
        """(B, 2) int32 full-pel MVs (dy, dx) of a non-centre frame ``f``
        (three planes; its luma is searched): KJ's plane entry, one launch
        per block shape, reading each window in the padded frame."""
        padded = self.padded(f[0])
        mv = torch.empty((self.B, 2), dtype=torch.int32, device=padded.device)
        for hw, ids in self.groups:
            mv[ids] = MV.full_pel_plane_search(self.src[hw], padded,
                                               *self.origins[hw],
                                               SEARCH_RAD)[0]
        return mv

    def weight_inputs(self, f, mv):
        """(org, mses, dfac) of a non-centre frame ``f`` with block MVs
        ``mv`` (B, 2): the prediction's origin in each plane, clamped to
        the plane; the subblock MSEs of the luma prediction; each block's
        distance factor."""
        dy, dx = mv[:, 0].long(), mv[:, 1].long()
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
            pred = MV.cut(f[0], org[ids, 0, 0], org[ids, 0, 1], h, w)
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


# ---------------------------------------------------------------------------
# Kernel KK and its plain version: one span
# ---------------------------------------------------------------------------

def _round(accum, count):
    """The filtered planes: ``(accum + count // 2) // max(count, 1)``,
    clamped, as uint8 (``:177-181``)."""
    out = []
    for a, n in zip(accum, count):
        c = n.clamp(min=1)
        out.append(((a + (c >> 1)) // c).clamp(0, 255).to(torch.uint8))
    return out


def tf_span_filter_plain(center_idx: int, planes, mvs, params,
                         ss_x: int = 1, ss_y: int = 1, mb: int = 32):
    """Plain version of KK: the filtered (y, u, v) uint8 planes of
    ``planes[center_idx]``.

    planes: the span's frames, each three integer planes; mvs (N, B, 2):
    each frame's full-pel (dy, dx) per block (block b at ((b // nbx) * mb,
    (b % nbx) * mb) of the luma plane, cut to the frame), |dy|, |dx| <=
    SEARCH_RAD; the centre's row is not read (MV 0, MSEs 0); params:
    ``filter_params``'s triple. Frame by frame: the prediction's origins,
    the subblock MSEs and the distance factors (``SpanGrid.weight_inputs``),
    ``tf_weight_accum_plain`` into int64 sums, then the rounding."""
    center = planes[center_idx]
    grid = SpanGrid(center, mb, ss_x, ss_y)
    accum = [torch.zeros(p.shape, dtype=torch.int64, device=p.device)
             for p in center]
    count = [torch.zeros_like(a) for a in accum]
    for fi, f in enumerate(planes):
        inputs = grid.centre_inputs() if fi == center_idx else \
            grid.weight_inputs(f, mvs[fi])
        tf_weight_accum_plain(center, f, *inputs, params, ss_x, ss_y, mb,
                              accum, count)
    return _round(accum, count)


def tf_span_filter(center_idx: int, planes, mvs, params, ss_x: int = 1,
                   ss_y: int = 1, mb: int = 32):
    """``tf_span_filter_plain``'s planes. CPU tensors: the plain version;
    CUDA tensors: kernel KK, one launch for the span (each frame's three
    int32 planes of 8-bit samples, int32 mvs (N, B, 2); int32 sums, exact
    while N * 1000 * 255 < 2^31)."""
    if planes[center_idx][0].device.type == "cpu":
        return tf_span_filter_plain(center_idx, planes, mvs, params, ss_x,
                                    ss_y, mb)
    n = len(planes)
    if not 0 <= center_idx < n or n > MAX_FRAMES:
        raise ValueError(f"KK: {n} frames (at most {MAX_FRAMES}), centre "
                         f"{center_idx}")
    if n * TF_WEIGHT_SCALE * 255 >= 2 ** 31:
        raise ValueError(f"KK: {n} frames overflow the int32 sums")
    if not 0 < mb <= 32 or ss_x not in (0, 1) or ss_y not in (0, 1):
        raise ValueError(f"KK: block size {mb} (at most 32), subsampling "
                         f"{ss_x}, {ss_y}")
    y = planes[center_idx][0]
    di = y.get_device()
    H, W = y.shape
    Hc, Wc = planes[center_idx][1].shape
    if Hc < H >> ss_y or Wc < W >> ss_x or H * W >= 2 ** 31:
        raise ValueError(f"KK: luma {H}x{W} (below 2^31 pixels), chroma "
                         f"{Hc}x{Wc} (at least the luma subsampled)")
    nbx = -(-W // mb)
    B = -(-H // mb) * nbx
    weight_factor, inv_factor, decay = params
    out = [torch.empty(s, dtype=torch.uint8, device=y.device)
           for s in ((H, W), (Hc, Wc), (Hc, Wc))]
    a = _KKArgs(mvs=need(mvs, torch.int32, (n, B, 2), di, "KK mvs"),
                dtab=_dtab_on(W, H, str(y.device)).data_ptr(),
                thresholds=_thresholds_on(str(y.device)).data_ptr(),
                wf=weight_factor, inv=inv_factor, n=n, center=center_idx,
                H=H, W=W, Hc=Hc, Wc=Wc, nbx=nbx, mb=mb, rad=SEARCH_RAD,
                ss_x=ss_x, ss_y=ss_y)
    a.decay[:] = decay
    a.out[:] = [t.data_ptr() for t in out]
    for f, frame in enumerate(planes):
        for p, (t, shape) in enumerate(zip(frame, ((H, W), (Hc, Wc),
                                                   (Hc, Wc)), strict=True)):
            a.planes[3 * f + p] = need(t, torch.int32, shape, di,
                                       f"KK frame {f} plane {p}")
    KK.launch("tf_span_filter", ctypes.byref(a), device=di, variant="span")
    return out


# ---------------------------------------------------------------------------
# The frame loop
# ---------------------------------------------------------------------------

def upload(frames, device):
    """Each frame's planes (numpy or tensors) as int32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return [[torch.as_tensor(p, device=dev).to(torch.int32) for p in f]
            for f in frames]


def temporal_filter_frames(frames, center_idx: int, q_factor: int,
                           strength: int, noise_levels=(1.0, 1.0, 1.0),
                           ss_x: int = 1, ss_y: int = 1, mb: int = 32,
                           device="cuda"):
    """Simplified av1_temporal_filter: filter frames[center_idx]
    against its neighbors with full-pel 32x32 motion compensation
    (dense-grid search) and the normative weighting kernel. ``frames``
    holds each frame's (y, u, v) planes, numpy or tensors (``upload``).
    Returns the filtered (y, u, v) planes (uint8 numpy): KJ's search per
    non-centre frame, then one KK launch for the span."""
    planes = upload(frames, device)
    grid = SpanGrid(planes[center_idx], mb, ss_x, ss_y)
    mvs = torch.zeros((len(planes), grid.B, 2), dtype=torch.int32,
                      device=grid.by.device)
    for fi, f in enumerate(planes):
        if fi != center_idx:
            mvs[fi] = grid.motion_inputs(f)
    out = tf_span_filter(center_idx, planes, mvs,
                         filter_params(q_factor, strength, noise_levels),
                         ss_x, ss_y, mb)
    return [p.cpu().numpy() for p in out]


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
