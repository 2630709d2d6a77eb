"""Temporal filtering (ARF/KF multi-frame denoise) — the non-local-mean
weighted accumulation kernel of ``av1/encoder/temporal_filter.c``
(av1_apply_temporal_filter_c :905) as batched array math, plus a light
frame-level loop. --tune-content=psy forces filter strength 2 and +2
frames for non-KF (temporal_filter.c:815-831, :1060-1075; see
encoder/psy.PsyConfig).
"""
from __future__ import annotations

import numpy as np

TF_WINDOW_LENGTH = 5
TF_WEIGHT_SCALE = 1000
TF_WINDOW_BLOCK_BALANCE_WEIGHT = 5
TF_Q_DECAY_THRESHOLD = 20
TF_SEARCH_ERROR_NORM_WEIGHT = 20
TF_STRENGTH_THRESHOLD = 4
TF_SEARCH_DISTANCE_THRESHOLD = 0.1
TF_QINDEX_CUTOFF = 128


def _window_sum(sq: np.ndarray, half: int) -> np.ndarray:
    """Sum over a (2*half+1)^2 window with edge clamping."""
    h, w = sq.shape
    pad = np.pad(sq, half, mode="edge")
    out = np.zeros((h, w), np.uint64)
    for wi in range(2 * half + 1):
        for wj in range(2 * half + 1):
            out += pad[wi : wi + h, wj : wj + w]
    return out


def apply_temporal_filter(ref_planes, pred_planes, noise_levels,
                          subblock_mvs, subblock_mses, q_factor: int,
                          filter_strength: int, frame_width: int,
                          frame_height: int, ss_x: int, ss_y: int,
                          accum, count) -> None:
    """One block's weighted accumulation (av1_apply_temporal_filter_c).

    ref_planes / pred_planes: per-plane arrays for THIS block (luma
    (H, W), chroma subsampled); subblock_mvs: (4, 2) (row, col) in
    1/8-pel; subblock_mses: (4,); accum/count: same layout as planes,
    accumulated in place.
    """
    num_planes = len(ref_planes)
    inv_factor = 1.0 / ((TF_WINDOW_BLOCK_BALANCE_WEIGHT + 1)
                        * TF_SEARCH_ERROR_NORM_WEIGHT)
    weight_factor = TF_WINDOW_BLOCK_BALANCE_WEIGHT * inv_factor
    q_decay = min(max((q_factor / TF_Q_DECAY_THRESHOLD) ** 2, 1e-5), 1.0)
    if q_factor >= TF_QINDEX_CUTOFF:
        q_decay = 0.5 * (q_factor / 64) ** 2
    s_decay = min(max((filter_strength / TF_STRENGTH_THRESHOLD) ** 2,
                      1e-5), 1.0)
    decay = [1.0 / ((0.5 + np.log(2 * noise_levels[p] + 5.0))
                    * q_decay * s_decay) for p in range(num_planes)]
    min_frame_size = min(frame_width, frame_height)
    d_factor = np.empty(4)
    for s in range(4):
        mvr, mvc = subblock_mvs[s]
        distance = float(np.hypot(mvr, mvc))
        dt = max(min_frame_size * TF_SEARCH_DISTANCE_THRESHOLD, 1)
        d_factor[s] = max(distance / dt, 1.0)

    half = TF_WINDOW_LENGTH >> 1
    luma_sse_sum = None
    for plane in range(num_planes):
        ref = ref_planes[plane].astype(np.int64)
        pred = pred_planes[plane].astype(np.int64)
        h, w = ref.shape
        sq = ((ref - pred) ** 2).astype(np.uint64)
        ssx = ss_x if plane else 0
        ssy = ss_y if plane else 0
        num_ref_pixels = TF_WINDOW_LENGTH ** 2 + \
            ((1 << (ssx + ssy)) if plane else 0)
        win = _window_sum(sq, half).astype(np.float64)
        if plane == 1:
            # accumulate co-located luma square diffs for chroma
            sql = ((ref_planes[0].astype(np.int64)
                    - pred_planes[0].astype(np.int64)) ** 2)
            lh, lw = h << ssy, w << ssx
            sql = sql[:lh, :lw].reshape(h, 1 << ssy, w, 1 << ssx) \
                .sum((1, 3)).astype(np.float64)
            luma_sse_sum = sql
        total = win + (luma_sse_sum if plane else 0.0)
        window_error = total / num_ref_pixels
        iy = (np.arange(h)[:, None] >= h // 2) * 2
        jx = (np.arange(w)[None, :] >= w // 2) * 1
        sub = iy + jx
        block_error = np.asarray(subblock_mses, np.float64)[sub]
        combined = weight_factor * window_error + block_error * inv_factor
        scaled = np.minimum(combined * d_factor[sub] * decay[plane], 7.0)
        weight = (np.exp(-scaled) * TF_WEIGHT_SCALE).astype(np.int64)
        accum[plane] += weight * pred
        count[plane] += weight


def temporal_filter_frames(frames, center_idx: int, q_factor: int,
                           strength: int, noise_levels=(1.0, 1.0, 1.0),
                           ss_x: int = 1, ss_y: int = 1, mb: int = 32):
    """Simplified av1_temporal_filter: filter frames[center_idx]
    against its neighbors with full-pel 32x32 motion compensation
    (dense-grid search) and the normative weighting kernel. Returns the
    filtered (y, u, v) planes (uint8)."""
    from ..ops import mvsearch as MV
    center = frames[center_idx]
    planes_c = [p.astype(np.int64) for p in center]
    H, W = planes_c[0].shape
    accum = [np.zeros_like(p, np.int64) for p in planes_c]
    count = [np.zeros_like(p, np.int64) for p in planes_c]

    for fi, frame in enumerate(frames):
        planes_f = [p.astype(np.int64) for p in frame]
        for by in range(0, H, mb):
            for bx in range(0, W, mb):
                h = min(mb, H - by)
                w = min(mb, W - bx)
                if fi == center_idx:
                    mvs = np.zeros((4, 2), np.int64)
                    mses = np.zeros(4, np.int64)
                    pred_blocks = []
                    for pl in range(3):
                        sy = ss_y if pl else 0
                        sx = ss_x if pl else 0
                        pred_blocks.append(
                            planes_c[pl][by >> sy : (by + h) >> sy,
                                         bx >> sx : (bx + w) >> sx])
                else:
                    # full-pel motion per block (radius 16), zero subpel
                    rad = 16
                    src = planes_c[0][by : by + h, bx : bx + w][None]
                    win = np.full((1, h + 2 * rad, w + 2 * rad), 128,
                                  np.int64)
                    y0, x0 = by - rad, bx - rad
                    ys, xs = max(0, y0), max(0, x0)
                    ye, xe = min(H, y0 + h + 2 * rad), min(W, x0 + w + 2 * rad)
                    win[0, ys - y0 : ye - y0, xs - x0 : xe - x0] = \
                        planes_f[0][ys:ye, xs:xe]
                    mv, sad = MV.full_pel_grid_search(src, win, rad)
                    dy_, dx_ = int(mv[0, 0]), int(mv[0, 1])
                    mvs = np.tile(np.array([[dy_ * 8, dx_ * 8]]), (4, 1))
                    pred_blocks = []
                    for pl in range(3):
                        sy = ss_y if pl else 0
                        sx = ss_x if pl else 0
                        py0 = np.clip((by + dy_) >> sy, 0,
                                      planes_f[pl].shape[0] - (h >> sy))
                        px0 = np.clip((bx + dx_) >> sx, 0,
                                      planes_f[pl].shape[1] - (w >> sx))
                        pred_blocks.append(
                            planes_f[pl][py0 : py0 + (h >> sy),
                                         px0 : px0 + (w >> sx)])
                    # per-subblock MSE of the chosen prediction
                    # (tf_motion_search fills real subblock_mses; a
                    # SAD-derived scale inflates block_error ~10x and
                    # clamps every weight to zero)
                    dsq = (pred_blocks[0] - src[0]) ** 2
                    hh, hw = max(h // 2, 1), max(w // 2, 1)
                    mses = np.zeros(4, np.int64)
                    for si, (r0_, c0_) in enumerate(
                            ((0, 0), (0, hw), (hh, 0), (hh, hw))):
                        sub = dsq[r0_ : r0_ + hh, c0_ : c0_ + hw]
                        mses[si] = int(sub.sum()) // max(sub.size, 1)
                ref_blocks = []
                acc_blocks = []
                cnt_blocks = []
                for pl in range(3):
                    sy = ss_y if pl else 0
                    sx = ss_x if pl else 0
                    sl = (slice(by >> sy, (by + h) >> sy),
                          slice(bx >> sx, (bx + w) >> sx))
                    ref_blocks.append(planes_c[pl][sl])
                    acc_blocks.append(accum[pl][sl])
                    cnt_blocks.append(count[pl][sl])
                apply_temporal_filter(ref_blocks, pred_blocks, noise_levels,
                                      mvs, mses, q_factor, strength, W, H,
                                      ss_x, ss_y, acc_blocks, cnt_blocks)
    out = []
    for pl in range(3):
        c = np.maximum(count[pl], 1)
        out.append(((accum[pl] + (c >> 1)) // c).clip(0, 255).astype(np.uint8))
    return out


def estimate_noise_level(plane: np.ndarray, edge_thresh: int = 50,
                         bd: int = 8) -> float:
    """av1_estimate_noise_from_single_plane (temporal_filter.c:1150):
    mean |Laplacian| over Sobel-smooth pixels * sqrt(pi/2)/6, vectorized.
    Returns -1.0 when too few smooth pixels (unreliable)."""
    m = plane.astype(np.int64)
    c = m[1:-1, 1:-1]
    tl, t, tr = m[:-2, :-2], m[:-2, 1:-1], m[:-2, 2:]
    l, r = m[1:-1, :-2], m[1:-1, 2:]
    bl, b, br = m[2:, :-2], m[2:, 1:-1], m[2:, 2:]
    gx = (tl - tr) + (bl - br) + 2 * (l - r)
    gy = (tl - bl) + (tr - br) + 2 * (t - b)
    ga = np.abs(gx) + np.abs(gy)
    if bd > 8:
        ga = (ga + (1 << (bd - 9))) >> (bd - 8)
    smooth = ga < edge_thresh
    lap = np.abs(4 * c - 2 * (t + b + l + r) + (tl + tr + bl + br))
    if bd > 8:
        lap = (lap + (1 << (bd - 9))) >> (bd - 8)
    cnt = int(smooth.sum())
    if cnt < 16:
        return -1.0
    return float(lap[smooth].sum()) / (6 * cnt) * 1.25331413732


def filter_key_frame(frames, idx: int, q_kf: int, n_lookahead: int = 2,
                     strength: int = 1):
    """KEY-frame temporal filtering (enable_keyframe_filtering semantics):
    filter frames[idx] against up to ``n_lookahead`` FUTURE frames with
    the golden-tested kernel; strength defaults to 1 per the reference's
    KF rule (temporal_filter.c:833-841; psy tuning uses 2 for non-KF,
    :815-831). Returns a new Frame (or the original when there is no
    future frame / estimation says the content is clean and static).

    q_kf is the KEY frame's base_q_idx; the kernel's q_factor is the
    real-valued quantizer step (av1_get_q analogue: ac_quant/4).
    """
    from ..utils.frame import Frame
    from ..normative import tables
    span = [frames[j] for j in range(idx, min(idx + 1 + n_lookahead,
                                              len(frames)))]
    if len(span) < 2:
        return frames[idx]
    planes_list = [list(f.planes()) for f in span]
    noise = [max(estimate_noise_level(p), 0.0)
             for p in frames[idx].planes()]
    q_factor = max(1, tables.ac_quant(max(q_kf, 1)) // 4)
    y, u, v = temporal_filter_frames(planes_list, 0, q_factor, strength,
                                     noise_levels=tuple(noise))
    return Frame(y, u, v)
