"""Motion search — dense full-pel grid scan (kernel KJ) + subpel refinement.

The reference's motion search (av1/encoder/mcomp.c) walks sequential
diamond/hex/NSTEP patterns with early exits — a latency-bound scalar
program. Here, as in the JAX package, EVERY candidate in a (2R+1)^2
full-pel window is scored for a whole batch of blocks at once, then the
argmin is taken. Subpel refinement evaluates all 8 half/quarter-pel
neighbours in one shot through the normative convolve kernels
(ops/convolve.py) instead of iterative FIRST_LEVEL/SECOND_LEVEL checks
(mcomp.c:av1_find_best_sub_pixel_tree).

Kernel KJ ``fullpel_sad`` (``csrc/mvsearch.cu``) replaces the jnp branch of
``aom_av1_psy_tpu/ops/mvsearch.py:48-134`` (``full_pel_grid_search`` and
``full_pel_hierarchical``: the (B, n, n, h, w) candidate gather, the SAD
and the first-index argmin). It has two entries over one kernel body:
``sad_argmin`` takes the caller's (B, h + 2r, w + 2r) windows, whatever
they hold outside the frame (KJ does not clamp to a crop);
``sad_argmin_plane`` / ``full_pel_plane_search`` read each block's window
where it lies in a plane, at the block's origin, so no window tensor is
built (the temporal filter passes its luma frame padded with 128; its
plain version is ``cut`` + ``sad_argmin_plain``). CPU tensors go to the
plain versions, CUDA tensors to KJ; there is no fallback from one to the
other.

Cost model mirrors av1_mv_bit_cost (mcomp.c:96): mvcost[] lookups are
replaced round-1 by the standard log2-based approximation
``mv_err_cost`` with sad_per_bit weighting (mvsad_err_cost analogue). The
cost grid is made on the host (numpy float32, as the reference's numpy
branch; its jnp branch gives the same grids at radius 3-32, weights 1-13)
and added to the SAD as an int32 table.

``subpel_refine`` and ``batched_subpel_refine`` take numpy arrays (the
host branch, the reference's numpy code) or tensors (the counterpart of
its jnp branch). On tensors ``subpel_refine`` scores each level's 9
neighbours with one ``convolve.subpel_predict`` (kernel KL on the card)
and an int64 SAD, and moves the centre on the host; kernel KM
``subpel_refine49`` (``csrc/mvsearch.cu``) replaces the jnp branch of
``batched_subpel_refine`` (``aom_av1_psy_tpu/ops/mvsearch.py:195-223``):
the 49-point quarter-pel lattice, each candidate through the facade path
its phases select, the SAD and the first-index argmin.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import convolve as C
from ..kernels.build import CudaKernel, I, P

KJ = CudaKernel("mvsearch", {
    # src, win, B, h, w, wh, ww, m, stride, cost, best_idx, best_sad
    "fullpel_sad": [P, P, I, I, I, I, I, I, I, P, P, P],
    # src, plane, H, W, oy, ox, B, h, w, m, cost, best_idx, best_sad
    "fullpel_sad_plane": [P, P, I, I, P, P, I, I, I, I, P, P, P],
})
KM = CudaKernel("subpel_refine49", {
    # src, win, B, w, h, tabx, taby, bd, best_idx, best_sad
    "subpel_refine49": [P, P, I, I, I, P, P, I, P, P],
}, source="mvsearch")

# blocks per chunk of the plain version: (chunk, h, m, w) int32 per row
# offset, 138 MB at 1024 blocks of 32x32 and m = 33
_CHUNK = 1024


def _xp(x):
    """numpy, the array type of the host branches."""
    if isinstance(x, np.ndarray):
        return np
    raise TypeError(f"numpy array expected, got {type(x).__name__}")


# ---------------------------------------------------------------------------
# Full-pel dense grid search
# ---------------------------------------------------------------------------

def mv_cost_bits(dr, dc, weight: int = 0):
    """Approximate rate cost of an MV residual, in SAD-comparable units
    (analogue of mvsad_err_cost, mcomp.c:115: the exact table-driven
    cost is joint-class + component bits; round-1 uses the dominant
    magnitude term 2*log2(1+|d|) bits per component). Host numpy."""
    xp = _xp(dr) if not isinstance(dr, (int, float)) else np
    bits = 2.0 * (xp.log2(1.0 + xp.abs(dr)) + xp.log2(1.0 + xp.abs(dc)))
    return (bits * weight).astype(xp.int32) if weight else \
        xp.zeros_like(bits, dtype=xp.int32)


def _cost_grid(radius: int, sad_per_bit: int):
    """The (n, n) int32 cost added to every SAD (n = 2 * radius + 1)."""
    dr = np.arange(2 * radius + 1) - radius
    return mv_cost_bits(dr[:, None].astype(np.float32),
                        dr[None, :].astype(np.float32), sad_per_bit)


def sad_argmin_plain(src, win, m: int, stride: int = 1, cost=None):
    """Plain version of KJ. src (B, h, w), win (B, h + (m-1)*stride + e,
    w + ...): the candidate at grid point (ky, kx) is the window's (h, w)
    patch at (ky * stride, kx * stride). ``cost`` (m*m,) int32 or None is
    added to each SAD. Returns (flat index (B,) int64, dy-major, first
    index on ties; SAD + cost (B,) int32)."""
    B, h, w = src.shape
    s32 = src.to(torch.int32)
    w32 = win.to(torch.int32)
    idx, best = [], []
    for i in range(0, B, _CHUNK):
        s = s32[i:i + _CHUNK, :, None, :]                    # (b, h, 1, w)
        sad = []
        for ky in range(m):
            rows = w32[i:i + _CHUNK, ky * stride:ky * stride + h, :]
            cand = rows.unfold(2, w, stride)[:, :, :m]       # (b, h, m, w)
            sad.append((cand - s).abs().sum((1, 3)))         # (b, m) int64
        flat = torch.stack(sad, 1).reshape(-1, m * m)
        if cost is not None:
            flat = flat + cost.to(flat.device, torch.int64)[None]
        k = flat.argmin(1)
        idx.append(k)
        best.append(flat.gather(1, k[:, None])[:, 0])
    return torch.cat(idx), torch.cat(best).to(torch.int32)


def _check_int32_cuda(what, *ts):
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.int32:
            raise ValueError(f"{what} input: want int32 on cuda, got "
                             f"{t.dtype} on {t.device}")


def _cost_ptr(cost, m: int, device):
    """(tensor kept alive, data pointer) of the (m * m,) int32 cost grid;
    (None, 0) without one."""
    if cost is None:
        return None, 0
    cost = cost.to(device, torch.int32).contiguous()
    if cost.numel() != m * m:
        raise ValueError(f"KJ: cost has {cost.numel()} entries, want {m * m}")
    return cost, cost.data_ptr()


def sad_argmin(src, win, m: int, stride: int = 1, cost=None):
    """``sad_argmin_plain``'s (flat index, SAD). CPU tensors: plain
    version; CUDA tensors: kernel KJ (int32 inputs, made contiguous)."""
    if src.device.type == "cpu":
        return sad_argmin_plain(src, win, m, stride, cost)
    B, h, w = src.shape
    wh, ww = win.shape[1:]
    if win.shape[0] != B or wh < h + (m - 1) * stride or \
            ww < w + (m - 1) * stride:
        raise ValueError(f"KJ: windows {tuple(win.shape)} too small for "
                         f"blocks {tuple(src.shape)}, m={m}, stride={stride}")
    _check_int32_cuda("KJ", src, win)
    src, win = src.contiguous(), win.contiguous()
    cost, cptr = _cost_ptr(cost, m, win.device)
    idx = torch.empty((B,), dtype=torch.int32, device=src.device)
    sad = torch.empty((B,), dtype=torch.int32, device=src.device)
    KJ.launch("fullpel_sad", src.data_ptr(), win.data_ptr(), B, h, w, wh, ww,
              m, stride, cptr, idx.data_ptr(), sad.data_ptr(),
              device=idx.get_device(),
              variant="dense" if stride == 1 else "coarse")
    return idx.long(), sad


def cut(plane, r0, c0, h: int, w: int):
    """(G, h, w) patches of ``plane`` at origins r0/c0 (G,)."""
    ar_h = torch.arange(h, device=plane.device)
    ar_w = torch.arange(w, device=plane.device)
    return plane[(r0[:, None] + ar_h[None])[:, :, None],
                 (c0[:, None] + ar_w[None])[:, None, :]]


def _clamped_origins(plane, oy, ox, wh: int, ww: int):
    H, W = plane.shape
    return (oy.to(plane.device, torch.int64).clamp(0, H - wh),
            ox.to(plane.device, torch.int64).clamp(0, W - ww))


def sad_argmin_plane_plain(src, plane, oy, ox, m: int, cost=None):
    """Plain version of KJ's plane entry: the (h + m - 1, w + m - 1)
    windows of ``plane`` (H, W) at origins oy/ox (B,) cut out (origins
    clamp to the plane, as in the kernel), then ``sad_argmin_plain`` at
    stride 1."""
    _, h, w = src.shape
    wh, ww = h + m - 1, w + m - 1
    oy, ox = _clamped_origins(plane, oy, ox, wh, ww)
    return sad_argmin_plain(src, cut(plane, oy, ox, wh, ww), m, 1, cost)


def sad_argmin_plane(src, plane, oy, ox, m: int, cost=None):
    """``sad_argmin_plane_plain``'s (flat index, SAD). CPU tensors: plain
    version; CUDA tensors: kernel KJ's plane entry, which reads each window
    where it lies (int32 src (B, h, w) and plane (H, W); origins of any
    integer type)."""
    if plane.device.type == "cpu":
        return sad_argmin_plane_plain(src, plane, oy, ox, m, cost)
    B, h, w = src.shape
    H, W = plane.shape
    if h + m - 1 > H or w + m - 1 > W:
        raise ValueError(f"KJ: plane {tuple(plane.shape)} smaller than a "
                         f"window of blocks {tuple(src.shape)}, m={m}")
    _check_int32_cuda("KJ", src, plane)
    oy = oy.to(plane.device, torch.int32).contiguous()
    ox = ox.to(plane.device, torch.int32).contiguous()
    if oy.shape != (B,) or ox.shape != (B,):
        raise ValueError(f"KJ: origins {tuple(oy.shape)} / "
                         f"{tuple(ox.shape)}, want ({B},)")
    src, plane = src.contiguous(), plane.contiguous()
    cost, cptr = _cost_ptr(cost, m, plane.device)
    idx = torch.empty((B,), dtype=torch.int32, device=plane.device)
    sad = torch.empty((B,), dtype=torch.int32, device=plane.device)
    KJ.launch("fullpel_sad_plane", src.data_ptr(), plane.data_ptr(), H, W,
              oy.data_ptr(), ox.data_ptr(), B, h, w, m, cptr,
              idx.data_ptr(), sad.data_ptr(), device=idx.get_device(),
              variant="plane")
    return idx.long(), sad


def full_pel_grid_search_plain(src_blocks, ref_windows, radius: int,
                               sad_per_bit: int = 0):
    """``full_pel_grid_search`` through the plain version, whatever the
    tensors' device."""
    return _grid_search(
        lambda n, cost: sad_argmin_plain(src_blocks, ref_windows, n, 1, cost),
        src_blocks.device, radius, sad_per_bit)


def full_pel_grid_search(src_blocks, ref_windows, radius: int,
                         sad_per_bit: int = 0):
    """Exhaustive full-pel search over a square window, batched.

    src_blocks:  (B, h, w) source blocks.
    ref_windows: (B, h + 2*radius, w + 2*radius) reference windows whose
                 center (radius, radius) is the zero-MV position.
    Returns (mvs, best_sad): mvs (B, 2) int32 as (row, col) offsets in
    [-radius, radius], best_sad (B,) int32.

    Replaces av1_full_pixel_search / exhaustive_mesh_search
    (mcomp.c:2015): a mesh search with step 1, evaluated as one dense
    batched scan (KJ on the card) instead of nested scalar loops.
    """
    return _grid_search(
        lambda n, cost: sad_argmin(src_blocks, ref_windows, n, 1, cost),
        src_blocks.device, radius, sad_per_bit)


def full_pel_plane_search_plain(src_blocks, plane, oy, ox, radius: int,
                                sad_per_bit: int = 0):
    """``full_pel_plane_search`` through the plain version, whatever the
    tensors' device."""
    return _grid_search(
        lambda n, cost: sad_argmin_plane_plain(src_blocks, plane, oy, ox, n,
                                               cost),
        src_blocks.device, radius, sad_per_bit)


def full_pel_plane_search(src_blocks, plane, oy, ox, radius: int,
                          sad_per_bit: int = 0):
    """``full_pel_grid_search`` on the windows of ``plane`` at origins
    oy/ox (B,): block b's window is ``plane[oy[b]:oy[b] + h + 2*radius,
    ox[b]:ox[b] + w + 2*radius]``, read where it lies (KJ's plane entry on
    the card; no window tensor is built). Same (mvs, best_sad)."""
    return _grid_search(
        lambda n, cost: sad_argmin_plane(src_blocks, plane, oy, ox, n, cost),
        src_blocks.device, radius, sad_per_bit)


def _grid_search(scan, device, radius, sad_per_bit):
    n = 2 * radius + 1
    cost = None
    if sad_per_bit:
        cost = torch.as_tensor(_cost_grid(radius, sad_per_bit).reshape(-1),
                               device=device)
    best, best_sad = scan(n, cost)
    mvs = torch.stack([best // n - radius, best % n - radius], 1)
    return mvs.to(torch.int32), best_sad


def full_pel_hierarchical(src_blocks, ref_windows, radius: int,
                          step: int = 4, sad_per_bit: int = 0):
    """Two-level grid search for big windows: coarse grid at `step`,
    then a dense refine of +/-(step-1) around the coarse winner.
    Keeps the candidate set small while covering the full window
    (the equivalent of NSTEP's shrinking diamonds, mcomp.c:1672).

    Two scans (KJ on the card): the coarse one with a candidate stride of
    ``step`` and no MV cost, then the dense one on the sub-window cut out
    by a torch gather (the reference's ``vmap`` + ``dynamic_slice``)."""
    B, h, w = src_blocks.shape
    n = 2 * radius + 1
    m = len(range(0, n, step))
    best, _ = sad_argmin(src_blocks, ref_windows, m, step)
    cr = best // m * step
    cc = best % m * step
    fine_r = step - 1
    fr0 = (cr - fine_r).clamp(0, n - 1 - 2 * fine_r)
    fc0 = (cc - fine_r).clamp(0, n - 1 - 2 * fine_r)
    dev = src_blocks.device
    rows = fr0[:, None] + torch.arange(h + 2 * fine_r, device=dev)[None]
    cols = fc0[:, None] + torch.arange(w + 2 * fine_r, device=dev)[None]
    sub = ref_windows[torch.arange(B, device=dev)[:, None, None],
                      rows[:, :, None], cols[:, None, :]]
    mv_f, best_sad = full_pel_grid_search(src_blocks, sub, fine_r,
                                          sad_per_bit)
    mvs = torch.stack([mv_f[:, 0] + fr0 + fine_r - radius,
                       mv_f[:, 1] + fc0 + fine_r - radius], 1)
    return mvs.to(torch.int32), best_sad


# ---------------------------------------------------------------------------
# Subpel refinement
# ---------------------------------------------------------------------------

_NEIGH8 = np.array([(-1, -1), (-1, 0), (-1, 1),
                    (0, -1), (0, 0), (0, 1),
                    (1, -1), (1, 0), (1, 1)], np.int32)


def _subpel_pred_one(ref_pad, w, h, mv8_r, mv8_c, interp):
    """Prediction at 1/8-pel MV (mv8_*), ref_pad origin at [3+?,3+?].

    AV1 MVs are 1/8-pel but the convolve phase grid is 1/16
    (subpel = (mv & 7) << 1, reconinter.h:au (fractional part doubled))."""
    fr, sr = mv8_r >> 3, (mv8_r & 7) << 1
    fc, sc = mv8_c >> 3, (mv8_c & 7) << 1
    reg = ref_pad[fr : fr + h + 7, fc : fc + w + 7]
    return C.predict_subpel(reg, w, h, sc, sr, interp, interp)


def subpel_refine(src_block, ref_padded, mv_fullpel, levels: int = 3,
                  interp: int = C.EIGHTTAP_REGULAR):
    """Refine a full-pel MV to 1/2, 1/4, 1/8 pel by evaluating all 8
    neighbours at each precision level and keeping the SAD winner
    (parallel-evaluation analogue of av1_find_best_sub_pixel_tree,
    mcomp.c:3331: same candidate set, no early-termination pruning).

    src_block:  (h, w).
    ref_padded: window around the full-pel winner with >= levels of halo:
                origin [4,4] == full-pel MV position minus the (3,3)
                filter tap offset, i.e. shape (h+7+2, w+7+2) minimum.
    mv_fullpel: (row, col) ints — returned MV is 1/8-pel units including
                this full-pel part.
    Returns ((mv8_r, mv8_c), best_sad).
    """
    if torch.is_tensor(src_block):
        return _subpel_refine_tensor(src_block, ref_padded, mv_fullpel,
                                     levels, interp)
    h, w = src_block.shape
    src = src_block.astype(np.int64)
    # work in 1/8-pel units relative to ref_padded origin + 1 full pel
    cur_r, cur_c = 8, 8   # full-pel center inside the 1-px halo
    best = None
    step = 4
    for _ in range(levels):
        preds = []
        for dr, dc in _NEIGH8:
            r8, c8 = cur_r + dr * step, cur_c + dc * step
            p = _subpel_pred_one(ref_padded, w, h, r8, c8, interp)
            preds.append(np.abs(np.asarray(p).astype(np.int64) - src).sum())
        k = int(np.argmin(preds))
        if best is None or preds[k] <= best:
            best = preds[k]
        cur_r += int(_NEIGH8[k, 0]) * step
        cur_c += int(_NEIGH8[k, 1]) * step
        step >>= 1
    mv8_r = (mv_fullpel[0] - 1) * 8 + cur_r
    mv8_c = (mv_fullpel[1] - 1) * 8 + cur_c
    return (int(mv8_r), int(mv8_c)), int(best)


def batched_subpel_refine(src_blocks, ref_windows, mvs_fullpel,
                          interp: int = C.EIGHTTAP_REGULAR):
    """Vectorized one-level half+quarter refine for a batch (used by the
    analyze pipeline): evaluates the 49-point 1/4-pel lattice around each
    full-pel winner in one batched convolve sweep.

    src_blocks (B,h,w); ref_windows (B,h+9,w+9) centered so [4,4] is the
    full-pel winner minus the tap offset. Returns (B,2) 1/8-pel MVs and
    (B,) SADs. Tensors: KM on the card, the plain version on the CPU
    (int32 results either way)."""
    if torch.is_tensor(src_blocks):
        best, best_sad = subpel_refine49(src_blocks, ref_windows, interp)
        mv8 = mvs_fullpel.to(torch.int32) * 8 + \
            _lattice_on(str(src_blocks.device))[best]
        return mv8.to(torch.int32), best_sad.to(torch.int32)
    xp = _xp(src_blocks)
    B, h, w = src_blocks.shape
    src = src_blocks.astype(xp.int32)
    cands_sad = []
    cands_mv = []
    for dr in range(-3, 4):
        for dc in range(-3, 4):
            r8, c8 = 8 + dr * 2, 8 + dc * 2
            fr, sr = r8 >> 3, (r8 & 7) << 1
            fc, sc = c8 >> 3, (c8 & 7) << 1
            reg = ref_windows[:, fr : fr + h + 7, fc : fc + w + 7]
            p = C.predict_subpel(reg, w, h, sc, sr, interp, interp)
            cands_sad.append(xp.abs(p - src).sum(axis=(-1, -2)))
            cands_mv.append((dr * 2, dc * 2))
    sads = xp.stack(cands_sad, axis=1)            # (B, 49)
    best = xp.argmin(sads, axis=1)
    mvtab = xp.asarray(np.array(cands_mv, np.int32))
    mv8 = mvs_fullpel * 8 + mvtab[best]
    best_sad = xp.take_along_axis(sads, best[:, None], axis=1)[:, 0]
    return mv8.astype(xp.int32), best_sad.astype(xp.int32)


def _subpel_refine_tensor(src_block, ref_padded, mv_fullpel, levels, interp):
    """``subpel_refine`` on tensors: per level one ``subpel_predict`` of the
    9 neighbours (KL on the card) and their int64 SADs; the centre and
    ``best`` move on the host by the reference's rules."""
    h, w = src_block.shape
    dev = src_block.device
    src = src_block.to(torch.int64)
    cur_r, cur_c = 8, 8
    best = None
    step = 4
    for _ in range(levels):
        r8 = [cur_r + int(dr) * step for dr, _ in _NEIGH8]
        c8 = [cur_c + int(dc) * step for _, dc in _NEIGH8]
        regs = torch.stack([ref_padded[r >> 3:(r >> 3) + h + 7,
                                       c >> 3:(c >> 3) + w + 7]
                            for r, c in zip(r8, c8)]).to(torch.int32)
        ph = torch.tensor([[(c & 7) << 1 for c in c8],
                           [(r & 7) << 1 for r in r8]], dtype=torch.int32,
                          device=dev)
        p = C.subpel_predict(regs, w, h, ph[0], ph[1], interp, interp)
        preds = (p.to(torch.int64) - src).abs().sum((1, 2)).tolist()
        k = int(np.argmin(preds))
        if best is None or preds[k] <= best:
            best = preds[k]
        cur_r += int(_NEIGH8[k, 0]) * step
        cur_c += int(_NEIGH8[k, 1]) * step
        step >>= 1
    mv8_r = (mv_fullpel[0] - 1) * 8 + cur_r
    mv8_c = (mv_fullpel[1] - 1) * 8 + cur_c
    return (int(mv8_r), int(mv8_c)), int(best)


# the 49 lattice points of batched_subpel_refine, dr-major: (2*dr, 2*dc)
_LATTICE49 = np.array([(2 * dr, 2 * dc) for dr in range(-3, 4)
                       for dc in range(-3, 4)], np.int32)


@functools.cache
def _lattice_on(device: str) -> torch.Tensor:
    """``_LATTICE49`` as an int32 tensor on ``device``, uploaded once (the
    5i chain would otherwise copy it to the card at every call)."""
    return torch.as_tensor(_LATTICE49, device=device)


def subpel_refine49_plain(src_blocks, ref_windows,
                          interp: int = C.EIGHTTAP_REGULAR, bd: int = 8):
    """Plain version of KM, whatever the tensors' device: the reference's
    49-candidate loop (``predict_subpel_plain`` per lattice point, int64
    SADs) at bit depth ``bd``. src_blocks (B, h, w), ref_windows (B, h+9,
    w+9). Returns (index into the lattice (B,) int64, first on ties; SAD
    (B,) int64)."""
    B, h, w = src_blocks.shape
    src = src_blocks.to(torch.int64)
    sads = []
    for dr, dc in _LATTICE49 // 2:
        r8, c8 = 8 + 2 * int(dr), 8 + 2 * int(dc)
        reg = ref_windows[:, r8 >> 3:(r8 >> 3) + h + 7,
                          c8 >> 3:(c8 >> 3) + w + 7]
        p = C.predict_subpel_plain(reg, w, h, (c8 & 7) << 1, (r8 & 7) << 1,
                                   interp, interp, bd)
        sads.append((p.to(torch.int64) - src).abs().sum((-1, -2)))
    sads = torch.stack(sads, 1)
    best = sads.argmin(1)
    return best, sads.gather(1, best[:, None])[:, 0]


KM_MAX = 128      # AV1's largest block side


def check_km_block(w: int, h: int) -> None:
    """Raise ``ValueError`` unless kernel KM takes (w, h) blocks on the
    card: every w and h in 2..128. Above 128 (where AV1 has no block) the
    kernel would stage more than a CTA's shared memory: 141.8 KB of window,
    block and sums at 128x128."""
    for v in (w, h):
        if not 2 <= v <= KM_MAX:
            raise ValueError(f"KM: block {w}x{h}: the card takes w and h "
                             f"in 2..{KM_MAX}")


def subpel_refine49(src_blocks, ref_windows, interp: int = C.EIGHTTAP_REGULAR,
                    bd: int = 8):
    """``subpel_refine49_plain``'s (index, SAD). CPU tensors: the plain
    version; CUDA tensors: kernel KM (int32 blocks (B, h, w) with w, h in
    2..128, windows (B, >= h+9, >= w+9), bd 8..12)."""
    if src_blocks.device.type == "cpu":
        return subpel_refine49_plain(src_blocks, ref_windows, interp, bd)
    B, h, w = src_blocks.shape
    check_km_block(w, h)
    if not 8 <= bd <= 12:
        raise ValueError(f"KM: bit depth {bd} not in 8..12")
    if ref_windows.shape[0] != B or ref_windows.shape[1] < h + 9 or \
            ref_windows.shape[2] < w + 9:
        raise ValueError(f"KM: windows {tuple(ref_windows.shape)} too small "
                         f"for blocks {tuple(src_blocks.shape)}")
    for t in (src_blocks, ref_windows):
        if t.device != src_blocks.device or t.dtype != torch.int32:
            raise ValueError(f"KM input: want int32 on {src_blocks.device}, "
                             f"got {t.dtype} on {t.device}")
    src = src_blocks.contiguous()
    win = ref_windows[:, :h + 9, :w + 9].contiguous()
    dev = str(src.device)
    tx, ty = C._tap_table(interp, w, dev), C._tap_table(interp, h, dev)
    idx = torch.empty((B,), dtype=torch.int32, device=src.device)
    sad = torch.empty((B,), dtype=torch.int32, device=src.device)
    KM.launch("subpel_refine49", src.data_ptr(), win.data_ptr(), B, w, h,
              tx.data_ptr(), ty.data_ptr(), bd, idx.data_ptr(), sad.data_ptr(),
              device=idx.get_device(), variant=f"{w}x{h}")
    return idx.long(), sad.long()
