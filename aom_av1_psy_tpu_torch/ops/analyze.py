"""Batched encode analysis — torch counterpart of
``aom_av1_psy_tpu/ops/analyze.py``.

One fused pipeline over a plane's whole n x n block grid:

  plane -> (B, n, n) block batch -> intra predictions for the 7 broadcast
  modes -> SSE mode decision -> exact integer forward transform ->
  fp-domain quantization -> eob over the default scan

Mode-decision predictions use source neighbours (the row above and the
column left of each block in the source), as in the reference.

``analyze_plane`` on a CUDA tensor is one launch of kernel KP
``analyze_blocks`` (``csrc/analyze.cu``) over all blocks; on a CPU tensor
it is ``analyze_plane_plain``, the same function in torch ops. The plain
helpers (``blockify`` ... ``quantize_fp``) are the reference's, on
tensors. Arithmetic is int32 with jnp's wraparound; the samples are 8-bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import CudaKernel, I, P
from ..normative import tables
from ..normative import txsize as TS
from ..normative.enums import TX_HEIGHT, TX_WIDTH, TxSize
from . import txfm as txfm_ops
from .intra import SMOOTH_WEIGHT_LOG2_SCALE, smooth_weights
from .txq import _programs, stage_table

# candidate modes in the batched search (DC, V, H, SMOOTH, SMOOTH_V,
# SMOOTH_H, PAETH) — the ones whose predictors are pure broadcasts
BATCH_MODES = (0, 1, 2, 9, 10, 11, 12)

KP = CudaKernel("analyze", {
    # plane, W, blocks, above, left, corner, B, n, sw, dc_q, ac_q, shift,
    # scan, stages, meta, mode, sse, levels, eob, totals
    "analyze_blocks": [P, I, P, P, P, P, I, I, P, I, I, I, P, P, P, P, P, P,
                       P, P],
})

# stages of the forward DCT program at each n that kernel KP's DCT pass is
# unrolled over (csrc/analyze.cu, KPShape::kStages)
KP_DCT_STAGES = {4: 3, 8: 5, 16: 7, 32: 9}


@functools.cache
def _kp_programs(n: int, device: str):
    """``_programs(n, device)`` once the table's forward DCT programs
    (columns, rows) are found to have the ``KP_DCT_STAGES[n]`` stages that
    KP is compiled for, and no stage clamp."""
    _, meta = stage_table(n)
    for prog in (0, 2):
        if meta[4 * prog + 1] != KP_DCT_STAGES[n] or meta[4 * prog + 3]:
            raise ValueError(
                f"KP: forward DCT program {prog} at n={n} has "
                f"{meta[4 * prog + 1]} stages, clamp {meta[4 * prog + 3]}; "
                f"the kernel runs {KP_DCT_STAGES[n]}, no clamp")
    return _programs(n, device)


def blockify(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) -> (B, n, n) raster-ordered blocks. H, W multiples of n."""
    h, w = plane.shape
    return (plane.reshape(h // n, n, w // n, n)
            .permute(0, 2, 1, 3)
            .reshape(-1, n, n))


def unblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n = blocks.shape[-1]
    return (blocks.reshape(h // n, w // n, n, n)
            .permute(0, 2, 1, 3)
            .reshape(h, w))


def _edges_from_source(plane: torch.Tensor, n: int):
    """Above row / left col per block, from source neighbors.

    above: (B, n), left: (B, n), corner: (B,). Edge blocks fall back to the
    AV1 defaults (127 above / 129 left / 128 corner)."""
    h, w = plane.shape
    kw = {"dtype": plane.dtype, "device": plane.device}
    above_rows = torch.cat([torch.full((1, w), 127, **kw),
                            plane[n - 1 :: n][:-1]], 0)
    above = blockify(above_rows.repeat_interleave(n, 0), n)[:, 0, :]
    left_cols = torch.cat([torch.full((h, 1), 129, **kw),
                           plane[:, n - 1 :: n][:, :-1]], 1)
    left = blockify(left_cols.repeat_interleave(n, 1), n)[:, :, 0]
    corner_grid = torch.full((h // n + 1, w // n + 1), 128, **kw)
    corner_grid[1:, 1:] = plane[n - 1 :: n, n - 1 :: n]
    corner = corner_grid[:-1, :-1].reshape(-1)
    return above, left, corner


@functools.cache
def _smooth_weights_on(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(smooth_weights(n).astype(np.int32), device=device)


def predict_modes(above: torch.Tensor, left: torch.Tensor,
                  corner: torch.Tensor, n: int) -> torch.Tensor:
    """All BATCH_MODES predictions: returns (M, B, n, n) int32."""
    above = above.to(torch.int32)
    left = left.to(torch.int32)
    corner = corner.to(torch.int32)
    b = above.shape[0]
    a2 = above[:, None, :]  # (B,1,n)
    l2 = left[:, :, None]  # (B,n,1)
    c2 = corner[:, None, None]
    full = (b, n, n)

    dc = ((above.sum(1, dtype=torch.int32) + left.sum(1, dtype=torch.int32)
           + n).div(2 * n, rounding_mode="floor"))[:, None, None]
    sw = _smooth_weights_on(n, str(above.device))
    scale = 1 << SMOOTH_WEIGHT_LOG2_SCALE
    below = left[:, -1][:, None, None]
    right = above[:, -1][:, None, None]
    wh = sw[None, :, None]
    ww = sw[None, None, :]
    smooth = (wh * a2 + (scale - wh) * below + ww * l2
              + (scale - ww) * right + scale) >> (SMOOTH_WEIGHT_LOG2_SCALE + 1)
    smooth_v = (wh * a2 + (scale - wh) * below
                + (scale >> 1)) >> SMOOTH_WEIGHT_LOG2_SCALE
    smooth_h = (ww * l2 + (scale - ww) * right
                + (scale >> 1)) >> SMOOTH_WEIGHT_LOG2_SCALE

    base = l2 + a2 - c2
    pl, pt, ptl = (base - l2).abs(), (base - a2).abs(), (base - c2).abs()
    paeth = torch.where((pl <= pt) & (pl <= ptl), l2,
                        torch.where(pt <= ptl, a2, c2))

    return torch.stack([t.expand(full) for t in
                        (dc, a2, l2, smooth, smooth_v, smooth_h, paeth)])


def quantize_fp(coeff_flat: torch.Tensor, dc_q: int, ac_q: int,
                shift: int) -> torch.Tensor:
    """fp-domain quantization: level = round(F << shift / dqv)."""
    dqv = torch.full((coeff_flat.shape[-1],), ac_q, dtype=coeff_flat.dtype,
                     device=coeff_flat.device)
    dqv[0] = dc_q
    scaled = coeff_flat.abs() << shift
    lv = (scaled + (dqv >> 1)).div(dqv, rounding_mode="floor")
    return coeff_flat.sign() * lv


@functools.cache
def _scan_on(tx_size: int, device: str) -> torch.Tensor:
    scan = tables.scan_table(TS.adjusted_tx_size(tx_size), 0)
    return torch.as_tensor(scan.astype(np.int32), device=device)


def _check_tx(n: int, tx_size: int) -> None:
    if n not in (4, 8, 16, 32) or int(TX_WIDTH[tx_size]) != n \
            or int(TX_HEIGHT[tx_size]) != n:
        raise ValueError(f"n = {n} with tx_size {tx_size}: the analysis "
                         "takes square n x n transforms, n in 4..32")


def analyze_blocks_plain(src, above, left, corner, dc_q: int, ac_q: int,
                         tx_size: int) -> dict:
    """Plain version of kernel KP on (B, n, n) source blocks and their
    edges (above, left (B, n); corner (B,)): per block the best mode index
    (into BATCH_MODES), its SSE, the quantized levels (B, n*n) in
    coefficient layout and the eob, all int32."""
    src = src.to(torch.int32)
    b, n = src.shape[0], src.shape[-1]
    preds = predict_modes(above, left, corner, n)  # (M,B,n,n)
    sse = ((preds - src[None]) ** 2).sum((-1, -2), dtype=torch.int32)
    best = sse.argmin(0)  # (B,), ties: the first mode
    best_pred = preds.gather(0, best[None, :, None, None]
                             .expand(1, b, n, n))[0]
    res = src - best_pred

    coeffs = txfm_ops.fwd_txfm2d(res, tx_size, 0)  # (B, n, n) W,H
    shift = TS.tx_scale(tx_size)
    levels = quantize_fp(coeffs.reshape(b, -1), dc_q, ac_q, shift)

    scanned = levels[:, _scan_on(tx_size, str(src.device)).long()]
    idx = torch.arange(1, scanned.shape[1] + 1, dtype=torch.int32,
                       device=src.device)
    eob = torch.where(scanned != 0, idx, torch.zeros_like(idx)).amax(1)
    return {"mode": best.to(torch.int32), "sse": sse.gather(0, best[None])[0],
            "levels": levels, "eob": eob}


def analyze_plane_plain(plane, dc_q: int, ac_q: int, n: int = 16,
                        tx_size: int = int(TxSize.TX_16X16)) -> dict:
    """Plain version of ``analyze_plane`` (any device)."""
    p = plane.to(torch.int32)
    above, left, corner = _edges_from_source(p, n)
    return analyze_blocks_plain(blockify(p, n), above, left, corner, dc_q,
                                ac_q, tx_size)


def _kernel_input(t, shape):
    if tuple(t.shape) != shape:
        raise ValueError(f"KP input: want {shape}, got {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def _launch_kp(n: int, tx_size: int, dc_q: int, ac_q: int, plane=None,
               edges=None):
    """One KP launch over a plane (``plane`` (H, W)) or over blocks and
    their edges (``edges`` = (blocks, above, left, corner)), the latter
    with the two totals. Returns the dict of ``analyze_blocks_plain`` (and
    "totals", (2,) int64, for blocks)."""
    if plane is not None:
        h, w = plane.shape
        B = (h // n) * (w // n)
        plane = plane.to(torch.int32).contiguous()
        ptrs = (plane.data_ptr(), w, 0, 0, 0, 0)
        dev = plane.device
    else:
        B = edges[0].shape[0]
        blocks, above, left, corner = (
            _kernel_input(t, s) for t, s in
            zip(edges, ((B, n, n), (B, n), (B, n), (B,)), strict=True))
        ptrs = (0, 0, blocks.data_ptr(), above.data_ptr(), left.data_ptr(),
                corner.data_ptr())
        dev = blocks.device
    out = {"mode": torch.empty((B,), dtype=torch.int32, device=dev),
           "sse": torch.empty((B,), dtype=torch.int32, device=dev),
           "levels": torch.empty((B, n * n), dtype=torch.int32, device=dev),
           "eob": torch.empty((B,), dtype=torch.int32, device=dev)}
    totals = None
    if edges is not None:
        totals = out["totals"] = torch.zeros((2,), dtype=torch.int64,
                                             device=dev)
    if B == 0:
        return out
    stages, meta = _kp_programs(n, str(dev))
    KP.launch("analyze_blocks", *ptrs, B, n,
              _smooth_weights_on(n, str(dev)).data_ptr(), dc_q, ac_q,
              TS.tx_scale(tx_size), _scan_on(tx_size, str(dev)).data_ptr(),
              stages.data_ptr(), meta.data_ptr(), out["mode"].data_ptr(),
              out["sse"].data_ptr(), out["levels"].data_ptr(),
              out["eob"].data_ptr(),
              0 if totals is None else totals.data_ptr(),
              variant=f"n{n}" + (" plane" if plane is not None else ""))
    return out


def analyze_plane(plane, dc_q: int, ac_q: int, n: int = 16,
                  tx_size: int = int(TxSize.TX_16X16), device="cuda"):
    """Full batched analysis of one plane with n×n blocks.

    ``plane``: (H, W) 8-bit samples (any integer dtype), H and W multiples
    of n; a tensor stays on its device, a numpy array goes to ``device``.
    Returns dict of per-block int32 tensors on that device: best mode index
    (into BATCH_MODES), SSE of the winner, quantized levels (B, n*n) in
    coeff layout, eob. CPU tensors: the plain version; CUDA tensors: one
    launch of kernel KP.
    """
    _check_tx(n, tx_size)
    if not torch.is_tensor(plane):
        plane = torch.as_tensor(np.asarray(plane),
                                device=resolve_device(device))
    h, w = plane.shape
    if h % n or w % n:
        raise ValueError(f"plane {h}x{w} is not a multiple of n = {n}")
    if plane.device.type == "cpu":
        return analyze_plane_plain(plane, dc_q, ac_q, n, tx_size)
    return _launch_kp(n, tx_size, dc_q, ac_q, plane=plane)


def analyze_blocks(blocks, above, left, corner, dc_q: int, ac_q: int,
                   tx_size: int):
    """The analysis of (B, n, n) blocks with the caller's edges (tensors
    on one device): (mode, levels, eob, tot_sse, tot_coeff), the totals
    0-d int32 sums of the blocks' SSE and eob, wrapped as int32 wraps.
    CPU tensors: the plain version; CUDA tensors: one launch of kernel
    KP."""
    n = blocks.shape[-1]
    _check_tx(n, tx_size)
    if any(t.device != blocks.device for t in (above, left, corner)):
        raise ValueError("blocks and edges must lie on one device")
    if blocks.device.type == "cpu":
        out = analyze_blocks_plain(blocks, above, left, corner, dc_q, ac_q,
                                   tx_size)
        totals = torch.stack([out["sse"].to(torch.int64).sum(),
                              out["eob"].to(torch.int64).sum()])
    else:
        out = _launch_kp(n, tx_size, dc_q, ac_q,
                         edges=(blocks, above, left, corner))
        totals = out["totals"]
    # exact int64 sums truncated to int32: the reference's psum of int32
    # shard sums, modulo 2**32
    tot = totals.to(torch.int32)
    return out["mode"], out["levels"], out["eob"], tot[0], tot[1]
