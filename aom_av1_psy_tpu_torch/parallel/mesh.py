"""One GPU in place of the reference's device mesh — torch counterpart of
``aom_av1_psy_tpu/parallel/mesh.py``. ``make_mesh`` has no counterpart:
there is one card, and each sharded program becomes one batched program.

``batched_analyze_step`` is ``sharded_analyze_step`` (``:32-75``): the
reference shards the block batch over a "tiles" mesh and reduces the
frame totals with ``psum``; here the mesh axis is the batch axis of one
launch of kernel KP and ``psum`` is a sum.

``tile_plans_batched`` is ``tile_plans_sharded`` (``:78-185``).

The reference shards the equal SB-aligned tile slabs one per device under
``shard_map``, each device running the two-level plan of its slab. On one
GPU the tile axis is a batch axis instead: the T slabs, their lambda grids
and their edge-cell and position masks are stacked, and ONE pair of
wavefronts (``tpu_intra._luma_wavefront_part``, ``_chroma_wavefront_part``)
walks the R + C - 1 anti-diagonals of a slab, every step launching kernels
KA and KB once for the cells of all T tiles on that diagonal. Tiles are
prediction-independent, so no edge is read across a slab, and the plans
equal the reference's per-tile loop (``tpu_frame.py:234-243``). At 1080p
with T = 2 that is 63 diagonal steps where the untiled frame walks 93.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ec.context import FrameContext
from ..device import resolve_device
from ..encoder import tpu_intra as TI
from ..normative import tables
from ..ops import analyze as A
from ..ops.txfm import SQUARE_TX


def batched_analyze_step(n: int = 16, qindex: int = 100, device="cuda"):
    """The encode-analysis step of ``sharded_analyze_step`` on one device.

    Returns fn(blocks, above, left, corner) -> (modes, levels, eob,
    tot_sse, tot_coeff): blocks (B, n, n), above / left (B, n), corner
    (B,) 8-bit samples as tensors on ``device`` or numpy arrays (uploaded
    there); per-block int32 modes (into ``BATCH_MODES``), levels (B, n*n)
    and eob, and the frame totals of the winners' SSE and of the eobs as
    0-d int32 tensors. The totals are summed exactly and truncated to
    int32, so they wrap as the reference's int32 psum does at any mesh
    size. CUDA: one launch of kernel KP; CPU: its plain version."""
    dev = resolve_device(device)
    dc_q, ac_q = tables.dc_quant(qindex), tables.ac_quant(qindex)
    tx_size = SQUARE_TX[n]

    def on_device(x):
        if not torch.is_tensor(x):
            return torch.as_tensor(np.asarray(x), device=dev)
        if x.device.type != dev.type:
            raise ValueError(f"input on {x.device}, step on {dev}")
        return x

    def fn(blocks, above, left, corner):
        return A.analyze_blocks(*map(on_device, (blocks, above, left,
                                                 corner)),
                                dc_q, ac_q, tx_size)

    return fn


def tile_plans_batched(slabs: list, q: int, mi_rows: int, device="cuda"):
    """Two-level intra plans of equal tile-column slabs in one batched run.

    slabs: the per-tile dicts that ``tpu_intra.plan_tiles_part`` takes
    (planes, ``rd`` lambda grid, ``mi_cols_eff``, ``tile_mi_w``,
    ``vis_mi_w``). Returns a list of per-tile plan dicts (the reference's
    keys and dtypes; ``recon_dev`` on ``device``)."""
    return TI.plan_tiles_part(slabs, q, FrameContext(q), mi_rows,
                              resolve_device(device))
