"""Tile columns on one GPU — torch counterpart of
``aom_av1_psy_tpu/parallel/mesh.py:tile_plans_sharded`` (``:78-185``).

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

from ..ec.context import FrameContext
from ..device import resolve_device
from ..encoder import tpu_intra as TI


def tile_plans_batched(slabs: list, q: int, mi_rows: int, device="cuda"):
    """Two-level intra plans of equal tile-column slabs in one batched run.

    slabs: the per-tile dicts that ``tpu_intra.plan_tiles_part`` takes
    (planes, ``rd`` lambda grid, ``mi_cols_eff``, ``tile_mi_w``,
    ``vis_mi_w``). Returns a list of per-tile plan dicts (the reference's
    keys and dtypes; ``recon_dev`` on ``device``)."""
    return TI.plan_tiles_part(slabs, q, FrameContext(q), mi_rows,
                              resolve_device(device))
