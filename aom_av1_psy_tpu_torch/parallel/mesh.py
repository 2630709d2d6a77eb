"""Cards in place of the reference's device mesh — torch counterpart of
``aom_av1_psy_tpu/parallel/mesh.py``.

``Mesh`` / ``make_mesh`` (``:26``) name the cards, in order, along the
"tiles" axis. The reference's two sharded programs each have two forms:

- ``sharded_analyze_step`` (``:32-75``) shards the block batch over the
  mesh, one KP launch per shard on its card, and reduces the frame totals
  as the reference's ``psum`` does (exact, truncated to int32);
  ``batched_analyze_step`` is the same step on one card, the mesh axis
  folded into KP's batch axis.
- ``tile_plans_sharded`` (``:78-185``) plans tile t on card t: each card
  gets its slab, and its own pair of wavefronts
  (``tpu_intra._luma_wavefront_part``, ``_chroma_wavefront_part``) runs
  there with that card current. Every card's wavefronts are queued before
  any plan is fetched (the fetch is the one wait per card), so one host
  thread keeps several cards busy. ``tile_plans_batched`` is the one-card
  form: the T slabs, their lambda grids and their edge-cell and position
  masks are stacked, and ONE pair of wavefronts walks the R + C - 1
  anti-diagonals of a slab, every step launching kernels KA and KB once
  for the cells of all T tiles on that diagonal. At 1080p with T = 2 that
  is 63 diagonal steps where the untiled frame walks 93.

Tiles are prediction-independent, so no edge is read across a slab, and
both forms give the plans of the reference's per-tile loop
(``tpu_frame.py:234-243``) and of its sharded run.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ec.context import FrameContext
from ..device import on_device, resolve_device
from ..encoder import tpu_intra as TI
from ..normative import tables
from ..ops import analyze as A
from ..ops.txfm import SQUARE_TX


class Mesh:
    """An ordered tuple of devices along one named axis ("tiles").

    A device may appear more than once (a one-card machine runs a mesh of
    ``cuda:0`` twice, the CPU tests ``cpu`` k times): each entry is one
    shard with its own inputs, outputs and launches. CUDA entries are
    given an index (the current device where none is named) and must
    exist; CPU and CUDA entries do not mix."""

    def __init__(self, devices, axis: str = "tiles"):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a mesh mixes CPU and CUDA devices: {devs}")
        devs = [resolve_device(d) for d in devs]
        if devs[0].type == "cuda":
            n = torch.cuda.device_count()
            devs = [torch.device("cuda", torch.cuda.current_device()
                                 if d.index is None else d.index)
                    for d in devs]
            if any(d.index >= n for d in devs):
                raise RuntimeError(f"mesh {devs}: this machine has {n} CUDA "
                                   "devices")
        self.devices = tuple(devs)
        self.axis = axis

    @property
    def type(self) -> str:
        return self.devices[0].type

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh([{', '.join(map(str, self.devices))}], "
                f"axis={self.axis!r})")


def make_mesh(n_devices: int | None = None, axis: str = "tiles",
              device="cuda") -> Mesh:
    """The first ``n_devices`` cards (all of them when None) as a mesh.
    Raises RuntimeError when fewer cards exist (the reference's quietly
    returns fewer); never pads with the CPU. ``device="cpu"``: a mesh of
    ``n_devices`` (default 1) CPU entries, for tests."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return Mesh(["cpu"] * (n_devices or 1), axis)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or have
    if n < 1 or n > have:
        raise RuntimeError(f"make_mesh({n_devices}): this machine has "
                           f"{have} CUDA devices")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def _upload(x, dev):
    """A numpy array or tensor as a tensor on ``dev``."""
    if torch.is_tensor(x):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def sharded_analyze_step(mesh: Mesh, n: int = 16, qindex: int = 100):
    """The encode-analysis step sharded over ``mesh``.

    Returns fn(blocks, above, left, corner) -> (modes, levels, eob,
    tot_sse, tot_coeff): blocks (B, n, n), above / left (B, n), corner
    (B,) 8-bit samples (tensors or numpy arrays), B a multiple of the mesh
    size (ValueError otherwise, as the reference's ``shard_map`` refuses).
    Shard s (the s-th run of B / S blocks) goes to ``mesh.devices[s]``,
    where one KP launch analyzes it with that card current (on the CPU,
    KP's plain version). The per-block int32 modes (into ``BATCH_MODES``),
    levels (B, n*n) and eob come back as one tensor each on
    ``mesh.devices[0]``, in batch order; the frame totals of the winners'
    SSE and of the eobs are the shards' sums added there in int64 and
    truncated to 0-d int32, which equals modulo 2**32 the reference's
    int32 ``psum`` of int32 shard sums."""
    dc_q, ac_q = tables.dc_quant(qindex), tables.ac_quant(qindex)
    tx_size = SQUARE_TX[n]
    S, dev0 = len(mesh), mesh.devices[0]

    def fn(blocks, above, left, corner):
        B = blocks.shape[0]
        if B % S:
            raise ValueError(f"batch {B} does not divide over a mesh of {S}")
        m = B // S
        shards = []
        for s, dev in enumerate(mesh.devices):
            part = [_upload(x[s * m:(s + 1) * m], dev)
                    for x in (blocks, above, left, corner)]
            with on_device(dev):
                shards.append(A.analyze_blocks(*part, dc_q, ac_q, tx_size))
        modes, levels, eob = (torch.cat([sh[i].to(dev0) for sh in shards])
                              for i in range(3))
        tot_sse, tot_coeff = (
            torch.stack([sh[i].to(dev0) for sh in shards])
            .to(torch.int64).sum().to(torch.int32) for i in (3, 4))
        return modes, levels, eob, tot_sse, tot_coeff

    return fn


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

    def placed(x):
        if not torch.is_tensor(x):
            return torch.as_tensor(np.asarray(x), device=dev)
        if x.device.type != dev.type:
            raise ValueError(f"input on {x.device}, step on {dev}")
        return x

    def fn(blocks, above, left, corner):
        return A.analyze_blocks(*map(placed, (blocks, above, left, corner)),
                                dc_q, ac_q, tx_size)

    return fn


def tile_plans_sharded(mesh: Mesh, slabs: list, q: int, mi_rows: int):
    """Two-level intra plans of equal tile-column slabs, tile t on
    ``mesh.devices[t]`` (the reference's ``tile_plans_sharded``; ValueError
    unless the mesh has one device per slab).

    slabs: the per-tile dicts that ``tpu_intra.plan_tiles_part`` takes.
    The host tables are made once; each card gets its slab and its
    wavefronts (``start_tiles_part``, with the card current); only then is
    each card's plan fetched, in one device->host copy per card. Returns
    T plan dicts (the reference's keys and dtypes; ``recon_dev`` on the
    tile's own card)."""
    if len(mesh) != len(slabs):
        raise ValueError(f"a mesh of {len(mesh)} devices for {len(slabs)} "
                         "tile slabs")
    shared = TI.slab_shared_inputs(slabs, q, FrameContext(q))
    started = [TI.start_tiles_part([sl], shared, mi_rows, dev)
              for sl, dev in zip(slabs, mesh.devices)]
    return [TI.fetch_tiles_part(x)[0] for x in started]


def tile_plans_batched(slabs: list, q: int, mi_rows: int, device="cuda"):
    """Two-level intra plans of equal tile-column slabs in one batched run.

    slabs: the per-tile dicts that ``tpu_intra.plan_tiles_part`` takes
    (planes, ``rd`` lambda grid, ``mi_cols_eff``, ``tile_mi_w``,
    ``vis_mi_w``). Returns a list of per-tile plan dicts (the reference's
    keys and dtypes; ``recon_dev`` on ``device``)."""
    return TI.plan_tiles_part(slabs, q, FrameContext(q), mi_rows,
                              resolve_device(device))
