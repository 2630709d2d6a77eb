"""All-intra plans — torch counterpart of
``aom_av1_psy_tpu/encoder/tpu_intra.py``: the two-level (32 -> 16)
partition plan (``plan_frame_part``; ``plan_tiles_part`` for T equal tile
slabs at once) and the uniform-grid fallback (``plan_frame``).

The reference runs each wavefront as one ``lax.scan`` over the
anti-diagonals of the block grid; here a host loop walks the R+C-1
diagonals and every step is kernel launches and nothing else: kernel KA's
pick (``ops/intra_pred.intra_pick``) reads each cell's edges from the
recon buffer, scores and prices all candidates, chooses the RD argmin and
predicts the winner in one launch, and kernel KB's in-place entry
(``ops/txq.TxqStep``) reads the source where it lies, quantizes,
reconstructs, (on the partition plan) makes the skip decision, prices the
two partition paths and chooses the split, and writes levels, eobs, recon
and the mode context into the plan's maps. A partition step is 5 picks +
5 KB launches, a uniform step 1 + 1; both kernels read the source planes
where they lie. The cells of a diagonal are known on the host, so only
the valid cells are processed (the reference computes padding lanes and
drops them) and the loop never waits for the device. The partition
wavefronts carry a leading tile axis: tiles are prediction-independent, so
the cells of one diagonal in all T slabs form one batch (a frame without
tile columns is T = 1). The plan reaches the host in one copy.

On a card the partition wavefronts are issued by what the plan's key
(``graph_key``: the grid, T, chroma, the card, the quantizers and
partition rates, the inputs' shapes) has seen before: the key's first plan
walks them eagerly, launch by launch; its second captures both walks and
the fetch's packing as one CUDA graph (``PlanGraph``, at most
``GRAPHS_PER_DEVICE`` keys a card) and replays it; every later plan copies
its inputs into the graph's static tensors and replays it, one graph
launch for the 1240 kernel launches of a 720p frame. The graph's outputs
live in its own memory and are overwritten by its next replay, so the
fetch copies all it returns (host arrays and ``recon_dev`` planes of their
own). CPU tensors and the uniform grid always run eagerly.

The plans' host inputs, their upload and the one-copy fetch are
``encoder/plan_inputs``' (the KEY plan's in two parts: ``shared_inputs``
once a frame, ``slab_inputs`` for the slabs of one card). The building
blocks keep the reference's names: ``_predict_all_modes`` is KA's plain
half (``ops/intra_pred.py``); ``_quantize``, ``_dequantize``,
``_coeff_rate_est`` and ``_skip_rd`` are KB's (``ops/txq.py``); the host
tables ``_plan_cost_tables*``, ``_rate_tables``, ``_part_rate_scalars``,
``_scan`` and ``plan_part_supported`` are ``plan_inputs``'.
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..normative.enums import TxSize
from .. import convert
from ..device import on_device, resolve_device
from ..kernels.build import launches_total
from ..ops import intra_pred as IP
from ..ops import txq as TQ
from ..utils import trace
from . import plan_inputs as PI
from . import tpu_intra_dir as DIR
from .plan_inputs import (PLAN_MODES, plan_part_supported,  # noqa: F401
                          part_rate_scalars as _part_rate_scalars,
                          plan_cost_tables as _plan_cost_tables,
                          plan_cost_tables2 as _plan_cost_tables2,
                          rate_tables as _rate_tables, scan_order as _scan)

BS_TO_TX = {4: int(TxSize.TX_4X4), 8: int(TxSize.TX_8X8),
            16: int(TxSize.TX_16X16), 32: int(TxSize.TX_32X32)}
_QUADS = ((0, 0), (0, 1), (1, 0), (1, 1))

_predict_all_modes = IP.predict_all_modes
_quantize = TQ.quantize
_dequantize = TQ.dequantize
_coeff_rate_est = TQ.coeff_rate_est
_skip_rd = TQ.skip_rd
_uv_adst = TQ.uv_adst


def _tq_recon(src, pred, dc_q, ac_q, tx_size, scan):
    """(B,bs,bs) src/pred -> (levels (B,n), eob (B,), recon (B,bs,bs)),
    DCT_DCT."""
    assert BS_TO_TX[src.shape[-1]] == tx_size
    return TQ.tq_recon(src, pred, dc_q, ac_q, scan)


def _tq_recon_uv(src, pred, dc_q, ac_q, tx_size, scan, uv_mode):
    """Chroma TQ+recon with the tx type derived from the (B,) uv modes."""
    assert BS_TO_TX[src.shape[-1]] == tx_size
    va, ha = _uv_adst(uv_mode)
    return TQ.tq_recon(src, pred, dc_q, ac_q, scan, va, ha)


# ----------------------------------------------------------------------
# wavefronts
# ----------------------------------------------------------------------
@functools.cache
def _diagonals(R: int, C: int, T: int = 1):
    """Cells of each anti-diagonal d = r + c of T (R, C) grids, each
    tile's cells in the reference's lane order, tile after tile: flat
    tile/row/col arrays and per-diagonal offsets."""
    tiles, rows, cols, offs = [], [], [], [0]
    for d in range(R + C - 1):
        r = np.arange(max(0, d - (C - 1)), min(R - 1, d) + 1)
        tiles.append(np.repeat(np.arange(T), len(r)))
        rows.append(np.tile(r, T))
        cols.append(np.tile(d - r, T))
        offs.append(offs[-1] + T * len(r))
    return (np.concatenate(tiles), np.concatenate(rows),
            np.concatenate(cols), tuple(offs))


@functools.cache
def _diagonals_on(R: int, C: int, T: int, device: str):
    """``_diagonals``' tile, row and column arrays as int64 tensors on
    ``device``, uploaded once per shape and device (read-only), so that a
    wavefront queues no host copy (a copy would wait for the device)."""
    tiles, rows, cols, _ = _diagonals(R, C, T)
    return tuple(convert.to_device(a, device) for a in (tiles, rows, cols))


def _walk(R: int, C: int, device, T: int = 1, plane: str = "y"):
    """Yield (tt, rc, cc) int64 device tensors per diagonal: the tile, row
    and column of every cell of the diagonal in T grids. Under a profiler
    each step (the loop's body) is a ``plan.step`` span of ``plane``."""
    offs = _diagonals(R, C, T)[3]
    all_ = _diagonals_on(R, C, T, str(device))
    steps = trace.profiling()
    for d in range(R + C - 1):
        cells = tuple(a[offs[d]:offs[d + 1]] for a in all_)
        if steps:
            with trace.span("plan.step", plane=plane, diagonal=d,
                            cells=offs[d + 1] - offs[d]):
                yield cells
        else:
            yield cells


def _luma_wavefront_part(src, t: dict):
    """Two-level luma wavefront over 32px cells with the full candidate set
    (7 plain modes + the directional (mode, delta) pairs), over T tile
    slabs at once: tiles are prediction-independent, so every diagonal
    step runs the cells of all T tiles as one batch.

    A step is 5 KA picks and 5 KB launches (``ops/txq.TxqStep``): the 32
    pick and KB (which also fills each cell's local window from the recon
    buffer), then per 16 quad its pick (from the local window) and KB
    (recon into the window; quad (1, 1)'s launch takes the split and
    writes the chosen recon and mode context back).

    src: (T, R*32, C*32) int32 on the device; ``t`` the plan inputs as
    tensors (``plan_inputs.upload`` of ``slab_inputs``). Returns
    (split (T,R,C), m32 (AV1 mode), d32 (angle delta), lv32, eob32, m16,
    d16, lv16, eob16, recon (T, R*32, C*32))."""
    R, C = t["R"], t["C"]
    T = src.shape[0]
    dev = src.device
    masks = t["masks"]
    K = len(DIR.candidates())
    rd16, rd32 = t["rd16"], t["rd32"]
    H, W = R * 32, C * 32
    i32 = dict(dtype=torch.int32, device=dev)
    buf = torch.zeros((T, H + 2 + 32, W + 2 + 32), **i32)
    mode16 = torch.zeros((T, 2 * R, 2 * C), **i32)   # AV1 mode ctx map
    split_out = torch.zeros((T, R, C), **i32)
    m32o = torch.zeros((T, R, C), **i32)
    d32o = torch.zeros((T, R, C), **i32)
    lv32o = torch.zeros((T, R, C, 1024), **i32)
    e32o = torch.zeros((T, R, C), **i32)
    m16o = torch.zeros((T, 2 * R, 2 * C), **i32)
    d16o = torch.zeros((T, 2 * R, 2 * C), **i32)
    lv16o = torch.zeros((T, 2 * R, 2 * C, 256), **i32)
    e16o = torch.zeros((T, 2 * R, 2 * C), **i32)
    # the longest diagonal's cells: each one's local window (its edges and
    # its 32x32), its 32 recon and its two costs
    bmax = T * min(R, C)
    loc = torch.zeros((bmax, 34, 34), **i32)
    stage = torch.zeros((bmax, 32, 32), **i32)
    cost = torch.zeros((2, bmax), dtype=torch.float32, device=dev)
    common = dict(dc_q=t["dc_q"], ac_q=t["ac_q"], loc=loc, stage=stage,
                  cost=cost)
    kb32 = TQ.luma_cell_step(src, buf, lv32o[:, None], e32o[:, None],
                             scan=_scan(BS_TO_TX[32], str(dev)), rd=rd32,
                             rt=t["rt"]["y32"], pr_none=t["pr_none"],
                             **common)
    kb16 = TQ.luma_quad_step(src, buf, lv16o[:, None], e16o[:, None],
                             scan=_scan(BS_TO_TX[16], str(dev)), rd=rd16,
                             rt=t["rt"]["y16"], rd_cell=rd32,
                             forced=t["forced"], no_split=t["no_split"],
                             split=split_out, m32=m32o, m16=m16o,
                             mode16=mode16, pr_split=t["pr_split"], **common)
    # the luma pick's pricing: the neighbours' modes in the ctx map
    price = dict(mode_cost=t["kf_cost"], angle_cost=t["angle_cost"],
                 nbr=mode16, nbr_scale=2)

    for tt, rc, cc in _walk(R, C, dev, T):
        B = rc.shape[0]
        pick32, pred32 = IP.intra_pick(
            buf, tt, rc, cc, (src,), 32, K, rd32, **price,
            ok=(masks["ok1_32"], masks["ok2_32"], masks["ok3_32"]),
            mode_out=m32o, delta_out=d32o)
        kb32(tt, rc, cc, pick32, pred32)
        # the 4 sub-blocks, raster order, in the cells' local windows: the
        # top-right row is window row qr*16 cols 17..32, the bottom-left
        # column window col 0/16; the neighbours inside the cell are the
        # quads already chosen
        for qr, qc in _QUADS:
            pick16, pr = IP.intra_pick(
                loc[:B], tt, rc, cc, (src,), 16, K, rd16, local=True, qr=qr,
                qc=qc, scale=2, **price,
                ok=(masks["ok1_16"], masks["ok2_16"], masks["ok3_16"]),
                trreal=masks["trreal_16"], blreal=masks["blreal_16"],
                mode_out=m16o, delta_out=d16o)
            kb16(tt, rc, cc, pick16, pr, qr, qc)
    return (split_out, m32o, d32o, lv32o, e32o, m16o, d16o, lv16o, e16o,
            buf[:, 1:1 + H, 1:1 + W])


def _chroma_wavefront_part(src_u, src_v, t: dict, split32, y_m32, y_m16):
    """Two-level chroma wavefront over 16px chroma cells (4:2:0 mirror of
    the luma 32/16 partition) of T tile slabs at once. The structure
    follows the luma split map; both alternatives are reconstructed and
    selected by ``split32`` in quad (1, 1)'s KB launch. The U and V blocks
    of a step run as one batch of 2B blocks: a step is 5 KA picks and 5 KB
    launches, as in the luma wavefront.

    src_u/src_v: (T, R*16, C*16). Returns (uvm16 (T,R,C), uvlv16
    (T,2,R,C,256), uveob16 (T,2,R,C), uvm8 (T,2R,2C), uvlv8 (T,2,2R,2C,64),
    uveob8 (T,2,2R,2C), recon (2,T,H,W))."""
    R, C = t["R"], t["C"]
    T = src_u.shape[0]
    dev = src_u.device
    uv_cost = t["uv_cost"]
    rd16, rd32 = t["rd16"], t["rd32"]
    H, W = R * 16, C * 16
    i32 = dict(dtype=torch.int32, device=dev)
    bufs = torch.zeros((2, T, H + 2 + 16, W + 2 + 16), **i32)
    uvm16o = torch.zeros((T, R, C), **i32)
    uvlv16o = torch.zeros((T, 2, R, C, 256), **i32)
    uve16o = torch.zeros((T, 2, R, C), **i32)
    uvm8o = torch.zeros((T, 2 * R, 2 * C), **i32)
    uvlv8o = torch.zeros((T, 2, 2 * R, 2 * C, 64), **i32)
    uve8o = torch.zeros((T, 2, 2 * R, 2 * C), **i32)
    planes = bufs.view(2 * T, H + 2 + 16, W + 2 + 16)   # U tiles, V tiles
    bmax = T * min(R, C)
    locs = torch.zeros((2 * bmax, 18, 18), **i32)
    stage = torch.zeros((2 * bmax, 16, 16), **i32)
    common = dict(dc_q=t["dc_q"], ac_q=t["ac_q"], loc=locs, stage=stage)
    kb16 = TQ.chroma_cell_step(src_u, src_v, planes, uvlv16o, uve16o,
                               scan=_scan(BS_TO_TX[16], str(dev)), rd=rd32,
                               rt=t["rt"]["uv16"], **common)
    kb8 = TQ.chroma_quad_step(src_u, src_v, planes, uvlv8o, uve8o,
                              scan=_scan(BS_TO_TX[8], str(dev)), rd=rd16,
                              rt=t["rt"]["uv8"], split=split32, **common)

    for tt, rc, cc in _walk(R, C, dev, T, plane="uv"):
        B = rc.shape[0]
        pick16, pred = IP.intra_pick(planes, tt, rc, cc, (src_u, src_v), 16,
                                     7, rd32,
                                     uv_cost=uv_cost, nbr=y_m32,
                                     mode_out=uvm16o)
        kb16(tt, rc, cc, pick16, pred)
        for qr, qc in _QUADS:
            p8, pred = IP.intra_pick(
                locs[:2 * B], tt, rc, cc, (src_u, src_v), 8, 7, rd16,
                local=True, qr=qr, qc=qc, scale=2, uv_cost=uv_cost,
                nbr=y_m16, nbr_scale=2, mode_out=uvm8o)
            kb8(tt, rc, cc, p8, pred, qr, qc)
    return (uvm16o, uvlv16o, uve16o, uvm8o, uvlv8o, uve8o,
            bufs[:, :, 1:1 + H, 1:1 + W])


_LUMA_KEYS = ("split32", "y_mode32", "y_delta32", "y_levels32", "y_eob32",
              "y_mode16", "y_delta16", "y_levels16", "y_eob16")
_CHROMA_KEYS = ("uv_mode16", "uv_levels16", "uv_eob16", "uv_mode8",
                "uv_levels8", "uv_eob8")


def _wavefronts(srcs: list, t: dict):
    """Queue the luma wavefront and, with chroma planes, the chroma one
    over the T slabs of ``srcs`` ((y,) or (y, u, v), each (T, H, W)).
    Returns (named plan maps, recon planes (T, H, W) each, the maps
    packed by ``plan_inputs.pack16``), views of the tensors the
    wavefronts write."""
    luma = _luma_wavefront_part(srcs[0], t)
    named = dict(zip(_LUMA_KEYS, luma[:9]))
    recons = [luma[9]]
    if len(srcs) > 1:
        chroma = _chroma_wavefront_part(srcs[1], srcs[2], t,
                                        named["split32"], named["y_mode32"],
                                        named["y_mode16"])
        named.update(zip(_CHROMA_KEYS, chroma[:6]))
        recons += [chroma[6][0], chroma[6][1]]
    return named, recons, PI.pack16(named)


# ----------------------------------------------------------------------
# the partition wavefronts as one CUDA graph per key
# ----------------------------------------------------------------------
GRAPHS_PER_DEVICE = 4


def _leaves(srcs: list, t: dict) -> list:
    """The input tensors of a plan in a fixed order: the source planes,
    then the tensors of ``t`` by key, through its nested dicts, lists
    and tuples (every container ``_cloned`` copies)."""
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            for k in sorted(v):
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(srcs)
    walk(t)
    return out


def graph_key(srcs: list, t: dict) -> tuple:
    """What a captured pair of partition wavefronts bakes in: the cell
    grid ``R``, ``C``, the tile count T, whether chroma is planned, the
    card's index, the scalars the kernels take by value (``dc_q``,
    ``ac_q``, ``pr_none``, ``pr_split``), and the shape and dtype of every
    input tensor (``_leaves``). The inputs' values are not in it: each
    plan copies its own into the graph's static inputs."""
    return (t["R"], t["C"], srcs[0].shape[0], len(srcs) > 1,
            srcs[0].get_device(), t["dc_q"], t["ac_q"], t["pr_none"],
            t["pr_split"],
            tuple((tuple(x.shape), x.dtype) for x in _leaves(srcs, t)))


def _cloned(v):
    """``v`` with every tensor of its dicts, lists and tuples cloned."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: _cloned(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_cloned(x) for x in v)
    return v


class PlanGraph:
    """The partition wavefronts of one key (``graph_key``) on one card.

    The key's first plan runs eagerly: it uploads what the walk reads
    besides its inputs (``_diagonals_on``, ``_scan``, KB's programs, KA's
    table), so the second finds nothing left to upload. The second clones
    its inputs into the static tensors ``srcs`` and ``t``, captures both
    wavefronts and ``plan_inputs.pack16`` over them as one CUDA graph and
    replays it; every later plan copies its inputs into ``srcs`` and ``t``
    and replays. The plan maps, the scratch and each step's pick and
    prediction are allocated inside the capture, in the graph's memory
    pool, and zeroed by the graph on every replay; ``named``, ``recons``
    and ``flat`` view them and hold the latest replay's plan until the
    next. ``busy`` from a replay to its fetch: a plan of the key meanwhile
    (a mesh that names one card twice) runs eagerly."""

    def __init__(self):
        self.plans = 0
        self.graph = None
        self.srcs = self.t = None
        self.named = self.recons = self.flat = None
        self.busy = False

    def load(self, srcs: list, t: dict) -> bool:
        """Count a plan of the key; True where it takes the graph, its
        inputs then in the static tensors (cloned for the capture,
        copied on the card for a replay)."""
        self.plans += 1
        if self.plans == 1 or self.busy:
            return False
        if self.graph is None:
            self.srcs, self.t = _cloned(srcs), _cloned(t)
        else:
            for dst, src in zip(_leaves(self.srcs, self.t),
                                _leaves(srcs, t)):
                dst.copy_(src)
        self.busy = True
        return True

    def run(self) -> bool:
        """Replay the graph, capturing it first where there is none.
        True where it only replayed.

        The capture records on a stream of its own and runs nothing, so
        it neither waits for the card nor, as ``torch.cuda.graph`` does,
        collects garbage and empties the allocator's caches (the frames
        after it would allocate their memory afresh)."""
        replay_only = self.graph is not None
        if not replay_only:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(torch.cuda.Stream()):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.named, self.recons, self.flat = _wavefronts(
                        self.srcs, self.t)
                finally:
                    graph.capture_end()
            self.graph = graph
        self.graph.replay()
        return replay_only


class PlanGraphs:
    """The ``PlanGraph`` of each key on one card, the
    ``GRAPHS_PER_DEVICE`` most recently used (a dropped entry's graph and
    memory pool are freed once no started plan holds them)."""

    def __init__(self):
        self.entries = collections.OrderedDict()

    def get(self, key) -> PlanGraph:
        pg = self.entries.pop(key, None) or PlanGraph()
        self.entries[key] = pg
        while len(self.entries) > GRAPHS_PER_DEVICE:
            self.entries.popitem(last=False)
        return pg


_PLAN_GRAPHS = {}      # CUDA device index -> PlanGraphs


def _plan_graph(srcs: list, t: dict) -> PlanGraph | None:
    """The key's ``PlanGraph`` with this plan's inputs loaded where the
    plan takes the graph; None where it runs eagerly: CPU tensors, the
    key's first plan, a graph whose last plan waits for its fetch."""
    if srcs[0].device.type != "cuda":
        return None
    cache = _PLAN_GRAPHS.setdefault(srcs[0].get_device(), PlanGraphs())
    pg = cache.get(graph_key(srcs, t))
    return pg if pg.load(srcs, t) else None


def start_tiles_part(slabs: list, shared: dict, mi_rows: int,
                     device) -> dict:
    """First half of :func:`plan_tiles_part`: under ``device`` (the current
    device while it runs), upload the T slabs' planes and inputs
    (``plan_inputs.slab_inputs`` of ``shared``, the frame's
    ``plan_inputs.shared_inputs``) and queue the luma and chroma
    wavefronts. It waits for nothing on the
    device: the inputs go up before the first kernel is queued, so the
    host can go on to another card while this one computes. Returns the
    plan's device tensors for :func:`fetch_tiles_part`.

    On a card the wavefronts are walked eagerly on the key's first plan,
    captured as one CUDA graph on its second and replayed after
    (``PlanGraph``); a replayed plan's device tensors are the graph's
    own, valid until its next replay, so fetch it first.

    The inputs' host work and uploads (and the copies into a graph's
    static inputs) are the span ``plan.inputs``, the wavefronts' queuing
    (or the graph's replay) ``plan.submit``; the frame's record gains
    their seconds (``plan_inputs_s``, ``plan_submit_s``), the kernel
    launches made in the submit (``plan_launches``; a replay makes none)
    and ``plan_graph``, 1 where the submit replayed a captured graph (0
    where it walked eagerly or captured)."""
    R, C = shared["R"], shared["C"]
    with on_device(device):
        with trace.span("plan.inputs", into="plan_inputs_s"):
            t = PI.upload(PI.slab_inputs(shared, slabs, mi_rows), device)
            planes = ("y", "u", "v") if "u" in slabs[0] else ("y",)
            srcs = PI.upload([np.stack([s[p] for s in slabs])
                              for p in planes], device)
            # the walk's indices too go up before the first kernel is queued
            _diagonals_on(R, C, len(slabs), str(srcs[0].device))
            pg = _plan_graph(srcs, t)
        n0 = launches_total()
        with trace.span("plan.submit", into="plan_submit_s"):
            if pg is None:
                named, recons, flat = _wavefronts(srcs, t)
                replayed = False
            else:
                replayed = pg.run()
                named, recons, flat = pg.named, pg.recons, pg.flat
        trace.add("plan_launches", launches_total() - n0)
        trace.add("plan_graph", int(replayed))
    return {"named": named, "recons": recons, "flat": flat, "graph": pg,
            "T": len(slabs)}


def fetch_tiles_part(started: dict) -> list:
    """Second half of :func:`plan_tiles_part`: the one device->host copy
    of the plan arrays, and the T plan dicts (``recon_dev`` on the device
    the wavefronts ran on); the span ``plan.fetch`` (``plan_fetch_s``).
    Everything returned is a copy: the host arrays and each
    ``recon_dev`` plane (a contiguous clone) alias none of the
    wavefronts' tensors, which a graph's next replay overwrites."""
    with trace.span("plan.fetch", into="plan_fetch_s"):
        host = PI.fetch(started["named"], started["flat"])
        own = torch.contiguous_format
        plans = [{"part": True, **{k: v[i] for k, v in host.items()},
                  "recon_dev": [r[i].clone(memory_format=own)
                                for r in started["recons"]]}
                 for i in range(started["T"])]
    if started["graph"] is not None:
        started["graph"].busy = False
    return plans


def plan_tiles_part(slabs: list, q: int, fc, mi_rows: int, device):
    """Two-level plans of T equal tile slabs in one pair of wavefronts.

    slabs: list of dicts with ``y`` (and ``u``/``v`` unless monochrome)
    int32 numpy planes of one shape, an ``rd`` lambda (scalar or (2R, 2C)
    grid), ``mi_cols_eff`` (the slab's effective mi width for the edge-cell
    masks) and ``tile_mi_w`` / ``vis_mi_w`` (None: ``mi_cols_eff``).
    Returns T plan dicts (the reference's keys and dtypes; ``recon_dev``
    on ``device``) from one device->host copy: the frame's
    ``plan_inputs.shared_inputs``, :func:`start_tiles_part`, then
    :func:`fetch_tiles_part`."""
    return fetch_tiles_part(start_tiles_part(
        slabs, PI.shared_inputs(slabs, q, fc), mi_rows, device))


def plan_frame_part(src_planes, q, fc, rdmult, mi_rows, mi_cols,
                    fetch_recon=False, tile_mi_w=None, vis_mi_w=None,
                    device="cuda"):
    """Two-level (32 -> 16) partition plan over one frame (or one tile).

    src_planes: mi-aligned int32 numpy planes padded to multiples of 32
    (luma) / 16 (chroma). ``rdmult`` scalar or (2R, 2C) 16-granularity
    grid. ``tile_mi_w`` / ``vis_mi_w`` (tile columns): the tile's actual
    and visible mi widths, both ``mi_cols`` by default. Returns the plan
    dict consumed by the native part2 pack (the reference's keys and
    dtypes); ``recon_dev`` holds the recon planes as tensors on
    ``device``."""
    dev = resolve_device(device)
    slab = {"rd": rdmult, "mi_cols_eff": mi_cols, "tile_mi_w": tile_mi_w,
            "vis_mi_w": vis_mi_w, **dict(zip("yuv", src_planes))}
    plan = plan_tiles_part([slab], q, fc, mi_rows, dev)[0]
    if fetch_recon:
        plan["recon"] = [convert.to_host(r) for r in plan["recon_dev"]]
    return plan


# ----------------------------------------------------------------------
# the uniform-grid fallback (7 plain modes, TX == block size, no skip)
# ----------------------------------------------------------------------
def _luma_wavefront(src, mode_cost, angle_cost, dc_q, ac_q, rdmult, bs: int,
                    R: int, C: int):
    """Uniform-grid luma wavefront (the reference's ``_luma_wavefront``):
    per anti-diagonal, KA's pick chooses among the 7 plain modes of every
    block (priced from the chosen neighbours in the PLAN-index grid) and
    predicts the winner, and KB (``TxqStep``, no skip decision) quantizes
    and reconstructs it into the recon buffer: 1 pick + 1 KB per step.

    src: (R*bs, C*bs) int32; rdmult (R, C) float32. Returns (mode_idx
    (R,C) PLAN index, levels (R,C,n), eob (R,C), recon (R*bs, C*bs))."""
    dev = src.device
    H, W = R * bs, C * bs
    i32 = dict(dtype=torch.int32, device=dev)
    buf = torch.zeros((1, H + 2 + bs, W + 2 + bs), **i32)
    mode_grid = torch.zeros((1, R, C), **i32)         # chosen PLAN index
    levels_out = torch.zeros((R, C, bs * bs), **i32)
    eob_out = torch.zeros((R, C), **i32)
    kb = TQ.uniform_step(bs, src[None], buf, levels_out[None, None],
                         eob_out[None, None], dc_q=dc_q, ac_q=ac_q,
                         scan=_scan(BS_TO_TX[bs], str(dev)))
    for tt, rc, cc in _walk(R, C, dev):
        pick, pred = IP.intra_pick(buf, tt, rc, cc, (src[None],), bs,
                                   IP.N_PLAIN, rdmult[None],
                                   mode_cost=mode_cost, angle_cost=angle_cost,
                                   nbr=mode_grid, nbr_plan=True,
                                   mode_out=mode_grid)
        kb(tt, rc, cc, pick, pred)
    return mode_grid[0], levels_out, eob_out, buf[0, 1:1 + H, 1:1 + W]


def _chroma_wavefront(src_u, src_v, uv_cost, dc_q, ac_q, rdmult, y_mode_idx,
                      bs: int, R: int, C: int):
    """Uniform-grid joint U/V wavefront (the reference's
    ``_chroma_wavefront``): one mode per block from the summed U+V SSE,
    the U and V blocks of a step as one batch of 2B, the chroma tx type
    derived from the mode (ADST/DCT), no skip decision; 1 pick + 1 KB per
    step.

    Returns (mode_idx (R,C), levels (2,R,C,n), eob (2,R,C),
    recon (2, R*bs, C*bs))."""
    dev = src_u.device
    H, W = R * bs, C * bs
    i32 = dict(dtype=torch.int32, device=dev)
    bufs = torch.zeros((2, H + 2 + bs, W + 2 + bs), **i32)
    mode_grid = torch.zeros((1, R, C), **i32)
    levels_out = torch.zeros((2, R, C, bs * bs), **i32)
    eob_out = torch.zeros((2, R, C), **i32)
    kb = TQ.uniform_step(bs, src_u[None], bufs, levels_out[None],
                         eob_out[None], src_v=src_v[None], dc_q=dc_q,
                         ac_q=ac_q, scan=_scan(BS_TO_TX[bs], str(dev)))
    for tt, rc, cc in _walk(R, C, dev, plane="uv"):
        pick, pred = IP.intra_pick(
            bufs, tt, rc, cc, (src_u[None], src_v[None]), bs, IP.N_PLAIN,
            rdmult[None], uv_cost=uv_cost, nbr=y_mode_idx[None],
            nbr_plan=True, mode_out=mode_grid)
        kb(tt, rc, cc, pick, pred)
    return mode_grid[0], levels_out, eob_out, bufs[:, 1:1 + H, 1:1 + W]


def plan_frame(src_planes, q, bs, fc, rdmult, fetch_recon=False,
               device="cuda"):
    """Uniform-grid plan over one frame (the reference's ``plan_frame``).

    src_planes: mi-aligned int32 numpy planes (luma dims multiples of
    ``bs``); ``rdmult`` a scalar or a per-block (R, C) grid. Returns the
    plan dict consumed by the native uniform pack (the reference's keys and
    dtypes) from one device->host copy; ``recon_dev`` holds the recon
    planes on ``device``. Spans and counts as the partition plan's
    (:func:`start_tiles_part`, :func:`fetch_tiles_part`)."""
    dev = resolve_device(device)
    with trace.span("plan.inputs", into="plan_inputs_s"):
        kf_cost, angle_cost, uv_cost = PI.plan_cost_tables(fc)
        y = src_planes[0]
        R, C = y.shape[0] // bs, y.shape[1] // bs
        dc_q, ac_q = PI.quantizers(q)
        ins = [PI.lambda_grid(rdmult, R, C), y, kf_cost, angle_cost]
        if len(src_planes) > 1:
            ins += [src_planes[1], src_planes[2], uv_cost]
        rdgrid, *ins = PI.upload(ins, dev)
        _diagonals_on(R, C, 1, str(dev))
    n0 = launches_total()
    with trace.span("plan.submit", into="plan_submit_s"):
        ym, ylv, yeob, yrec = _luma_wavefront(*ins[:3], dc_q, ac_q, rdgrid,
                                              bs, R, C)
        named = {"y_mode": ym, "y_levels": ylv, "y_eob": yeob}
        recon_dev = [yrec.contiguous()]
        if len(src_planes) > 1:
            uvm, uvlv, uveob, uvrec = _chroma_wavefront(
                *ins[3:], dc_q, ac_q, rdgrid, ym, bs // 2, R, C)
            named.update(uv_mode=uvm, uv_levels=uvlv, uv_eob=uveob)
            recon_dev += [uvrec[0].contiguous(), uvrec[1].contiguous()]
    trace.add("plan_launches", launches_total() - n0)
    with trace.span("plan.fetch", into="plan_fetch_s"):
        plan = {"bs": bs, **PI.fetch(named, PI.pack16(named)),
                "recon_dev": recon_dev}
    if fetch_recon:
        plan["recon"] = [convert.to_host(r) for r in recon_dev]
    return plan
