"""The device plans' host inputs, their upload and their one-copy fetch,
for the KEY and uniform-grid plans (``tpu_intra``) and the inter plan
(``tpu_inter``): tables, lambda grids and edge rules carried over from
the reference's inline code (``aom_av1_psy_tpu/encoder/tpu_intra.py``,
``tpu_inter.py``; nothing of it is imported), the KEY plan's inputs in
two parts (``shared_inputs`` once a frame, ``slab_inputs`` for the slabs
one card plans), ``upload``, and ``pack16`` / ``fetch``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import convert
from ..ec.costs import cdf_cost_table, coeff_rate_tables
from ..normative import tables
from ..normative.enums import TxSize
from ..utils import trace
from . import tpu_intra_dir as DIR

# plan mode set: no top-right/bottom-left extensions, no edge filtering
PLAN_MODES = (0, 1, 2, 9, 10, 11, 12)  # DC V H SMOOTH SMOOTH_V SMOOTH_H PAETH


def quantizers(q: int) -> tuple:
    """(dc_q, ac_q) of qindex ``q``."""
    return tables.dc_quant(q), tables.ac_quant(q)


def _kf_costs(fc, modes) -> np.ndarray:
    """(5, 5, K) luma cost of each of the K ``modes`` per neighbour ctx."""
    return np.array([[cdf_cost_table(fc.kf_y_cdf[a][l], 13)[list(modes)]
                      for l in range(5)] for a in range(5)], np.int32)


def _angle_costs(fc, cands) -> np.ndarray:
    """(K,) angle-delta symbol cost of each (mode, delta) of ``cands`` (0
    for a non-directional mode)."""
    return np.array([cdf_cost_table(fc.angle_delta_cdf[m - 1], 7)[d + 3]
                     if 1 <= m <= 8 else 0 for m, d in cands], np.int32)


def _uv_costs(fc) -> np.ndarray:
    """(13, 7) chroma cost of each ``PLAN_MODES`` mode per luma mode, its
    angle-delta-0 symbol included."""
    return np.array([cdf_cost_table(fc.uv_mode_cdf[1][ym], 14)[
        list(PLAN_MODES)] for ym in range(13)], np.int32) \
        + _angle_costs(fc, [(m, 0) for m in PLAN_MODES])


def plan_cost_tables(fc):
    """kf (5, 5, 7), angle (7,) and uv (13, 7) of ``PLAN_MODES`` (the
    directional V / H at angle delta 0)."""
    return (_kf_costs(fc, PLAN_MODES),
            _angle_costs(fc, [(m, 0) for m in PLAN_MODES]), _uv_costs(fc))


def plan_cost_tables2(fc):
    """kf (5, 5, K) and angle (K,) of the K candidates of
    ``tpu_intra_dir.candidates``; uv (13, 7) as ``plan_cost_tables``'."""
    cands = DIR.candidates()
    return (_kf_costs(fc, [m for m, _, _ in cands]),
            _angle_costs(fc, [(m, d) for m, d, _ in cands]), _uv_costs(fc))


def rate_tables(fc):
    """Coefficient-rate tables per (tx size, plane) as numpy pairs
    (ec/costs.coeff_rate_tables). The level costs must be half-integers:
    the device sums them exactly in half units."""

    def pair(tx, pl):
        lvl, eob = coeff_rate_tables(fc, tx, pl)
        if not np.array_equal(lvl * 2, np.round(lvl * 2)):
            raise ValueError("coefficient level costs must be half-integers")
        return lvl, eob

    return {"y32": pair(int(TxSize.TX_32X32), 0),
            "y16": pair(int(TxSize.TX_16X16), 0),
            "uv16": pair(int(TxSize.TX_16X16), 1),
            "uv8": pair(int(TxSize.TX_8X8), 1)}


def part_rate_scalars(fc):
    """Default-CDF costs of PARTITION_NONE / PARTITION_SPLIT at the
    32x32 bsize (ctx: bsl=2, no-split neighbours) — decision-only."""
    t = cdf_cost_table(fc.partition_cdf[8], 10)
    return float(t[0]), float(t[3])


def lambda_grid(rdmult, R: int, C: int) -> np.ndarray:
    """``rdmult`` (a scalar or an (R, C) grid) as an (R, C) float32
    grid."""
    g = np.asarray(rdmult, np.float32)
    if g.ndim == 0:
        g = np.full((R, C), float(rdmult), np.float32)
    assert g.shape == (R, C), (g.shape, R, C)
    return g


def lambda_grids(rdmult, R: int, C: int) -> tuple:
    """The two-level plans' lambdas of an (R, C) grid of 32-px cells: the
    16-px grid rd16 (2R, 2C) of ``rdmult`` (a scalar or that grid) and the
    32-px grid rd32 (R, C), the geometric mean of the four 16 lambdas each
    cell covers."""
    rd16 = lambda_grid(rdmult, 2 * R, 2 * C)
    rd32 = np.exp(np.log(rd16).reshape(R, 2, C, 2).mean((1, 3))) \
        .astype(np.float32)
    return rd16, rd32


def plan_part_supported(mi_rows: int, mi_cols: int) -> bool:
    """True when every frame-edge cell has a square-leaf coding (a cell
    that the decoder implies SPLIT must not contain partial 16s)."""
    return mi_rows % 8 != 2 and mi_cols % 8 != 2


def edge_cell_masks(R: int, C: int, mi_rows: int, mi_cols: int):
    """(forced, no_split) (R, C) bool masks of the 32-px cells: splits the
    decoder implies at the frame edge (has_rows/has_cols false), and cells
    that must NOT split because a visited 16 sub-block would be partial
    (no square leaf available there). Shared by the intra and inter
    plans, as in the reference."""
    rr = 8 * np.arange(R)[:, None]
    cc = 8 * np.arange(C)[None, :]
    forced = ((rr + 4 >= mi_rows) | (cc + 4 >= mi_cols))
    no_split = np.zeros((R, C), bool)
    for qr in (0, 1):
        for qc in (0, 1):
            sr, sc = rr + 4 * qr, cc + 4 * qc
            visited = (sr < mi_rows) & (sc < mi_cols)
            partial = visited & ((sr + 2 >= mi_rows) | (sc + 2 >= mi_cols))
            no_split |= partial
    assert not (forced & no_split).any(), "unsupported mi dims for part2"
    return forced, no_split


def shared_inputs(slabs: list, q: int, fc) -> dict:
    """The inputs of the two-level plan that every slab of a frame
    shares, made once a frame (a ``plan.inputs`` span): the slabs' (R, C)
    cell grid, the quantizers, the mode cost tables, the coefficient-rate
    tables and the partition rates. ``slabs`` as
    ``tpu_intra.plan_tiles_part`` takes them."""
    with trace.span("plan.inputs", into="plan_inputs_s"):
        h, w = np.shape(slabs[0]["y"])
        kf_cost, angle_cost, uv_cost = plan_cost_tables2(fc)
        pr_none, pr_split = part_rate_scalars(fc)
        dc_q, ac_q = quantizers(q)
        return {"R": h // 32, "C": w // 32, "dc_q": dc_q, "ac_q": ac_q,
                "kf_cost": kf_cost, "angle_cost": angle_cost,
                "uv_cost": uv_cost, "pr_none": pr_none,
                "pr_split": pr_split, "rt": rate_tables(fc)}


def slab_inputs(shared: dict, slabs: list, mi_rows: int) -> dict:
    """The inputs of the T slabs that one card plans at once: ``shared``
    and, with a leading tile axis, each slab's 16/32 lambda grids
    (``lambda_grids`` of its ``rd``), its forced / no_split edge-cell
    masks (of its effective mi width ``mi_cols_eff``) and its candidate
    position masks (bounded by its actual and visible mi widths
    ``tile_mi_w`` / ``vis_mi_w``, both ``mi_cols_eff`` when None)."""
    R, C = shared["R"], shared["C"]
    tiles = []
    for s in slabs:
        mi_cols = s["mi_cols_eff"]
        tile_w, vis_w = s.get("tile_mi_w"), s.get("vis_mi_w")
        rd16, rd32 = lambda_grids(s["rd"], R, C)
        forced, no_split = edge_cell_masks(R, C, mi_rows, mi_cols)
        masks = DIR.position_masks(
            mi_rows, mi_cols if tile_w is None else tile_w,
            mi_cols if vis_w is None else vis_w, R, C)
        tiles.append({"rd16": rd16, "rd32": rd32, "forced": forced,
                      "no_split": no_split, "masks": masks})
    out = dict(shared)
    for k in ("rd16", "rd32", "forced", "no_split"):
        out[k] = np.stack([d[k] for d in tiles])
    out["masks"] = {k: np.stack([d["masks"][k] for d in tiles])
                    for k in tiles[0]["masks"]}
    return out


def upload(v, device):
    """Plan inputs (an array, or a dict, tuple or list of them, nested) as
    tensors on ``device``, every array through ``convert.to_device`` in
    order: bool and float32 arrays as they are, integer arrays as int32.
    Python scalars pass through unchanged."""
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, dict):
        return {k: upload(x, device) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(upload(x, device) for x in v)
    a = np.asarray(v)
    if a.dtype == np.bool_ or a.dtype == np.float32:
        return convert.to_device(a, device)
    if np.issubdtype(a.dtype, np.integer):
        return convert.to_device(a.astype(np.int32, copy=False), device)
    raise TypeError(f"unexpected table dtype {a.dtype}")


@functools.cache
def scan_order(tx_size: int, device: str):
    """The DCT_DCT scan of ``tx_size`` as an int32 tensor on ``device``,
    uploaded once per device (read-only)."""
    return convert.to_device(tables.scan_table(tx_size, 0).astype(np.int32),
                             device)


def pack16(named: dict) -> torch.Tensor:
    """Every plan array as one flat int16 tensor: all values fit int16
    (levels are clipped to +/-32767, the reference's ``_shrink_levels``
    downcast)."""
    return torch.cat([v.reshape(-1).to(torch.int16) for v in named.values()])


def fetch(named: dict, flat: torch.Tensor) -> dict:
    """Every plan array to the host in ONE device->host copy of
    ``flat``, ``pack16(named)``: int32 arrays of the plan's shapes
    (``split32`` uint8)."""
    host = convert.to_host(flat)
    out, off = {}, 0
    for k, v in named.items():
        n = v.numel()
        out[k] = host[off:off + n].reshape(tuple(v.shape)).astype(np.int32)
        off += n
    if "split32" in out:
        out["split32"] = out["split32"].astype(np.uint8)
    return out
