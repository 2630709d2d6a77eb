"""Rate estimation — CDF-based symbol costs and a cost-accumulating
encoder shim (av1/encoder/cost.{h,c}: av1_cost_symbol / av1_cost_literal;
mode_costs.c builds per-frame tables the same way).

Costs are in 1/512-bit units (AV1_PROB_COST_SHIFT = 9), matching
RDCOST's scaling (rd.h:31)."""
from __future__ import annotations

import numpy as np

PROB_COST_SHIFT = 9
CDF_TOP = 1 << 15


def symbol_cost(icdf, s: int) -> int:
    """Cost of coding symbol s against an inverse CDF, in 1/512 bits."""
    fl = int(icdf[s - 1]) if s > 0 else CDF_TOP
    fh = int(icdf[s])
    p = (fl - fh) / CDF_TOP
    if p <= 0:
        p = 1.0 / CDF_TOP
    return int(round(-np.log2(p) * (1 << PROB_COST_SHIFT)))


def cdf_cost_table(icdf, nsyms: int) -> np.ndarray:
    """Per-symbol costs for one CDF row."""
    return np.array([symbol_cost(icdf, s) for s in range(nsyms)], np.int64)


def literal_cost(bits: int) -> int:
    """av1_cost_literal: raw bits at p=1/2."""
    return bits << PROB_COST_SHIFT


class CostingEncoder:
    """Drop-in for ec.coder.Encoder that accumulates rate instead of
    writing; lets the exact write paths (e.g. write_coeffs_txb) double as
    rate estimators. CDF adaptation is disabled (cost estimation uses the
    frame-start CDFs, like the reference's per-frame cost tables)."""

    allow_update = False

    def __init__(self) -> None:
        self.cost = 0  # 1/512 bits

    def encode_cdf(self, s: int, icdf, nsyms: int) -> None:
        self.cost += symbol_cost(icdf, s)

    def encode_symbol(self, s: int, icdf, nsyms: int,
                      allow_update=None) -> None:
        self.cost += symbol_cost(icdf, s)

    def encode_bool_q15(self, val: int, f: int) -> None:
        p0 = f / (1 << 15)  # probability of the 0 branch
        p = (1.0 - p0) if val else p0
        p = min(max(p, 1.0 / CDF_TOP), 1.0 - 1.0 / CDF_TOP)
        self.cost += int(round(-np.log2(p) * (1 << PROB_COST_SHIFT)))

    def write_bit(self, bit: int) -> None:
        self.cost += 1 << PROB_COST_SHIFT

    def write_literal(self, data: int, bits: int) -> None:
        self.cost += bits << PROB_COST_SHIFT

    def bits(self) -> float:
        return self.cost / (1 << PROB_COST_SHIFT)


def rdcost(rdmult: int, rate: int, dist_sse: int) -> int:
    """RDCOST (rd.h:31): rate in 1/512 bits; the reference passes
    distortion pre-scaled by 16 (e.g. pixel_dist_visible's `<< 4`), so
    scale raw SSE here to keep the rd multiplier calibration."""
    return ((rate * rdmult + (1 << (PROB_COST_SHIFT - 1)))
            >> PROB_COST_SHIFT) + ((dist_sse << 4) << 7)


def compute_rd_mult(qindex: int, frame_type_kf: bool = True) -> int:
    """av1_compute_rd_mult_based_on_qindex (rd.c:384), 8-bit KF path."""
    from ..normative import tables
    q = tables.dc_quant(qindex)
    rdmult = q * q
    mult = (3.3 + 0.0015 * q) if frame_type_kf else (4.25 + 0.001 * q)
    return max(int(rdmult * mult), 1)


def coeff_rate_tables(fc, tx_size: int, plane_type: int):
    """Decision-only per-|level| and per-eob-token cost tables for one
    (tx_size, plane) from the frame's CDFs (av1_cost_coeffs_txb's role,
    context-averaged: the device RD needs a context-free estimate, not
    the exact write-path rate, which ec/ computes on the host).

    Returns (lvl (16,) float32 incl. sign, eobtok (nsyms,) float32 incl.
    the eob-extra literal bits at each token) in 1/512-bit units.
    The golomb tail beyond |level| 15 is added on device.
    """
    from ..normative.txsize import txsize_entropy_ctx, TXSIZE_LOG2_MINUS4
    ectx = txsize_entropy_ctx(tx_size)
    base = fc.coeff_base_cdf[ectx][plane_type]          # (ctx, 5)
    br = fc.coeff_br_cdf[min(ectx, 3)][plane_type]      # (ctx, 5)
    # median over contexts: a plain mean overweights rare extreme
    # contexts (a zero would cost ~2 bits); the median tracks typical use
    base_cost = np.median(
        np.stack([cdf_cost_table(row, 4) for row in base]), 0)   # (4,)
    br_cost = np.median(
        np.stack([cdf_cost_table(row, 4) for row in br]), 0)
    sign = 1 << PROB_COST_SHIFT                         # ~1 bit
    lvl = np.zeros(16, np.float32)
    lvl[0] = base_cost[0]
    for l in range(1, 16):
        c = base_cost[min(l, 3)] + sign
        if l >= 3:
            k = l - 3
            for _ in range(4):       # at most 4 br symbols
                sym = min(k, 3)
                c += br_cost[sym]
                k -= sym
                if sym < 3:
                    break
        lvl[l] = c
    ems = int(TXSIZE_LOG2_MINUS4[tx_size])
    eob_cdf = getattr(fc, f"eob_flag_cdf{16 << ems}")[plane_type][0]
    nsyms = 5 + ems
    eobtok = cdf_cost_table(eob_cdf, nsyms).astype(np.float32)
    bits = np.asarray(
        [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9][:nsyms], np.float32)
    eobtok = eobtok + bits * (1 << PROB_COST_SHIFT)
    return lvl.astype(np.float32), eobtok
