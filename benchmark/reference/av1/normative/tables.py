"""Loader for the normative AV1 tables (default CDFs, quant lookups, scans).

Data extracted once from the reference's normative tables
(``av1/common/token_cdfs.h``, ``entropymode.c``, ``quant_common.c``,
``scan.c``, ``av1_txfm.c`` — all AV1-spec constants) into
``data/tables.npz`` by ``tools/gen_tables.py``; committed so the framework
is standalone.

CDF convention: libaom stores "inverse CDFs" — entry ``i`` is
``32768 - cdf(i)`` (``AOM_ICDF``, aom_dsp/prob.h) — with one trailing slot
holding the adaptation counter (initially 0). The ec layer consumes exactly
this layout.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data", "tables.npz")


@functools.cache
def _npz():
    return np.load(_DATA)


@functools.cache
def _arrays() -> dict:
    """Every table, read from the archive once (an ``NpzFile`` reads and
    parses its member again at each access)."""
    z = _npz()
    return {k: z[k] for k in z.files}


def get(name: str) -> np.ndarray:
    """Fetch a table by name (see tools/dump_tables.c for the inventory): a
    copy, as the archive gave each caller its own array to adapt."""
    return _arrays()[name].copy()


@functools.cache
def scan_table(tx_size: int, tx_type: int) -> np.ndarray:
    """Scan order: array of raster positions in coding order, int16."""
    return _npz()[f"scan_ts{tx_size}_tt{tx_type}"].astype(np.int32)


@functools.cache
def dc_quant(qindex: int, bit_depth: int = 8) -> int:
    b = {8: 0, 10: 1, 12: 2}[bit_depth]
    return int(_npz()["dc_quant_qtx"][b, qindex])


@functools.cache
def ac_quant(qindex: int, bit_depth: int = 8) -> int:
    b = {8: 0, 10: 1, 12: 2}[bit_depth]
    return int(_npz()["ac_quant_qtx"][b, qindex])


def cospi(cos_bit: int) -> np.ndarray:
    """cospi[i] = round(cos(i*pi/128) * 2^cos_bit), cos_bit in 10..13."""
    return _npz()["cospi_arr"][cos_bit - 10].astype(np.int64)


def sinpi(cos_bit: int) -> np.ndarray:
    return _npz()["sinpi_arr"][cos_bit - 10].astype(np.int64)


# qctx bucketing for default coefficient CDFs (av1/common/entropy.c:24-29)
def coef_q_ctx(base_qindex: int) -> int:
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3
