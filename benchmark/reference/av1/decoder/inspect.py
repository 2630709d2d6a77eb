"""Frame inspection — the accounting/visualization surface of the
reference's ``av1/decoder/inspection.{h,c}`` (aomdx AV1_GET_ACCOUNTING /
--enable-inspection build, used by the AV1 analyzer).

The reference fills an ``insp_frame_data`` of per-MI ``insp_mi_data``
(mode, uv mode, mvs, ref frames, skip, tx size/type, cdef, q) through a
decode callback. Our decoder already keeps those grids as arrays for the
in-loop filters, so inspection is a cheap snapshot, not a parallel
bookkeeping pass.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FrameInspection:
    """Per-frame mi-grid snapshot (insp_frame_data analogue).

    All grids are (mi_rows, mi_cols); mvs is (mi_rows, mi_cols, 2) in
    1/8-pel (row, col) for ref 0.
    """

    frame_type: int
    show_frame: bool
    base_q_idx: int
    width: int
    height: int
    mi_rows: int
    mi_cols: int
    mode: np.ndarray        # AV1 intra/inter mode id per mi
    uv_mode: np.ndarray
    bsize: np.ndarray
    skip: np.ndarray
    is_inter: np.ndarray
    ref_frame0: np.ndarray  # LAST..ALTREF index, 0 = intra
    mv: np.ndarray
    tx_size: np.ndarray
    cdef_strength: np.ndarray  # transmitted index per mi (-1 where n/a)
    filter_level: tuple


def snapshot(dec) -> FrameInspection:
    """Build a FrameInspection from a decoded FrameDecoder (decoder/frame
    .py). Call after ``decode_packet`` via ``Av1Decoder.inspect()``."""
    fd = dec.fdec
    fh = dec.fh
    mvs = np.zeros((fd.mi_rows, fd.mi_cols, 2), np.int32)
    is_inter = np.zeros((fd.mi_rows, fd.mi_cols), np.int32)
    for r in range(fd.mi_rows):
        for c in range(fd.mi_cols):
            mb = fd.mi[r, c]
            if mb is not None and getattr(mb, "is_inter", False):
                is_inter[r, c] = 1
                mvs[r, c] = mb.mv[0]
    return FrameInspection(
        frame_type=fh.frame_type,
        show_frame=bool(fh.show_frame),
        base_q_idx=fh.quant.base_q_idx,
        width=fh.width, height=fh.height,
        mi_rows=fd.mi_rows, mi_cols=fd.mi_cols,
        mode=fd.mi_mode[: fd.mi_rows, : fd.mi_cols].copy(),
        uv_mode=fd.mi_uv_mode[: fd.mi_rows, : fd.mi_cols].copy(),
        bsize=fd.mi_bsize[: fd.mi_rows, : fd.mi_cols].copy(),
        skip=fd.mi_skip[: fd.mi_rows, : fd.mi_cols].copy(),
        is_inter=is_inter,
        ref_frame0=fd.mi_ref0[: fd.mi_rows, : fd.mi_cols].copy(),
        mv=mvs,
        tx_size=fd.mi_tx_size[: fd.mi_rows, : fd.mi_cols].copy(),
        cdef_strength=fd.mi_cdef[: fd.mi_rows, : fd.mi_cols].copy(),
        filter_level=(int(fh.lf.filter_level[0]),
                      int(fh.lf.filter_level[1]),
                      int(fh.lf.filter_level_u), int(fh.lf.filter_level_v)),
    )
