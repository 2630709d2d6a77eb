"""Normative AV1 enums and geometry tables.

Rebuilt from the AV1 specification; layout parity with the reference's
``av1/common/enums.h`` (block sizes :101-124, partition types :155-166,
tx sizes/types in ``aom_dsp/txfm_common.h:26+``).
"""
from __future__ import annotations

import enum

import numpy as np

# ---------------------------------------------------------------------------
# Superblock / MI geometry  (enums.h:34-56)
# ---------------------------------------------------------------------------
MAX_SB_SIZE_LOG2 = 7
MAX_SB_SIZE = 1 << MAX_SB_SIZE_LOG2  # 128
MI_SIZE_LOG2 = 2
MI_SIZE = 1 << MI_SIZE_LOG2  # 4 (mode-info unit is 4x4 luma pixels)
MAX_MIB_SIZE_LOG2 = MAX_SB_SIZE_LOG2 - MI_SIZE_LOG2
MAX_TILE_ROWS = 64
MAX_TILE_COLS = 64


class BlockSize(enum.IntEnum):
    """22 block sizes, BLOCK_4X4..BLOCK_16X64 (enums.h:101-124)."""

    BLOCK_4X4 = 0
    BLOCK_4X8 = 1
    BLOCK_8X4 = 2
    BLOCK_8X8 = 3
    BLOCK_8X16 = 4
    BLOCK_16X8 = 5
    BLOCK_16X16 = 6
    BLOCK_16X32 = 7
    BLOCK_32X16 = 8
    BLOCK_32X32 = 9
    BLOCK_32X64 = 10
    BLOCK_64X32 = 11
    BLOCK_64X64 = 12
    BLOCK_64X128 = 13
    BLOCK_128X64 = 14
    BLOCK_128X128 = 15
    BLOCK_4X16 = 16
    BLOCK_16X4 = 17
    BLOCK_8X32 = 18
    BLOCK_32X8 = 19
    BLOCK_16X64 = 20
    BLOCK_64X16 = 21


BLOCK_SIZES_ALL = 22

# width/height in pixels per BlockSize, indexable np arrays.
BLOCK_WIDTH = np.array(
    [4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64],
    dtype=np.int32,
)
BLOCK_HEIGHT = np.array(
    [4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16],
    dtype=np.int32,
)


class TxSize(enum.IntEnum):
    """19 transform sizes (txfm_common.h:26-45)."""

    TX_4X4 = 0
    TX_8X8 = 1
    TX_16X16 = 2
    TX_32X32 = 3
    TX_64X64 = 4
    TX_4X8 = 5
    TX_8X4 = 6
    TX_8X16 = 7
    TX_16X8 = 8
    TX_16X32 = 9
    TX_32X16 = 10
    TX_32X64 = 11
    TX_64X32 = 12
    TX_4X16 = 13
    TX_16X4 = 14
    TX_8X32 = 15
    TX_32X8 = 16
    TX_16X64 = 17
    TX_64X16 = 18


TX_SIZES_ALL = 19

TX_WIDTH = np.array(
    [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64], dtype=np.int32
)
TX_HEIGHT = np.array(
    [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16], dtype=np.int32
)


class TxType(enum.IntEnum):
    """16 2-D transform types (txfm_common.h:52+)."""

    DCT_DCT = 0
    ADST_DCT = 1
    DCT_ADST = 2
    ADST_ADST = 3
    FLIPADST_DCT = 4
    DCT_FLIPADST = 5
    FLIPADST_FLIPADST = 6
    ADST_FLIPADST = 7
    FLIPADST_ADST = 8
    IDTX = 9
    V_DCT = 10
    H_DCT = 11
    V_ADST = 12
    H_ADST = 13
    V_FLIPADST = 14
    H_FLIPADST = 15


TX_TYPES = 16


class TxType1D(enum.IntEnum):
    """1-D column/row transform kinds making up a TxType."""

    DCT = 0
    ADST = 1
    FLIPADST = 2
    IDTX = 3


# (vertical/column 1-D type, horizontal/row 1-D type) per TxType.
TX_TYPE_1D = {
    TxType.DCT_DCT: (TxType1D.DCT, TxType1D.DCT),
    TxType.ADST_DCT: (TxType1D.ADST, TxType1D.DCT),
    TxType.DCT_ADST: (TxType1D.DCT, TxType1D.ADST),
    TxType.ADST_ADST: (TxType1D.ADST, TxType1D.ADST),
    TxType.FLIPADST_DCT: (TxType1D.FLIPADST, TxType1D.DCT),
    TxType.DCT_FLIPADST: (TxType1D.DCT, TxType1D.FLIPADST),
    TxType.FLIPADST_FLIPADST: (TxType1D.FLIPADST, TxType1D.FLIPADST),
    TxType.ADST_FLIPADST: (TxType1D.ADST, TxType1D.FLIPADST),
    TxType.FLIPADST_ADST: (TxType1D.FLIPADST, TxType1D.ADST),
    TxType.IDTX: (TxType1D.IDTX, TxType1D.IDTX),
    TxType.V_DCT: (TxType1D.DCT, TxType1D.IDTX),
    TxType.H_DCT: (TxType1D.IDTX, TxType1D.DCT),
    TxType.V_ADST: (TxType1D.ADST, TxType1D.IDTX),
    TxType.H_ADST: (TxType1D.IDTX, TxType1D.ADST),
    TxType.V_FLIPADST: (TxType1D.FLIPADST, TxType1D.IDTX),
    TxType.H_FLIPADST: (TxType1D.IDTX, TxType1D.FLIPADST),
}


class Partition(enum.IntEnum):
    """10 partition types (enums.h:155-166)."""

    NONE = 0
    HORZ = 1
    VERT = 2
    SPLIT = 3
    HORZ_A = 4  # HORZ split, top half split vertically
    HORZ_B = 5  # HORZ split, bottom half split vertically
    VERT_A = 6
    VERT_B = 7
    HORZ_4 = 8
    VERT_4 = 9


EXT_PARTITION_TYPES = 10


class PredictionMode(enum.IntEnum):
    """Intra prediction modes (enums.h, UV_PREDICTION_MODE shares 0-12)."""

    DC_PRED = 0
    V_PRED = 1
    H_PRED = 2
    D45_PRED = 3
    D135_PRED = 4
    D113_PRED = 5
    D157_PRED = 6
    D203_PRED = 7
    D67_PRED = 8
    SMOOTH_PRED = 9
    SMOOTH_V_PRED = 10
    SMOOTH_H_PRED = 11
    PAETH_PRED = 12


INTRA_MODES = 13
UV_CFL_PRED = 13  # chroma-only CFL mode index
UV_INTRA_MODES = 14

# Directional mode base angles in degrees (reconintra: 8 directional modes).
MODE_TO_ANGLE = {
    PredictionMode.V_PRED: 90,
    PredictionMode.H_PRED: 180,
    PredictionMode.D45_PRED: 45,
    PredictionMode.D135_PRED: 135,
    PredictionMode.D113_PRED: 113,
    PredictionMode.D157_PRED: 157,
    PredictionMode.D203_PRED: 203,
    PredictionMode.D67_PRED: 67,
}


class FrameType(enum.IntEnum):
    KEY_FRAME = 0
    INTER_FRAME = 1
    INTRA_ONLY_FRAME = 2
    S_FRAME = 3


class ObuType(enum.IntEnum):
    """OBU types (aom/aom_codec.h:542-550)."""

    SEQUENCE_HEADER = 1
    TEMPORAL_DELIMITER = 2
    FRAME_HEADER = 3
    TILE_GROUP = 4
    METADATA = 5
    FRAME = 6
    REDUNDANT_FRAME_HEADER = 7
    TILE_LIST = 8
    PADDING = 15


# Quantizer domain (av1/common/quant_common.h:26)
MINQ = 0
MAXQ = 255
QINDEX_RANGE = MAXQ - MINQ + 1

# Entropy coder probability domain (aom_dsp/prob.h:33)
CDF_PROB_BITS = 15
CDF_PROB_TOP = 1 << CDF_PROB_BITS  # 32768
