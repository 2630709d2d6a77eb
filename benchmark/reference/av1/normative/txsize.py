"""Transform-size derived tables (av1/common/common_data.h, blockd.h)."""
from __future__ import annotations

import numpy as np

from .enums import (TxSize, BlockSize, TX_WIDTH, TX_HEIGHT, BLOCK_WIDTH,
                    BLOCK_HEIGHT, TX_SIZES_ALL, BLOCK_SIZES_ALL)

_SQUARE = {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16,
           32: TxSize.TX_32X32, 64: TxSize.TX_64X64}
_BY_DIMS = {(int(TX_WIDTH[t]), int(TX_HEIGHT[t])): TxSize(t)
            for t in range(TX_SIZES_ALL)}

# square size using min / max dimension (txsize_sqr_map / txsize_sqr_up_map)
TXSIZE_SQR = np.array([_SQUARE[min(int(TX_WIDTH[t]), int(TX_HEIGHT[t]))]
                       for t in range(TX_SIZES_ALL)], np.int32)
TXSIZE_SQR_UP = np.array([_SQUARE[max(int(TX_WIDTH[t]), int(TX_HEIGHT[t]))]
                          for t in range(TX_SIZES_ALL)], np.int32)


def adjusted_tx_size(ts: int) -> int:
    """64-dim sizes coded as <=32 (blockd.h av1_get_adjusted_tx_size)."""
    w, h = min(int(TX_WIDTH[ts]), 32), min(int(TX_HEIGHT[ts]), 32)
    return int(_BY_DIMS[(w, h)])


# log2(coded coefficient count) - 4 (common_data.h txsize_log2_minus4)
TXSIZE_LOG2_MINUS4 = np.array([
    (min(int(TX_WIDTH[t]), 32) * min(int(TX_HEIGHT[t]), 32)).bit_length() - 5
    for t in range(TX_SIZES_ALL)], np.int32)


def txsize_entropy_ctx(ts: int) -> int:
    """(sqr + sqr_up + 1) >> 1 (entropy.h:173)."""
    return (int(TXSIZE_SQR[ts]) + int(TXSIZE_SQR_UP[ts]) + 1) >> 1


def tx_scale(ts: int) -> int:
    """Dequant downshift for large transforms (av1_get_tx_scale,
    av1_txfm.h): based on the PIXEL COUNT, not the squared-up size —
    TX_8X32 (256 pels) scales by 0 even though its square-up is 32x32."""
    pels = int(TX_WIDTH[ts]) * int(TX_HEIGHT[ts])
    return int(pels > 256) + int(pels > 1024)


# largest rectangular tx fitting each block (blockd.h max_txsize_rect_lookup);
# every <=2:1 block dim pair clamped to 64 is itself a valid tx size
MAX_TXSIZE_RECT = np.array([
    _BY_DIMS[(min(int(BLOCK_WIDTH[b]), 64), min(int(BLOCK_HEIGHT[b]), 64))]
    for b in range(BLOCK_SIZES_ALL)], np.int32)

# bsize with the same dims as a tx size (txsize_to_bsize)
TXSIZE_TO_BSIZE = np.array([
    next(b for b in range(BLOCK_SIZES_ALL)
         if int(BLOCK_WIDTH[b]) == int(TX_WIDTH[t])
         and int(BLOCK_HEIGHT[b]) == int(TX_HEIGHT[t]))
    for t in range(TX_SIZES_ALL)], np.int32)

TX_WIDE_UNIT = (TX_WIDTH // 4).astype(np.int32)
TX_HIGH_UNIT = (TX_HEIGHT // 4).astype(np.int32)
