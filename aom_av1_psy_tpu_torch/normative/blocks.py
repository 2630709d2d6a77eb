"""Block geometry & partition helpers (common_data.h / blockd.h logic)."""
from __future__ import annotations

import numpy as np

from .enums import (BlockSize, Partition, BLOCK_WIDTH, BLOCK_HEIGHT,
                    BLOCK_SIZES_ALL, PredictionMode)

_BY_DIMS = {(int(BLOCK_WIDTH[b]), int(BLOCK_HEIGHT[b])): BlockSize(b)
            for b in range(BLOCK_SIZES_ALL)}

MI_W = (BLOCK_WIDTH // 4).astype(np.int32)
MI_H = (BLOCK_HEIGHT // 4).astype(np.int32)

# partition-context byte patterns per bsize (common_data.h:385-408)
PARTITION_CTX_ABOVE = np.array(
    [31, 31, 30, 30, 30, 28, 28, 28, 24, 24, 24, 16, 16, 16, 0, 0,
     31, 28, 30, 24, 28, 16], np.int32)
PARTITION_CTX_LEFT = np.array(
    [31, 30, 31, 30, 28, 30, 28, 24, 28, 24, 16, 24, 16, 0, 16, 0,
     28, 31, 24, 30, 16, 28], np.int32)

INTRA_MODE_CONTEXT = np.array([0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0], np.int32)

# uv chroma tx type derivation (blockd.h intra_mode_to_tx_type)
INTRA_MODE_TO_TX_TYPE = np.array(
    [0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3], np.int32)

# av1_ext_tx_used_flag per set type (entropymode.h)
EXT_TX_USED_FLAG = np.array([0x0001, 0x0201, 0x020F, 0x0E0F, 0x0FFF, 0xFFFF],
                            np.int32)
NUM_EXT_TX_SET = np.array([1, 2, 5, 7, 12, 16], np.int32)
EXT_TX_SET_INDEX_INTRA = {0: 0, 2: 2, 3: 1}  # set_type -> eset
EXT_TX_SET_INDEX_INTER = {0: 0, 1: 3, 4: 2, 5: 1}  # blockd.h:1114
EXT_TX_IND = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 3, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
    [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6]], np.int32)
EXT_TX_INV = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 10, 11, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8, 0, 0, 0, 0],
    [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8]], np.int32)

FIMODE_TO_INTRADIR = np.array([0, 1, 2, 6, 0], np.int32)  # blockd.h:181


def bsize_from_dims(w: int, h: int) -> BlockSize:
    return _BY_DIMS[(w, h)]


def get_partition_subsize(bsize: int, partition: int) -> int:
    """subsize_lookup equivalent (main child size per partition)."""
    w, h = int(BLOCK_WIDTH[bsize]), int(BLOCK_HEIGHT[bsize])
    p = Partition(partition)
    if p == Partition.NONE:
        return bsize
    if p == Partition.SPLIT:
        return int(_BY_DIMS[(w // 2, h // 2)])
    if p in (Partition.HORZ, Partition.HORZ_A, Partition.HORZ_B):
        return int(_BY_DIMS[(w, h // 2)])
    if p in (Partition.VERT, Partition.VERT_A, Partition.VERT_B):
        return int(_BY_DIMS[(w // 2, h)])
    if p == Partition.HORZ_4:
        return int(_BY_DIMS[(w, h // 4)])
    return int(_BY_DIMS[(w // 4, h)])


def get_plane_block_size(bsize: int, ss_x: int, ss_y: int) -> int:
    w = max(int(BLOCK_WIDTH[bsize]) >> ss_x, 4)
    h = max(int(BLOCK_HEIGHT[bsize]) >> ss_y, 4)
    # clamp extreme ratios that can't exist (4:1 after subsampling of 4xN)
    while (w, h) not in _BY_DIMS:
        if w < h:
            h //= 2
        else:
            w //= 2
    return int(_BY_DIMS[(w, h)])


def scale_chroma_bsize(bsize: int, ss_x: int, ss_y: int) -> int:
    """Round sub-8x8 blocks up so chroma covers a full 4x4 (blockd.h)."""
    w, h = int(BLOCK_WIDTH[bsize]), int(BLOCK_HEIGHT[bsize])
    if w < 8 and ss_x:
        w = 8
    if h < 8 and ss_y:
        h = 8
    return int(_BY_DIMS[(w, h)])


def is_directional_mode(mode: int) -> bool:
    return PredictionMode.V_PRED <= mode <= PredictionMode.D67_PRED
