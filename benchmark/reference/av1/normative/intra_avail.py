"""Top-right / bottom-left intra edge availability (reconintra.c:178-318
``has_top_right`` / ``has_bottom_left``).

Shared by the decoder's reconstruction and the encoder's prediction so
both derive identical edge extensions — the in-loop recon must be
bit-identical on both sides.  The per-superblock availability bitmasks
(``has_tr_4x4`` ...) were extracted from the reference build into
``normative/data/misc.npz``.
"""
from __future__ import annotations

from functools import lru_cache

from .enums import BLOCK_WIDTH, Partition
from .blocks import MI_W, MI_H
from .txsize import TX_WIDE_UNIT, TX_HIGH_UNIT


@lru_cache(maxsize=2)
def load_avail_tables(kind: str):
    """(normal, vert) bitmask tables per bsize; kind in {"tr", "bl"}."""
    from ..ops import intra as intra_ops
    m = intra_ops._misc()
    sizes = ["4x4", "4x8", "8x4", "8x8", "8x16", "16x8", "16x16",
             "16x32", "32x16", "32x32", "32x64", "64x32", "64x64",
             "64x128", "128x64", "128x128", "4x16", "16x4", "8x32",
             "32x8", "16x64", "64x16"]
    normal = [m[f"has_{kind}_{s}"] for s in sizes]
    vert = []
    vert_names = {3: "8x8", 6: "16x16", 9: "32x32", 12: "64x64"}
    for b in range(16):
        if b in vert_names:
            vert.append(m[f"has_{kind}_vert_{vert_names[b]}"])
        elif b in (1, 4, 7, 10, 13):  # 4x8-like use the normal table
            vert.append(normal[b])
        elif b == 15:
            vert.append(normal[15])
        else:
            vert.append(None)
    return normal, vert


def _table_bit(tables_pair, partition, bsize, blk_idx):
    normal, vert = tables_pair
    if partition in (Partition.VERT_A, Partition.VERT_B):
        tab = vert[bsize]
    else:
        tab = normal[bsize]
    return (int(tab[blk_idx // 8]) >> (blk_idx % 8)) & 1


def has_top_right(sb_mi, bsize, mi_row, mi_col, top_avail, right_avail,
                  partition, tx_size, row_off, col_off, ss_x, ss_y):
    """reconintra.c:178 has_top_right."""
    if not top_avail or not right_avail:
        return 0
    bw_unit = int(MI_W[bsize])
    plane_bw_unit = max(bw_unit >> ss_x, 1)
    tr_count = int(TX_WIDE_UNIT[tx_size])
    if row_off > 0:
        if int(BLOCK_WIDTH[bsize]) > 64:
            if (row_off == (16 >> ss_y)
                    and col_off + tr_count == (16 >> ss_x)):
                return 1
            pbw64 = 16 >> ss_x
            return (col_off % pbw64) + tr_count < pbw64
        return col_off + tr_count < plane_bw_unit
    if col_off + tr_count < plane_bw_unit:
        return 1
    bw_log2 = bw_unit.bit_length() - 1
    bh_log2 = int(MI_H[bsize]).bit_length() - 1
    blk_row_sb = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col_sb = (mi_col & (sb_mi - 1)) >> bw_log2
    if blk_row_sb == 0:
        return 1
    if ((blk_col_sb + 1) << bw_log2) >= sb_mi:
        return 0
    idx = (blk_row_sb << (5 - bw_log2)) + blk_col_sb
    return _table_bit(load_avail_tables("tr"), partition, bsize, idx)


def has_bottom_left(sb_mi, bsize, mi_row, mi_col, bottom_avail, left_avail,
                    partition, tx_size, row_off, col_off, ss_x, ss_y):
    """reconintra.c:246 has_bottom_left."""
    if not bottom_avail or not left_avail:
        return 0
    if int(BLOCK_WIDTH[bsize]) > 64 and col_off > 0:
        pbw64 = 16 >> ss_x
        if col_off % pbw64 == 0:
            pbh64 = 16 >> ss_y
            row64 = row_off % pbh64
            pbh = min(int(MI_H[bsize]) >> ss_y, pbh64)
            return row64 + int(TX_HIGH_UNIT[tx_size]) < pbh
    if col_off > 0:
        return 0
    bh_unit = int(MI_H[bsize])
    plane_bh_unit = max(bh_unit >> ss_y, 1)
    bl_count = int(TX_HIGH_UNIT[tx_size])
    if row_off + bl_count < plane_bh_unit:
        return 1
    bw_log2 = int(MI_W[bsize]).bit_length() - 1
    bh_log2 = bh_unit.bit_length() - 1
    blk_row_sb = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col_sb = (mi_col & (sb_mi - 1)) >> bw_log2
    if blk_col_sb == 0:
        blk_start_row_off = (blk_row_sb << bh_log2) >> ss_y
        row_off_sb = blk_start_row_off + row_off
        sb_h_unit = sb_mi >> ss_y
        return row_off_sb + bl_count < sb_h_unit
    if ((blk_row_sb + 1) << bh_log2) >= sb_mi:
        return 0
    idx = (blk_row_sb << (5 - bw_log2)) + blk_col_sb
    return _table_bit(load_avail_tables("bl"), partition, bsize, idx)
