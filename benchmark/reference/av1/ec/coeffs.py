"""Coefficient (transform block) entropy coding — encodetxb/decodetxb.

Bit-exact reimplementation of the reference coefficient syntax
(``av1/decoder/decodetxb.c``, ``av1/encoder/encodetxb.c``) and its context
derivation (``av1/common/txb_common.h``). Coefficients use the framework's
(W, H) "C layout" (flat index ``col*H + row``); the padded ``levels`` array
is column-major with stride ``H + 4`` exactly like the reference.
"""
from __future__ import annotations

import numpy as np

from ..normative import tables
from ..normative.enums import TxType
from ..normative.txsize import (TXSIZE_LOG2_MINUS4, TXSIZE_SQR, TXSIZE_SQR_UP,
                                adjusted_tx_size, txsize_entropy_ctx, tx_scale,
                                TXSIZE_TO_BSIZE, TX_WIDE_UNIT, TX_HIGH_UNIT)
from ..normative.enums import TX_WIDTH, TX_HEIGHT, TxSize
from .coder import Encoder, Decoder

NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
MAX_BASE_BR_RANGE = 15
COEFF_CONTEXT_BITS = 3
COEFF_CONTEXT_MASK = 7
TX_PAD_HOR = 4
SIG_COEF_CONTEXTS_2D = 26

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2
TX_TYPE_TO_CLASS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1], np.int32)

_NZ_CTX_OFFSET_1D = np.array(
    [26, 31] + [36] * 30, np.int32)  # nz_map_ctx_offset_1d


def eob_group_start() -> np.ndarray:
    return tables.get("eob_group_start").astype(np.int32)


def eob_offset_bits() -> np.ndarray:
    return tables.get("eob_offset_bits").astype(np.int32)


def nz_map_ctx_offset(ts: int) -> np.ndarray:
    return tables.get(f"nz_map_ctx_offset_ts{ts}").astype(np.int32)


def get_eob_pos_token(eob: int) -> tuple[int, int]:
    """(eob_pt, extra) — av1_get_eob_pos_token."""
    gs = eob_group_start()
    t = int(np.searchsorted(gs, eob, side="right")) - 1
    return t, eob - int(gs[t])


class Levels:
    """Padded |level| array, column-major with stride H+4 (set_levels)."""

    def __init__(self, width: int, height: int):
        self.h = height
        self.stride = height + TX_PAD_HOR
        self.buf = np.zeros((width + 4) * self.stride + 16, np.uint8)

    def padded_idx(self, pos: int, bhl: int) -> int:
        return pos + ((pos >> bhl) << 2)

    def __getitem__(self, i: int) -> int:
        return int(self.buf[i])

    def set(self, pos: int, bhl: int, v: int) -> None:
        self.buf[self.padded_idx(pos, bhl)] = v

    def init_from_coeffs(self, coeff_flat: np.ndarray, width: int,
                         height: int) -> None:
        """av1_txb_init_levels: |coeff| clamped to 127, padded layout."""
        a = np.minimum(np.abs(coeff_flat[: width * height]), 127)
        v = a.reshape(width, height)
        view = self.buf[: width * self.stride].reshape(width, self.stride)
        view[:, :height] = v
        view[:, height:] = 0


def _clip3(x: int) -> int:
    return x if x < 3 else 3


def get_nz_mag(lv: Levels, padded_pos: int, bhl: int, tx_class: int) -> int:
    b = lv.buf
    s = (1 << bhl) + TX_PAD_HOR
    p = padded_pos
    mag = _clip3(int(b[p + s])) + _clip3(int(b[p + 1]))
    if tx_class == TX_CLASS_2D:
        mag += _clip3(int(b[p + s + 1]))
        mag += _clip3(int(b[p + 2 * s])) + _clip3(int(b[p + 2]))
    elif tx_class == TX_CLASS_VERT:
        mag += _clip3(int(b[p + 2])) + _clip3(int(b[p + 3])) + _clip3(int(b[p + 4]))
    else:
        mag += _clip3(int(b[p + 2 * s])) + _clip3(int(b[p + 3 * s])) + \
            _clip3(int(b[p + 4 * s]))
    return mag


def get_nz_map_ctx(lv: Levels, pos: int, bhl: int, tx_size: int,
                   tx_class: int) -> int:
    """get_lower_levels_ctx (txb_common.h:252+). NB: the offset table is
    indexed by the ORIGINAL tx size (av1_nz_map_ctx_offset[tx_size])."""
    stats = get_nz_mag(lv, lv.padded_idx(pos, bhl), bhl, tx_class)
    if (tx_class | pos) == 0:
        return 0
    ctx = min((stats + 1) >> 1, 4)
    if tx_class == TX_CLASS_2D:
        return ctx + int(nz_map_ctx_offset(tx_size)[pos])
    col = pos >> bhl
    row = pos - (col << bhl)
    idx = col if tx_class == TX_CLASS_HORIZ else row
    return ctx + int(_NZ_CTX_OFFSET_1D[idx])


def get_lower_levels_ctx_eob(bhl: int, width: int, scan_idx: int) -> int:
    if scan_idx == 0:
        return 0
    if scan_idx <= (width << bhl) // 8:
        return 1
    if scan_idx <= (width << bhl) // 4:
        return 2
    return 3


def get_br_ctx(lv: Levels, pos: int, bhl: int, tx_class: int) -> int:
    col = pos >> bhl
    row = pos - (col << bhl)
    s = (1 << bhl) + TX_PAD_HOR
    p = col * s + row
    b = lv.buf
    mag = int(b[p + 1]) + int(b[p + s])
    if tx_class == TX_CLASS_2D:
        mag += int(b[p + s + 1])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row < 2 and col < 2:
            return mag + 7
    elif tx_class == TX_CLASS_HORIZ:
        mag += int(b[p + 2 * s])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if col == 0:
            return mag + 7
    else:
        mag += int(b[p + 2])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row == 0:
            return mag + 7
    return mag + 14


def get_br_ctx_eob(pos: int, bhl: int, tx_class: int) -> int:
    col = pos >> bhl
    row = pos - (col << bhl)
    if pos == 0:
        return 0
    if ((tx_class == TX_CLASS_2D and row < 2 and col < 2)
            or (tx_class == TX_CLASS_HORIZ and col == 0)
            or (tx_class == TX_CLASS_VERT and row == 0)):
        return 7
    return 14


# ---------------------------------------------------------------------------
# txb skip / dc sign context from the above/left entropy-context bytes
# ---------------------------------------------------------------------------

_SKIP_CONTEXTS = np.array([[1, 2, 2, 2, 3], [2, 4, 4, 4, 5], [2, 4, 4, 4, 5],
                           [2, 4, 4, 4, 5], [3, 5, 5, 5, 6]], np.int32)
_SIGNS = (0, -1, 1)


def get_txb_ctx(plane_bsize: int, tx_size: int, plane: int, a: np.ndarray,
                l: np.ndarray) -> tuple[int, int]:
    """Returns (txb_skip_ctx, dc_sign_ctx) — txb_common.h get_txb_ctx."""
    wu, hu = int(TX_WIDE_UNIT[tx_size]), int(TX_HIGH_UNIT[tx_size])
    dc_sign = 0
    for k in range(wu):
        dc_sign += _SIGNS[int(a[k]) >> COEFF_CONTEXT_BITS]
    for k in range(hu):
        dc_sign += _SIGNS[int(l[k]) >> COEFF_CONTEXT_BITS]
    # dc_sign_contexts[dc_sign + 32]: 0 at center, 1 negative, 2 positive
    dc_sign_ctx = 0 if dc_sign == 0 else (1 if dc_sign < 0 else 2)

    if plane == 0:
        if plane_bsize == int(TXSIZE_TO_BSIZE[tx_size]):
            skip_ctx = 0
        else:
            top = 0
            left = 0
            for k in range(wu):
                top |= int(a[k])
            for k in range(hu):
                left |= int(l[k])
            top = min(top & COEFF_CONTEXT_MASK, 4)
            left = min(left & COEFF_CONTEXT_MASK, 4)
            skip_ctx = int(_SKIP_CONTEXTS[top][left])
    else:
        above_ec = any(int(a[k]) != 0 for k in range(wu))
        left_ec = any(int(l[k]) != 0 for k in range(hu))
        ctx_base = int(above_ec) + int(left_ec)
        from ..normative.enums import BLOCK_WIDTH, BLOCK_HEIGHT
        npels_blk = int(BLOCK_WIDTH[plane_bsize]) * int(BLOCK_HEIGHT[plane_bsize])
        npels_tx = int(TX_WIDTH[tx_size]) * int(TX_HEIGHT[tx_size])
        skip_ctx = ctx_base + (10 if npels_blk > npels_tx else 7)
    return skip_ctx, dc_sign_ctx


def set_dc_sign(cul_level: int, dc_val: int) -> int:
    if dc_val < 0:
        cul_level |= 1 << COEFF_CONTEXT_BITS
    elif dc_val > 0:
        cul_level += 2 << COEFF_CONTEXT_BITS
    return cul_level


# ---------------------------------------------------------------------------
# Golomb
# ---------------------------------------------------------------------------


def read_golomb(dec: Decoder) -> int:
    length = 0
    while True:
        length += 1
        if dec.read_bit():
            break
        if length > 20:
            raise ValueError("invalid golomb length")
    x = 1
    for _ in range(length - 1):
        x = (x << 1) + dec.read_bit()
    return x - 1


def write_golomb(enc: Encoder, level: int) -> None:
    x = level + 1
    length = x.bit_length()
    for _ in range(length - 1):
        enc.write_bit(0)
    for i in range(length - 1, -1, -1):
        enc.write_bit((x >> i) & 1)


# ---------------------------------------------------------------------------
# Transform block read / write
# ---------------------------------------------------------------------------


def _eob_flag_cdf(fc, eob_multi_size: int, plane_type: int, eob_multi_ctx: int):
    name = f"eob_flag_cdf{16 << eob_multi_size}"
    return getattr(fc, name)[plane_type][eob_multi_ctx], 5 + eob_multi_size


def read_coeffs_txb(dec: Decoder, fc, tx_size: int, tx_type: int, plane: int,
                    txb_skip_ctx: int, dc_sign_ctx: int,
                    read_tx_type_fn=None) -> tuple[np.ndarray, int, int]:
    """Decode one transform block's quantized levels (signed).

    Returns (coeff_flat int32 of adjusted w*h in C layout, eob, cul_level).
    ``read_tx_type_fn``: called after a nonzero txb_skip for luma to parse
    the tx type (returns updated tx_type).
    """
    plane_type = 1 if plane > 0 else 0
    txs_ctx = txsize_entropy_ctx(tx_size)
    ts_adj = adjusted_tx_size(tx_size)
    width = int(TX_WIDTH[ts_adj])
    height = int(TX_HEIGHT[ts_adj])
    bhl = height.bit_length() - 1

    all_zero = dec.decode_symbol(fc.txb_skip_cdf[txs_ctx][txb_skip_ctx], 2)
    if all_zero:
        return np.zeros(width * height, np.int32), 0, 0

    if plane == 0 and read_tx_type_fn is not None:
        tx_type = read_tx_type_fn()
    tx_class = int(TX_TYPE_TO_CLASS[tx_type])
    scan = tables.scan_table(ts_adj, tx_type)

    eob_multi_size = int(TXSIZE_LOG2_MINUS4[tx_size])
    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    cdf, nsyms = _eob_flag_cdf(fc, eob_multi_size, plane_type, eob_multi_ctx)
    eob_pt = dec.decode_symbol(cdf, nsyms) + 1

    ofs_bits = int(eob_offset_bits()[eob_pt])
    eob_extra = 0
    if ofs_bits > 0:
        eob_ctx = eob_pt - 3
        bit = dec.decode_symbol(
            fc.eob_extra_cdf[txs_ctx][plane_type][eob_ctx], 2)
        if bit:
            eob_extra += 1 << (ofs_bits - 1)
        for i in range(1, ofs_bits):
            if dec.read_bit():
                eob_extra += 1 << (ofs_bits - 1 - i)
    eob = int(eob_group_start()[eob_pt])
    if eob > 2:
        eob += eob_extra

    lv = Levels(width, height)
    # eob-position coefficient
    c = eob - 1
    pos = int(scan[c])
    coeff_ctx = get_lower_levels_ctx_eob(bhl, width, c)
    level = dec.decode_symbol(
        fc.coeff_base_eob_cdf[txs_ctx][plane_type][coeff_ctx], 3) + 1
    if level > NUM_BASE_LEVELS:
        br_ctx = get_br_ctx_eob(pos, bhl, tx_class)
        cdf = fc.coeff_br_cdf[min(txs_ctx, int(TxSize.TX_32X32))][plane_type][br_ctx]
        for _ in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
            k = dec.decode_symbol(cdf, BR_CDF_SIZE)
            level += k
            if k < BR_CDF_SIZE - 1:
                break
    lv.set(pos, bhl, level)

    if eob > 1:
        base_cdf = fc.coeff_base_cdf[txs_ctx][plane_type]
        br_cdf = fc.coeff_br_cdf[min(txs_ctx, int(TxSize.TX_32X32))][plane_type]
        for c in range(eob - 2, -1, -1):
            pos = int(scan[c])
            coeff_ctx = get_nz_map_ctx(lv, pos, bhl, tx_size, tx_class)
            level = dec.decode_symbol(base_cdf[coeff_ctx], 4)
            if level > NUM_BASE_LEVELS:
                br_ctx = get_br_ctx(lv, pos, bhl, tx_class)
                cdf = br_cdf[br_ctx]
                for _ in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
                    k = dec.decode_symbol(cdf, BR_CDF_SIZE)
                    level += k
                    if k < BR_CDF_SIZE - 1:
                        break
            lv.set(pos, bhl, level)

    # signs + golomb remainders, forward scan order
    coeff = np.zeros(width * height, np.int32)
    cul_level = 0
    dc_val = 0
    for c in range(eob):
        pos = int(scan[c])
        level = lv[lv.padded_idx(pos, bhl)]
        if not level:
            continue
        if c == 0:
            sign = dec.decode_symbol(fc.dc_sign_cdf[plane_type][dc_sign_ctx], 2)
        else:
            sign = dec.read_bit()
        if level >= MAX_BASE_BR_RANGE:
            level += read_golomb(dec)
        if c == 0:
            dc_val = -level if sign else level
        level &= 0xFFFFF
        cul_level += level
        coeff[pos] = -level if sign else level

    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    cul_level = set_dc_sign(cul_level, dc_val)
    return coeff, eob, cul_level


def write_coeffs_txb(enc: Encoder, fc, tx_size: int, tx_type: int, plane: int,
                     coeff_flat: np.ndarray, eob: int, txb_skip_ctx: int,
                     dc_sign_ctx: int, write_tx_type_fn=None) -> int:
    """Encode one transform block (av1_write_coeffs_txb). Returns cul_level."""
    plane_type = 1 if plane > 0 else 0
    txs_ctx = txsize_entropy_ctx(tx_size)
    ts_adj = adjusted_tx_size(tx_size)
    width = int(TX_WIDTH[ts_adj])
    height = int(TX_HEIGHT[ts_adj])
    bhl = height.bit_length() - 1

    enc.encode_symbol(int(eob == 0), fc.txb_skip_cdf[txs_ctx][txb_skip_ctx], 2)
    if eob == 0:
        return 0
    if plane == 0 and write_tx_type_fn is not None:
        write_tx_type_fn()
    tx_class = int(TX_TYPE_TO_CLASS[tx_type])
    scan = tables.scan_table(ts_adj, tx_type)

    eob_pt, eob_extra = get_eob_pos_token(eob)
    eob_multi_size = int(TXSIZE_LOG2_MINUS4[tx_size])
    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    cdf, nsyms = _eob_flag_cdf(fc, eob_multi_size, plane_type, eob_multi_ctx)
    enc.encode_symbol(eob_pt - 1, cdf, nsyms)

    ofs_bits = int(eob_offset_bits()[eob_pt])
    if ofs_bits > 0:
        eob_ctx = eob_pt - 3
        bit = (eob_extra >> (ofs_bits - 1)) & 1
        enc.encode_symbol(bit, fc.eob_extra_cdf[txs_ctx][plane_type][eob_ctx], 2)
        for i in range(1, ofs_bits):
            enc.write_bit((eob_extra >> (ofs_bits - 1 - i)) & 1)

    base_eob_cdf = fc.coeff_base_eob_cdf[txs_ctx][plane_type]
    base_cdf = fc.coeff_base_cdf[txs_ctx][plane_type]
    br_cdf = fc.coeff_br_cdf[min(txs_ctx, int(TxSize.TX_32X32))][plane_type]

    tx_class_n = tx_class
    lv = Levels(width, height)
    lv.init_from_coeffs(coeff_flat, width, height)

    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        level = abs(int(coeff_flat[pos]))
        if c == eob - 1:
            coeff_ctx = get_lower_levels_ctx_eob(bhl, width, c)
            enc.encode_symbol(min(level, 3) - 1, base_eob_cdf[coeff_ctx], 3)
        else:
            coeff_ctx = get_nz_map_ctx(lv, pos, bhl, tx_size, tx_class)
            enc.encode_symbol(min(level, 3), base_cdf[coeff_ctx], 4)
        if level > NUM_BASE_LEVELS:
            base_range = level - 1 - NUM_BASE_LEVELS
            # the reference encoder uses get_br_ctx even at c == eob-1; all
            # scan-later neighbors are zero there, so it equals get_br_ctx_eob
            br_ctx = get_br_ctx(lv, pos, bhl, tx_class)
            cdf = br_cdf[br_ctx]
            for idx in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
                k = min(base_range - idx, BR_CDF_SIZE - 1)
                enc.encode_symbol(k, cdf, BR_CDF_SIZE)
                if k < BR_CDF_SIZE - 1:
                    break

    cul_level = 0
    dc_val = 0
    for c in range(eob):
        v = int(coeff_flat[int(scan[c])])
        level = abs(v)
        sign = 1 if v < 0 else 0
        if level:
            if c == 0:
                enc.encode_symbol(sign, fc.dc_sign_cdf[plane_type][dc_sign_ctx], 2)
                dc_val = v
            else:
                enc.write_bit(sign)
            if level > COEFF_BASE_RANGE + NUM_BASE_LEVELS:
                write_golomb(enc, level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS)
            cul_level += level
    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    cul_level = set_dc_sign(cul_level, dc_val)
    return cul_level