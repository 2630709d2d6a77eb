"""Intra-frame decoder: tile/SB/partition parse + reconstruction.

Mirrors ``av1/decoder/decodeframe.c`` (decode_partition :1244,
parse_decode_block :1115, decode_token_recon_block) and ``decodemv.c``
(read_intra_frame_mode_info) for KEY / INTRA_ONLY frames, 8-bit 4:2:0.

This host-side reference decoder is the conformance anchor; batched TPU
paths (wavefront recon) plug in behind the same normative logic.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.headers import SequenceHeader, FrameHeader
from ..ec.coder import Decoder
from ..ec.context import FrameContext
from ..ec import coeffs as C
from ..normative import tables
from ..normative.enums import (BlockSize, Partition, PredictionMode, TxSize,
                               BLOCK_WIDTH, BLOCK_HEIGHT, TX_WIDTH, TX_HEIGHT,
                               MODE_TO_ANGLE)
from ..normative.blocks import (MI_W, MI_H, PARTITION_CTX_ABOVE,
                                PARTITION_CTX_LEFT, INTRA_MODE_CONTEXT,
                                INTRA_MODE_TO_TX_TYPE, EXT_TX_USED_FLAG,
                                NUM_EXT_TX_SET, EXT_TX_SET_INDEX_INTRA,
                                EXT_TX_INV, FIMODE_TO_INTRADIR,
                                get_partition_subsize, get_plane_block_size,
                                scale_chroma_bsize, is_directional_mode,
                                bsize_from_dims)
from ..normative.txsize import (MAX_TXSIZE_RECT, TXSIZE_SQR, TXSIZE_SQR_UP,
                                TXSIZE_TO_BSIZE, TX_WIDE_UNIT, TX_HIGH_UNIT,
                                adjusted_tx_size, tx_scale)
from ..normative import txsize as TS
from ..normative import intra_avail as IA
from ..ops import intra as intra_ops
from ..ops import txfm_host as txfm_ops

SUB_TX_SIZE_MAP = np.array(
    [0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10], np.int32)
BSIZE_TO_MAX_DEPTH = np.array(
    [0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
    np.int32)
BSIZE_TO_TX_SIZE_CAT = np.array(
    [0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4],
    np.int32)

MAX_ANGLE_DELTA = 3
CFL_BUF_LINE = 32


def _has_misc(name):
    return intra_ops._misc()[name]


def partition_cdf_length(bsize: int) -> int:
    if bsize <= BlockSize.BLOCK_8X8:
        return 4
    if bsize == BlockSize.BLOCK_128X128:
        return 8
    return 10


def _cdf_element_prob(icdf, el: int) -> int:
    prev = int(icdf[el - 1]) if el > 0 else 32768
    return prev - int(icdf[el])


def gather_partition_cdf(icdf, bsize: int, horz: bool) -> np.ndarray:
    """partition_gather_{horz,vert}_alike → 2-symbol icdf (no counter use)."""
    p = 32768
    els = ([Partition.HORZ, Partition.SPLIT, Partition.HORZ_A,
            Partition.HORZ_B, Partition.VERT_A]
           if horz else
           [Partition.VERT, Partition.SPLIT, Partition.HORZ_A,
            Partition.VERT_A, Partition.VERT_B])
    for el in els:
        p -= _cdf_element_prob(icdf, el)
    if bsize != BlockSize.BLOCK_128X128:
        p -= _cdf_element_prob(
            icdf, Partition.HORZ_4 if horz else Partition.VERT_4)
    out = np.zeros(3, np.uint16)
    out[0] = 32768 - p
    out[1] = 0
    return out


def depth_to_tx_size(depth: int, bsize: int) -> int:
    ts = int(MAX_TXSIZE_RECT[bsize])
    for _ in range(depth):
        ts = int(SUB_TX_SIZE_MAP[ts])
    return ts


class CflCtx:
    def __init__(self, ss_x: int, ss_y: int):
        self.recon_q3 = np.zeros((CFL_BUF_LINE, CFL_BUF_LINE), np.int32)
        self.buf_w = 0
        self.buf_h = 0
        self.ss_x = ss_x
        self.ss_y = ss_y

    def store(self, luma: np.ndarray, row_off: int, col_off: int) -> None:
        """cfl_store: luma recon region (h, w) subsampled into q3 buffer."""
        h, w = luma.shape
        sr = row_off << (2 - self.ss_y)
        sc = col_off << (2 - self.ss_x)
        sh, sw = h >> self.ss_y, w >> self.ss_x
        if row_off == 0 and col_off == 0:
            self.buf_w, self.buf_h = sw, sh
        else:
            self.buf_w = max(sc + sw, self.buf_w)
            self.buf_h = max(sr + sh, self.buf_h)
        if self.ss_x and self.ss_y:
            sub = (luma[0::2, 0::2] + luma[0::2, 1::2] + luma[1::2, 0::2]
                   + luma[1::2, 1::2]) << 1
        elif self.ss_x:
            sub = (luma[:, 0::2] + luma[:, 1::2]) << 2
        else:
            sub = luma << 3
        self.recon_q3[sr : sr + sh, sc : sc + sw] = sub

    def predict(self, dc_pred: np.ndarray, alpha_q3: int, w: int,
                h: int) -> np.ndarray:
        """cfl_pad + subtract_average + cfl_predict on a (h, w) block."""
        buf = self.recon_q3
        if w > self.buf_w:
            buf = buf.copy()
            buf[: self.buf_h, self.buf_w : w] = \
                buf[: self.buf_h, self.buf_w - 1 : self.buf_w]
            self.recon_q3 = buf
            self.buf_w = w
        if h > self.buf_h:
            buf = buf if buf is not self.recon_q3 else buf.copy()
            buf[self.buf_h : h, :w] = buf[self.buf_h - 1 : self.buf_h, :w]
            self.recon_q3 = buf
            self.buf_h = h
        region = self.recon_q3[:h, :w].astype(np.int64)
        avg = int(region.sum() + ((w * h) >> 1)) >> (w * h).bit_length() - 1
        ac = region - avg
        scaled = np.where(
            alpha_q3 * ac >= 0,
            (np.abs(alpha_q3 * ac) + 32) >> 6,
            -((np.abs(alpha_q3 * ac) + 32) >> 6))
        return np.clip(dc_pred + scaled, 0, 255).astype(np.int32)


class FrameDecoder:
    def __init__(self, seq: SequenceHeader, fh: FrameHeader, refs=None,
                 ref_sign_bias=None):
        self.seq = seq
        self.fh = fh
        self.bd = seq.bit_depth
        assert self.bd == 8, "8-bit only for now"
        self.w, self.h = fh.width, fh.height
        # inter state (refs: list indexed by ref frame 1..7 -> slot dicts)
        from ..normative import mvref as MR
        self.frame_is_intra = fh.frame_type in (0, 2)
        self.refs = refs or [None] * 8
        self.global_motion = (fh.global_motion
                              or [MR.WarpModel() for _ in range(8)])
        self.ref_frame_sign_bias = ref_sign_bias or [0] * 8
        self.cur_order_hint = fh.order_hint
        self.enable_order_hint = seq.enable_order_hint
        self.order_hint_bits = seq.order_hint_bits
        self.allow_high_precision_mv = fh.allow_high_precision_mv
        self.force_integer_mv = bool(fh.force_integer_mv)
        self.allow_ref_frame_mvs = fh.allow_ref_frame_mvs
        self.tpl_mvs = None  # set by the OBU layer when ref-frame MVs are on
        self.ref_frame_side = [0] * 8
        self.mi_cols = (self.w + 7) // 8 * 2
        self.mi_rows = (self.h + 7) // 8 * 2
        self.sb_mi = 32 if seq.use_128x128_superblock else 16
        self.sb_bsize = (BlockSize.BLOCK_128X128 if seq.use_128x128_superblock
                         else BlockSize.BLOCK_64X64)
        self.nplanes = 1 if seq.monochrome else 3
        ss = [(0, 0), (seq.subsampling_x, seq.subsampling_y),
              (seq.subsampling_x, seq.subsampling_y)][: self.nplanes]
        self.ss = ss
        # plane buffers with enough padding that FULL transform blocks can
        # be written even when they overhang the mi area (the reference
        # writes whole tx blocks into its bordered buffers and CFL reads
        # those pixels back — cfl_store reads tx_size_wide regardless of
        # the frame crop, decodeframe.c inverse_transform_block)
        self.planes = []
        for (sx, sy) in ss:
            pw = ((self.mi_cols * 4) >> sx) + 64
            ph = ((self.mi_rows * 4) >> sy) + 64
            self.planes.append(np.zeros((ph, pw), np.int32))
        # mode-info grids
        shape = (self.mi_rows, self.mi_cols)
        g = lambda fill=0, dt=np.int32: np.full(shape, fill, dt)
        self.mi_bsize = g(BlockSize.BLOCK_64X64)
        self.mi_mode = g(PredictionMode.DC_PRED)
        self.mi_uv_mode = g(0)
        self.mi_angle_y = g(0)
        self.mi_angle_uv = g(0)
        self.mi_skip = g(0)
        self.mi_tx_size = g(TxSize.TX_4X4)
        self.mi_filter_intra = g(-1)
        self.mi_cfl_idx = g(0)
        self.mi_cfl_signs = g(0)
        self.mi_valid = g(0)
        self.mi_uv_tx = g(TxSize.TX_4X4)
        self.tx_type_map = g(0)
        # dequant tables per plane: (dc, ac)
        q = fh.quant
        deltas = [(q.y_dc_delta_q, 0), (q.u_dc_delta_q, q.u_ac_delta_q),
                  (q.v_dc_delta_q, q.v_ac_delta_q)]
        self.dequant = []
        for p in range(self.nplanes):
            dcq = tables.get("dc_quant_qtx")[0][
                np.clip(q.base_q_idx + deltas[p][0], 0, 255)]
            acq = tables.get("ac_quant_qtx")[0][
                np.clip(q.base_q_idx + deltas[p][1], 0, 255)]
            self.dequant.append((int(dcq), int(acq)))
        self.lossless = fh.coded_lossless
        self.cdef_unit_strength = np.full(((self.mi_rows + 15) // 16,
                                           (self.mi_cols + 15) // 16), -1,
                                          np.int32)
        self.cdef_transmitted = [False] * 4
        # per-mi CDEF strength grid with C's mbmi-sharing semantics: the
        # value read for a CDEF unit is stored on the BLOCK covering the
        # unit's top-left mi (decodemv.c read_cdef writes into
        # mi_grid[mi_row & ~15, mi_col & ~15]'s mbmi, which all mi of that
        # block share); origins track each mi's block for the propagation
        self.mi_cdef = np.full(shape, -1, np.int32)
        self.mi_borigin_r = np.zeros(shape, np.int32)
        self.mi_borigin_c = np.zeros(shape, np.int32)
        self.mi_bh4 = np.ones(shape, np.int32)
        self.mi_bw4 = np.ones(shape, np.int32)
        # object mi grid (mirrors the C mi_grid_base pointer sharing) and
        # the inter-side grids
        self.mi = np.empty(shape, object)
        self.mi_ref0 = g(0)
        self.mi_is_inter = g(0)
        self.mi_inter_tx = g(TxSize.TX_4X4)  # per-4x4 luma tx (var-tx)
        # per-8x8 saved MVs for future frames' temporal MVP
        # (av1_copy_frame_mvs)
        mvs_r = (self.mi_rows + 1) >> 1
        mvs_c = (self.mi_cols + 1) >> 1
        self.frame_mvs_ref = np.full((mvs_r, mvs_c), -1, np.int32)
        self.frame_mvs = np.zeros((mvs_r, mvs_c, 2), np.int32)

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def decode_tile(self, data: bytes, tile_row: int, tile_col: int,
                    fc: FrameContext) -> None:
        t = self.fh.tiles
        self.fc = fc
        self.dec = Decoder(data)
        self.dec.allow_update = not self.fh.disable_cdf_update
        self.tile_mi_row_start = t.row_starts[tile_row] * self.sb_mi
        self.tile_mi_row_end = min(t.row_starts[tile_row + 1] * self.sb_mi,
                                   self.mi_rows)
        self.tile_mi_col_start = t.col_starts[tile_col] * self.sb_mi
        self.tile_mi_col_end = min(t.col_starts[tile_col + 1] * self.sb_mi,
                                   self.mi_cols)
        # superblock-aligned width: edge tx blocks may span past mi_cols
        _lr_reset_refs(self)
        # per-tile delta-q / delta-lf running state (spec: reset per tile)
        self.current_base_qindex = self.fh.quant.base_q_idx
        self.current_delta_lf = [0, 0, 0, 0]
        if not hasattr(self, "mi_qindex"):
            self.mi_qindex = np.full((self.mi_rows, self.mi_cols),
                                     self.fh.quant.base_q_idx, np.int32)
            self.mi_delta_lf = np.zeros((self.mi_rows, self.mi_cols, 4),
                                        np.int32)
        ncols = (self.mi_cols + self.sb_mi - 1) // self.sb_mi * self.sb_mi
        self.above_part = np.zeros(ncols, np.int32)
        # txfm contexts init to 64 = tx_size_wide[TX_SIZES_LARGEST]
        # (av1_zero_above_context/av1_zero_left_context, av1_common_int.h:1607)
        self.above_txfm = np.full(ncols, 64, np.int32)
        self.above_ent = [np.zeros(ncols >> sx, np.uint8) for sx, _ in self.ss]
        for r0 in range(self.tile_mi_row_start, self.tile_mi_row_end,
                        self.sb_mi):
            self.left_part = np.zeros(self.sb_mi, np.int32)
            self.left_txfm = np.full(self.sb_mi, 64, np.int32)
            self.left_ent = [np.zeros(self.sb_mi >> sy, np.uint8)
                             for _, sy in self.ss]
            for c0 in range(self.tile_mi_col_start, self.tile_mi_col_end,
                            self.sb_mi):
                self.cfl = CflCtx(self.seq.subsampling_x,
                                  self.seq.subsampling_y)
                if any(self.fh.lr_type[: self.nplanes]):
                    _lr_read_for_sb(self, r0, c0)
                self.decode_partition(r0, c0, int(self.sb_bsize))

    # ------------------------------------------------------------------
    def _read_symbol(self, icdf, nsyms):
        return self.dec.decode_symbol(icdf, nsyms)

    def partition_ctx(self, mi_row, mi_col, bsize):
        # bsl relative to the 8x8 minimum partition (av1_common_int.h:1527)
        bsl = int(MI_W[bsize]).bit_length() - 2
        above = (int(self.above_part[mi_col]) >> bsl) & 1
        left = (int(self.left_part[mi_row & (self.sb_mi - 1)]) >> bsl) & 1
        return (left * 2 + above) + bsl * 4

    def update_partition_ctx(self, mi_row, mi_col, subsize, bsize):
        bw, bh = int(MI_W[bsize]), int(MI_H[bsize])
        self.above_part[mi_col : mi_col + bw] = PARTITION_CTX_ABOVE[subsize]
        lr = mi_row & (self.sb_mi - 1)
        self.left_part[lr : lr + bh] = PARTITION_CTX_LEFT[subsize]

    def decode_partition(self, mi_row, mi_col, bsize):
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        bw4 = int(MI_W[bsize])
        hbs = bw4 // 2
        qbs = bw4 // 4
        has_rows = mi_row + hbs < self.mi_rows
        has_cols = mi_col + hbs < self.mi_cols
        if bsize >= BlockSize.BLOCK_8X8:
            ctx = self.partition_ctx(mi_row, mi_col, bsize)
            if not has_rows and not has_cols:
                partition = Partition.SPLIT
            elif has_rows and has_cols:
                partition = Partition(self._read_symbol(
                    self.fc.partition_cdf[ctx], partition_cdf_length(bsize)))
            elif has_cols:
                # rows clipped: HORZ vs SPLIT via the vert-alike gather
                cdf2 = gather_partition_cdf(self.fc.partition_cdf[ctx], bsize,
                                            horz=False)
                split = self.dec.decode_cdf(cdf2, 2)
                partition = Partition.SPLIT if split else Partition.HORZ
            else:
                cdf2 = gather_partition_cdf(self.fc.partition_cdf[ctx], bsize,
                                            horz=True)
                split = self.dec.decode_cdf(cdf2, 2)
                partition = Partition.SPLIT if split else Partition.VERT
        else:
            partition = Partition.NONE
        subsize = get_partition_subsize(bsize, partition)
        bsize2 = (get_partition_subsize(bsize, Partition.SPLIT)
                  if bsize >= BlockSize.BLOCK_8X8 else bsize)

        B = self.decode_block
        if partition == Partition.NONE:
            B(mi_row, mi_col, partition, subsize)
        elif partition == Partition.HORZ:
            B(mi_row, mi_col, partition, subsize)
            if has_rows:
                B(mi_row + hbs, mi_col, partition, subsize)
        elif partition == Partition.VERT:
            B(mi_row, mi_col, partition, subsize)
            if has_cols:
                B(mi_row, mi_col + hbs, partition, subsize)
        elif partition == Partition.SPLIT:
            self.decode_partition(mi_row, mi_col, subsize)
            self.decode_partition(mi_row, mi_col + hbs, subsize)
            self.decode_partition(mi_row + hbs, mi_col, subsize)
            self.decode_partition(mi_row + hbs, mi_col + hbs, subsize)
        elif partition == Partition.HORZ_A:
            B(mi_row, mi_col, partition, bsize2)
            B(mi_row, mi_col + hbs, partition, bsize2)
            B(mi_row + hbs, mi_col, partition, subsize)
        elif partition == Partition.HORZ_B:
            B(mi_row, mi_col, partition, subsize)
            B(mi_row + hbs, mi_col, partition, bsize2)
            B(mi_row + hbs, mi_col + hbs, partition, bsize2)
        elif partition == Partition.VERT_A:
            B(mi_row, mi_col, partition, bsize2)
            B(mi_row + hbs, mi_col, partition, bsize2)
            B(mi_row, mi_col + hbs, partition, subsize)
        elif partition == Partition.VERT_B:
            B(mi_row, mi_col, partition, subsize)
            B(mi_row, mi_col + hbs, partition, bsize2)
            B(mi_row + hbs, mi_col + hbs, partition, bsize2)
        elif partition == Partition.HORZ_4:
            for i in range(4):
                row = mi_row + i * qbs
                if i > 0 and row >= self.mi_rows:
                    break
                B(row, mi_col, partition, subsize)
        elif partition == Partition.VERT_4:
            for i in range(4):
                col = mi_col + i * qbs
                if i > 0 and col >= self.mi_cols:
                    break
                B(mi_row, col, partition, subsize)
        # update_ext_partition_context
        if bsize >= BlockSize.BLOCK_8X8:
            if partition in (Partition.NONE, Partition.HORZ, Partition.VERT,
                             Partition.HORZ_4, Partition.VERT_4) or \
                    (partition == Partition.SPLIT
                     and bsize == BlockSize.BLOCK_8X8):
                self.update_partition_ctx(mi_row, mi_col, subsize, bsize)
            elif partition == Partition.HORZ_A:
                self.update_partition_ctx(mi_row, mi_col, bsize2, subsize)
                self.update_partition_ctx(mi_row + hbs, mi_col, subsize,
                                          subsize)
            elif partition == Partition.HORZ_B:
                self.update_partition_ctx(mi_row, mi_col, subsize, subsize)
                self.update_partition_ctx(mi_row + hbs, mi_col, bsize2,
                                          subsize)
            elif partition == Partition.VERT_A:
                self.update_partition_ctx(mi_row, mi_col, bsize2, subsize)
                self.update_partition_ctx(mi_row, mi_col + hbs, subsize,
                                          subsize)
            elif partition == Partition.VERT_B:
                self.update_partition_ctx(mi_row, mi_col, subsize, subsize)
                self.update_partition_ctx(mi_row, mi_col + hbs, bsize2,
                                          subsize)

    # ------------------------------------------------------------------
    def _neighbors(self, mi_row, mi_col):
        up = mi_row > self.tile_mi_row_start
        left = mi_col > self.tile_mi_col_start
        above_mi = (mi_row - 1, mi_col) if up else None
        left_mi = (mi_row, mi_col - 1) if left else None
        return up, left, above_mi, left_mi

    def ref_order_hint(self, rf: int) -> int:
        slot = self.refs[rf] if 0 < rf < 8 else None
        return slot["order_hint"] if slot else 0

    def decode_block(self, mi_row, mi_col, partition, bsize):
        if self.frame_is_intra:
            self._decode_block_intra_frame(mi_row, mi_col, partition, bsize)
        else:
            self._decode_block_inter_frame(mi_row, mi_col, partition, bsize)

    def _store_mbmi(self, mbmi, mi_row, mi_col, bsize):
        """Store the shared MbInfo + the scalar grids filters consume."""
        bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
        r1 = min(mi_row + bh4, self.mi_rows)
        c1 = min(mi_col + bw4, self.mi_cols)
        self.mi[mi_row:r1, mi_col:c1] = mbmi
        self.mi_ref0[mi_row:r1, mi_col:c1] = max(mbmi.ref_frame[0], 0)
        self.mi_is_inter[mi_row:r1, mi_col:c1] = int(mbmi.is_inter)
        mbmi.current_qindex = self.current_base_qindex
        if self.fh.delta_q_present:
            self.mi_qindex[mi_row:r1, mi_col:c1] = self.current_base_qindex
        if self.fh.delta_lf_present:
            self.mi_delta_lf[mi_row:r1, mi_col:c1] = self.current_delta_lf
        return r1, c1

    def _decode_block_intra_frame(self, mi_row, mi_col, partition, bsize):
        fc = self.fc
        dec = self.dec
        bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
        up, left, above_mi, left_mi = self._neighbors(mi_row, mi_col)
        ss_x, ss_y = self.ss[1] if self.nplanes > 1 else (1, 1)
        # chroma availability / reference (set_mi_row_col, is_chroma_reference)
        chroma_up = up
        chroma_left = left
        if ss_x and bw4 < 2:
            chroma_left = mi_col - 1 > self.tile_mi_col_start
        if ss_y and bh4 < 2:
            chroma_up = mi_row - 1 > self.tile_mi_row_start
        is_chroma_ref = self.nplanes > 1 and (
            ((mi_row & 1) or not (bh4 & 1) or not ss_y)
            and ((mi_col & 1) or not (bw4 & 1) or not ss_x))

        # ---- mode info (read_intra_frame_mode_info) ----
        skip_ctx = 0
        if up:
            skip_ctx += int(self.mi_skip[above_mi])
        if left:
            skip_ctx += int(self.mi_skip[left_mi])
        skip = self._read_symbol(fc.skip_txfm_cdfs[skip_ctx], 2)

        self._read_cdef(mi_row, mi_col, bh4, bw4, skip)
        self._read_delta_q_params(mi_row, mi_col, bsize, skip)

        above_mode = (int(self.mi_mode[above_mi]) if up else
                      PredictionMode.DC_PRED)
        left_mode = (int(self.mi_mode[left_mi]) if left else
                     PredictionMode.DC_PRED)
        actx = int(INTRA_MODE_CONTEXT[above_mode])
        lctx = int(INTRA_MODE_CONTEXT[left_mode])
        mode = self._read_symbol(fc.kf_y_cdf[actx][lctx], 13)

        use_angle = bsize >= BlockSize.BLOCK_8X8
        angle_y = 0
        if use_angle and is_directional_mode(mode):
            angle_y = self._read_symbol(
                fc.angle_delta_cdf[mode - PredictionMode.V_PRED],
                2 * MAX_ANGLE_DELTA + 1) - MAX_ANGLE_DELTA

        uv_mode = 0
        angle_uv = 0
        cfl_idx = 0
        cfl_signs = 0
        if is_chroma_ref:
            cfl_allowed = self._cfl_allowed(bsize, ss_x, ss_y)
            uv_mode = self._read_symbol(fc.uv_mode_cdf[int(cfl_allowed)][mode],
                                        14 if cfl_allowed else 13)
            if uv_mode == 13:  # UV_CFL_PRED
                cfl_signs = self._read_symbol(fc.cfl_sign_cdf, 8)
                sign_u = ((cfl_signs + 1) * 11) >> 5
                sign_v = (cfl_signs + 1) - 3 * sign_u
                idx = 0
                if sign_u != 0:
                    ctx = cfl_signs + 1 - 3
                    idx = self._read_symbol(fc.cfl_alpha_cdf[ctx], 16) << 4
                if sign_v != 0:
                    ctx = sign_v * 3 + sign_u - 3
                    idx += self._read_symbol(fc.cfl_alpha_cdf[ctx], 16)
                cfl_idx = idx
            uv_dir = 0 if uv_mode == 13 else uv_mode
            if use_angle and is_directional_mode(uv_dir):
                angle_uv = self._read_symbol(
                    fc.angle_delta_cdf[uv_mode - PredictionMode.V_PRED],
                    2 * MAX_ANGLE_DELTA + 1) - MAX_ANGLE_DELTA

        # palette: requires allow_screen_content_tools (unsupported -> absent)
        filter_intra_mode = -1
        if (self.seq.enable_filter_intra and mode == PredictionMode.DC_PRED
                and self._filter_intra_allowed_bsize(bsize)):
            if self._read_symbol(fc.filter_intra_cdfs[bsize], 2):
                filter_intra_mode = self._read_symbol(
                    fc.filter_intra_mode_cdf, 5)

        # ---- tx size ----
        if self.lossless:
            tx_size = int(TxSize.TX_4X4)
        elif bsize > BlockSize.BLOCK_4X4:
            if self.fh.tx_mode_select:
                tx_size = self._read_selected_tx_size(
                    bsize, mi_row, mi_col, up, left)
            else:
                tx_size = int(MAX_TXSIZE_RECT[bsize])  # TX_MODE_LARGEST
        else:
            tx_size = int(MAX_TXSIZE_RECT[bsize])
        # set_txfm_ctxs
        self.above_txfm[mi_col : mi_col + bw4] = int(TX_WIDTH[tx_size])
        lr = mi_row & (self.sb_mi - 1)
        self.left_txfm[lr : lr + bh4] = int(TX_HEIGHT[tx_size])

        # store MI
        if self.nplanes > 1:
            pb = get_plane_block_size(scale_chroma_bsize(bsize, ss_x, ss_y),
                                      ss_x, ss_y)
            uv_tx = (int(TxSize.TX_4X4) if self.lossless
                     else TS.adjusted_tx_size(int(MAX_TXSIZE_RECT[pb])))
        else:
            uv_tx = int(TxSize.TX_4X4)
        from ..normative import mvref as MR
        mbmi = MR.MbInfo()
        mbmi.bsize = bsize
        mbmi.mode = mode
        mbmi.uv_mode = uv_mode
        mbmi.angle_y = angle_y
        mbmi.angle_uv = angle_uv
        mbmi.filter_intra = filter_intra_mode
        mbmi.skip_txfm = skip
        mbmi.partition = partition
        mbmi.tx_size = tx_size
        mbmi.mi_row, mbmi.mi_col = mi_row, mi_col
        self._store_mbmi(mbmi, mi_row, mi_col, bsize)
        r1, c1 = min(mi_row + bh4, self.mi_rows), min(mi_col + bw4,
                                                      self.mi_cols)
        self.mi_uv_tx[mi_row:r1, mi_col:c1] = uv_tx
        self.mi_bsize[mi_row:r1, mi_col:c1] = bsize
        self.mi_mode[mi_row:r1, mi_col:c1] = mode
        self.mi_uv_mode[mi_row:r1, mi_col:c1] = uv_mode
        self.mi_angle_y[mi_row:r1, mi_col:c1] = angle_y
        self.mi_angle_uv[mi_row:r1, mi_col:c1] = angle_uv
        self.mi_skip[mi_row:r1, mi_col:c1] = skip
        self.mi_tx_size[mi_row:r1, mi_col:c1] = tx_size
        self.mi_filter_intra[mi_row:r1, mi_col:c1] = filter_intra_mode
        self.mi_valid[mi_row:r1, mi_col:c1] = 1
        self.mi_borigin_r[mi_row:r1, mi_col:c1] = mi_row
        self.mi_borigin_c[mi_row:r1, mi_col:c1] = mi_col
        self.mi_bh4[mi_row:r1, mi_col:c1] = bh4
        self.mi_bw4[mi_row:r1, mi_col:c1] = bw4

        # intra-edge filter type: 1 when a neighbor uses a SMOOTH mode
        # (reconintra.c get_intra_edge_filter_type)
        ab_sm = up and int(self.mi_mode[above_mi]) in (9, 10, 11)
        le_sm = left and int(self.mi_mode[left_mi]) in (9, 10, 11)
        ef_type_y = 1 if (ab_sm or le_sm) else 0
        ef_type_uv = 0
        if is_chroma_ref:
            base_r = mi_row - (mi_row & ss_y)
            base_c = mi_col - (mi_col & ss_x)
            ab_sm = le_sm = False
            if chroma_up:
                m = int(self.mi_uv_mode[base_r - 1, base_c + ss_x])
                v = int(self.mi_valid[base_r - 1, base_c + ss_x])
                ab_sm = v and m in (9, 10, 11)
            if chroma_left:
                m = int(self.mi_uv_mode[base_r + ss_y, base_c - 1])
                v = int(self.mi_valid[base_r + ss_y, base_c - 1])
                le_sm = v and m in (9, 10, 11)
            ef_type_uv = 1 if (ab_sm or le_sm) else 0
        self.ef_types = (ef_type_y, ef_type_uv)

        if skip:
            self._reset_entropy_ctx(mi_row, mi_col, bsize, is_chroma_ref)

        # ---- residual + recon ----
        self._decode_token_recon(mi_row, mi_col, bsize, tx_size, mode, uv_mode,
                                 angle_y, angle_uv, skip, filter_intra_mode,
                                 cfl_idx, cfl_signs, is_chroma_ref, up, left,
                                 chroma_up, chroma_left, partition)

    def _read_delta_q_params(self, mi_row, mi_col, bsize, skip):
        """read_delta_q_params (decodemv.c:734): per-SB delta q / delta lf,
        read at each superblock's first coded block."""
        if not self.fh.delta_q_present:
            return
        b_col = mi_col & (self.sb_mi - 1)
        b_row = mi_row & (self.sb_mi - 1)
        read_flag = b_col == 0 and b_row == 0
        if (bsize != int(self.sb_bsize) or skip == 0) and read_flag:
            abs_v = self._read_symbol(self.fc.delta_q_cdf, 4)
            if abs_v == 3:  # !smallval (DELTA_Q_SMALL)
                rem_bits = self.dec.read_literal(3) + 1
                thr = (1 << rem_bits) + 1
                abs_v = self.dec.read_literal(rem_bits) + thr
            if abs_v:
                sign = self.dec.read_bit()
            else:
                sign = 1
            delta = -abs_v if sign else abs_v
            self.current_base_qindex = int(np.clip(
                self.current_base_qindex + delta * (1 << self.fh.delta_q_res),
                1, 255))
            if self.fh.delta_lf_present:
                n = (4 if self.nplanes > 1 else 2) \
                    if self.fh.delta_lf_multi else 1
                for i in range(n):
                    cdf = (self.fc.delta_lf_multi_cdf[i]
                           if self.fh.delta_lf_multi else self.fc.delta_lf_cdf)
                    a = self._read_symbol(cdf, 4)
                    if a == 3:
                        rem_bits = self.dec.read_literal(3) + 1
                        thr = (1 << rem_bits) + 1
                        a = self.dec.read_literal(rem_bits) + thr
                    s = self.dec.read_bit() if a else 1
                    d = -a if s else a
                    v = int(np.clip(self.current_delta_lf[i]
                                    + d * (1 << self.fh.delta_lf_res),
                                    -63, 63))
                    if self.fh.delta_lf_multi:
                        self.current_delta_lf[i] = v
                    else:
                        self.current_delta_lf[:] = v

    def _read_cdef(self, mi_row, mi_col, bh4, bw4, skip):
        """read_cdef (decodemv.c): per-64x64 strength literal at the first
        non-skip block of each CDEF unit; the value is stored on the
        BLOCK covering the unit's top-left mi (mbmi sharing), so with
        128x128 superblocks one large block can carry several units'
        effective strength."""
        if self.lossless or self.fh.allow_intrabc:
            return
        if (mi_row & (self.sb_mi - 1)) == 0 and \
                (mi_col & (self.sb_mi - 1)) == 0:
            self.cdef_transmitted = [False] * 4
        if self.sb_mi == 32:
            index = int((mi_col & 16) != 0) + 2 * int((mi_row & 16) != 0)
        else:
            index = 0
        if not self.cdef_transmitted[index] and not skip:
            bits = self.fh.cdef.bits
            v = self.dec.read_literal(bits)
            tr, tc = mi_row & ~15, mi_col & ~15
            if (mi_row <= tr < mi_row + bh4
                    and mi_col <= tc < mi_col + bw4):
                br, bc, h4, w4 = mi_row, mi_col, bh4, bw4
            else:  # target mi belongs to an earlier-decoded block
                br = int(self.mi_borigin_r[tr, tc])
                bc = int(self.mi_borigin_c[tr, tc])
                h4 = int(self.mi_bh4[tr, tc])
                w4 = int(self.mi_bw4[tr, tc])
            r1 = min(br + h4, self.mi_rows)
            c1 = min(bc + w4, self.mi_cols)
            self.mi_cdef[br:r1, bc:c1] = v
            self.cdef_transmitted[index] = True

    def _cfl_allowed(self, bsize, ss_x, ss_y):
        if self.lossless:
            return get_plane_block_size(bsize, ss_x, ss_y) == \
                BlockSize.BLOCK_4X4
        return (int(BLOCK_WIDTH[bsize]) <= 32
                and int(BLOCK_HEIGHT[bsize]) <= 32)

    def _filter_intra_allowed_bsize(self, bsize) -> bool:
        return (int(BLOCK_WIDTH[bsize]) <= 32
                and int(BLOCK_HEIGHT[bsize]) <= 32)

    def _read_selected_tx_size(self, bsize, mi_row, mi_col, up, left):
        cat = int(BSIZE_TO_TX_SIZE_CAT[bsize]) - 1  # depth-1 (blockd.h:1355)
        max_depth = int(BSIZE_TO_MAX_DEPTH[bsize])
        max_tx = int(MAX_TXSIZE_RECT[bsize])
        above = int(self.above_txfm[mi_col]) >= int(TX_WIDTH[max_tx])
        lval = int(self.left_txfm[mi_row & (self.sb_mi - 1)])
        leftc = lval >= int(TX_HEIGHT[max_tx])
        # get_tx_size_context: INTER neighbors use their block dims
        if up:
            amb = self.mi[mi_row - 1, mi_col]
            if amb is not None and amb.is_inter:
                above = int(BLOCK_WIDTH[amb.bsize]) >= int(TX_WIDTH[max_tx])
        if left:
            lmb = self.mi[mi_row, mi_col - 1]
            if lmb is not None and lmb.is_inter:
                leftc = int(BLOCK_HEIGHT[lmb.bsize]) >= int(TX_HEIGHT[max_tx])
        if up and left:
            ctx = int(above) + int(leftc)
        elif up:
            ctx = int(above)
        elif left:
            ctx = int(leftc)
        else:
            ctx = 0
        depth = self._read_symbol(self.fc.tx_size_cdf[cat][ctx], max_depth + 1)
        return depth_to_tx_size(depth, bsize)

    def _reset_entropy_ctx(self, mi_row, mi_col, bsize, is_chroma_ref):
        """av1_reset_entropy_context for skip blocks."""
        for p in range(self.nplanes):
            if p and not is_chroma_ref:
                break
            sx, sy = self.ss[p]
            pb = get_plane_block_size(bsize, sx, sy) if p else bsize
            w4 = int(MI_W[pb])
            h4 = int(MI_H[pb])
            c = mi_col >> sx
            r = (mi_row & (self.sb_mi - 1)) >> sy
            self.above_ent[p][c : c + w4] = 0
            self.left_ent[p][r : r + h4] = 0

    # ------------------------------------------------------------------
    def _decode_token_recon(self, mi_row, mi_col, bsize, tx_size_y, mode,
                            uv_mode, angle_y, angle_uv, skip,
                            filter_intra_mode, cfl_idx, cfl_signs,
                            is_chroma_ref, up, left, chroma_up, chroma_left,
                            partition):
        max_w4 = int(MI_W[bsize])
        max_h4 = int(MI_H[bsize])
        # frame-edge clipping (max_block_wide/high)
        max_w4 = min(max_w4, self.mi_cols - mi_col)
        max_h4 = min(max_h4, self.mi_rows - mi_row)
        mu_w = min(16, max_w4)
        mu_h = min(16, max_h4)
        store_cfl = (self.nplanes > 1 and (
            (not is_chroma_ref) or uv_mode == 13))
        for row in range(0, max_h4, mu_h):
            for col in range(0, max_w4, mu_w):
                for plane in range(self.nplanes):
                    if plane and not is_chroma_ref:
                        break
                    sx, sy = self.ss[plane]
                    if plane == 0:
                        tx_size = tx_size_y
                    else:
                        pb = get_plane_block_size(
                            scale_chroma_bsize(bsize, sx, sy), sx, sy)
                        tx_size = TS.adjusted_tx_size(int(MAX_TXSIZE_RECT[pb]))
                        if self.lossless:
                            tx_size = int(TxSize.TX_4X4)
                    stepr = int(TX_HIGH_UNIT[tx_size])
                    stepc = int(TX_WIDE_UNIT[tx_size])
                    unit_h = ((min(mu_h + row, max_h4) + sy) >> sy)
                    unit_w = ((min(mu_w + col, max_w4) + sx) >> sx)
                    for br in range(row >> sy, unit_h, stepr):
                        for bc in range(col >> sx, unit_w, stepc):
                            self._tx_block(mi_row, mi_col, bsize, plane, br,
                                           bc, tx_size, mode, uv_mode,
                                           angle_y, angle_uv, skip,
                                           filter_intra_mode, cfl_idx,
                                           cfl_signs, up, left, chroma_up,
                                           chroma_left, store_cfl, partition)

    def _tx_block(self, mi_row, mi_col, bsize, plane, blk_row, blk_col,
                  tx_size, mode, uv_mode, angle_y, angle_uv, skip,
                  filter_intra_mode, cfl_idx, cfl_signs, up, left, chroma_up,
                  chroma_left, store_cfl, partition):
        fc = self.fc
        sx, sy = self.ss[plane]
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        plane_bsize = bsize if plane == 0 else get_plane_block_size(
            scale_chroma_bsize(bsize, sx, sy), sx, sy)

        # ---- parse coefficients ----
        coeff = None
        eob = 0
        if not skip:
            wu = int(TX_WIDE_UNIT[tx_size])
            hu = int(TX_HIGH_UNIT[tx_size])
            ac = self.above_ent[plane]
            lc = self.left_ent[plane]
            acol = (mi_col >> sx) + blk_col
            lrow = ((mi_row & (self.sb_mi - 1)) >> sy) + blk_row
            skip_ctx, sign_ctx = C.get_txb_ctx(
                plane_bsize, tx_size, plane, ac[acol : acol + wu],
                lc[lrow : lrow + hu])

            tx_type_holder = [0]

            def read_tx_type():
                tt = self._read_tx_type(mi_row + (blk_row << sy),
                                        mi_col + (blk_col << sx), tx_size,
                                        mode, filter_intra_mode, skip)
                tx_type_holder[0] = tt
                return tt

            if plane == 0:
                coeff, eob, cul = C.read_coeffs_txb(
                    self.dec, fc, tx_size, 0, plane, skip_ctx, sign_ctx,
                    read_tx_type_fn=read_tx_type)
                tx_type = tx_type_holder[0] if eob else 0
                self.tx_type_map[mi_row + blk_row : mi_row + blk_row + 1,
                                 mi_col + blk_col : mi_col + blk_col + 1] = \
                    tx_type
            else:
                tx_type = self._uv_tx_type(uv_mode, tx_size)
                coeff, eob, cul = C.read_coeffs_txb(
                    self.dec, fc, tx_size, tx_type, plane, skip_ctx, sign_ctx)
            # av1_set_entropy_contexts: tx units past the frame edge get 0
            bw_px = int(BLOCK_WIDTH[plane_bsize])
            bh_px = int(BLOCK_HEIGHT[plane_bsize])
            over_x = ((self.mi_cols - (mi_col + int(MI_W[bsize]))) * 4) >> sx
            over_y = ((self.mi_rows - (mi_row + int(MI_H[bsize]))) * 4) >> sy
            vis_w = (bw_px + min(over_x, 0)) >> 2
            vis_h = (bh_px + min(over_y, 0)) >> 2
            nw = max(0, min(wu, vis_w - blk_col))
            nh = max(0, min(hu, vis_h - blk_row))
            ac[acol : acol + nw] = cul
            ac[acol + nw : acol + wu] = 0
            lc[lrow : lrow + nh] = cul
            lc[lrow + nh : lrow + hu] = 0
        else:
            tx_type = 0

        # ---- predict ----
        x = ((mi_col >> sx) << 2) + (blk_col << 2)
        y = ((mi_row >> sy) << 2) + (blk_row << 2)
        if plane and (sx or sy):
            # sub-8x8 chroma anchors at the even MI (setup_pred_plane)
            bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
            ax_mi = mi_col - (1 if (sx and (mi_col & 1) and bw4 == 1) else 0)
            ay_mi = mi_row - (1 if (sy and (mi_row & 1) and bh4 == 1) else 0)
            x = ((ax_mi << 2) >> sx) + (blk_col << 2)
            y = ((ay_mi << 2) >> sy) + (blk_row << 2)
        pmode = mode if plane == 0 else (0 if uv_mode == 13 else uv_mode)
        adelta = angle_y if plane == 0 else angle_uv
        pred = self._predict_intra(plane, x, y, tx_size, pmode, adelta,
                                   filter_intra_mode if plane == 0 else None,
                                   blk_row, blk_col, bsize, up, left,
                                   chroma_up, chroma_left, partition,
                                   mi_row, mi_col)
        if plane and uv_mode == 13:
            alpha = self._cfl_alpha(cfl_idx, cfl_signs, plane)
            pred = self.cfl.predict(pred, alpha, txw, txh)

        buf = self.planes[plane]
        h, w = buf.shape
        vw = min(txw, w - x)
        vh = min(txh, h - y)
        if vw <= 0 or vh <= 0:
            return
        # ---- reconstruct ----
        if eob > 0:
            dq = self._dequant(coeff, plane, tx_size, tx_type)
            if self.lossless:
                rec = txfm_ops.iwht4x4_add(dq[None], pred[None, :4, :4],
                                           bd=self.bd)[0]
            else:
                ts_adj = TS.adjusted_tx_size(tx_size)
                cw = int(TX_WIDTH[ts_adj])
                ch = int(TX_HEIGHT[ts_adj])
                full = np.zeros((txw, txh), np.int32)
                full[:cw, :ch] = dq.reshape(cw, ch)
                rec = txfm_ops.inv_txfm2d_add(full[None], pred[None], tx_size,
                                              tx_type, bd=self.bd)[0]
        else:
            rec = pred
        buf[y : y + vh, x : x + vw] = rec[:vh, :vw]

        if plane == 0 and store_cfl:
            self._store_cfl_tx(mi_row, mi_col, bsize, blk_row, blk_col,
                               tx_size, x, y)

    def _store_cfl_tx(self, mi_row, mi_col, bsize, blk_row, blk_col, tx_size,
                      x, y):
        row, col = blk_row, blk_col
        if int(BLOCK_HEIGHT[bsize]) == 4 or int(BLOCK_WIDTH[bsize]) == 4:
            if (mi_row & 1) and self.cfl.ss_y:
                row += 1
            if (mi_col & 1) and self.cfl.ss_x:
                col += 1
        buf = self.planes[0]
        txw = int(TX_WIDTH[tx_size])
        txh = int(TX_HEIGHT[tx_size])
        vh = min(txh, buf.shape[0] - y)
        vw = min(txw, buf.shape[1] - x)
        luma = np.empty((txh, txw), np.int32)
        luma[:vh, :vw] = buf[y : y + vh, x : x + vw]
        if vh < txh:
            luma[vh:, :vw] = luma[vh - 1 : vh, :vw]
        if vw < txw:
            luma[:, vw:] = luma[:, vw - 1 : vw]
        self.cfl.store(luma, row, col)

    def _cfl_alpha(self, idx, joint_sign, plane):
        sign_u = ((joint_sign + 1) * 11) >> 5
        sign_v = (joint_sign + 1) - 3 * sign_u
        sign = sign_u if plane == 1 else sign_v
        if sign == 0:  # CFL_SIGN_ZERO
            return 0
        mag = (idx >> 4) if plane == 1 else (idx & 15)
        return mag + 1 if sign == 2 else -(mag + 1)

    def _uv_tx_type(self, uv_mode, tx_size):
        if self.lossless or int(TXSIZE_SQR_UP[tx_size]) > TxSize.TX_32X32:
            return 0
        m = 0 if uv_mode == 13 else uv_mode
        tt = int(INTRA_MODE_TO_TX_TYPE[m])
        set_type = self._ext_tx_set_type(tx_size)
        if not (int(EXT_TX_USED_FLAG[set_type]) >> tt) & 1:
            return 0
        return tt

    def _ext_tx_set_type(self, tx_size):
        sqr_up = int(TXSIZE_SQR_UP[tx_size])
        if sqr_up > TxSize.TX_32X32:
            return 0  # DCTONLY
        if sqr_up == TxSize.TX_32X32:
            return 0
        if self.fh.reduced_tx_set:
            return 2  # DTT4_IDTX
        sqr = int(TXSIZE_SQR[tx_size])
        return 2 if sqr == TxSize.TX_16X16 else 3

    def _read_tx_type(self, mi_row, mi_col, tx_size, mode, filter_intra_mode,
                      skip):
        if skip or self.lossless:
            return 0
        if self.fh.quant.base_q_idx == 0:
            return 0
        set_type = self._ext_tx_set_type(tx_size)
        if int(NUM_EXT_TX_SET[set_type]) <= 1:
            return 0
        eset = EXT_TX_SET_INDEX_INTRA[set_type]
        sqr = int(TXSIZE_SQR[tx_size])
        intra_dir = (int(FIMODE_TO_INTRADIR[filter_intra_mode])
                     if filter_intra_mode >= 0 else mode)
        sym = self._read_symbol(
            self.fc.intra_ext_tx_cdf[eset][sqr][intra_dir],
            int(NUM_EXT_TX_SET[set_type]))
        return int(EXT_TX_INV[set_type][sym])

    def _iqmatrix(self, plane, tx_size, tx_type):
        """av1_get_iqmatrix (quant_common.c:251): per-plane qm level from
        the header, flat (None) for 1D/IDTX transforms or level 15."""
        q = self.fh.quant
        if not q.using_qmatrix or self.lossless or tx_type >= 9:
            return None
        lvl = (q.qm_y, q.qm_u, q.qm_v)[plane]
        if lvl == 15:
            return None
        ts_adj = TS.adjusted_tx_size(tx_size)
        key = f"iqm_q{lvl}_c{1 if plane else 0}_t{ts_adj}"
        cache = getattr(self, "_qm_cache", None)
        if cache is None:
            cache = self._qm_cache = {}
        if key not in cache:
            import os
            path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                "normative", "data", "qm_tables.npz")
            if not hasattr(FrameDecoder, "_qm_npz"):
                FrameDecoder._qm_npz = np.load(path)
            # the table's memory order IS the coefficient flat order the
            # scan positions index (same convention as our col*H+row
            # layout) — use it directly
            cache[key] = FrameDecoder._qm_npz[key].astype(np.int64).ravel()
        return cache[key]

    def _dequant(self, coeff, plane, tx_size, tx_type=0):
        if self.fh.delta_q_present:
            q = self.fh.quant
            deltas = [(q.y_dc_delta_q, 0),
                      (q.u_dc_delta_q, q.u_ac_delta_q),
                      (q.v_dc_delta_q, q.v_ac_delta_q)]
            qidx = self.current_base_qindex
            dc = int(tables.get("dc_quant_qtx")[0][
                np.clip(qidx + deltas[plane][0], 0, 255)])
            ac = int(tables.get("ac_quant_qtx")[0][
                np.clip(qidx + deltas[plane][1], 0, 255)])
        else:
            dc, ac = self.dequant[plane]
        shift = tx_scale(tx_size)
        dqv = np.full(coeff.shape, ac, np.int64)
        dqv[0] = dc
        iqm = self._iqmatrix(plane, tx_size, tx_type)
        if iqm is not None:
            # get_dqv (decodetxb.c): dqv = (iqm[pos]*dqv + 16) >> 5
            dqv = (iqm[: len(dqv)] * dqv + 16) >> 5
        mag = np.abs(coeff.astype(np.int64)) * dqv
        mag &= 0xFFFFFF
        mag >>= shift
        out = np.where(coeff < 0, -mag, mag)
        lim = 1 << (7 + self.bd)
        out = np.clip(out, -lim, lim - 1)
        ts_adj = TS.adjusted_tx_size(tx_size)
        return out.astype(np.int32).reshape(int(TX_WIDTH[ts_adj]),
                                            int(TX_HEIGHT[ts_adj]))

    # ------------------------------------------------------------------
    def _predict_intra(self, plane, x, y, tx_size, mode, angle_delta,
                       filter_intra_mode, blk_row, blk_col, bsize, up, left,
                       chroma_up, chroma_left, partition, mi_row, mi_col):
        """av1_predict_intra_block: availability + edge prep + predict."""
        sx, sy = self.ss[plane]
        buf = self.planes[plane]
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        have_top = blk_row > 0 or (chroma_up if plane else up)
        have_left = blk_col > 0 or (chroma_left if plane else left)
        bsize_eff = scale_chroma_bsize(bsize, sx, sy) if (sx or sy) else bsize
        # frame-relative geometry (wpx/hpx in plane pixels)
        w_px = int(BLOCK_WIDTH[bsize_eff]) >> sx
        h_px = int(BLOCK_HEIGHT[bsize_eff]) >> sy
        bx = blk_col * 4
        by = blk_row * 4
        frame_w = (self.mi_cols * 4) >> sx
        frame_h = (self.mi_rows * 4) >> sy
        blk_x0 = x - bx  # plane-px origin of the whole block
        blk_y0 = y - by
        xr = (frame_w - blk_x0 - w_px) + w_px - bx - txw
        yd = (frame_h - blk_y0 - h_px) + h_px - by - txh
        wu = int(TX_WIDE_UNIT[tx_size])
        hu = int(TX_HIGH_UNIT[tx_size])
        right_avail = (mi_col + ((blk_col + wu) << sx)) < self.tile_mi_col_end
        bottom_avail = yd > 0 and (
            (mi_row + ((blk_row + hu) << sy)) < self.tile_mi_row_end)
        mi_row0, mi_col0 = mi_row, mi_col

        mode_e = PredictionMode(mode)
        p_angle = (MODE_TO_ANGLE.get(mode_e, 0) + angle_delta * 3
                   if is_directional_mode(mode) else 0)
        use_fi = filter_intra_mode is not None and filter_intra_mode >= 0
        need = intra_ops.EXTEND_MODES[mode_e]
        need_tr = bool(need & intra_ops.NEED_ABOVERIGHT)
        need_bl = bool(need & intra_ops.NEED_BOTTOMLEFT)
        if use_fi:
            need_tr = need_bl = False
        if is_directional_mode(mode):
            need_tr = p_angle < 90
            need_bl = p_angle > 180

        have_tr = -1
        if need_tr:
            have_tr = self._has_top_right(bsize_eff, mi_row0, mi_col0,
                                          have_top, right_avail, partition,
                                          tx_size, blk_row, blk_col, sx, sy)
        have_bl = -1
        if need_bl:
            have_bl = self._has_bottom_left(bsize_eff, mi_row0, mi_col0,
                                            bottom_avail, have_left,
                                            partition, tx_size, blk_row,
                                            blk_col, sx, sy)

        n_top = min(txw, xr + txw) if have_top else 0
        n_tr = min(txw, xr) if have_tr > 0 else have_tr
        n_left = min(txh, yd + txh) if have_left else 0
        n_bl = min(txh, yd) if have_bl > 0 else have_bl

        above_ref = np.zeros(2 * (txw + txh) + 2, np.int32)
        left_ref = np.zeros(2 * (txw + txh) + 2, np.int32)
        tl = 128
        if n_top > 0:
            n = n_top + max(n_tr, 0)
            n = min(n, buf.shape[1] - x)
            above_ref[:n] = buf[y - 1, x : x + n]
            if n < n_top + max(n_tr, 0):
                above_ref[n : n_top + max(n_tr, 0)] = above_ref[n - 1]
        if n_left > 0:
            n = n_left + max(n_bl, 0)
            n = min(n, buf.shape[0] - y)
            left_ref[:n] = buf[y : y + n, x - 1]
            if n < n_left + max(n_bl, 0):
                left_ref[n : n_left + max(n_bl, 0)] = left_ref[n - 1]
        if n_top > 0 and n_left > 0:
            tl = int(buf[y - 1, x - 1])

        return intra_ops.build_intra_predictor(
            above_ref, left_ref, tl, n_top, n_tr, n_left, n_bl, mode,
            angle_delta, txw, txh,
            filter_intra_mode=filter_intra_mode if use_fi else None,
            disable_edge_filter=not self.seq.enable_intra_edge_filter,
            intra_edge_filter_type=self.ef_types[1 if plane else 0],
            bd=self.bd)

    def _has_top_right(self, bsize, mi_row, mi_col, top_avail, right_avail,
                       partition, tx_size, row_off, col_off, ss_x, ss_y):
        return IA.has_top_right(self.sb_mi, bsize, mi_row, mi_col, top_avail,
                                right_avail, partition, tx_size, row_off,
                                col_off, ss_x, ss_y)

    def _has_bottom_left(self, bsize, mi_row, mi_col, bottom_avail, left_avail,
                         partition, tx_size, row_off, col_off, ss_x, ss_y):
        return IA.has_bottom_left(self.sb_mi, bsize, mi_row, mi_col,
                                  bottom_avail, left_avail, partition, tx_size,
                                  row_off, col_off, ss_x, ss_y)

    # ------------------------------------------------------------------
    # Inter-frame block decode (decodemv.c read_inter_frame_mode_info +
    # decodeframe.c parse_decode_block / decode_token_recon_block)
    # ------------------------------------------------------------------
    def _decode_block_inter_frame(self, mi_row, mi_col, partition, bsize):
        from . import inter as IT
        from ..normative import mvref as MR
        fc = self.fc
        bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
        up, left, above_mi, left_mi = self._neighbors(mi_row, mi_col)
        above = self.mi[above_mi] if up else None
        left_mb = self.mi[left_mi] if left else None
        ss_x, ss_y = self.ss[1] if self.nplanes > 1 else (1, 1)
        chroma_up = up
        chroma_left = left
        if ss_x and bw4 < 2:
            chroma_left = mi_col - 1 > self.tile_mi_col_start
        if ss_y and bh4 < 2:
            chroma_up = mi_row - 1 > self.tile_mi_row_start
        is_chroma_ref = self.nplanes > 1 and (
            ((mi_row & 1) or not (bh4 & 1) or not ss_y)
            and ((mi_col & 1) or not (bw4 & 1) or not ss_x))

        mbmi = MR.MbInfo()
        mbmi.bsize = bsize
        mbmi.partition = partition
        mbmi.mi_row, mbmi.mi_col = mi_row, mi_col
        # the C mi grid points at this mbmi before parsing (set_offsets);
        # _has_top_right reads the current block's partition through it
        self.mi[mi_row, mi_col] = mbmi

        # skip_mode (read_skip_mode, decodemv.c:420)
        skip_mode = 0
        if self.fh.skip_mode_present and int(BLOCK_WIDTH[bsize]) >= 8 \
                and int(BLOCK_HEIGHT[bsize]) >= 8:
            ctx = ((above.skip_mode if up else 0)
                   + (left_mb.skip_mode if left else 0))
            skip_mode = self._read_symbol(fc.skip_mode_cdfs[ctx], 2)
        mbmi.skip_mode = skip_mode
        if skip_mode:
            skip = 1
        else:
            skip_ctx = ((above.skip_txfm if up else 0)
                        + (left_mb.skip_txfm if left else 0))
            skip = self._read_symbol(fc.skip_txfm_cdfs[skip_ctx], 2)
        mbmi.skip_txfm = skip
        self._read_cdef(mi_row, mi_col, bh4, bw4, skip)
        self._read_delta_q_params(mi_row, mi_col, bsize, skip)

        # is_inter (read_is_inter_block)
        if skip_mode:
            is_inter_blk = 1
        else:
            if up and left:
                ai, li = not above.is_inter, not left_mb.is_inter
                ctx = 3 if (ai and li) else int(ai or li)
            elif up or left:
                e = above if up else left_mb
                ctx = 2 * int(not e.is_inter)
            else:
                ctx = 0
            is_inter_blk = self._read_symbol(fc.intra_inter_cdf[ctx], 2)

        xd = MR.XdCtx(self.mi, mi_row, mi_col, bsize,
                      (self.tile_mi_row_start, self.tile_mi_row_end,
                       self.tile_mi_col_start, self.tile_mi_col_end),
                      self.mi_rows, self.mi_cols)
        if is_inter_blk:
            self._read_inter_block_mode_info(mbmi, xd, above, left_mb, up,
                                             left, is_chroma_ref)
        else:
            self._read_intra_block_mode_info(mbmi, is_chroma_ref, ss_x, ss_y)

        # ---- tx sizes (parse_decode_block) ----
        r1 = min(mi_row + bh4, self.mi_rows)
        c1 = min(mi_col + bw4, self.mi_cols)
        max_tx = int(MAX_TXSIZE_RECT[bsize])
        if self.fh.tx_mode_select and bsize > BlockSize.BLOCK_4X4 \
                and not skip and mbmi.is_inter and not self.lossless:
            bh_u = int(TX_HIGH_UNIT[max_tx])
            bw_u = int(TX_WIDE_UNIT[max_tx])
            for idy in range(0, bh4, bh_u):
                for idx in range(0, bw4, bw_u):
                    self._read_tx_size_vartx(mbmi, max_tx, 0, idy, idx,
                                             mi_row, mi_col)
            tx_size = mbmi.tx_size
        else:
            if self.lossless:
                tx_size = int(TxSize.TX_4X4)
            elif bsize > BlockSize.BLOCK_4X4 and self.fh.tx_mode_select \
                    and not mbmi.is_inter:
                tx_size = self._read_selected_tx_size(bsize, mi_row, mi_col,
                                                      up, left)
            else:
                tx_size = max_tx
            mbmi.tx_size = tx_size
            self.mi_inter_tx[mi_row:r1, mi_col:c1] = tx_size
            # set_txfm_ctxs: skip inter blocks use the block dims
            if skip and mbmi.is_inter:
                tw, th = int(BLOCK_WIDTH[bsize]), int(BLOCK_HEIGHT[bsize])
            else:
                tw, th = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
            self.above_txfm[mi_col : mi_col + bw4] = tw
            lr = mi_row & (self.sb_mi - 1)
            self.left_txfm[lr : lr + bh4] = th

        # ---- store mode info grids ----
        if self.nplanes > 1:
            pb = get_plane_block_size(scale_chroma_bsize(bsize, ss_x, ss_y),
                                      ss_x, ss_y)
            uv_tx = (int(TxSize.TX_4X4) if self.lossless
                     else TS.adjusted_tx_size(int(MAX_TXSIZE_RECT[pb])))
        else:
            uv_tx = int(TxSize.TX_4X4)
        self.mi_uv_tx[mi_row:r1, mi_col:c1] = uv_tx
        self.mi_bsize[mi_row:r1, mi_col:c1] = bsize
        self.mi_mode[mi_row:r1, mi_col:c1] = mbmi.mode
        self.mi_uv_mode[mi_row:r1, mi_col:c1] = mbmi.uv_mode
        self.mi_angle_y[mi_row:r1, mi_col:c1] = mbmi.angle_y
        self.mi_angle_uv[mi_row:r1, mi_col:c1] = mbmi.angle_uv
        self.mi_skip[mi_row:r1, mi_col:c1] = skip
        self.mi_tx_size[mi_row:r1, mi_col:c1] = mbmi.tx_size
        self.mi_filter_intra[mi_row:r1, mi_col:c1] = mbmi.filter_intra
        self.mi_valid[mi_row:r1, mi_col:c1] = 1
        self.mi_borigin_r[mi_row:r1, mi_col:c1] = mi_row
        self.mi_borigin_c[mi_row:r1, mi_col:c1] = mi_col
        self.mi_bh4[mi_row:r1, mi_col:c1] = bh4
        self.mi_bw4[mi_row:r1, mi_col:c1] = bw4
        self._store_mbmi(mbmi, mi_row, mi_col, bsize)

        # intra-edge filter types (for intra blocks inside inter frames)
        ab_sm = up and int(self.mi_mode[above_mi]) in (9, 10, 11)
        le_sm = left and int(self.mi_mode[left_mi]) in (9, 10, 11)
        ef_type_y = 1 if (ab_sm or le_sm) else 0
        ef_type_uv = 0
        if is_chroma_ref:
            base_r = mi_row - (mi_row & ss_y)
            base_c = mi_col - (mi_col & ss_x)
            ab_sm = le_sm = False
            if chroma_up:
                m = int(self.mi_uv_mode[base_r - 1, base_c + ss_x])
                v = int(self.mi_valid[base_r - 1, base_c + ss_x])
                ab_sm = v and m in (9, 10, 11)
            if chroma_left:
                m = int(self.mi_uv_mode[base_r + ss_y, base_c - 1])
                v = int(self.mi_valid[base_r + ss_y, base_c - 1])
                le_sm = v and m in (9, 10, 11)
            ef_type_uv = 1 if (ab_sm or le_sm) else 0
        self.ef_types = (ef_type_y, ef_type_uv)

        if skip:
            self._reset_entropy_ctx(mi_row, mi_col, bsize, is_chroma_ref)

        # ---- residual + recon ----
        if mbmi.is_inter:
            self._predict_inter_block(mbmi, xd, is_chroma_ref)
            if not skip:
                self._decode_residual_inter(mbmi, mi_row, mi_col, bsize,
                                            is_chroma_ref)
            # store_cfl_required: luma of non-chroma-ref blocks feeds a
            # later chroma block's CfL
            if self.nplanes > 1 and not is_chroma_ref:
                self._store_cfl_inter(mbmi, mi_row, mi_col, bsize)
        else:
            self._decode_token_recon(
                mi_row, mi_col, bsize, mbmi.tx_size, mbmi.mode, mbmi.uv_mode,
                mbmi.angle_y, mbmi.angle_uv, skip, mbmi.filter_intra,
                mbmi.cfl_idx, mbmi.cfl_signs, is_chroma_ref, up, left,
                chroma_up, chroma_left, partition)

        # av1_copy_frame_mvs (for future frames' temporal MVP)
        if self.seq.enable_ref_frame_mvs:
            self._copy_frame_mvs(mbmi, mi_row, mi_col, bw4, bh4)

    def _read_intra_block_mode_info(self, mbmi, is_chroma_ref, ss_x, ss_y):
        """read_intra_block_mode_info (decodemv.c:1064): intra block inside
        an inter frame (y_mode_cdf by size group, not the kf tables)."""
        from . import inter as IT
        fc = self.fc
        bsize = mbmi.bsize
        mbmi.ref_frame = [0, -1]
        mbmi.mode = self._read_symbol(
            fc.y_mode_cdf[int(IT.SIZE_GROUP[bsize])], 13)
        use_angle = bsize >= BlockSize.BLOCK_8X8
        if use_angle and is_directional_mode(mbmi.mode):
            mbmi.angle_y = self._read_symbol(
                fc.angle_delta_cdf[mbmi.mode - PredictionMode.V_PRED],
                2 * MAX_ANGLE_DELTA + 1) - MAX_ANGLE_DELTA
        if not self.seq.monochrome and is_chroma_ref:
            cfl_allowed = self._cfl_allowed(bsize, ss_x, ss_y)
            mbmi.uv_mode = self._read_symbol(
                fc.uv_mode_cdf[int(cfl_allowed)][mbmi.mode],
                14 if cfl_allowed else 13)
            if mbmi.uv_mode == 13:
                signs = self._read_symbol(fc.cfl_sign_cdf, 8)
                sign_u = ((signs + 1) * 11) >> 5
                sign_v = (signs + 1) - 3 * sign_u
                idx = 0
                if sign_u != 0:
                    idx = self._read_symbol(
                        fc.cfl_alpha_cdf[signs + 1 - 3], 16) << 4
                if sign_v != 0:
                    idx += self._read_symbol(
                        fc.cfl_alpha_cdf[sign_v * 3 + sign_u - 3], 16)
                mbmi.cfl_idx = idx
                mbmi.cfl_signs = signs
            uv_dir = 0 if mbmi.uv_mode == 13 else mbmi.uv_mode
            if use_angle and is_directional_mode(uv_dir):
                mbmi.angle_uv = self._read_symbol(
                    fc.angle_delta_cdf[mbmi.uv_mode - PredictionMode.V_PRED],
                    2 * MAX_ANGLE_DELTA + 1) - MAX_ANGLE_DELTA
        if self.fh.allow_screen_content_tools:
            raise NotImplementedError("palette in inter frames")
        if (self.seq.enable_filter_intra
                and mbmi.mode == PredictionMode.DC_PRED
                and self._filter_intra_allowed_bsize(bsize)):
            if self._read_symbol(fc.filter_intra_cdfs[bsize], 2):
                mbmi.filter_intra = self._read_symbol(
                    fc.filter_intra_mode_cdf, 5)

    def _read_inter_block_mode_info(self, mbmi, xd, above, left_mb, up, left,
                                    is_chroma_ref):
        from . import inter as IT
        from ..normative import mvref as MR
        fc = self.fc
        bsize = mbmi.bsize
        counts = IT.collect_neighbors_ref_counts(self, above, left_mb)
        IT.read_ref_frames(self, mbmi, counts, above, left_mb, up, left)
        is_compound = mbmi.is_compound
        ref_frame_type = MR.av1_ref_frame_type(mbmi.ref_frame)
        stack, weights, count, mode_ctx_val, mv_ref_list, gm_mv = \
            MR.find_mv_refs(self, xd, mbmi, ref_frame_type)

        mbmi.ref_mv_idx = 0
        if mbmi.skip_mode:
            mbmi.mode = MR.NEAREST_NEARESTMV
        else:
            if is_compound:
                newmv_ctx = mode_ctx_val & MR.NEWMV_CTX_MASK
                refmv_ctx = (mode_ctx_val >> MR.REFMV_OFFSET) \
                    & MR.REFMV_CTX_MASK
                mode_ctx = MR.COMPOUND_MODE_CTX_MAP[refmv_ctx >> 1][
                    min(newmv_ctx, MR.COMP_NEWMV_CTXS - 1)]
                mbmi.mode = MR.NEAREST_NEARESTMV + self._read_symbol(
                    fc.inter_compound_mode_cdf[mode_ctx], 8)
            else:
                mbmi.mode = IT.read_inter_mode(self, mode_ctx_val)
            if mbmi.mode in (MR.NEWMV, MR.NEW_NEWMV) or \
                    MR.have_nearmv_in_inter_mode(mbmi.mode):
                IT.read_drl_idx(self, mbmi, count, weights)

        allow_hp = self.allow_high_precision_mv
        fim = self.force_integer_mv
        lower = lambda mv: MR.lower_mv_precision(mv, allow_hp, fim)
        nearest_mv = [(0, 0), (0, 0)]
        near_mv = [(0, 0), (0, 0)]
        if not is_compound and mbmi.mode != MR.GLOBALMV:
            lst = [lower(mv) for mv in mv_ref_list]
            nearest_mv[0] = lst[0]
            near_mv[0] = lst[1]
        if is_compound and mbmi.mode != MR.GLOBAL_GLOBALMV:
            idx = mbmi.ref_mv_idx + 1
            nearest_mv = [lower(stack[0][0]), lower(stack[0][1])]
            near_mv = [lower(stack[idx][0]), lower(stack[idx][1])]
        elif mbmi.ref_mv_idx > 0 and mbmi.mode == MR.NEARMV:
            near_mv[0] = stack[1 + mbmi.ref_mv_idx][0]
        ref_mv = [nearest_mv[0], nearest_mv[1]]
        if is_compound:
            rmi = mbmi.ref_mv_idx
            if mbmi.mode in (MR.NEAR_NEWMV, MR.NEW_NEARMV):
                rmi += 1
            if MR.compound_ref0_mode(mbmi.mode) == MR.NEWMV:
                ref_mv[0] = stack[rmi][0]
            if MR.compound_ref1_mode(mbmi.mode) == MR.NEWMV:
                ref_mv[1] = stack[rmi][1]
        else:
            if mbmi.mode == MR.NEWMV and count > 1:
                ref_mv[0] = stack[mbmi.ref_mv_idx][0]
        precision = 0 if fim else (2 if allow_hp else 1)
        IT.assign_mv(self, mbmi, ref_mv, nearest_mv, near_mv, gm_mv,
                     precision)

        # interintra (decodemv.c:1382 read_interintra flag + mode + wedge)
        if self.seq.enable_interintra_compound and not mbmi.skip_mode \
                and self._interintra_allowed(mbmi):
            grp = int(IT.SIZE_GROUP[bsize])
            if self._read_symbol(fc.interintra_cdf[grp], 2):
                mbmi.interintra_mode = self._read_symbol(
                    fc.interintra_mode_cdf[grp], 4)
                mbmi.ref_frame[1] = MR.INTRA_FRAME
                mbmi.angle_y = 0
                mbmi.angle_uv = 0
                mbmi.filter_intra = -1
                mbmi.use_wedge_interintra = 0
                if self._wedge_allowed(bsize):
                    mbmi.use_wedge_interintra = self._read_symbol(
                        fc.wedge_interintra_cdf[bsize], 2)
                    if mbmi.use_wedge_interintra:
                        mbmi.interintra_wedge_index = self._read_symbol(
                            fc.wedge_idx_cdf[bsize], 16)

        # motion mode
        overlappable = 0
        if int(BLOCK_WIDTH[bsize]) >= 8 and int(BLOCK_HEIGHT[bsize]) >= 8 \
                and not mbmi.skip_mode and not is_compound:
            n, pts, pts_inref = MR.find_samples(self, xd, mbmi)
            mbmi.num_proj_ref = n
            self._warp_pts = (pts, pts_inref)
        overlappable = IT.count_overlappable_neighbors(self, xd, bsize)
        if mbmi.ref_frame[1] != MR.INTRA_FRAME:
            mbmi.motion_mode = IT.read_motion_mode(self, xd, mbmi,
                                                   overlappable)

        # compound type
        mbmi.comp_group_idx = 0
        mbmi.compound_idx = 1
        mbmi.comp_type = IT.COMPOUND_AVERAGE
        if is_compound and not mbmi.skip_mode:
            masked_ok = self.seq.enable_masked_compound and \
                self._masked_compound_allowed(bsize)
            if masked_ok:
                ctx = self._comp_group_idx_ctx(above, left_mb)
                mbmi.comp_group_idx = self._read_symbol(
                    fc.comp_group_idx_cdf[ctx], 2)
            if mbmi.comp_group_idx == 0:
                if self.seq.enable_jnt_comp:
                    ctx = self._comp_index_ctx(mbmi, above, left_mb)
                    mbmi.compound_idx = self._read_symbol(
                        fc.compound_index_cdf[ctx], 2)
                    mbmi.comp_type = (IT.COMPOUND_AVERAGE if mbmi.compound_idx
                                      else IT.COMPOUND_DISTWTD)
                else:
                    mbmi.compound_idx = 1
                    mbmi.comp_type = IT.COMPOUND_AVERAGE
            else:
                if self._wedge_allowed(bsize):
                    mbmi.comp_type = IT.COMPOUND_WEDGE + self._read_symbol(
                        fc.compound_type_cdf[bsize], 2)
                else:
                    mbmi.comp_type = IT.COMPOUND_DIFFWTD
                if mbmi.comp_type == IT.COMPOUND_WEDGE:
                    mbmi.wedge_index = self._read_symbol(
                        fc.wedge_idx_cdf[bsize], 16)
                    mbmi.wedge_sign = self.dec.read_bit()
                else:
                    mbmi.mask_type = self.dec.read_literal(1)

        IT.read_mb_interp_filter(self, mbmi, above, left_mb, up, left)

        if mbmi.motion_mode == IT.WARPED_CAUSAL:
            self._derive_warp_params(mbmi, xd)

    def _interintra_allowed(self, mbmi):
        """is_interintra_allowed (blockd.h): bsize is an ENUM-ORDER range
        BLOCK_8X8..BLOCK_32X32 (excludes 8X32/32X8), single-ref inter mode,
        rf[0] inter + rf[1] none/intra."""
        from ..normative import mvref as MR
        from ..normative.enums import BlockSize as BS
        return (BS.BLOCK_8X8 <= mbmi.bsize <= BS.BLOCK_32X32
                and MR.NEARESTMV <= mbmi.mode <= MR.NEWMV
                and mbmi.ref_frame[0] > 0 and mbmi.ref_frame[1] <= 0)

    def _masked_compound_allowed(self, bsize):
        # is_any_masked_compound_used == is_comp_ref_allowed (DIFFWTD is
        # usable whenever compound is)
        return min(int(BLOCK_WIDTH[bsize]), int(BLOCK_HEIGHT[bsize])) >= 8

    def _wedge_allowed(self, bsize):
        from ..normative.enums import BlockSize as BS
        return bsize in (BS.BLOCK_8X8, BS.BLOCK_8X16, BS.BLOCK_16X8,
                         BS.BLOCK_16X16, BS.BLOCK_16X32, BS.BLOCK_32X16,
                         BS.BLOCK_32X32, BS.BLOCK_8X32, BS.BLOCK_32X8)

    def _comp_group_idx_ctx(self, above, left_mb):
        ctx = 0
        for mb in (above, left_mb):
            if mb is not None:
                if mb.is_compound:
                    ctx += mb.comp_group_idx
                elif mb.ref_frame[0] == 7:  # ALTREF
                    ctx += 3
        return min(5, ctx)

    def _comp_index_ctx(self, mbmi, above, left_mb):
        from ..normative import mvref as MR
        cur = self.cur_order_hint
        bck = self.ref_order_hint(mbmi.ref_frame[0])
        fwd = self.ref_order_hint(mbmi.ref_frame[1])
        d_fwd = abs(MR.get_relative_dist(self.enable_order_hint,
                                         self.order_hint_bits, fwd, cur))
        d_bck = abs(MR.get_relative_dist(self.enable_order_hint,
                                         self.order_hint_bits, cur, bck))
        offset = int(d_fwd == d_bck)
        ctx = 0
        for mb in (above, left_mb):
            if mb is not None:
                if mb.is_compound:
                    ctx += mb.compound_idx
                elif mb.ref_frame[0] == 7:
                    ctx += 1
        return ctx + 3 * offset

    def _derive_warp_params(self, mbmi, xd):
        """WARPED_CAUSAL model fit (read_inter_block_mode_info tail:
        av1_selectSamples + av1_find_projection)."""
        from ..normative import mvref as MR
        from ..ops.warp import get_shear_params, find_projection
        pts, pts_inref = self._warp_pts
        if mbmi.num_proj_ref > 1:
            n, pts, pts_inref = MR.select_samples(mbmi.mv[0], pts, pts_inref,
                                                  mbmi.bsize)
            mbmi.num_proj_ref = n
        wm = MR.WarpModel()
        wm.wmtype = MR.ROTZOOM  # DEFAULT_WMTYPE
        ok = find_projection(mbmi.num_proj_ref, pts, pts_inref,
                             int(BLOCK_WIDTH[mbmi.bsize]),
                             int(BLOCK_HEIGHT[mbmi.bsize]),
                             mbmi.mv[0], wm, xd.mi_row, xd.mi_col)
        if not ok or not get_shear_params(wm):
            wm.invalid = True
        mbmi.wm_params = wm

    def _read_tx_size_vartx(self, mbmi, tx_size, depth, blk_row, blk_col,
                            mi_row, mi_col):
        """read_tx_size_vartx (decodeframe.c)."""
        bsize = mbmi.bsize
        max_h4 = min(int(MI_H[bsize]), self.mi_rows - mi_row)
        max_w4 = min(int(MI_W[bsize]), self.mi_cols - mi_col)
        if blk_row >= max_h4 or blk_col >= max_w4:
            return
        lr = mi_row & (self.sb_mi - 1)

        def set_size(ts, txb_size):
            bs2 = int(TXSIZE_TO_BSIZE[txb_size])
            h4 = int(MI_H[bs2])
            w4 = int(MI_W[bs2])
            r0 = mi_row + blk_row
            c0 = mi_col + blk_col
            self.mi_inter_tx[r0 : min(r0 + h4, self.mi_rows),
                             c0 : min(c0 + w4, self.mi_cols)] = ts
            mbmi.tx_size = ts
            # txfm_partition_update
            self.above_txfm[c0 : c0 + w4] = int(TX_WIDTH[ts])
            self.left_txfm[lr + blk_row : lr + blk_row + h4] = \
                int(TX_HEIGHT[ts])

        MAX_VARTX_DEPTH = 2
        if depth == MAX_VARTX_DEPTH:
            set_size(tx_size, tx_size)
            return
        # txfm_partition_context
        txw = int(TX_WIDTH[tx_size])
        txh = int(TX_HEIGHT[tx_size])
        above = int(self.above_txfm[mi_col + blk_col]) < txw
        leftv = int(self.left_txfm[lr + blk_row]) < txh
        max_dim = max(int(BLOCK_WIDTH[bsize]), int(BLOCK_HEIGHT[bsize]))
        max_sq_tx = {128: 4, 64: 4, 32: 3, 16: 2, 8: 1}.get(max_dim, 0)
        category = (int(int(TXSIZE_SQR_UP[tx_size]) != max_sq_tx
                        and max_sq_tx > 1)
                    + (5 - 1 - max_sq_tx) * 2)
        ctx = category * 3 + above + leftv
        is_split = self._read_symbol(self.fc.txfm_partition_cdf[ctx], 2)
        if is_split:
            sub_txs = int(SUB_TX_SIZE_MAP[tx_size])
            if sub_txs == TxSize.TX_4X4:
                set_size(sub_txs, tx_size)
                return
            bsw = int(TX_WIDE_UNIT[sub_txs])
            bsh = int(TX_HIGH_UNIT[sub_txs])
            for row in range(0, int(TX_HIGH_UNIT[tx_size]), bsh):
                for col in range(0, int(TX_WIDE_UNIT[tx_size]), bsw):
                    self._read_tx_size_vartx(mbmi, sub_txs, depth + 1,
                                             blk_row + row, blk_col + col,
                                             mi_row, mi_col)
        else:
            set_size(tx_size, tx_size)

    # ------------------------------------------------------------------
    def _predict_inter_block(self, mbmi, xd, is_chroma_ref):
        """av1_predict_inter_block: MC prediction for all planes."""
        from . import inter as IT
        mi_row, mi_col = mbmi.mi_row, mbmi.mi_col
        bw4, bh4 = int(MI_W[mbmi.bsize]), int(MI_H[mbmi.bsize])
        for plane in range(self.nplanes):
            if plane and not is_chroma_ref:
                break
            sx, sy = self.ss[plane]
            # setup_pred_plane: sub-4 chroma anchors at the even MI
            ax_mi = mi_col - (1 if (sx and (mi_col & 1) and bw4 == 1) else 0)
            ay_mi = mi_row - (1 if (sy and (mi_row & 1) and bh4 == 1) else 0)
            dst_x = (ax_mi * 4) >> sx
            dst_y = (ay_mi * 4) >> sy
            IT.build_inter_predictors(self, xd, mbmi, plane,
                                      self.planes[plane], dst_x, dst_y)
            if mbmi.ref_frame[1] == 0:  # INTRA_FRAME: interintra block
                self._build_interintra(mbmi, xd, plane, dst_x, dst_y)
        if mbmi.motion_mode == IT.OBMC_CAUSAL:
            self._obmc_prediction(mbmi, xd, is_chroma_ref)

    # interintra_to_intra_mode (reconinter.h): DC, V, H, SMOOTH
    _II_TO_INTRA = (0, 1, 2, 9)

    def _build_interintra(self, mbmi, xd, plane, dst_x, dst_y):
        """av1_build_interintra_predictor (reconinter.c:1152): one intra
        prediction covering the whole plane block (tx = max rect tx, edges
        from the recon frame), masked-blended onto the inter pred in dst."""
        from ..ops import compound as CP
        sx, sy = self.ss[plane]
        bsize = mbmi.bsize
        pbs = get_plane_block_size(bsize, sx, sy)
        tx_size = int(MAX_TXSIZE_RECT[pbs])
        mode = self._II_TO_INTRA[mbmi.interintra_mode]
        up, left = xd.up_available, xd.left_available
        intra = self._predict_intra(
            plane, dst_x, dst_y, tx_size, mode, 0, None, 0, 0, bsize,
            up, left, up, left, mbmi.partition, mbmi.mi_row, mbmi.mi_col)
        bw = int(BLOCK_WIDTH[pbs])
        bh = int(BLOCK_HEIGHT[pbs])
        buf = self.planes[plane]
        inter = buf[dst_y : dst_y + bh, dst_x : dst_x + bw]
        if mbmi.use_wedge_interintra:
            # INTERINTRA_WEDGE_SIGN = 0 (blockd.h:40); luma-sized mask
            mask = CP.wedge_mask(bsize, mbmi.interintra_wedge_index, 0)
            comp = CP.blend_a64_mask(intra[:bh, :bw], inter, mask,
                                     sx if plane else 0, sy if plane else 0)
        else:
            mask = CP.smooth_interintra_mask(mbmi.interintra_mode, pbs)
            comp = CP.blend_a64_mask(intra[:bh, :bw], inter, mask, 0, 0)
        buf[dst_y : dst_y + bh, dst_x : dst_x + bw] = comp

    def _obmc_prediction(self, mbmi, xd, is_chroma_ref):
        from . import inter as IT
        IT.obmc_predict(self, xd, mbmi, is_chroma_ref)

    def _store_cfl_inter(self, mbmi, mi_row, mi_col, bsize):
        """cfl_store_inter_block: keep the luma recon of non-chroma-ref
        blocks for a later chroma block's CfL."""
        x = mi_col * 4
        y = mi_row * 4
        bw = int(BLOCK_WIDTH[bsize])
        bh = int(BLOCK_HEIGHT[bsize])
        row, col = 0, 0
        if (mi_row & 1) and self.cfl.ss_y and bh == 4:
            row = 1
        if (mi_col & 1) and self.cfl.ss_x and bw == 4:
            col = 1
        buf = self.planes[0]
        luma = buf[y : y + bh, x : x + bw]
        self.cfl.store(luma.astype(np.int32), row, col)

    def _decode_residual_inter(self, mbmi, mi_row, mi_col, bsize,
                               is_chroma_ref):
        """decode_token_recon_block inter branch: per-64x64 unit, per-plane
        residual tree walk over the var-tx sizes."""
        max_w4 = min(int(MI_W[bsize]), self.mi_cols - mi_col)
        max_h4 = min(int(MI_H[bsize]), self.mi_rows - mi_row)
        mu_w = min(16, max_w4)
        mu_h = min(16, max_h4)
        for row in range(0, max_h4, mu_h):
            for col in range(0, max_w4, mu_w):
                for plane in range(self.nplanes):
                    if plane and not is_chroma_ref:
                        break
                    sx, sy = self.ss[plane]
                    pb = bsize if plane == 0 else get_plane_block_size(
                        scale_chroma_bsize(bsize, sx, sy), sx, sy)
                    if plane == 0:
                        max_tx = int(MAX_TXSIZE_RECT[pb])
                    else:
                        max_tx = TS.adjusted_tx_size(
                            int(MAX_TXSIZE_RECT[pb]))
                    stepr = int(TX_HIGH_UNIT[max_tx])
                    stepc = int(TX_WIDE_UNIT[max_tx])
                    unit_h = (min(mu_h + row, max_h4) + sy) >> sy
                    unit_w = (min(mu_w + col, max_w4) + sx) >> sx
                    for br in range(row >> sy, unit_h, stepr):
                        for bc in range(col >> sx, unit_w, stepc):
                            self._recon_tx_tree(mbmi, mi_row, mi_col, plane,
                                                pb, br, bc, max_tx)

    def _recon_tx_tree(self, mbmi, mi_row, mi_col, plane, plane_bsize,
                       blk_row, blk_col, tx_size):
        """decode_reconstruct_tx: descend to coded tx sizes, then read +
        inverse-transform the residual onto the MC prediction."""
        sx, sy = self.ss[plane]
        max_h4 = min(int(MI_H[plane_bsize]) if plane == 0 else 0, 0)
        # max block units for this plane
        mw4 = min(int(MI_W[mbmi.bsize]), self.mi_cols - mi_col)
        mh4 = min(int(MI_H[mbmi.bsize]), self.mi_rows - mi_row)
        max_w_u = (mw4 + sx) >> sx
        max_h_u = (mh4 + sy) >> sy
        del max_h4
        if blk_row >= max_h_u or blk_col >= max_w_u:
            return
        if plane:
            plane_tx = TS.adjusted_tx_size(
                int(MAX_TXSIZE_RECT[plane_bsize]))
            if self.lossless:
                plane_tx = int(TxSize.TX_4X4)
        else:
            plane_tx = int(self.mi_inter_tx[mi_row + blk_row,
                                            mi_col + blk_col])
        if tx_size == plane_tx or plane:
            self._inter_txb(mbmi, mi_row, mi_col, plane, plane_bsize,
                            blk_row, blk_col, plane_tx if plane else tx_size)
        else:
            sub_txs = int(SUB_TX_SIZE_MAP[tx_size])
            bsw = int(TX_WIDE_UNIT[sub_txs])
            bsh = int(TX_HIGH_UNIT[sub_txs])
            row_end = min(int(TX_HIGH_UNIT[tx_size]), max_h_u - blk_row)
            col_end = min(int(TX_WIDE_UNIT[tx_size]), max_w_u - blk_col)
            for r in range(0, row_end, bsh):
                for c in range(0, col_end, bsw):
                    self._recon_tx_tree(mbmi, mi_row, mi_col, plane,
                                        plane_bsize, blk_row + r,
                                        blk_col + c, sub_txs)

    def _read_tx_type_inter(self, tx_size):
        """av1_read_tx_type inter branch."""
        from ..normative.blocks import EXT_TX_SET_INDEX_INTER
        if self.fh.quant.base_q_idx == 0:
            return 0
        set_type = self._ext_tx_set_type_inter(tx_size)
        if int(NUM_EXT_TX_SET[set_type]) <= 1:
            return 0
        eset = EXT_TX_SET_INDEX_INTER[set_type]
        sqr = int(TXSIZE_SQR[tx_size])
        sym = self._read_symbol(self.fc.inter_ext_tx_cdf[eset][sqr],
                                int(NUM_EXT_TX_SET[set_type]))
        return int(EXT_TX_INV[set_type][sym])

    def _ext_tx_set_type_inter(self, tx_size):
        sqr_up = int(TXSIZE_SQR_UP[tx_size])
        if sqr_up > TxSize.TX_32X32:
            return 0  # DCTONLY
        if sqr_up == TxSize.TX_32X32:
            return 1  # DCT_IDTX
        if self.fh.reduced_tx_set:
            return 1
        sqr = int(TXSIZE_SQR[tx_size])
        return 4 if sqr == TxSize.TX_16X16 else 5

    def _inter_txb(self, mbmi, mi_row, mi_col, plane, plane_bsize, blk_row,
                   blk_col, tx_size):
        """Read one inter residual tx block and reconstruct in place."""
        fc = self.fc
        sx, sy = self.ss[plane]
        skip = 0
        wu = int(TX_WIDE_UNIT[tx_size])
        hu = int(TX_HIGH_UNIT[tx_size])
        ac = self.above_ent[plane]
        lc = self.left_ent[plane]
        acol = (mi_col >> sx) + blk_col
        lrow = ((mi_row & (self.sb_mi - 1)) >> sy) + blk_row
        skip_ctx, sign_ctx = C.get_txb_ctx(
            plane_bsize, tx_size, plane, ac[acol : acol + wu],
            lc[lrow : lrow + hu])
        tx_type_holder = [0]

        def read_tx_type():
            tt = self._read_tx_type_inter(tx_size)
            tx_type_holder[0] = tt
            return tt

        if plane == 0:
            coeff, eob, cul = C.read_coeffs_txb(
                self.dec, fc, tx_size, 0, plane, skip_ctx, sign_ctx,
                read_tx_type_fn=read_tx_type)
            tx_type = tx_type_holder[0] if eob else 0
            self.tx_type_map[mi_row + blk_row, mi_col + blk_col] = tx_type
            # update_txk_array (blockd.h:1259): 64-dim transforms cover all
            # 16x16 units so sub-sampled chroma lookups see the type
            if wu == 16 or hu == 16:
                for idy in range(0, hu, 4):
                    for idx in range(0, wu, 4):
                        rr = min(mi_row + blk_row + idy, self.mi_rows - 1)
                        cc = min(mi_col + blk_col + idx, self.mi_cols - 1)
                        self.tx_type_map[rr, cc] = tx_type
        else:
            # inter chroma tx type: follows the co-located luma tx type when
            # luma tx is >= the chroma tx (av1_get_tx_type: inter uses the
            # luma tx_type_map entry at the chroma position)
            base_r = mi_row + (blk_row << sy)
            base_c = mi_col + (blk_col << sx)
            tx_type = int(self.tx_type_map[min(base_r, self.mi_rows - 1),
                                           min(base_c, self.mi_cols - 1)])
            if self.lossless or int(TXSIZE_SQR_UP[tx_size]) > TxSize.TX_32X32:
                tx_type = 0
            else:
                set_type = self._ext_tx_set_type_inter(tx_size)
                if not (int(EXT_TX_USED_FLAG[set_type]) >> tx_type) & 1:
                    tx_type = 0
            coeff, eob, cul = C.read_coeffs_txb(
                self.dec, fc, tx_size, tx_type, plane, skip_ctx, sign_ctx)
        # entropy ctx update with frame-edge clipping
        bw_px = int(BLOCK_WIDTH[plane_bsize])
        bh_px = int(BLOCK_HEIGHT[plane_bsize])
        over_x = ((self.mi_cols - (mi_col + int(MI_W[mbmi.bsize]))) * 4) >> sx
        over_y = ((self.mi_rows - (mi_row + int(MI_H[mbmi.bsize]))) * 4) >> sy
        vis_w = (bw_px + min(over_x, 0)) >> 2
        vis_h = (bh_px + min(over_y, 0)) >> 2
        nw = max(0, min(wu, vis_w - blk_col))
        nh = max(0, min(hu, vis_h - blk_row))
        ac[acol : acol + nw] = cul
        ac[acol + nw : acol + wu] = 0
        lc[lrow : lrow + nh] = cul
        lc[lrow + nh : lrow + hu] = 0
        del skip
        if eob <= 0:
            return
        x = ((mi_col >> sx) << 2) + (blk_col << 2)
        y = ((mi_row >> sy) << 2) + (blk_row << 2)
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        buf = self.planes[plane]
        pred = buf[y : y + txh, x : x + txw]
        dq = self._dequant(coeff, plane, tx_size, tx_type)
        if self.lossless:
            rec = txfm_ops.iwht4x4_add(dq[None], pred[None, :4, :4],
                                       bd=self.bd)[0]
        else:
            ts_adj = TS.adjusted_tx_size(tx_size)
            cw = int(TX_WIDTH[ts_adj])
            ch = int(TX_HEIGHT[ts_adj])
            full = np.zeros((txw, txh), np.int32)
            full[:cw, :ch] = dq.reshape(cw, ch)
            rec = txfm_ops.inv_txfm2d_add(full[None], pred[None], tx_size,
                                          tx_type, bd=self.bd)[0]
        vh = min(txh, buf.shape[0] - y)
        vw = min(txw, buf.shape[1] - x)
        buf[y : y + vh, x : x + vw] = rec[:vh, :vw]

    def _copy_frame_mvs(self, mbmi, mi_row, mi_col, bw4, bh4):
        """av1_copy_frame_mvs: store one MV per 8x8 for temporal MVP."""
        from ..normative import mvref as MR
        x0 = mi_col >> 1
        y0 = mi_row >> 1
        xm = (min(bw4, self.mi_cols - mi_col) + 1) >> 1
        ym = (min(bh4, self.mi_rows - mi_row) + 1) >> 1
        ref = -1
        mv = (0, 0)
        if mbmi.is_inter:
            for idx in range(2):
                rf = mbmi.ref_frame[idx]
                if rf > MR.INTRA_FRAME:
                    if self.ref_frame_side[rf]:
                        continue
                    if abs(mbmi.mv[idx][0]) > MR.REFMVS_LIMIT or \
                            abs(mbmi.mv[idx][1]) > MR.REFMVS_LIMIT:
                        continue
                    ref = rf
                    mv = mbmi.mv[idx]
        self.frame_mvs_ref[y0 : y0 + ym, x0 : x0 + xm] = ref
        self.frame_mvs[y0 : y0 + ym, x0 : x0 + xm] = mv

    # ------------------------------------------------------------------
    def apply_loop_filter(self):
        from ..ops import deblock
        # luma tx grid: per-4x4 var-tx sizes for inter frames (mi_inter_tx is
        # also filled with the coded size for intra/skip blocks there)
        tx_grid = self.mi_tx_size if self.frame_is_intra else self.mi_inter_tx
        info = deblock.DeblockInfo(tx_grid, self.mi_bsize,
                                   self.mi_skip, self.mi_is_inter,
                                   self.mi_rows, self.mi_cols,
                                   mi_ref0=self.mi_ref0, mi_mode=self.mi_mode,
                                   mi_borigin_r=self.mi_borigin_r,
                                   mi_borigin_c=self.mi_borigin_c)
        for p in range(self.nplanes):
            deblock.loop_filter_plane(self.planes[p], p, info, self.fh,
                                      self.seq, uv_tx_grid=self.mi_uv_tx)
        self.deblocked = [p.copy() for p in self.planes]
        if self.seq.enable_cdef and not self.lossless \
                and not self.fh.allow_intrabc:
            from ..ops import cdef as cdef_ops
            # per-fb strength = the covering block's transmitted value at
            # each 64x64 unit's top-left mi (cdef_fb_col reads that mbmi)
            unit_strength = self.mi_cdef[::16, ::16]
            cdef_ops.cdef_frame(self.planes, self.mi_skip,
                                unit_strength, self.fh, self.seq,
                                self.mi_rows, self.mi_cols)
        if self.fh.use_superres:
            # superres_post_decode: upscale CDEF output AND the saved
            # deblock boundary source before LR (decodeframe.c:5305;
            # boundary lines are upscaled rows of the deblocked frame,
            # restoration.c save_deblock_boundary_lines)
            from ..ops import resize as RZ
            self.planes = RZ.upscale_normative_frame(self.planes, self.fh,
                                                     self.seq)
            self.deblocked = RZ.upscale_normative_frame(self.deblocked,
                                                        self.fh, self.seq)
            self.w = self.fh.upscaled_width
        _lr_apply(self)

    # ------------------------------------------------------------------
    def output_frame(self):
        from ..utils.frame import Frame
        y = np.clip(self.planes[0][: self.h, : self.w], 0, 255).astype(np.uint8)
        if self.nplanes == 1:
            return Frame(y, None, None)
        sx, sy = self.ss[1]
        cw = (self.w + sx) >> sx
        ch = (self.h + sy) >> sy
        u = np.clip(self.planes[1][:ch, :cw], 0, 255).astype(np.uint8)
        v = np.clip(self.planes[2][:ch, :cw], 0, 255).astype(np.uint8)
        return Frame(y, u, v)


# ---------------------------------------------------------------------------
# Loop restoration state + parse + apply (decodeframe.c read_lr,
# restoration.c apply) — attached to FrameDecoder
# ---------------------------------------------------------------------------

def _lr_init(self):
    """Set up per-plane restoration unit grids from the frame header."""
    from ..ops import restoration as R
    # coded 2-bit value remaps: 0 NONE, 1 SWITCHABLE, 2 WIENER, 3 SGRPROJ
    # (obu.c remap_lr_type); internally: 1=wiener, 2=sgrproj, 3=switchable
    remap = {0: 0, 1: 3, 2: 1, 3: 2}
    self.lr_planes = []
    for p in range(self.nplanes):
        rtype = remap[self.fh.lr_type[p]]
        if rtype == 0:
            self.lr_planes.append(None)
            continue
        sx, sy = self.ss[p]
        usize = (64 << self.fh.lr_unit_shift)
        if p:
            usize >>= self.fh.lr_uv_shift
        # LR units live in the (superres-)upscaled frame geometry
        w = (self.fh.upscaled_width + sx) >> sx
        h = (self.h + sy) >> sy
        hunits = max((w + (usize >> 1)) // usize, 1)
        vunits = max((h + (usize >> 1)) // usize, 1)
        self.lr_planes.append({
            "frame_type": rtype, "usize": usize, "w": w, "h": h,
            "hunits": hunits, "vunits": vunits,
            "units": [None] * (hunits * vunits),
        })


def _lr_reset_refs(self):
    """av1_reset_loop_restoration: per-tile subexp references."""
    self.lr_wiener_ref = []
    self.lr_sgr_ref = []
    for _ in range(self.nplanes):
        f = [3, -7, 15, -2 * (3 - 7 + 15), 15, -7, 3, 0]
        self.lr_wiener_ref.append({"v": list(f), "h": list(f)})
        # C truncating division: (SGRPROJ_PRJ_MIN0 + SGRPROJ_PRJ_MAX0) / 2 =
        # -65/2 = -32 (Python floor // would give -33)
        self.lr_sgr_ref.append([int((-96 + 31) / 2), (-32 + 95) // 2])


def _lr_read_unit(self, plane, runit_idx):
    from ..ec import binary_codes as BC
    from ..ops import restoration as R
    lp = self.lr_planes[plane]
    fc = self.fc
    dec = self.dec
    frame_type = lp["frame_type"]
    wiener_win = 5 if plane else 7
    if frame_type == 3:  # RESTORE_SWITCHABLE
        rtype = dec.decode_symbol(fc.switchable_restore_cdf, 3)
    elif frame_type == 1:  # WIENER
        rtype = 1 if dec.decode_symbol(fc.wiener_restore_cdf, 2) else 0
    else:  # SGRPROJ
        rtype = 2 if dec.decode_symbol(fc.sgrproj_restore_cdf, 2) else 0

    if rtype == 1:  # wiener
        ref = self.lr_wiener_ref[plane]
        taps = {"v": [0] * 8, "h": [0] * 8}
        specs = [  # (min, max, subexp k) per tap 0..2
            (-5, 10, 1), (-23, 8, 2), (-17, 46, 3)]
        for dim in ("v", "h"):
            for t, (mn, mx, k) in enumerate(specs):
                if t == 0 and wiener_win != 7:
                    taps[dim][0] = taps[dim][6] = 0
                    continue
                v = BC.read_primitive_refsubexpfin(
                    dec, mx - mn + 1, k, ref[dim][t] - mn) + mn
                taps[dim][t] = taps[dim][6 - t] = v
            taps[dim][3] = -2 * (taps[dim][0] + taps[dim][1] + taps[dim][2])
            ref[dim] = list(taps[dim])
        unit = ("wiener", taps["v"], taps["h"])
    elif rtype == 2:  # sgrproj
        ref = self.lr_sgr_ref[plane]
        ep = dec.read_literal(4)
        (r0, r1), _ = R.SGR_PARAMS[ep]
        if r0 == 0:
            x0 = 0
            x1 = BC.read_primitive_refsubexpfin(
                dec, R.SGRPROJ_PRJ_MAX1 - R.SGRPROJ_PRJ_MIN1 + 1, 4,
                ref[1] - R.SGRPROJ_PRJ_MIN1) + R.SGRPROJ_PRJ_MIN1
        elif r1 == 0:
            x0 = BC.read_primitive_refsubexpfin(
                dec, R.SGRPROJ_PRJ_MAX0 - R.SGRPROJ_PRJ_MIN0 + 1, 4,
                ref[0] - R.SGRPROJ_PRJ_MIN0) + R.SGRPROJ_PRJ_MIN0
            x1 = int(np.clip((1 << 7) - x0, R.SGRPROJ_PRJ_MIN1,
                             R.SGRPROJ_PRJ_MAX1))
        else:
            x0 = BC.read_primitive_refsubexpfin(
                dec, R.SGRPROJ_PRJ_MAX0 - R.SGRPROJ_PRJ_MIN0 + 1, 4,
                ref[0] - R.SGRPROJ_PRJ_MIN0) + R.SGRPROJ_PRJ_MIN0
            x1 = BC.read_primitive_refsubexpfin(
                dec, R.SGRPROJ_PRJ_MAX1 - R.SGRPROJ_PRJ_MIN1 + 1, 4,
                ref[1] - R.SGRPROJ_PRJ_MIN1) + R.SGRPROJ_PRJ_MIN1
        self.lr_sgr_ref[plane] = [x0, x1]
        unit = ("sgrproj", ep, (x0, x1))
    else:
        unit = ("none",)
    lp["units"][runit_idx] = unit


def _lr_read_for_sb(self, mi_row, mi_col):
    """av1_loop_restoration_corners_in_sb + unit reads, at SB roots."""
    if not hasattr(self, "lr_planes"):
        _lr_init(self)
    for plane in range(self.nplanes):
        lp = self.lr_planes[plane]
        if lp is None:
            continue
        sx, sy = self.ss[plane]
        size = lp["usize"]
        mi_size_x = 4 >> sx
        mi_size_y = 4 >> sy
        # With superres the SB's mi position maps to upscaled pixels:
        # u = D * MI_SIZE * m / 8 (av1_loop_restoration_corners_in_sb)
        if self.fh.use_superres:
            mi_to_num_x = mi_size_x * self.fh.superres_denom
            denom_x = size * 8
        else:
            mi_to_num_x = mi_size_x
            denom_x = size
        mi_rel_row0, mi_rel_col0 = mi_row, mi_col
        mi_rel_row1 = mi_row + self.sb_mi
        mi_rel_col1 = mi_col + self.sb_mi
        rcol0 = (mi_rel_col0 * mi_to_num_x + denom_x - 1) // denom_x
        rrow0 = (mi_rel_row0 * mi_size_y + size - 1) // size
        rcol1 = min((mi_rel_col1 * mi_to_num_x + denom_x - 1) // denom_x,
                    lp["hunits"])
        rrow1 = min((mi_rel_row1 * mi_size_y + size - 1) // size,
                    lp["vunits"])
        if rcol0 < rcol1 and rrow0 < rrow1:
            for rr in range(rrow0, rrow1):
                for rc in range(rcol0, rcol1):
                    _lr_read_unit(self, plane, rc + rr * lp["hunits"])


def _lr_apply(self):
    """av1_loop_restoration_filter_frame with stripe boundary handling.

    When CDEF and superres are both inactive the reference decoder takes the
    optimized-LR path (decodeframe.c:5279 ``optimized_loop_restoration =
    !do_cdef && !do_superres``): no deblock boundary lines are swapped in;
    instead the 3rd border row above/below each stripe is a duplicate of the
    2nd row of the *current* frame data (restoration.c:345-366 ``opt`` arm of
    setup_processing_stripe_boundary)."""
    from ..ops import restoration as R
    if not hasattr(self, "lr_planes") or all(
            lp is None for lp in self.lr_planes):
        return
    c = self.fh.cdef
    do_cdef = (self.seq.enable_cdef and not self.lossless
               and not self.fh.allow_intrabc
               and bool(c.bits or (c.y_pri[0] * 4 + c.y_sec[0])
                        or (c.uv_pri[0] * 4 + c.uv_sec[0]
                            if c.uv_pri else 0)))
    optimized = not do_cdef and not self.fh.use_superres
    for plane in range(self.nplanes):
        lp = self.lr_planes[plane]
        if lp is None:
            continue
        sx, sy = self.ss[plane]
        w, h = lp["w"], lp["h"]
        usize = lp["usize"]
        src = self.planes[plane]  # CDEF output
        deb = self.deblocked[plane]  # pre-CDEF (deblocked)
        dst = src.copy()
        stripe_h = 64 >> sy
        off = 8 >> sy
        pw = 64 >> sx  # processing chunk width

        # crop then pad: 3 left, 3+16 right so padded wiener chunks fit
        def padded(arr):
            return np.pad(arr[:h, :w].astype(np.int64), ((0, 0), (3, 19)),
                          mode="edge")

        src_p = padded(src)
        deb_p = padded(deb)

        def boundaries(total):
            ext_sz = usize * 3 // 2
            pos = [0]
            x = 0
            while x < total:
                rem = total - x
                x += rem if rem < ext_sz else usize
                pos.append(x)
            return pos

        vb = boundaries(h)
        hb = boundaries(w)
        for ui in range(len(vb) - 1):
            for uj in range(len(hb) - 1):
                unit = lp["units"][ui * lp["hunits"] + uj]
                if unit is None or unit[0] == "none":
                    continue
                v0, v1 = vb[ui], vb[ui + 1]
                h0, h1 = hb[uj], hb[uj + 1]
                wu = h1 - h0
                wu_pad = (wu + 18) & ~15  # room for padded wiener chunks
                i = v0
                while i < v1:
                    tile_stripe = (i + off) // stripe_h
                    nominal = stripe_h - (off if tile_stripe == 0 else 0)
                    sh = min(nominal, v1 - i)
                    ys0 = i
                    copy_above = ys0 != 0
                    copy_below = (ys0 + sh) < h
                    # (sh+6, wu_pad+6) source: columns h0-3 .. h0+wu_pad+3
                    rows = np.clip(np.arange(ys0 - 3, ys0 + sh + 3), 0, h - 1)
                    cs = slice(h0, h0 + wu_pad + 6)  # +3 offset baked in pad
                    ext = src_p[rows][:, cs].copy()
                    if optimized:
                        # opt arm: only the outermost border rows are
                        # overwritten, with the adjacent current-data row
                        if copy_above:
                            ext[0] = ext[1]
                        if copy_below:
                            ext[sh + 5] = ext[sh + 4]
                    elif copy_above or copy_below:
                        if copy_above:
                            ext[0] = deb_p[ys0 - 2, cs]
                            ext[1] = deb_p[ys0 - 2, cs]
                            ext[2] = deb_p[ys0 - 1, cs]
                        if copy_below:
                            yb = ys0 + sh
                            yb1 = min(yb + 1, h - 1)
                            ext[sh + 3] = deb_p[yb, cs]
                            ext[sh + 4] = deb_p[yb1, cs]
                            ext[sh + 5] = deb_p[yb1, cs]
                    out = np.empty((sh, wu), np.int32)
                    j = 0
                    while j < wu:
                        if unit[0] == "wiener":
                            cw = min(pw, ((wu - j) + 15) & ~15)
                            seg = ext[:, j : j + cw + 6]
                            got = R.wiener_convolve(seg, unit[2], unit[1])
                        else:
                            cw = min(pw, wu - j)
                            seg = ext[:, j : j + cw + 6]
                            got = R.apply_sgr(seg, unit[1], unit[2])
                        n = min(cw, wu - j)
                        out[:, j : j + n] = got[:, :n]
                        j += cw
                    dst[ys0 : ys0 + sh, h0:h1] = out
                    i += sh
        self.planes[plane][:h, :w] = dst[:h, :w]
