"""All-intra frame encoder — the minimum end-to-end slice.

Mirrors the decoder's traversal and syntax (``av1/encoder/bitstream.c`` pack
path + ``encodeframe.c`` walk) writing a conforming AV1 intra stream:
partition tree, intra mode syntax, transform + quantize + coefficient
coding, in-loop recon identical to the decoder's.

Round-1 decision making is deliberately simple (uniform partition, SSE-best
intra mode against in-loop recon edges, largest-tx); the search machinery
widens in later rounds — the *syntax* written here is complete and
conformant for the tools it uses.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..bitstream.headers import (SequenceHeader, FrameHeader, TileInfo,
                                 write_frame_header)
from ..bitstream.bitio import BitWriter, write_leb128
from ..ec.coder import Encoder
from ..ec.native_coder import make_encoder
from ..ec.context import FrameContext
from ..ec import coeffs as C
from ..normative import tables
from ..normative.enums import (BlockSize, Partition, PredictionMode, TxSize,
                               BLOCK_WIDTH, BLOCK_HEIGHT, TX_WIDTH, TX_HEIGHT)
from ..normative.blocks import (MI_W, MI_H, PARTITION_CTX_ABOVE,
                                PARTITION_CTX_LEFT, INTRA_MODE_CONTEXT,
                                INTRA_MODE_TO_TX_TYPE, EXT_TX_USED_FLAG,
                                NUM_EXT_TX_SET, EXT_TX_SET_INDEX_INTRA,
                                EXT_TX_IND, get_partition_subsize,
                                get_plane_block_size, scale_chroma_bsize,
                                is_directional_mode)
from ..normative.txsize import MAX_TXSIZE_RECT, TX_WIDE_UNIT, TX_HIGH_UNIT
from ..normative import txsize as TS
from ..ops import intra as intra_ops
from ..ops import txfm_host as txfm_ops
from ..decoder.frame import (partition_cdf_length, gather_partition_cdf,
                             CflCtx)
from ..utils.frame import Frame


@dataclasses.dataclass
class EncoderConfig:
    """Mirror of the subset of aom_codec_enc_cfg_t we drive (aom/aom_encoder.h)."""

    base_q_idx: int = 60
    lossless: bool = False
    block_size: int = int(BlockSize.BLOCK_16X16)  # max partition size
    # intra mode candidates: modes needing top-right/bottom-left extensions
    # (D45/D203/D67) join once the encoder mirrors that availability
    modes: tuple = (0, 1, 2, 4, 5, 6, 9, 10, 11, 12)
    uv_modes: tuple = (0, 1, 2, 9, 10, 11, 12)
    rd_modes: bool = True        # RD (dist+rate) mode decision vs pred-SSE
    adaptive_partition: bool = True   # variance-based split below block_size
    search_lpf: bool = True      # picklpf-style filter level search
    search_cdef: bool = False    # CDEF strength search (enables CDEF syntax)
    cdef_fixed: bool = False     # CDEF with quantizer-derived strengths
    tune_psy: bool = False       # psy rdmult modulation (SSIM factors)
    tune_butteraugli: bool = False  # butteraugli-lite masking rdmult grid
    tune_vmaf: bool = False      # VIF-optimal unsharp source preprocessing
    tile_cols_log2: int = 0      # vertical tile columns (fused path only)
    try_smooth64: bool = True    # RD-picked uniform-64 (TX_64X64) fallback
                                 # on smooth KEY frames (fused path only)

    def __post_init__(self):
        if self.lossless:
            self.base_q_idx = 0
        # config validation (av1_validate_config / aom_codec_enc_config_set
        # AOM_CODEC_INVALID_PARAM contract)
        from ..errors import Av1InvalidParamError
        if not (0 <= int(self.base_q_idx) <= 255):
            raise Av1InvalidParamError(
                f"base_q_idx {self.base_q_idx} outside [0, 255]")
        if self.block_size not in (int(BlockSize.BLOCK_8X8),
                                   int(BlockSize.BLOCK_16X16),
                                   int(BlockSize.BLOCK_32X32),
                                   int(BlockSize.BLOCK_64X64)):
            raise Av1InvalidParamError(
                f"unsupported max partition bsize {self.block_size}")
        if not (0 <= int(self.tile_cols_log2) <= 6):
            raise Av1InvalidParamError(
                f"tile_cols_log2 {self.tile_cols_log2} outside [0, 6]")


class FrameEncoder:
    """Encodes one all-intra KEY frame; maintains in-loop recon."""

    def __init__(self, frame: Frame, cfg: EncoderConfig):
        self.cfg = cfg
        self.src = frame
        self.w, self.h = frame.width, frame.height
        self.mi_cols = (self.w + 7) // 8 * 2
        self.mi_rows = (self.h + 7) // 8 * 2
        self.sb_mi = 16
        self.nplanes = 1 if frame.monochrome else 3
        self.ss = [(0, 0)] + [(frame.subsampling_x, frame.subsampling_y)] * 2
        self.ss = self.ss[: self.nplanes]
        self.lossless = cfg.lossless or cfg.base_q_idx == 0

        # mi-aligned source + recon planes (int32), source padded by edge
        # replication so cost search sees sane values
        self.srcp = []
        self.planes = []
        for p, (sx, sy) in enumerate(self.ss):
            # +64 padding mirrors the decoder's buffers (full tx-block
            # writes may overhang the mi area; deblock masks at the right
            # mi edge read a few columns beyond it)
            pw = ((self.mi_cols * 4) >> sx) + 64
            ph = ((self.mi_rows * 4) >> sy) + 64
            s = frame.planes()[p].astype(np.int32)
            pad = np.zeros((ph, pw), np.int32)
            pad[: s.shape[0], : s.shape[1]] = s
            if s.shape[1] < pw:
                pad[: s.shape[0], s.shape[1] :] = s[:, -1:]
            if s.shape[0] < ph:
                pad[s.shape[0] :, :] = pad[s.shape[0] - 1 : s.shape[0], :]
            self.srcp.append(pad)
            self.planes.append(np.zeros((ph, pw), np.int32))

        shape = (self.mi_rows, self.mi_cols)
        g = lambda fill=0: np.full(shape, fill, np.int32)
        self.mi_mode = g(PredictionMode.DC_PRED)
        self.mi_uv_mode = g(0)
        self.mi_skip = g(0)
        self.mi_valid = g(0)
        self.mi_tx_size = g(int(TxSize.TX_4X4))
        self.mi_uv_tx = g(int(TxSize.TX_4X4))
        self.mi_bsize = g(int(BlockSize.BLOCK_4X4))

        q = cfg.base_q_idx
        self.dequant = []
        for p in range(self.nplanes):
            self.dequant.append((tables.dc_quant(q), tables.ac_quant(q)))

        from ..ec import costs as EC_costs
        self.rdmult = EC_costs.compute_rd_mult(q)
        self.ssim_factors = None
        if cfg.tune_psy and not self.lossless:
            from . import psy as psy_mod
            self.ssim_factors = psy_mod.ssim_rdmult_scaling_factors(
                frame.planes()[0])

    # ------------------------------------------------------------------
    def make_headers(self) -> tuple[SequenceHeader, FrameHeader]:
        seq = SequenceHeader(
            max_frame_width=self.w, max_frame_height=self.h,
            frame_width_bits=max(self.w - 1, 1).bit_length(),
            frame_height_bits=max(self.h - 1, 1).bit_length(),
            enable_filter_intra=False, enable_intra_edge_filter=True,
            enable_cdef=bool(self.cfg.search_cdef and not self.lossless),
            enable_restoration=False,
            monochrome=self.nplanes == 1)
        fh = FrameHeader(width=self.w, height=self.h,
                         render_width=self.w, render_height=self.h)
        fh.quant.base_q_idx = self.cfg.base_q_idx
        fh.tx_mode_select = False  # TX_MODE_LARGEST
        fh.tiles = TileInfo()
        if not self.lossless:
            # keyframe first-guess filter level (picklpf.c:247), no search yet
            q = tables.ac_quant(self.cfg.base_q_idx)
            guess = (q * 17563 - 421574 + (1 << 17)) >> 18
            lvl = int(np.clip(guess, 0, 63))
            fh.lf.filter_level = (lvl, lvl)
            fh.lf.filter_level_u = lvl
            fh.lf.filter_level_v = lvl
        return seq, fh

    # ------------------------------------------------------------------
    def encode(self, include_seq: bool = True) -> bytes:
        """Returns a full temporal unit (TD [+ sequence header] + frame OBU)."""
        seq, fh = self.make_headers()
        self.seq, self.fh = seq, fh
        self.fc = FrameContext(self.cfg.base_q_idx)
        self.enc = make_encoder()
        self.enc.allow_update = not fh.disable_cdf_update

        ncols = (self.mi_cols + self.sb_mi - 1) // self.sb_mi * self.sb_mi
        self.above_part = np.zeros(ncols, np.int32)
        self.above_ent = [np.zeros(ncols >> sx, np.uint8) for sx, _ in self.ss]
        for r0 in range(0, self.mi_rows, self.sb_mi):
            self.left_part = np.zeros(self.sb_mi, np.int32)
            self.left_ent = [np.zeros(self.sb_mi >> sy, np.uint8)
                             for _, sy in self.ss]
            for c0 in range(0, self.mi_cols, self.sb_mi):
                self.encode_partition(r0, c0, int(BlockSize.BLOCK_64X64))
        tile_data = self.enc.done()

        if not self.lossless and self.cfg.search_lpf:
            self._search_lpf()
        if not self.lossless and self.cfg.search_cdef:
            self._search_cdef()

        # assemble OBUs
        td = bytes([0x12, 0x00])  # temporal delimiter w/ size 0
        seq_obu = b""
        if include_seq:
            w = BitWriter()
            seq.write(w)
            w.trailing_bits()
            seq_payload = w.data()
            seq_obu = bytes([0x0A]) + write_leb128(len(seq_payload)) \
                + seq_payload
        w = BitWriter()
        write_frame_header(w, seq, fh)
        w.byte_align()
        frame_payload = w.data() + tile_data
        frame_obu = bytes([0x32]) + write_leb128(len(frame_payload)) + \
            frame_payload
        return td + seq_obu + frame_obu

    # ------------------------------------------------------------------
    def partition_ctx(self, mi_row, mi_col, bsize):
        bsl = int(MI_W[bsize]).bit_length() - 2
        above = (int(self.above_part[mi_col]) >> bsl) & 1
        left = (int(self.left_part[mi_row & (self.sb_mi - 1)]) >> bsl) & 1
        return (left * 2 + above) + bsl * 4

    def update_partition_ctx(self, mi_row, mi_col, subsize, bsize):
        bw, bh = int(MI_W[bsize]), int(MI_H[bsize])
        self.above_part[mi_col : mi_col + bw] = PARTITION_CTX_ABOVE[subsize]
        lr = mi_row & (self.sb_mi - 1)
        self.left_part[lr : lr + bh] = PARTITION_CTX_LEFT[subsize]

    def _should_split(self, mi_row, mi_col, bsize):
        """Variance-based split decision (av1/encoder/var_based_part.c
        idea): split when the quadrants of the source block look unlike
        each other or carry high detail relative to the quantizer."""
        x, y = mi_col * 4, mi_row * 4
        w = int(BLOCK_WIDTH[bsize])
        h = int(BLOCK_HEIGHT[bsize])
        src = self.srcp[0][y : y + h, x : x + w].astype(np.int64)
        if src.shape != (h, w):
            return True  # partial block: keep splitting
        hw, hh = w // 2, h // 2
        quads = [src[:hh, :hw], src[:hh, hw:], src[hh:, :hw], src[hh:, hw:]]
        means = np.array([q.mean() for q in quads])
        qvars = np.array([q.var() for q in quads])
        ac_q = self.dequant[0][1]
        thr = (ac_q * ac_q) / 4.0
        spread = means.max() - means.min()
        return bool(qvars.max() > thr or spread * spread > 4 * thr)

    def encode_partition(self, mi_row, mi_col, bsize):
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        hbs = int(MI_W[bsize]) // 2
        has_rows = mi_row + hbs < self.mi_rows
        has_cols = mi_col + hbs < self.mi_cols
        # partition decision: SPLIT above cfg.block_size; below that, a
        # variance-based split rule (var_based_part.c analogue); frame-edge
        # blocks must keep splitting (NONE is not codable there)
        target = self.cfg.block_size
        if bsize > target or not (has_rows and has_cols):
            partition = Partition.SPLIT
        elif (self.cfg.adaptive_partition and not self.lossless
              and bsize > BlockSize.BLOCK_8X8
              and self._should_split(mi_row, mi_col, bsize)):
            partition = Partition.SPLIT
        else:
            partition = Partition.NONE
        if bsize >= BlockSize.BLOCK_8X8:
            ctx = self.partition_ctx(mi_row, mi_col, bsize)
            if not has_rows and not has_cols:
                assert partition == Partition.SPLIT
            elif has_rows and has_cols:
                self.enc.encode_symbol(int(partition),
                                       self.fc.partition_cdf[ctx],
                                       partition_cdf_length(bsize))
            elif has_cols:
                assert partition in (Partition.SPLIT, Partition.HORZ)
                cdf2 = gather_partition_cdf(self.fc.partition_cdf[ctx], bsize,
                                            horz=False)
                self.enc.encode_cdf(int(partition == Partition.SPLIT), cdf2, 2)
            else:
                assert partition in (Partition.SPLIT, Partition.VERT)
                cdf2 = gather_partition_cdf(self.fc.partition_cdf[ctx], bsize,
                                            horz=True)
                self.enc.encode_cdf(int(partition == Partition.SPLIT), cdf2, 2)
        else:
            partition = Partition.NONE
        subsize = get_partition_subsize(bsize, partition)

        if partition == Partition.NONE:
            self.encode_block(mi_row, mi_col, subsize)
        else:  # SPLIT
            self.encode_partition(mi_row, mi_col, subsize)
            self.encode_partition(mi_row, mi_col + hbs, subsize)
            self.encode_partition(mi_row + hbs, mi_col, subsize)
            self.encode_partition(mi_row + hbs, mi_col + hbs, subsize)
        if bsize >= BlockSize.BLOCK_8X8:
            if partition == Partition.NONE or bsize == BlockSize.BLOCK_8X8:
                self.update_partition_ctx(mi_row, mi_col, subsize, bsize)

    # ------------------------------------------------------------------
    def _predict(self, plane, x, y, tx_size, mode, have_above, have_left,
                 n_top, n_tr, n_left, n_bl, angle_delta=0):
        buf = self.planes[plane]
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        above_ref = np.zeros(2 * (txw + txh) + 2, np.int32)
        left_ref = np.zeros(2 * (txw + txh) + 2, np.int32)
        tl = 128
        if n_top > 0:
            n = min(n_top + max(n_tr, 0), buf.shape[1] - x)
            above_ref[:n] = buf[y - 1, x : x + n]
            need = n_top + max(n_tr, 0)
            if n < need:
                above_ref[n:need] = above_ref[n - 1]
        if n_left > 0:
            n = min(n_left + max(n_bl, 0), buf.shape[0] - y)
            left_ref[:n] = buf[y : y + n, x - 1]
            need = n_left + max(n_bl, 0)
            if n < need:
                left_ref[n:need] = left_ref[n - 1]
        if n_top > 0 and n_left > 0:
            tl = int(buf[y - 1, x - 1])
        return intra_ops.build_intra_predictor(
            above_ref, left_ref, tl, n_top, n_tr, n_left, n_bl, mode,
            angle_delta, txw, txh,
            disable_edge_filter=not self.seq.enable_intra_edge_filter,
            intra_edge_filter_type=self._ef_type(plane), bd=8)

    def _ef_type(self, plane):
        return self.ef_types[1 if plane else 0]

    def _edge_counts(self, plane, bsize, mi_row, mi_col, tx_size, blk_row,
                     blk_col, have_top, have_left, pmode, angle_delta, x, y):
        """Decoder-identical edge-pixel counts including top-right /
        bottom-left availability (mirrors the decoder's predict_intra
        set-up; reconintra.c av1_predict_intra_block).  The encoder's
        in-loop recon must match the decoder's bit-exactly, so the edge
        extension decisions are shared via normative/intra_avail."""
        from ..normative import intra_avail as IA
        from ..normative.enums import MODE_TO_ANGLE
        sx, sy = self.ss[plane]
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        bsize_eff = scale_chroma_bsize(bsize, sx, sy) if (sx or sy) else bsize
        bx, by = blk_col * 4, blk_row * 4
        frame_w = (self.mi_cols * 4) >> sx
        frame_h = (self.mi_rows * 4) >> sy
        xr = frame_w - (x - bx) - bx - txw
        yd = frame_h - (y - by) - by - txh
        wu, hu = int(TX_WIDE_UNIT[tx_size]), int(TX_HIGH_UNIT[tx_size])
        right_avail = (mi_col + ((blk_col + wu) << sx)) < self.mi_cols
        bottom_avail = yd > 0 and (
            (mi_row + ((blk_row + hu) << sy)) < self.mi_rows)
        mode_e = PredictionMode(pmode)
        need = intra_ops.EXTEND_MODES[mode_e]
        need_tr = bool(need & intra_ops.NEED_ABOVERIGHT)
        need_bl = bool(need & intra_ops.NEED_BOTTOMLEFT)
        if is_directional_mode(pmode):
            p_angle = MODE_TO_ANGLE.get(mode_e, 0) + angle_delta * 3
            need_tr = p_angle < 90
            need_bl = p_angle > 180
        have_tr = -1
        if need_tr:
            have_tr = IA.has_top_right(
                self.sb_mi, bsize_eff, mi_row, mi_col, have_top, right_avail,
                Partition.NONE, tx_size, blk_row, blk_col, sx, sy)
        have_bl = -1
        if need_bl:
            have_bl = IA.has_bottom_left(
                self.sb_mi, bsize_eff, mi_row, mi_col, bottom_avail,
                have_left, Partition.NONE, tx_size, blk_row, blk_col, sx, sy)
        n_top = min(txw, xr + txw) if have_top else 0
        n_tr = min(txw, xr) if have_tr > 0 else have_tr
        n_left = min(txh, yd + txh) if have_left else 0
        n_bl = min(txh, yd) if have_bl > 0 else have_bl
        return n_top, n_tr, n_left, n_bl

    # ------------------------------------------------------------------
    def encode_block(self, mi_row, mi_col, bsize):
        fc = self.fc
        bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
        up = mi_row > 0
        left = mi_col > 0
        ss_x, ss_y = self.ss[1] if self.nplanes > 1 else (1, 1)
        is_chroma_ref = self.nplanes > 1 and (
            ((mi_row & 1) or not (bh4 & 1) or not ss_y)
            and ((mi_col & 1) or not (bw4 & 1) or not ss_x))
        chroma_up, chroma_left = up, left
        if ss_x and bw4 < 2:
            chroma_left = mi_col - 1 > 0
        if ss_y and bh4 < 2:
            chroma_up = mi_row - 1 > 0

        # intra-edge filter types from neighbor smoothness, decoder-mirrored
        ab_sm = up and int(self.mi_mode[mi_row - 1, mi_col]) in (9, 10, 11)
        le_sm = left and int(self.mi_mode[mi_row, mi_col - 1]) in (9, 10, 11)
        ef_y = 1 if (ab_sm or le_sm) else 0
        ef_uv = 0
        if is_chroma_ref:
            base_r = mi_row - (mi_row & ss_y)
            base_c = mi_col - (mi_col & ss_x)
            cab = cle = False
            if chroma_up:
                m = int(self.mi_uv_mode[base_r - 1, base_c + ss_x])
                v = int(self.mi_valid[base_r - 1, base_c + ss_x])
                cab = v and m in (9, 10, 11)
            if chroma_left:
                m = int(self.mi_uv_mode[base_r + ss_y, base_c - 1])
                v = int(self.mi_valid[base_r + ss_y, base_c - 1])
                cle = v and m in (9, 10, 11)
            ef_uv = 1 if (cab or cle) else 0
        self.ef_types = (ef_y, ef_uv)

        # mode decision (RD or pred-SSE per cfg)
        mode, angle_y, txty = self._pick_y_mode(mi_row, mi_col, bsize, up,
                                                left)
        cfl_allowed = (int(BLOCK_WIDTH[bsize]) <= 32
                       and int(BLOCK_HEIGHT[bsize]) <= 32)
        if self.lossless:
            cfl_allowed = get_plane_block_size(bsize, ss_x, ss_y) == \
                BlockSize.BLOCK_4X4
        uv_mode = int(PredictionMode.DC_PRED)
        if is_chroma_ref:
            uv_mode = self._pick_uv_mode(mi_row, mi_col, bsize, mode,
                                         chroma_up, chroma_left, cfl_allowed)

        above_mode = int(self.mi_mode[mi_row - 1, mi_col]) if up else 0
        left_mode = int(self.mi_mode[mi_row, mi_col - 1]) if left else 0

        # transform/quantize all planes first to decide `skip`
        txs = self._block_txbs(mi_row, mi_col, bsize, mode, uv_mode,
                               is_chroma_ref, up, left, chroma_up,
                               chroma_left, angle_y, txty)
        skip = int(all(t["eob"] == 0 for t in txs))

        # forced-skip RD (encodemb super_block_yrd skip check analogue):
        # zero all residuals when pred-only beats coded cost
        if not skip and self.cfg.rd_modes and not self.lossless:
            from ..ec.costs import rdcost
            rdmult = self._block_rdmult(mi_row, mi_col, bsize)
            dist_coded = sum(t["dist"] for t in txs)
            dist_pred = sum(t["pred_dist"] for t in txs)
            rate_coded = sum(
                self._coeff_rate(t["plane"], bsize, t["tx_size"],
                                 t["tx_type"], t["levels"], t["eob"],
                                 mi_row, mi_col, t["blk_row"], t["blk_col"])
                for t in txs)
            if rdcost(rdmult, 0, dist_pred) < \
                    rdcost(rdmult, rate_coded, dist_coded):
                skip = 1
                for t in txs:
                    t["levels"] = np.zeros_like(t["levels"])
                    t["eob"] = 0
                    buf = self.planes[t["plane"]]
                    buf[t["y"] : t["y"] + t["vh"],
                        t["x"] : t["x"] + t["vw"]] = \
                        t["pred"][: t["vh"], : t["vw"]]

        # ---- write mode info ----
        skip_ctx = 0
        if up:
            skip_ctx += int(self.mi_skip[mi_row - 1, mi_col])
        if left:
            skip_ctx += int(self.mi_skip[mi_row, mi_col - 1])
        self.enc.encode_symbol(skip, fc.skip_txfm_cdfs[skip_ctx], 2)

        actx = int(INTRA_MODE_CONTEXT[above_mode if up else 0])
        lctx = int(INTRA_MODE_CONTEXT[left_mode if left else 0])
        self.enc.encode_symbol(mode, fc.kf_y_cdf[actx][lctx], 13)
        if bsize >= BlockSize.BLOCK_8X8 and is_directional_mode(mode):
            self.enc.encode_symbol(3 + angle_y, fc.angle_delta_cdf[mode - 1],
                                   7)
        if is_chroma_ref:
            self.enc.encode_symbol(uv_mode,
                                   fc.uv_mode_cdf[int(cfl_allowed)][mode],
                                   14 if cfl_allowed else 13)
            if bsize >= BlockSize.BLOCK_8X8 and is_directional_mode(uv_mode):
                self.enc.encode_symbol(3, fc.angle_delta_cdf[uv_mode - 1], 7)
        # filter_intra: seq-disabled -> no bit; tx size: TX_MODE_LARGEST -> none

        # store MI
        r1 = min(mi_row + bh4, self.mi_rows)
        c1 = min(mi_col + bw4, self.mi_cols)
        self.mi_mode[mi_row:r1, mi_col:c1] = mode
        self.mi_uv_mode[mi_row:r1, mi_col:c1] = uv_mode if is_chroma_ref \
            else 0
        self.mi_skip[mi_row:r1, mi_col:c1] = skip
        self.mi_valid[mi_row:r1, mi_col:c1] = 1
        self.mi_tx_size[mi_row:r1, mi_col:c1] = self._y_tx_size(bsize)
        self.mi_uv_tx[mi_row:r1, mi_col:c1] = \
            self._uv_tx_size(bsize, ss_x, ss_y)
        self.mi_bsize[mi_row:r1, mi_col:c1] = bsize

        if skip:
            self._reset_entropy_ctx(mi_row, mi_col, bsize, is_chroma_ref)

        # ---- write residual + finalize recon ----
        for t in txs:
            self._write_txb(t, skip, bsize, mi_row, mi_col)

    # ------------------------------------------------------------------
    def _block_rdmult(self, mi_row, mi_col, bsize):
        rdmult = self.rdmult
        if self.ssim_factors is not None:
            from . import psy as psy_mod
            rdmult = psy_mod.ssim_scaled_rdmult(
                rdmult, self.ssim_factors, mi_row, mi_col,
                int(MI_W[bsize]), int(MI_H[bsize]))
        return rdmult

    def _coeff_rate(self, plane, bsize, tx_size, tx_type, levels, eob,
                    mi_row, mi_col, blk_row, blk_col):
        """Exact coefficient rate at frame-start CDFs, via the real write
        path driven by a cost-accumulating encoder (txb_rdopt analogue)."""
        from ..ec.costs import CostingEncoder
        sx, sy = self.ss[plane]
        wu = int(TX_WIDE_UNIT[tx_size])
        hu = int(TX_HIGH_UNIT[tx_size])
        plane_bsize = bsize if plane == 0 else get_plane_block_size(
            scale_chroma_bsize(bsize, sx, sy), sx, sy)
        ac = self.above_ent[plane]
        lc = self.left_ent[plane]
        acol = (mi_col >> sx) + blk_col
        lrow = ((mi_row & (self.sb_mi - 1)) >> sy) + blk_row
        skip_ctx, sign_ctx = C.get_txb_ctx(plane_bsize, tx_size, plane,
                                           ac[acol : acol + wu],
                                           lc[lrow : lrow + hu])
        ce = CostingEncoder()
        C.write_coeffs_txb(ce, self.fc, tx_size, tx_type, plane, levels, eob,
                           skip_ctx, sign_ctx, write_tx_type_fn=None)
        return ce.cost

    def _pick_y_mode(self, mi_row, mi_col, bsize, up, left):
        """Intra mode search (av1_rd_pick_intra_mode analogue): full
        reconstruction distortion + exact coefficient rate per candidate,
        or prediction-SSE when cfg.rd_modes is off."""
        from ..ec.costs import symbol_cost, rdcost
        x, y = mi_col * 4, mi_row * 4
        tx_size = self._y_tx_size(bsize)
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        src = self.srcp[0][y : y + txh, x : x + txw]
        vh, vw = src.shape  # clipped at the mi-aligned frame edge
        # inter-mode neighbours (mode > PAETH, inter frames) fall back to DC
        # for the kf-ctx rate estimate (the write path uses y_mode_cdf there)
        above_mode = int(self.mi_mode[mi_row - 1, mi_col]) if up else 0
        left_mode = int(self.mi_mode[mi_row, mi_col - 1]) if left else 0
        if above_mode > 12:
            above_mode = 0
        if left_mode > 12:
            left_mode = 0
        actx = int(INTRA_MODE_CONTEXT[above_mode if up else 0])
        lctx = int(INTRA_MODE_CONTEXT[left_mode if left else 0])
        rdmult = self._block_rdmult(mi_row, mi_col, bsize)

        full_src = self._src_block(0, x, y, txw, txh)

        def rd_trial(mode, angle, tx_type):
            nt, ntr, nl, nbl = self._edge_counts(
                0, bsize, mi_row, mi_col, tx_size, 0, 0, up, left, mode,
                angle, x, y)
            pred = self._predict(0, x, y, tx_size, mode, up, left, nt, ntr,
                                 nl, nbl, angle)
            levels, eob, tt = self._tq_levels(full_src, pred, 0, tx_size,
                                              tx_type)
            rec = self._recon_from_levels(levels, eob, pred, 0, tx_size, tt)
            dist = int(((rec[:vh, :vw] - src) ** 2).sum())
            rate = symbol_cost(self.fc.kf_y_cdf[actx][lctx], mode)
            if bsize >= BlockSize.BLOCK_8X8 and is_directional_mode(mode):
                rate += symbol_cost(self.fc.angle_delta_cdf[mode - 1],
                                    3 + angle)
            rate += self._coeff_rate(0, bsize, tx_size, tt, levels, eob,
                                     mi_row, mi_col, 0, 0)
            if eob > 0 and not self.lossless:
                st = self._ext_tx_set_type(tx_size)
                if int(NUM_EXT_TX_SET[st]) > 1:
                    from ..normative.txsize import TXSIZE_SQR
                    eset = EXT_TX_SET_INDEX_INTRA[st]
                    sqr = int(TXSIZE_SQR[tx_size])
                    rate += symbol_cost(
                        self.fc.intra_ext_tx_cdf[eset][sqr][mode],
                        int(EXT_TX_IND[st][tt]))
            return rdcost(rdmult, rate, dist)

        best, best_mode = None, int(PredictionMode.DC_PRED)
        for mode in self.cfg.modes:
            if is_directional_mode(mode) and bsize < BlockSize.BLOCK_8X8:
                continue
            if not self.cfg.rd_modes or self.lossless:
                nt, ntr, nl, nbl = self._edge_counts(
                    0, bsize, mi_row, mi_col, tx_size, 0, 0, up, left, mode,
                    0, x, y)
                pred = self._predict(0, x, y, tx_size, mode, up, left, nt,
                                     ntr, nl, nbl)
                score = int(((pred[:vh, :vw] - src) ** 2).sum())
            else:
                score = rd_trial(mode, 0, 0)
            if best is None or score < best:
                best, best_mode = score, mode
        if not self.cfg.rd_modes or self.lossless:
            return best_mode, 0, 0
        # stage 2: angle delta refinement for directional winners
        best_angle = 0
        if bsize >= BlockSize.BLOCK_8X8 and is_directional_mode(best_mode):
            for ang in (-3, -2, -1, 1, 2, 3):
                s = rd_trial(best_mode, ang, 0)
                if s < best:
                    best, best_angle = s, ang
        # stage 3: luma tx type search over the codable set
        best_tt = 0
        set_type = self._ext_tx_set_type(tx_size)
        nsyms = int(NUM_EXT_TX_SET[set_type])
        if nsyms > 1 and not self.lossless and self.cfg.base_q_idx != 0:
            from ..normative.blocks import EXT_TX_INV
            for sym in range(1, nsyms):
                tt = int(EXT_TX_INV[set_type][sym])
                s = rd_trial(best_mode, best_angle, tt)
                if s < best:
                    best, best_tt = s, tt
        return best_mode, best_angle, best_tt

    def _pick_uv_mode(self, mi_row, mi_col, bsize, y_mode, chroma_up,
                      chroma_left, cfl_allowed):
        """Chroma mode search over both planes (intra_mode_search.c
        av1_rd_pick_intra_sbuv_mode analogue, CFL excluded round-1)."""
        from ..ec.costs import symbol_cost, rdcost
        if self.nplanes == 1 or self.lossless or not self.cfg.rd_modes:
            return int(PredictionMode.DC_PRED)
        sx, sy = self.ss[1]
        tx_size = self._uv_tx_size(bsize, sx, sy)
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
        ax_mi = mi_col - (1 if (sx and (mi_col & 1) and bw4 == 1) else 0)
        ay_mi = mi_row - (1 if (sy and (mi_row & 1) and bh4 == 1) else 0)
        x = (ax_mi << 2) >> sx
        y = (ay_mi << 2) >> sy
        rdmult = self._block_rdmult(mi_row, mi_col, bsize)
        best, best_mode = None, int(PredictionMode.DC_PRED)
        for mode in self.cfg.uv_modes:
            if is_directional_mode(mode) and bsize < BlockSize.BLOCK_8X8:
                continue
            total = 0
            rate = symbol_cost(
                self.fc.uv_mode_cdf[int(cfl_allowed)][y_mode], mode)
            if bsize >= BlockSize.BLOCK_8X8 and is_directional_mode(mode):
                rate += symbol_cost(self.fc.angle_delta_cdf[mode - 1], 3)
            for plane in (1, 2):
                have_top = chroma_up
                have_left = chroma_left
                n_top, n_tr, n_left, n_bl = self._edge_counts(
                    plane, bsize, mi_row, mi_col, tx_size, 0, 0, have_top,
                    have_left, mode, 0, x, y)
                pred = self._predict(plane, x, y, tx_size, mode, have_top,
                                     have_left, n_top, n_tr, n_left, n_bl)
                src = self._src_block(plane, x, y, txw, txh)
                levels, eob, tx_type = self._tq_levels(
                    src, pred, plane, tx_size,
                    self._uv_tx_type(mode, tx_size))
                rec = self._recon_from_levels(levels, eob, pred, plane,
                                              tx_size, tx_type)
                vh = min(txh, self.planes[plane].shape[0] - y)
                vw = min(txw, self.planes[plane].shape[1] - x)
                total += int(((rec[:vh, :vw]
                               - src[:vh, :vw]) ** 2).sum())
                rate += self._coeff_rate(plane, bsize, tx_size, tx_type,
                                         levels, eob, mi_row, mi_col, 0, 0)
            score = rdcost(rdmult, rate, total)
            if best is None or score < best:
                best, best_mode = score, mode
        return best_mode

    def _y_tx_size(self, bsize):
        if self.lossless:
            return int(TxSize.TX_4X4)
        return int(MAX_TXSIZE_RECT[bsize])  # TX_MODE_LARGEST

    def _uv_tx_size(self, bsize, ss_x, ss_y):
        if self.lossless:
            return int(TxSize.TX_4X4)
        pb = get_plane_block_size(scale_chroma_bsize(bsize, ss_x, ss_y),
                                  ss_x, ss_y)
        return TS.adjusted_tx_size(int(MAX_TXSIZE_RECT[pb]))

    # ------------------------------------------------------------------
    def _block_txbs(self, mi_row, mi_col, bsize, mode, uv_mode, is_chroma_ref,
                    up, left, chroma_up, chroma_left, angle_y=0, txty=0):
        """Predict + transform + quantize + recon every tx block; returns
        txb descriptors in coding order."""
        out = []
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
                    tx_size = (self._y_tx_size(bsize) if plane == 0
                               else self._uv_tx_size(bsize, sx, sy))
                    stepr = int(TX_HIGH_UNIT[tx_size])
                    stepc = int(TX_WIDE_UNIT[tx_size])
                    unit_h = (min(mu_h + row, max_h4) + sy) >> sy
                    unit_w = (min(mu_w + col, max_w4) + sx) >> sx
                    for br in range(row >> sy, unit_h, stepr):
                        for bc in range(col >> sx, unit_w, stepc):
                            out.append(self._do_txb(
                                mi_row, mi_col, bsize, plane, br, bc, tx_size,
                                mode, uv_mode, up, left, chroma_up,
                                chroma_left, angle_y, txty))
        return out

    def _do_txb(self, mi_row, mi_col, bsize, plane, blk_row, blk_col, tx_size,
                mode, uv_mode, up, left, chroma_up, chroma_left, angle_y=0,
                txty=0):
        sx, sy = self.ss[plane]
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        x = ((mi_col >> sx) << 2) + (blk_col << 2)
        y = ((mi_row >> sy) << 2) + (blk_row << 2)
        if plane and (sx or sy):
            bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
            ax_mi = mi_col - (1 if (sx and (mi_col & 1) and bw4 == 1) else 0)
            ay_mi = mi_row - (1 if (sy and (mi_row & 1) and bh4 == 1) else 0)
            x = ((ax_mi << 2) >> sx) + (blk_col << 2)
            y = ((ay_mi << 2) >> sy) + (blk_row << 2)

        pmode = mode if plane == 0 else uv_mode
        have_top = blk_row > 0 or (chroma_up if plane else up)
        have_left = blk_col > 0 or (chroma_left if plane else left)
        angle = angle_y if plane == 0 else 0
        n_top, n_tr, n_left, n_bl = self._edge_counts(
            plane, bsize, mi_row, mi_col, tx_size, blk_row, blk_col,
            have_top, have_left, pmode, angle, x, y)
        pred = self._predict(plane, x, y, tx_size, pmode, have_top, have_left,
                             n_top, n_tr, n_left, n_bl, angle)

        src = self._src_block(plane, x, y, txw, txh)
        want_tt = txty if plane == 0 else self._uv_tx_type(uv_mode, tx_size)
        levels, eob, tx_type = self._tq_levels(src, pred, plane, tx_size,
                                               want_tt)
        rec = self._recon_from_levels(levels, eob, pred, plane, tx_size,
                                      tx_type)
        buf = self.planes[plane]
        vh = min(txh, buf.shape[0] - y)
        vw = min(txw, buf.shape[1] - x)
        buf[y : y + vh, x : x + vw] = rec[:vh, :vw]

        dist = int(((rec[:vh, :vw] - src[:vh, :vw]).astype(np.int64) ** 2)
                   .sum())
        pdist = int(((pred[:vh, :vw] - src[:vh, :vw]).astype(np.int64) ** 2)
                    .sum())
        return {"plane": plane, "tx_size": tx_size, "tx_type": tx_type,
                "levels": levels, "eob": eob, "blk_row": blk_row,
                "blk_col": blk_col, "mi_row": mi_row, "mi_col": mi_col,
                "bsize": bsize, "mode": mode, "uv_mode": uv_mode,
                "dist": dist, "pred_dist": pdist, "x": x, "y": y,
                "pred": pred, "vh": vh, "vw": vw}

    def _deblock_info(self):
        from ..ops import deblock
        return deblock.DeblockInfo(self.mi_tx_size, self.mi_bsize,
                                   self.mi_skip, np.zeros_like(self.mi_skip),
                                   self.mi_rows, self.mi_cols)

    def _search_lpf(self):
        """Filter-level search (av1/encoder/picklpf.c
        av1_pick_filter_level analogue): brute-force a small candidate set
        around the q-derived first guess, minimizing recon MSE."""
        from ..ops import deblock
        info = self._deblock_info()
        guess = self.fh.lf.filter_level[0]
        cands = sorted({0, max(guess // 2, 0), max(guess - 4, 0),
                        max(guess - 2, 0), guess, min(guess + 2, 63),
                        min(guess + 4, 63), min(guess * 2, 63)})

        def mse(plane, buf):
            sx, sy = self.ss[plane]
            h = (self.h + sy) >> sy
            w = (self.w + sx) >> sx
            d = buf[:h, :w] - self.srcp[plane][:h, :w]
            return int((d.astype(np.int64) ** 2).sum())

        def eval_plane(plane, setter):
            best = (None, 0)
            for lvl in cands:
                setter(lvl)
                buf = self.planes[plane].copy()
                deblock.loop_filter_plane(buf, plane, info, self.fh, self.seq,
                                          uv_tx_grid=self.mi_uv_tx)
                e = mse(plane, buf)
                if best[0] is None or e < best[0]:
                    best = (e, lvl)
            setter(best[1])

        lf = self.fh.lf
        eval_plane(0, lambda v: setattr(lf, "filter_level", (v, v)))
        if self.nplanes > 1:
            if lf.filter_level == (0, 0):
                # chroma levels are only coded when a luma level is nonzero
                # (spec loop_filter_params); unsignalable -> force 0
                lf.filter_level_u = lf.filter_level_v = 0
            else:
                eval_plane(1, lambda v: setattr(lf, "filter_level_u", v))
                eval_plane(2, lambda v: setattr(lf, "filter_level_v", v))
        # apply the chosen filtering to the recon (in-loop state)
        for p in range(self.nplanes):
            deblock.loop_filter_plane(self.planes[p], p, info, self.fh,
                                      self.seq, uv_tx_grid=self.mi_uv_tx)
        self._recon_filtered = True

    def _search_cdef(self):
        """CDEF strength search (av1/encoder/pickcdef.c analogue):
        brute-force (pri, sec) for luma then chroma over the deblocked
        recon, bits=0 (one strength for the whole frame)."""
        from ..ops import cdef as cdef_ops
        if not getattr(self, "_recon_filtered", False):
            from ..ops import deblock
            info = self._deblock_info()
            for p in range(self.nplanes):
                deblock.loop_filter_plane(self.planes[p], p, info, self.fh,
                                          self.seq, uv_tx_grid=self.mi_uv_tx)
            self._recon_filtered = True
        nvfb = (self.mi_rows + 15) // 16
        nhfb = (self.mi_cols + 15) // 16
        unit = np.zeros((nvfb, nhfb), np.int32)
        for r in range(nvfb):
            for c in range(nhfb):
                sk = self.mi_skip[r * 16 : r * 16 + 16, c * 16 : c * 16 + 16]
                if sk.size and sk.all():
                    unit[r, c] = -1

        def mse(planes_list, which):
            tot = 0
            for p in which:
                sx, sy = self.ss[p]
                h = (self.h + sy) >> sy
                w = (self.w + sx) >> sx
                d = planes_list[p][:h, :w] - self.srcp[p][:h, :w]
                tot += int((d.astype(np.int64) ** 2).sum())
            return tot

        c = self.fh.cdef
        pri_cands = (0, 1, 2, 3, 4, 6, 9, 12, 15)
        sec_cands = (0, 1, 2, 4)

        def trial(y_pri, y_sec, uv_pri, uv_sec):
            c.bits = 0
            c.y_pri, c.y_sec = [y_pri], [min(y_sec, 3)]
            c.uv_pri, c.uv_sec = [uv_pri], [min(uv_sec, 3)]
            # note: coded sec==3 means 4 in application; candidates use
            # applied values {0,1,2,4} -> coded {0,1,2,3}
            trial_planes = [p.copy() for p in self.planes]
            cdef_ops.cdef_frame(trial_planes, self.mi_skip, unit, self.fh,
                                self.seq, self.mi_rows, self.mi_cols)
            return trial_planes

        best = (None, 0, 0)
        for pri in pri_cands:
            for sec in sec_cands:
                out = trial(pri, sec, 0, 0)
                e = mse(out, (0,))
                if best[0] is None or e < best[0]:
                    best = (e, pri, sec)
        y_pri, y_sec = best[1], best[2]
        best_uv = (None, 0, 0)
        if self.nplanes > 1:
            for pri in pri_cands:
                for sec in sec_cands:
                    out = trial(y_pri, y_sec, pri, sec)
                    e = mse(out, (1, 2))
                    if best_uv[0] is None or e < best_uv[0]:
                        best_uv = (e, pri, sec)
        c.bits = 0
        c.y_pri, c.y_sec = [y_pri], [min(y_sec, 3)]
        c.uv_pri, c.uv_sec = [best_uv[1]], [min(best_uv[2], 3)]
        # finalize recon with the chosen strengths
        cdef_ops.cdef_frame(self.planes, self.mi_skip, unit, self.fh,
                            self.seq, self.mi_rows, self.mi_cols)

    def _src_block(self, plane, x, y, txw, txh):
        src = self.srcp[plane][y : y + txh, x : x + txw]
        if src.shape != (txh, txw):
            # tx block overhangs the mi-aligned frame: edge-replicate source
            full = np.empty((txh, txw), np.int32)
            full[: src.shape[0], : src.shape[1]] = src
            if src.shape[1] < txw:
                full[: src.shape[0], src.shape[1] :] = src[:, -1:]
            if src.shape[0] < txh:
                full[src.shape[0] :, :] = full[src.shape[0] - 1, :]
            src = full
        return src

    def _uv_tx_type(self, uv_mode, tx_size):
        """Derived chroma tx type (av1_get_tx_type for plane>0; mirror of
        the decoder's _uv_tx_type — chroma tx type is NOT coded)."""
        from ..normative.txsize import TXSIZE_SQR_UP
        if self.lossless or int(TXSIZE_SQR_UP[tx_size]) > TxSize.TX_32X32:
            return 0
        m = 0 if uv_mode == 13 else uv_mode
        tt = int(INTRA_MODE_TO_TX_TYPE[m])
        set_type = self._ext_tx_set_type(tx_size)
        if not (int(EXT_TX_USED_FLAG[set_type]) >> tt) & 1:
            return 0
        return tt

    def _ext_tx_set_type(self, tx_size):
        from ..normative.txsize import TXSIZE_SQR, TXSIZE_SQR_UP
        sqr_up = int(TXSIZE_SQR_UP[tx_size])
        if sqr_up >= TxSize.TX_32X32:
            return 0
        if self.fh.reduced_tx_set:
            return 2
        return 2 if int(TXSIZE_SQR[tx_size]) == TxSize.TX_16X16 else 3

    def _tq_levels(self, src, pred, plane, tx_size, tx_type=0):
        """Forward transform + quantize; returns (levels, eob, tx_type)."""
        res = (src - pred).astype(np.int64)
        dc_q, ac_q = self.dequant[plane]
        shift = TS.tx_scale(tx_size)
        if self.lossless:
            # WHT output = 4 * invertible-core(res); dequant multiplies by 4
            # and the inverse WHT shifts >>2, so level = output / 4 exactly
            coeffs = txfm_ops.fwht4x4(res[None])[0]  # (4,4) W,H layout
            levels = coeffs.reshape(-1) // 4
            tx_type = 0
        else:
            # decoder reconstructs (level*dqv)>>shift ≈ F, so
            # level = round(F << shift / dqv) (av1_quantize_fp domain)
            ts_adj = TS.adjusted_tx_size(tx_size)
            cw, ch = int(TX_WIDTH[ts_adj]), int(TX_HEIGHT[ts_adj])
            coeffs = txfm_ops.fwd_txfm2d(res[None], tx_size, tx_type, bd=8)[0]
            flat = coeffs[:cw, :ch].reshape(-1).astype(np.int64)
            dqv = np.full(flat.shape, ac_q, np.int64)
            dqv[0] = dc_q
            scaled = np.abs(flat) << shift
            levels = np.sign(flat) * ((scaled + (dqv >> 1)) // dqv)
            levels = np.clip(levels, -(1 << 15), (1 << 15) - 1)
        levels = levels.astype(np.int32)
        scan = tables.scan_table(TS.adjusted_tx_size(tx_size), tx_type)
        nz = np.nonzero(levels[scan] != 0)[0]
        eob = int(nz[-1]) + 1 if len(nz) else 0
        return levels, eob, tx_type

    def _recon_from_levels(self, levels, eob, pred, plane, tx_size, tx_type):
        """Decoder-identical dequant + inverse transform + add."""
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        if eob == 0:
            return pred
        dq = self._dequant_levels(levels, plane, tx_size)
        if self.lossless:
            return txfm_ops.iwht4x4_add(dq[None], pred[None, :4, :4], bd=8)[0]
        ts_adj = TS.adjusted_tx_size(tx_size)
        cw, ch = int(TX_WIDTH[ts_adj]), int(TX_HEIGHT[ts_adj])
        full = np.zeros((txw, txh), np.int32)
        full[:cw, :ch] = dq.reshape(cw, ch)
        return txfm_ops.inv_txfm2d_add(full[None], pred[None], tx_size,
                                       tx_type, bd=8)[0]

    def _dequant_levels(self, levels, plane, tx_size):
        dc, ac = self.dequant[plane]
        shift = TS.tx_scale(tx_size)
        dqv = np.full(levels.shape, ac, np.int64)
        dqv[0] = dc
        mag = np.abs(levels.astype(np.int64)) * dqv
        mag &= 0xFFFFFF
        mag >>= shift
        out = np.where(levels < 0, -mag, mag)
        out = np.clip(out, -(1 << 15), (1 << 15) - 1)
        ts_adj = TS.adjusted_tx_size(tx_size)
        return out.astype(np.int32).reshape(int(TX_WIDTH[ts_adj]),
                                            int(TX_HEIGHT[ts_adj]))

    # ------------------------------------------------------------------
    def _reset_entropy_ctx(self, mi_row, mi_col, bsize, is_chroma_ref):
        for p in range(self.nplanes):
            if p and not is_chroma_ref:
                break
            sx, sy = self.ss[p]
            pb = get_plane_block_size(bsize, sx, sy) if p else bsize
            self.above_ent[p][mi_col >> sx : (mi_col >> sx) + int(MI_W[pb])] = 0
            r = (mi_row & (self.sb_mi - 1)) >> sy
            self.left_ent[p][r : r + int(MI_H[pb])] = 0

    def _write_txb(self, t, skip, bsize, mi_row, mi_col):
        if skip:
            return
        plane = t["plane"]
        sx, sy = self.ss[plane]
        tx_size = t["tx_size"]
        wu = int(TX_WIDE_UNIT[tx_size])
        hu = int(TX_HIGH_UNIT[tx_size])
        plane_bsize = bsize if plane == 0 else get_plane_block_size(
            scale_chroma_bsize(bsize, sx, sy), sx, sy)
        ac = self.above_ent[plane]
        lc = self.left_ent[plane]
        acol = (mi_col >> sx) + t["blk_col"]
        lrow = ((mi_row & (self.sb_mi - 1)) >> sy) + t["blk_row"]
        skip_ctx, sign_ctx = C.get_txb_ctx(plane_bsize, tx_size, plane,
                                           ac[acol : acol + wu],
                                           lc[lrow : lrow + hu])

        def write_tx_type():
            self._write_tx_type(t, tx_size)

        cul = C.write_coeffs_txb(self.enc, self.fc, tx_size, t["tx_type"],
                                 plane, t["levels"], t["eob"], skip_ctx,
                                 sign_ctx,
                                 write_tx_type_fn=write_tx_type
                                 if plane == 0 else None)
        from ..normative.enums import BLOCK_WIDTH, BLOCK_HEIGHT
        bw_px = int(BLOCK_WIDTH[plane_bsize])
        bh_px = int(BLOCK_HEIGHT[plane_bsize])
        over_x = ((self.mi_cols - (mi_col + int(MI_W[bsize]))) * 4) >> sx
        over_y = ((self.mi_rows - (mi_row + int(MI_H[bsize]))) * 4) >> sy
        vis_w = (bw_px + min(over_x, 0)) >> 2
        vis_h = (bh_px + min(over_y, 0)) >> 2
        nw = max(0, min(wu, vis_w - t["blk_col"]))
        nh = max(0, min(hu, vis_h - t["blk_row"]))
        ac[acol : acol + nw] = cul
        ac[acol + nw : acol + wu] = 0
        lc[lrow : lrow + nh] = cul
        lc[lrow + nh : lrow + hu] = 0

    def _write_tx_type(self, t, tx_size):
        """av1_write_tx_type mirror: only DCT_DCT in round 1."""
        if self.lossless or self.cfg.base_q_idx == 0 or t["eob"] == 0:
            return
        from ..normative.txsize import TXSIZE_SQR, TXSIZE_SQR_UP
        sqr_up = int(TXSIZE_SQR_UP[tx_size])
        if sqr_up > TxSize.TX_32X32 or sqr_up == TxSize.TX_32X32:
            return  # DCT-only set: nothing coded
        set_type = 2 if (self.fh.reduced_tx_set
                         or int(TXSIZE_SQR[tx_size]) == TxSize.TX_16X16) else 3
        nsyms = int(NUM_EXT_TX_SET[set_type])
        if nsyms <= 1:
            return
        eset = EXT_TX_SET_INDEX_INTRA[set_type]
        sqr = int(TXSIZE_SQR[tx_size])
        sym = int(EXT_TX_IND[set_type][t["tx_type"]])
        self.enc.encode_symbol(
            sym, self.fc.intra_ext_tx_cdf[eset][sqr][t["mode"]], nsyms)


def encode_ivf(frames: list, cfg: EncoderConfig, path: str) -> None:
    packets = [FrameEncoder(f, cfg).encode() for f in frames]
    from ..bitstream.containers import write_ivf
    write_ivf(path, packets, frames[0].width, frames[0].height)
