"""IPPP inter-frame encoder on the host, with its motion search on the
device — torch counterpart of ``aom_av1_psy_tpu/encoder/interframe.py``.

Single-reference (LAST) inter coding with NEWMV / NEARESTMV / NEARMV /
GLOBALMV, driven by the dense-grid motion search (``ops/mvsearch``) and
the decoder's own MV-prediction stack (``normative/mvref.find_mv_refs``)
so encoder and decoder derive identical reference MVs.  The write side
mirrors the decoder's inter parse symbol-for-symbol
(``decoder/frame.py:_decode_block_inter_frame``).

Reference analogues: av1/encoder/encodeframe.c (walk),
av1/encoder/bitstream.c write_modes_b / av1_write_mv (pack),
av1/encoder/rdopt.c av1_rd_pick_inter_mode (single-ref subset),
av1/encoder/mcomp.c (motion search, replaced by the batched grid scan).

The host planes stay numpy, as in the reference. What the device does, per
inter block: the full-pel search uploads the block and its clamped window
to ``ops/mvsearch.full_pel_grid_search`` (kernel KJ on the card), and the
9 half-pel, the 9 quarter-pel and the 4 mode candidates are each scored by
one ``_mv_sads`` call, which cuts every candidate's region as the decoder's
``_predict_one`` does and predicts them together through
``ops/convolve.subpel_predict`` (kernel KL, per-candidate phases): 1 KJ +
3 KL launches per inter block (against a reference of another size, the
candidates go through the decoder's scaled prediction on the host, as in
the reference, and KL is not launched). The choices between the returned
SADs stay the reference's sequential strict ``<``, on the host; the chosen
prediction's SSE and ``build_inter_predictors`` stay on the host copy of
the decoder path. ``device="cpu"`` runs the same calls on CPU tensors (the
plain versions); the packets are the reference's byte for byte.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bitstream.headers import FrameHeader, TileInfo
from ..normative import mvref as MR
from ..normative import tables
from ..normative.blocks import (MI_W, MI_H, INTRA_MODE_CONTEXT,
                                EXT_TX_SET_INDEX_INTER, EXT_TX_IND,
                                NUM_EXT_TX_SET, get_plane_block_size,
                                scale_chroma_bsize, is_directional_mode)
from ..normative.enums import (BlockSize, PredictionMode, TxSize,
                               BLOCK_WIDTH, BLOCK_HEIGHT, TX_WIDTH, TX_HEIGHT)
from ..normative.txsize import MAX_TXSIZE_RECT, TXSIZE_SQR
from ..decoder import inter as IT
from ..device import resolve_device
from ..ops import convolve as CONV
from ..ops import mvsearch as MS
from .frame import FrameEncoder

MV_CLASSES = 11
CLASS0_BITS = 1
CLASS0_SIZE = 1 << CLASS0_BITS


def _mv_class(z: int) -> int:
    """av1_get_mv_class (encodemv.c): class from magnitude-1.
    Class c covers z in [base(c), base(c+1)) with base(c>=1) = 2<<(c+2),
    i.e. c = floor(log2(z >> 3)) for z >= 8 and 0 below."""
    n = z >> 3
    c = n.bit_length() - 1 if n > 0 else 0
    return min(c, MV_CLASSES - 1)


class InterFrameEncoder(FrameEncoder):
    """Encodes one INTER frame against a single LAST reference slot.

    Duck-types the decoder's ``cm`` for ``find_mv_refs`` and
    ``build_inter_predictors`` so the normative MV-prediction and MC
    paths are shared verbatim with the decoder. ``device``: where the
    motion search runs (module docstring)."""

    def __init__(self, frame, cfg, seq, ref_slot, device="cuda"):
        super().__init__(frame, cfg)
        assert not self.lossless, "inter lossless not in the slice"
        self.device = resolve_device(device)
        self._seq = seq
        self.ref_slot = ref_slot
        # ---- cm duck-type (normative/mvref.py, decoder/inter.py) ----
        self.bd = 8
        self.force_integer_mv = False
        self.allow_high_precision_mv = False
        self.global_motion = [MR.WarpModel() for _ in range(8)]
        self.refs = [None] + [ref_slot] * 7
        self.ref_frame_sign_bias = [0] * 8
        self.enable_order_hint = False
        self.order_hint_bits = 0
        self.cur_order_hint = 0
        self.allow_ref_frame_mvs = False
        self.tpl_mvs = None
        self.tile_mi_row_start = 0
        self.tile_mi_col_start = 0
        self.tile_mi_row_end = self.mi_rows
        self.tile_mi_col_end = self.mi_cols
        # MbInfo grid (MVP state) + filter grids
        self.mi = np.full((self.mi_rows, self.mi_cols), None, object)
        shape = (self.mi_rows, self.mi_cols)
        self.mi_is_inter = np.zeros(shape, np.int32)
        self.mi_ref0 = np.zeros(shape, np.int32)
        self.mi_borigin_r = np.zeros(shape, np.int32)
        self.mi_borigin_c = np.zeros(shape, np.int32)

    def ref_order_hint(self, rf: int) -> int:
        return 0

    # ------------------------------------------------------------------
    def make_headers(self):
        fh = FrameHeader(width=self.w, height=self.h,
                         render_width=self.w, render_height=self.h)
        fh.frame_type = 1  # INTER
        fh.show_frame = True
        fh.showable_frame = True
        fh.error_resilient_mode = False
        fh.primary_ref_frame = 7  # PRIMARY_REF_NONE: default CDFs/deltas
        fh.refresh_frame_flags = 0xFF  # keep every slot at the new recon
        fh.ref_frame_idx = [0] * 7
        fh.allow_high_precision_mv = False
        fh.is_filter_switchable = False
        fh.interp_filter = 0  # EIGHTTAP_REGULAR
        fh.is_motion_mode_switchable = False
        fh.reference_select = False
        fh.allow_warped_motion = False
        fh.disable_frame_end_update_cdf = True
        fh.quant.base_q_idx = self.cfg.base_q_idx
        fh.tx_mode_select = False
        fh.tiles = TileInfo()
        fh.global_motion = [MR.WarpModel() for _ in range(8)]
        q = tables.ac_quant(self.cfg.base_q_idx)
        # inter-frame first guess (picklpf.c:258 non-keyframe line)
        guess = (q * 6017 + 1243066 + (1 << 17)) >> 18 if q > 16 else 0
        lvl = int(np.clip(guess, 0, 63))
        fh.lf.filter_level = (lvl, lvl)
        fh.lf.filter_level_u = lvl
        fh.lf.filter_level_v = lvl
        fh.lf.delta_enabled = False
        return self._seq, fh

    def _deblock_info(self):
        from ..ops import deblock
        return deblock.DeblockInfo(self.mi_tx_size, self.mi_bsize,
                                   self.mi_skip, self.mi_is_inter,
                                   self.mi_rows, self.mi_cols,
                                   mi_ref0=self.mi_ref0, mi_mode=self.mi_mode,
                                   mi_borigin_r=self.mi_borigin_r,
                                   mi_borigin_c=self.mi_borigin_c)

    # ------------------------------------------------------------------
    # Motion search (dense grid around the MVP, integer + subpel refine)
    # ------------------------------------------------------------------
    SEARCH_RADIUS = 16

    def _motion_search(self, mi_row, mi_col, bsize, center_mv8):
        """Full-pel dense-grid search (ops/mvsearch.full_pel_grid_search,
        KJ on the card) around center_mv8 (1/8-pel units), then 1/4-pel
        refinement through the normative convolve (``_mv_sads``). Returns a
        lowered 1/8-pel (row, col) MV."""
        bw = int(BLOCK_WIDTH[bsize])
        bh = int(BLOCK_HEIGHT[bsize])
        x, y = mi_col * 4, mi_row * 4
        src = self.srcp[0][y : y + bh, x : x + bw]
        ref = self.ref_slot["planes"][0]
        rH = self.ref_slot["height"]
        rW = self.ref_slot["upscaled_width"]
        r = self.SEARCH_RADIUS
        cy = y + (int(center_mv8[0]) >> 3)
        cx = x + (int(center_mv8[1]) >> 3)
        ys = np.clip(np.arange(cy - r, cy + bh + r), 0, rH - 1)
        xs = np.clip(np.arange(cx - r, cx + bw + r), 0, rW - 1)
        win = ref[np.ix_(ys, xs)]
        mvs, _ = MS.full_pel_grid_search(
            torch.as_tensor(src[None]).to(self.device, torch.int32),
            torch.as_tensor(win[None]).to(self.device, torch.int32), r)
        dy, dx = (int(v) for v in mvs[0].tolist())
        full_r = ((cy - y) + dy) * 8
        full_c = ((cx - x) + dx) * 8
        # 1/4-pel refine: evaluate the 8 half-pel then quarter-pel
        # neighbours with the real convolve (av1_find_best_sub_pixel_tree)
        best = (full_r, full_c)
        best_sad = None
        for step in (4, 2):
            b0 = best
            mvs = [(b0[0] + nr, b0[1] + nc) for nr in (-step, 0, step)
                   for nc in (-step, 0, step)]
            for mv, sad in zip(mvs, self._mv_sads(mi_row, mi_col, bw, bh,
                                                  mvs, src)):
                if best_sad is None or sad < best_sad:
                    best_sad, best = sad, mv
        return best

    def _mv_sads(self, mi_row, mi_col, bw, bh, mvs, src):
        """The luma SAD against ``src`` of the prediction at each MV of
        ``mvs`` (EIGHTTAP_REGULAR, as ``fh.interp_filter``): every
        candidate's (bh+7, bw+7) region is cut as ``IT._predict_one`` cuts
        it (``_clamp_mv_to_umv_border``, ``_fetch_ref_block``), and one
        ``subpel_predict`` predicts them all with their own phases. On a
        scaled reference (another size than the frame's) each candidate is
        predicted as the reference's ``_mv_sad`` predicts it: through
        ``IT._predict_one``, which scales, on the host."""
        ref = self.ref_slot
        if ref["upscaled_width"] != self.w or ref["height"] != self.h:
            mbmi = MR.MbInfo()
            mbmi.bsize = self.mi[mi_row, mi_col].bsize
            mbmi.interp_y = mbmi.interp_x = 0
            return [int(np.abs(IT._predict_one(
                self, mbmi, ref, mv, self._xd_tmp, 0, mi_col * 4, mi_row * 4,
                bw, bh, 0, 0, False) - src).sum()) for mv in mvs]
        regs, phases = [], []
        for mv in mvs:
            q4 = IT._clamp_mv_to_umv_border(mv, self._xd_tmp, bw, bh, 0, 0)
            pos_x = ((mi_col * 4) << 4) + q4[1]
            pos_y = ((mi_row * 4) << 4) + q4[0]
            regs.append(IT._fetch_ref_block(
                ref["planes"][0], ref["upscaled_width"], ref["height"],
                (pos_x >> 4) - 3, (pos_y >> 4) - 3, bw + 7, bh + 7))
            phases.append((q4[1] & 15, q4[0] & 15))
        dev = self.device
        regs = torch.as_tensor(np.stack(regs)).to(dev, torch.int32)
        ph = torch.as_tensor(np.array(phases, np.int32).T.copy()).to(dev)
        pred = CONV.subpel_predict(regs, bw, bh, ph[0], ph[1])
        src = torch.as_tensor(src).to(dev, torch.int64)
        return (pred.to(torch.int64) - src).abs().sum((1, 2)).tolist()

    # ------------------------------------------------------------------
    # Write-side mirrors of the decoder's inter parse
    # ------------------------------------------------------------------
    def _write_ref_frames(self, mbmi, counts, above, left_mb, up, lf):
        """Mirror of decoder read_ref_frames for single-ref LAST."""
        fc = self.fc
        assert mbmi.ref_frame == [MR.LAST_FRAME, MR.NONE_FRAME]
        # reference_select off -> no comp_inter bit
        self.enc.encode_symbol(0, fc.single_ref_cdf[
            IT.ctx_single_p1(counts)][0], 2)
        self.enc.encode_symbol(0, fc.single_ref_cdf[
            IT.ctx_ll2_or_l3gld(counts)][2], 2)
        self.enc.encode_symbol(0, fc.single_ref_cdf[
            IT.ctx_last_or_last2(counts)][3], 2)

    def _write_inter_mode(self, mode, mode_ctx):
        fc = self.fc
        ctx = mode_ctx & MR.NEWMV_CTX_MASK
        self.enc.encode_symbol(int(mode != MR.NEWMV), fc.newmv_cdf[ctx], 2)
        if mode == MR.NEWMV:
            return
        ctx = (mode_ctx >> MR.GLOBALMV_OFFSET) & MR.GLOBALMV_CTX_MASK
        self.enc.encode_symbol(int(mode != MR.GLOBALMV), fc.zeromv_cdf[ctx],
                               2)
        if mode == MR.GLOBALMV:
            return
        ctx = (mode_ctx >> MR.REFMV_OFFSET) & MR.REFMV_CTX_MASK
        self.enc.encode_symbol(int(mode != MR.NEARESTMV), fc.refmv_cdf[ctx],
                               2)

    def _write_drl_idx(self, mbmi, count, weights):
        """Mirror of read_drl_idx with ref_mv_idx always 0."""
        fc = self.fc
        assert mbmi.ref_mv_idx == 0
        if mbmi.mode == MR.NEWMV:
            if count > 1:
                ctx = MR.drl_ctx(weights, 0)
                self.enc.encode_symbol(0, fc.drl_cdf[ctx], 2)
        elif mbmi.mode == MR.NEARMV:
            if count > 2:
                ctx = MR.drl_ctx(weights, 1)
                self.enc.encode_symbol(0, fc.drl_cdf[ctx], 2)

    def _write_mv_component(self, diff, comp, use_subpel, usehp):
        """Mirror of read_mv_component (encodemv.c encode_mv_component)."""
        fc = self.fc
        g = lambda name: getattr(fc, f"nmv_comp{comp}_{name}_cdf")
        enc = self.enc.encode_symbol
        sign = int(diff < 0)
        mag = -diff if sign else diff
        z = mag - 1
        mv_class = _mv_class(z)
        base = 0 if mv_class == 0 else (CLASS0_SIZE << (mv_class + 2))
        offset = z - base
        d = offset >> 3
        fr = (offset >> 1) & 3
        hp = offset & 1
        enc(sign, g("sign"), 2)
        enc(mv_class, g("classes"), MV_CLASSES)
        if mv_class == 0:
            enc(d, g("class0"), CLASS0_SIZE)
        else:
            n = mv_class + CLASS0_BITS - 1
            bits_cdf = g("bits")
            for i in range(n):
                enc((d >> i) & 1, bits_cdf[i], 2)
        if use_subpel:
            enc(fr, g("class0_fp")[d] if mv_class == 0 else g("fp"), 4)
            if usehp:
                enc(hp, g("class0_hp") if mv_class == 0 else g("hp"), 2)

    def _write_mv(self, mv, ref_mv, precision):
        dr = mv[0] - ref_mv[0]
        dc = mv[1] - ref_mv[1]
        joint = 2 * int(dr != 0) + int(dc != 0)
        self.enc.encode_symbol(joint, self.fc.nmv_joints_cdf, 4)
        if dr:
            self._write_mv_component(dr, 0, precision > 0, precision > 1)
        if dc:
            self._write_mv_component(dc, 1, precision > 0, precision > 1)

    def _write_tx_type(self, t, tx_size):
        """Dispatch: inter blocks use the inter ext-tx sets."""
        if not t.get("is_inter"):
            return super()._write_tx_type(t, tx_size)
        if self.cfg.base_q_idx == 0 or t["eob"] == 0:
            return
        sqr_up = int(TXSIZE_SQR[tx_size])  # via sqr-up below
        from ..normative.txsize import TXSIZE_SQR_UP
        sqr_up = int(TXSIZE_SQR_UP[tx_size])
        if sqr_up > TxSize.TX_32X32:
            return
        if sqr_up == TxSize.TX_32X32 or self.fh.reduced_tx_set:
            set_type = 1  # DCT_IDTX
        else:
            sqr = int(TXSIZE_SQR[tx_size])
            set_type = 4 if sqr == TxSize.TX_16X16 else 5
        nsyms = int(NUM_EXT_TX_SET[set_type])
        if nsyms <= 1:
            return
        eset = EXT_TX_SET_INDEX_INTER[set_type]
        sqr = int(TXSIZE_SQR[tx_size])
        sym = int(EXT_TX_IND[set_type][t["tx_type"]])
        self.enc.encode_symbol(sym, self.fc.inter_ext_tx_cdf[eset][sqr],
                               nsyms)

    # ------------------------------------------------------------------
    def _inter_txbs(self, mbmi, mi_row, mi_col, bsize, is_chroma_ref):
        """MC-pred residual coding: prediction already in self.planes."""
        out = []
        for plane in range(self.nplanes):
            if plane and not is_chroma_ref:
                break
            sx, sy = self.ss[plane]
            tx_size = (self._y_tx_size(bsize) if plane == 0
                       else self._uv_tx_size(bsize, sx, sy))
            txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
            x = (mi_col << 2) >> sx
            y = (mi_row << 2) >> sy
            pred = self.planes[plane][y : y + txh, x : x + txw].copy()
            src = self._src_block(plane, x, y, txw, txh)
            levels, eob, tx_type = self._tq_levels(src, pred, plane, tx_size,
                                                   0)
            rec = self._recon_from_levels(levels, eob, pred, plane, tx_size,
                                          tx_type)
            buf = self.planes[plane]
            vh = min(txh, buf.shape[0] - y)
            vw = min(txw, buf.shape[1] - x)
            buf[y : y + vh, x : x + vw] = rec[:vh, :vw]
            dist = int(((rec[:vh, :vw] - src[:vh, :vw]).astype(np.int64) ** 2)
                       .sum())
            pdist = int(((pred[:vh, :vw] - src[:vh, :vw]).astype(np.int64)
                         ** 2).sum())
            out.append({"plane": plane, "tx_size": tx_size,
                        "tx_type": tx_type, "levels": levels, "eob": eob,
                        "blk_row": 0, "blk_col": 0, "mi_row": mi_row,
                        "mi_col": mi_col, "bsize": bsize, "mode": mbmi.mode,
                        "uv_mode": 0, "dist": dist, "pred_dist": pdist,
                        "x": x, "y": y, "pred": pred, "vh": vh, "vw": vw,
                        "is_inter": True})
        return out

    # ------------------------------------------------------------------
    def encode_block(self, mi_row, mi_col, bsize):
        fc = self.fc
        bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
        up = mi_row > 0
        left = mi_col > 0
        above = self.mi[mi_row - 1, mi_col] if up else None
        left_mb = self.mi[mi_row, mi_col - 1] if left else None
        ss_x, ss_y = self.ss[1] if self.nplanes > 1 else (1, 1)
        is_chroma_ref = self.nplanes > 1 and (
            ((mi_row & 1) or not (bh4 & 1) or not ss_y)
            and ((mi_col & 1) or not (bw4 & 1) or not ss_x))
        chroma_up, chroma_left = up, left
        if ss_x and bw4 < 2:
            chroma_left = mi_col - 1 > 0
        if ss_y and bh4 < 2:
            chroma_up = mi_row - 1 > 0

        mbmi = MR.MbInfo()
        mbmi.bsize = bsize
        mbmi.mi_row, mbmi.mi_col = mi_row, mi_col
        mbmi.interp_y = mbmi.interp_x = self.fh.interp_filter
        self.mi[mi_row, mi_col] = mbmi
        xd = MR.XdCtx(self.mi, mi_row, mi_col, bsize,
                      (0, self.mi_rows, 0, self.mi_cols),
                      self.mi_rows, self.mi_cols)
        self._xd_tmp = xd

        # ---- inter candidates (single-ref LAST) ----
        mbmi.ref_frame = [MR.LAST_FRAME, MR.NONE_FRAME]
        stack, weights, count, mode_ctx, mv_ref_list, gm_mv = \
            MR.find_mv_refs(self, xd, mbmi, MR.LAST_FRAME)
        lower = lambda mv: MR.lower_mv_precision(mv, False, False)
        nearest_mv = lower(mv_ref_list[0])
        near_mv = lower(mv_ref_list[1])
        gmv = gm_mv[0]
        bw = int(BLOCK_WIDTH[bsize])
        bh = int(BLOCK_HEIGHT[bsize])
        x, y = mi_col * 4, mi_row * 4
        src_y = self.srcp[0][y : y + bh, x : x + bw]
        new_mv = self._motion_search(mi_row, mi_col, bsize, nearest_mv)
        # NEWMV's signalled reference MV (decoder assign_mv flow)
        newmv_ref = nearest_mv if count <= 1 else stack[0][0]

        cands = [(MR.NEARESTMV, nearest_mv, 6), (MR.NEARMV, near_mv, 8),
                 (MR.GLOBALMV, gmv, 4), (MR.NEWMV, tuple(new_mv), 10)]
        sads = self._mv_sads(mi_row, mi_col, bw, bh,
                             [mv for _, mv, _ in cands], src_y)
        best = None
        for (mode, mv, rate0), sad in zip(cands, sads):
            rate = rate0
            if mode == MR.NEWMV:
                dr = abs(mv[0] - newmv_ref[0])
                dc = abs(mv[1] - newmv_ref[1])
                rate += 2 * (dr.bit_length() + dc.bit_length())
            score = sad + rate * 4
            if best is None or score < best[0]:
                best = (score, mode, mv)
        _, inter_mode, inter_mv = best
        inter_pred = IT._predict_one(self, mbmi, self.ref_slot, inter_mv, xd,
                                     0, x, y, bw, bh, 0, 0, False)
        inter_sse = int(((inter_pred - src_y).astype(np.int64) ** 2).sum())

        # ---- intra alternative ----
        ab_sm = up and int(self.mi_mode[mi_row - 1, mi_col]) in (9, 10, 11)
        le_sm = left and int(self.mi_mode[mi_row, mi_col - 1]) in (9, 10, 11)
        ef_y = 1 if (ab_sm or le_sm) else 0
        self.ef_types = (ef_y, 0)
        y_mode, angle_y, txty = self._pick_y_mode(mi_row, mi_col, bsize, up,
                                                  left)
        tx_size = self._y_tx_size(bsize)
        txw, txh = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        nt, ntr, nl, nbl = self._edge_counts(0, bsize, mi_row, mi_col,
                                             tx_size, 0, 0, up, left, y_mode,
                                             angle_y, x, y)
        intra_pred = self._predict(0, x, y, tx_size, y_mode, up, left,
                                   nt, ntr, nl, nbl, angle_y)
        intra_sse = int(((intra_pred[:bh, :bw] - src_y).astype(np.int64)
                         ** 2).sum())
        use_inter = inter_sse <= intra_sse

        if use_inter:
            mbmi.mode = inter_mode
            mbmi.mv[0] = tuple(int(v) for v in inter_mv)
            mbmi.ref_mv_idx = 0
            # MC prediction for every plane through the decoder's path
            for plane in range(self.nplanes):
                if plane and not is_chroma_ref:
                    break
                sx, sy = self.ss[plane]
                dst_x = (mi_col * 4) >> sx
                dst_y = (mi_row * 4) >> sy
                IT.build_inter_predictors(self, xd, mbmi, plane,
                                          self.planes[plane], dst_x, dst_y)
            txs = self._inter_txbs(mbmi, mi_row, mi_col, bsize,
                                   is_chroma_ref)
        else:
            mbmi.ref_frame = [MR.INTRA_FRAME, MR.NONE_FRAME]
            mbmi.mode = y_mode
            mbmi.angle_y = angle_y
            cfl_allowed = (bw <= 32 and bh <= 32)
            uv_mode = int(PredictionMode.DC_PRED)
            if is_chroma_ref:
                uv_mode = self._pick_uv_mode(mi_row, mi_col, bsize, y_mode,
                                             chroma_up, chroma_left,
                                             cfl_allowed)
            mbmi.uv_mode = uv_mode
            txs = self._block_txbs(mi_row, mi_col, bsize, y_mode, uv_mode,
                                   is_chroma_ref, up, left, chroma_up,
                                   chroma_left, angle_y, txty)

        skip = int(all(t["eob"] == 0 for t in txs))
        if not skip:
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
        mbmi.skip_txfm = skip

        # ---- write mode info (decoder parse order) ----
        skip_ctx = ((above.skip_txfm if up else 0)
                    + (left_mb.skip_txfm if left else 0))
        self.enc.encode_symbol(skip, fc.skip_txfm_cdfs[skip_ctx], 2)
        # is_inter (read_is_inter_block ctx)
        if up and left:
            ai, li = not above.is_inter, not left_mb.is_inter
            ctx = 3 if (ai and li) else int(ai or li)
        elif up or left:
            e = above if up else left_mb
            ctx = 2 * int(not e.is_inter)
        else:
            ctx = 0
        self.enc.encode_symbol(int(use_inter), fc.intra_inter_cdf[ctx], 2)

        if use_inter:
            counts = IT.collect_neighbors_ref_counts(self, above, left_mb)
            self._write_ref_frames(mbmi, counts, above, left_mb, up, left)
            self._write_inter_mode(mbmi.mode, mode_ctx)
            if mbmi.mode in (MR.NEWMV,) or mbmi.mode == MR.NEARMV:
                self._write_drl_idx(mbmi, count, weights)
            if mbmi.mode == MR.NEWMV:
                self._write_mv(mbmi.mv[0], newmv_ref, precision=1)
            # interp filter: not switchable -> nothing
        else:
            self.enc.encode_symbol(
                mbmi.mode, fc.y_mode_cdf[int(IT.SIZE_GROUP[bsize])], 13)
            if bsize >= BlockSize.BLOCK_8X8 and \
                    is_directional_mode(mbmi.mode):
                self.enc.encode_symbol(3 + mbmi.angle_y,
                                       fc.angle_delta_cdf[mbmi.mode - 1], 7)
            if is_chroma_ref:
                cfl_allowed = (bw <= 32 and bh <= 32)
                self.enc.encode_symbol(
                    mbmi.uv_mode, fc.uv_mode_cdf[int(cfl_allowed)][mbmi.mode],
                    14 if cfl_allowed else 13)
                if bsize >= BlockSize.BLOCK_8X8 and \
                        is_directional_mode(mbmi.uv_mode):
                    self.enc.encode_symbol(
                        3, fc.angle_delta_cdf[mbmi.uv_mode - 1], 7)

        # ---- store MI ----
        r1 = min(mi_row + bh4, self.mi_rows)
        c1 = min(mi_col + bw4, self.mi_cols)
        self.mi[mi_row:r1, mi_col:c1] = mbmi
        self.mi_mode[mi_row:r1, mi_col:c1] = mbmi.mode
        self.mi_uv_mode[mi_row:r1, mi_col:c1] = \
            mbmi.uv_mode if (not use_inter and is_chroma_ref) else 0
        self.mi_skip[mi_row:r1, mi_col:c1] = skip
        self.mi_valid[mi_row:r1, mi_col:c1] = 1
        self.mi_tx_size[mi_row:r1, mi_col:c1] = self._y_tx_size(bsize)
        self.mi_uv_tx[mi_row:r1, mi_col:c1] = \
            self._uv_tx_size(bsize, ss_x, ss_y)
        self.mi_bsize[mi_row:r1, mi_col:c1] = bsize
        self.mi_is_inter[mi_row:r1, mi_col:c1] = int(use_inter)
        self.mi_ref0[mi_row:r1, mi_col:c1] = max(mbmi.ref_frame[0], 0)
        self.mi_borigin_r[mi_row:r1, mi_col:c1] = mi_row
        self.mi_borigin_c[mi_row:r1, mi_col:c1] = mi_col

        if skip:
            self._reset_entropy_ctx(mi_row, mi_col, bsize, is_chroma_ref)
        for t in txs:
            self._write_txb(t, skip, bsize, mi_row, mi_col)


def encode_video(frames, cfg, path: str | None = None,
                 key_interval: int = 0, device="cuda"):
    """IPPP GOP driver: KEY + inter frames on a LAST-ref recon chain.

    ``key_interval`` > 0 inserts a keyframe every that-many frames.
    Returns ``(packets, recons)`` where recons are the encoder's in-loop
    reconstructions (must match any conforming decoder bit-exactly).
    ``device``: where the inter frames' motion search runs."""
    from ..bitstream.containers import write_ivf
    device = resolve_device(device)
    packets, recons = [], []
    ref_slot = None
    seq = None
    for i, frame in enumerate(frames):
        is_key = i == 0 or (key_interval > 0 and i % key_interval == 0)
        if is_key:
            enc = FrameEncoder(frame, cfg)
            packets.append(enc.encode(include_seq=(i == 0)))
            seq = enc.seq
        else:
            enc = InterFrameEncoder(frame, cfg, seq, ref_slot, device)
            packets.append(enc.encode(include_seq=False))
        recons.append([p.copy() for p in enc.planes])
        ref_slot = {"planes": [p.copy() for p in enc.planes],
                    "upscaled_width": enc.w, "height": enc.h,
                    "order_hint": 0, "frame_type": 0 if is_key else 1,
                    "showable": True}
    if path is not None:
        write_ivf(path, packets, frames[0].width, frames[0].height)
    return packets, recons
