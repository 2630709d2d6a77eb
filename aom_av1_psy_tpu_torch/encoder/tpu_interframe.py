"""Inter frames and the GOP encodes on the port — torch counterpart of
``aom_av1_psy_tpu/encoder/tpu_interframe.py`` (``TpuInterFrameEncoder``,
and ``encode_video_tpu`` / ``_arf`` / ``_cbr`` / ``_rc`` as
``encode_video`` / ``encode_video_arf`` / ``encode_video_cbr`` /
``encode_video_rc``).

Per P-frame: the batched inter plan on the device
(``tpu_inter.plan_inter_frame``: kernels KE, KD, KB), the device
loop-filter ladder around the inter first guess (``ops/deblock_torch``,
kernel KC), the device CDEF on the reference chain (``tpu_frame.
apply_cdef_refs``, kernel KF), then the symbol-script pack executed by the
native range coder. The reference chain (``ref_planes_out``) stays
on the device, post-LPF and post-CDEF like the decoder's.

With ``tune_vmaf`` the source luma is first unsharpened on the device
(``tune_vmaf.preprocess_frame``: kernels KG and KH), as the reference's
encoder does; in the GOP the KEY frame is temporally filtered first, then
unsharpened.

The host code is carried over from the reference module: the MV-class
helpers and constants (``tpu_interframe.py:
38-68``), ``make_headers``, ``_mi_skip_map``, ``_pack_script`` and
``_mv_ops`` (``:165-671``, over ``normative/mvref.find_mv_refs`` and
``decoder/inter``), ``_ref_chain_planes``, the GOP loops and the rate
control arithmetic (``:673-1044``). The temporal filters of the KEY frame
and of each ARF run on the device (``encoder/temporal_filter``: kernels KJ
and KK). ``_warm_transfer`` is a TPU-platform workaround and is
dropped. The host layers under it (headers, the range coder, the
decoder's inter prediction, ``normative/mvref``) are the port's own copies.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..bitstream.bitio import BitWriter, write_leb128
from ..bitstream.headers import FrameHeader, TileInfo, write_frame_header
from ..decoder import inter as IT
from ..ec.context import FrameContext
from ..ec.native_coder import (NativeEncoder, available, make_bundle,
                               native_run_script)
from .frame import EncoderConfig
from ..normative import mvref as MR
from ..normative import tables
from ..normative.blocks import (EXT_TX_IND, EXT_TX_SET_INDEX_INTER,
                                NUM_EXT_TX_SET, PARTITION_CTX_ABOVE,
                                PARTITION_CTX_LEFT)
from ..normative.enums import BlockSize, TxSize
from ..normative.txsize import (TXSIZE_LOG2_MINUS4, TXSIZE_SQR,
                                txsize_entropy_ctx)
from ..utils.frame import Frame
from ..device import resolve_device
from ..ops import deblock_torch as DT
from . import temporal_filter as TF
from . import tpu_inter, tune_vmaf
from .tpu_frame import (GpuFrameEncoder, _pad_plane, apply_cdef_refs,
                        cdef_fixed_strengths)

MV_CLASSES = 11
CLASS0_BITS = 1
CLASS0_SIZE = 1 << CLASS0_BITS

_B64, _B32, _B16 = (int(BlockSize.BLOCK_64X64), int(BlockSize.BLOCK_32X32),
                    int(BlockSize.BLOCK_16X16))


def _mv_class(z: int) -> int:
    n = z >> 3
    c = n.bit_length() - 1 if n > 0 else 0
    return min(c, MV_CLASSES - 1)


def _cul_levels(levels, eobs, scan, n):
    """Vectorized cul_level per block: min(sum|l|,7) + dc-sign bits
    (set_dc_sign), 0 where eob==0."""
    flat = levels.reshape(-1, n)
    s = np.minimum(np.abs(flat).sum(-1), 7)
    dc = flat[:, 0]
    s = s + np.where(dc > 0, 2 << 3, np.where(dc < 0, 1 << 3, 0))
    s = np.where(eobs.reshape(-1) > 0, s, 0)
    return s.reshape(eobs.shape)


def _dc_sign_ctx(vals):
    """dc_sign_ctx_from: vals = concatenated above+left ent bytes."""
    signs = {0: 0, 1: -1, 2: 1}
    s = sum(signs[v >> 3] for v in vals)
    return 0 if s == 0 else (1 if s < 0 else 2)


class GpuInterFrameEncoder:
    """One INTER frame against a single LAST reference through the device
    plan + symbol-script pack. API mirror of ``TpuInterFrameEncoder``:
    ``ref_planes_dev`` are the reference's int32 planes on ``device``;
    after
    ``encode()`` it holds ``plan``, ``seq``, ``fh``, ``saved_fc``,
    ``ref_planes_out`` (post-LPF, post-CDEF planes on ``device``) and
    ``timings`` (``plan_s``, ``pack_s``). The ARF slot plumbing
    (``ref_slot``, ``refresh_flags``, ``show``, ``primary_ref``) serves
    ``encode_video_arf``."""

    def __init__(self, frame: Frame, cfg: EncoderConfig, seq, ref_planes_dev,
                 crop_w: int, crop_h: int, zero_lpf: bool = False,
                 prev_fc=None, ref_slot: int = 0, refresh_flags: int = 0xFF,
                 show: bool = True, primary_ref: int = 0, device="cuda"):
        if not available():
            raise RuntimeError("the encoder requires the native EC library")
        self.device = resolve_device(device)
        # CDF forwarding: code this frame against the previous frame's
        # counter-reset end-of-frame entropy state (primary_ref_frame)
        self.prev_fc = prev_fc
        # zero_lpf=True: legacy pre-LPF chain with lf = 0 (no CDEF either)
        self.zero_lpf = zero_lpf
        self.cfg = cfg
        if cfg.tune_vmaf:
            t0 = time.perf_counter()
            self.vmaf_unsharp_amount, frame = tune_vmaf.preprocess_frame(
                frame, self.device)
            self.vmaf_s = time.perf_counter() - t0
        self.src = frame
        self._seq = seq
        self.w, self.h = frame.width, frame.height
        self.mi_cols = (self.w + 7) // 8 * 2
        self.mi_rows = (self.h + 7) // 8 * 2
        self.nplanes = 1 if frame.monochrome else 3
        pw, ph = self.mi_cols * 4, self.mi_rows * 4
        pw32 = (pw + 31) // 32 * 32
        ph32 = (ph + 31) // 32 * 32
        planes = frame.planes()
        self.srcp = [_pad_plane(planes[0].astype(np.int32), ph32, pw32)]
        if self.nplanes > 1:
            for p in (1, 2):
                self.srcp.append(_pad_plane(planes[p].astype(np.int32),
                                            ph32 // 2, pw32 // 2))
        self._srcs_dev = None
        self.ref_planes_dev = list(ref_planes_dev)
        self.crop_w, self.crop_h = crop_w, crop_h
        # slot plumbing (ARF group structure)
        self.ref_slot = ref_slot
        self.refresh_flags = refresh_flags
        self.show = show
        self.primary_ref = primary_ref
        from ..ec import costs as EC_costs
        self.rdmult = EC_costs.compute_rd_mult(cfg.base_q_idx,
                                               frame_type_kf=False)
        if cfg.tune_psy or cfg.tune_butteraugli:
            from . import psy as psy_mod
            f = (psy_mod.ssim_rdmult_scaling_factors(frame.planes()[0])
                 if cfg.tune_psy else
                 psy_mod.butteraugli_lite_factors(frame.planes()[0]))
            R2 = (self.mi_rows * 4 + 31) // 32 * 2
            C2 = (self.mi_cols * 4 + 31) // 32 * 2
            g = np.ones((R2, C2), np.float64)
            rr, cc = min(R2, f.shape[0]), min(C2, f.shape[1])
            g[:rr, :cc] = f[:rr, :cc]
            if rr < R2:
                g[rr:, :] = g[rr - 1 : rr, :]
            if cc < C2:
                g[:, cc:] = g[:, cc - 1 : cc]
            self.rdmult = (self.rdmult * g).astype(np.float32)

        # ---- cm duck-type for normative/mvref.find_mv_refs ----
        self.bd = 8
        self.force_integer_mv = False
        self.allow_high_precision_mv = False
        self.global_motion = [MR.WarpModel() for _ in range(8)]
        self.ref_frame_sign_bias = [0] * 8
        self.enable_order_hint = False
        self.order_hint_bits = 0
        self.cur_order_hint = 0
        self.allow_ref_frame_mvs = False
        self.tpl_mvs = None
        self.sb_mi = 16
        self.refs = [None] * 8

    def ref_order_hint(self, rf: int) -> int:
        return 0

    # ------------------------------------------------------------------
    def make_headers(self):
        fh = FrameHeader(width=self.w, height=self.h,
                         render_width=self.w, render_height=self.h)
        fh.frame_type = 1
        fh.show_frame = self.show
        fh.showable_frame = True
        fh.error_resilient_mode = False
        if self.prev_fc is not None:
            # inherit the saved CDFs of the primary ref's slot
            fh.primary_ref_frame = self.primary_ref
        else:
            fh.primary_ref_frame = 7      # PRIMARY_REF_NONE (CDF reset)
        fh.refresh_frame_flags = self.refresh_flags
        fh.ref_frame_idx = [self.ref_slot] * 7
        fh.allow_high_precision_mv = False
        fh.is_filter_switchable = False
        fh.interp_filter = 0   # overwritten by the plan's frame pick
        fh.is_motion_mode_switchable = False
        fh.reference_select = False
        fh.allow_warped_motion = False
        fh.disable_frame_end_update_cdf = False
        fh.quant.base_q_idx = self.cfg.base_q_idx
        fh.tx_mode_select = False
        fh.tiles = TileInfo()
        fh.global_motion = [MR.WarpModel() for _ in range(8)]
        if self.zero_lpf:
            lvl = 0
        else:
            q = tables.ac_quant(self.cfg.base_q_idx)
            guess = (q * 6017 + 1243066 + (1 << 17)) >> 18 if q > 16 else 0
            lvl = int(np.clip(guess, 0, 63))
        fh.lf.filter_level = (lvl, lvl)
        fh.lf.filter_level_u = lvl
        fh.lf.filter_level_v = lvl
        fh.lf.delta_enabled = False
        if getattr(self._seq, "enable_cdef", False):
            cdef_fixed_strengths(fh, self.cfg.base_q_idx)
        return self._seq, fh

    # ------------------------------------------------------------------
    def encode(self) -> bytes:
        seq, fh = self.make_headers()
        self.seq, self.fh = seq, fh
        if self.prev_fc is not None:
            fc = self.prev_fc.copy()
        else:
            fc = FrameContext(self.cfg.base_q_idx)
        self.fc = fc
        t0 = time.perf_counter()
        plan = tpu_inter.plan_inter_frame(
            self.srcp, self.ref_planes_dev, self.cfg.base_q_idx,
            self.rdmult, self.mi_rows, self.mi_cols, self.crop_w,
            self.crop_h, device=self.device)
        t1 = time.perf_counter()
        self.plan = plan
        fh.interp_filter = int(plan.get("interp_filter", 0))
        if not self.zero_lpf:
            self._lpf_device(fh)
        else:
            self.ref_planes_out = list(plan["recon_dev"])
        t2 = time.perf_counter()
        if getattr(self.seq, "enable_cdef", False) and not self.zero_lpf:
            self.ref_planes_out = apply_cdef_refs(
                self.ref_planes_out, self._mi_skip_map(), fh,
                self.mi_rows, self.mi_cols, self.nplanes,
                srcs=self.device_sources())
        t3 = time.perf_counter()
        tile_data = self._pack_script(plan, fc, fh)
        # end-of-frame context save (decoder/obu.py:_update_ref_slots):
        # the script adapted fc's tables in place; reset the per-row
        # adaptation counters exactly as the decoder does before storing
        fc.reset_counters()
        self.saved_fc = fc
        t4 = time.perf_counter()
        self.timings = {"plan_s": t1 - t0, "pack_s": t4 - t1}
        # pack_s, split: the LPF pick (KC), apply_cdef_refs (KF and its one
        # wait for the gate's sums), the symbol script and the native coder
        self.pack_stages = {"lpf_s": t2 - t1, "cdef_s": t3 - t2,
                            "script_s": t4 - t3}
        w = BitWriter()
        write_frame_header(w, seq, fh)
        w.byte_align()
        frame_payload = w.data() + tile_data
        td = bytes([0x12, 0x00])
        return td + bytes([0x32]) + write_leb128(len(frame_payload)) \
            + frame_payload

    # ------------------------------------------------------------------
    def _mi_skip_map(self):
        """Per-mi skip grid from the plan eobs (the pack derives the same
        flags; CDEF's unit gating needs them before the pack runs)."""
        p = self.plan
        skip32 = (p["y_eob32"] == 0)
        skip16 = (p["y_eob16"] == 0)
        if self.nplanes > 1:
            skip32 &= (p["uv_eob16"] == 0).all(0)
            skip16 &= (p["uv_eob8"] == 0).all(0)
        sp = p["split32"].astype(bool)
        blk = np.where(np.repeat(np.repeat(sp, 2, 0), 2, 1), skip16,
                       np.repeat(np.repeat(skip32, 2, 0), 2, 1))
        return np.repeat(np.repeat(blk.astype(np.int32), 4, 0),
                         4, 1)[: self.mi_rows, : self.mi_cols]

    # ------------------------------------------------------------------
    device_sources = GpuFrameEncoder.device_sources

    def _lpf_device(self, fh) -> None:
        """Pick + apply the loop filter on the device for this inter frame
        (``ops/deblock_torch``, kernel KC): the ladder around the inter
        first guess; sets ``fh.lf`` and keeps ``self.ref_planes_out`` = the
        post-LPF recon that the NEXT frame references."""
        dev = self.device
        sp = self.plan["split32"].astype(bool)
        split16 = torch.as_tensor(np.repeat(np.repeat(sp, 2, 0), 2, 1),
                                  device=dev)
        w, h = self.mi_cols * 4, self.mi_rows * 4
        g = fh.lf.filter_level[0]
        cands = torch.tensor([0, g // 2, max(g - 2, 0), g, min(g + 2, 63),
                              min(g * 2, 63)], dtype=torch.int32, device=dev)
        recs = tuple(self.plan["recon_dev"][: self.nplanes])
        levels, outs = DT.lpf_pick_and_filter(
            recs, self.device_sources(), split16, cands, w=w, h=h,
            nplanes=self.nplanes)
        lv = [int(x) for x in levels.cpu().numpy()]
        fh.lf.filter_level = (lv[0], lv[0])
        fh.lf.filter_level_u = lv[1]
        fh.lf.filter_level_v = lv[2]
        self.ref_planes_out = list(outs)

    # ------------------------------------------------------------------
    def _pack_script(self, plan, fc, fh) -> bytes:
        Rc, Cc = plan["split32"].shape
        R2, C2 = 2 * Rc, 2 * Cc
        split = plan["split32"].astype(bool)
        mv8 = plan["mv8"]

        # --- per-block skip flags + culs (vectorized) ---
        ye32, ye16 = plan["y_eob32"], plan["y_eob16"]
        if self.nplanes > 1:
            ue16, ue8 = plan["uv_eob16"], plan["uv_eob8"]
            skip32 = (ye32 == 0) & (ue16 == 0).all(0)
            skip16 = (ye16 == 0) & (ue8 == 0).all(0)
        else:
            skip32 = ye32 == 0
            skip16 = ye16 == 0
        tx32, tx16, tx8 = (int(TxSize.TX_32X32), int(TxSize.TX_16X16),
                           int(TxSize.TX_8X8))
        scan32 = np.ascontiguousarray(tables.scan_table(tx32, 0), np.int32)
        scan16 = np.ascontiguousarray(tables.scan_table(tx16, 0), np.int32)
        scan8 = np.ascontiguousarray(tables.scan_table(tx8, 0), np.int32)
        cul_y32 = _cul_levels(plan["y_levels32"], ye32, scan32, 1024)
        cul_y16 = _cul_levels(plan["y_levels16"], ye16, scan16, 256)
        if self.nplanes > 1:
            cul_u16 = _cul_levels(plan["uv_levels16"][0], ue16[0], scan16,
                                  256)
            cul_v16 = _cul_levels(plan["uv_levels16"][1], ue16[1], scan16,
                                  256)
            cul_u8 = _cul_levels(plan["uv_levels8"][0], ue8[0], scan8, 64)
            cul_v8 = _cul_levels(plan["uv_levels8"][1], ue8[1], scan8, 64)

        # --- CDF registry ---
        sref = fc.single_ref_cdf.reshape(18, 3)
        comp_tables = []
        for c in range(2):
            g = lambda n: getattr(fc, f"nmv_comp{c}_{n}_cdf")
            comp_tables += [
                g("sign").reshape(1, -1), g("classes").reshape(1, -1),
                g("class0").reshape(1, -1), g("bits"),
                g("class0_fp"), g("fp").reshape(1, -1),
                g("class0_hp").reshape(1, -1), g("hp").reshape(1, -1)]
        cdfs = [fc.partition_cdf, fc.skip_txfm_cdfs, fc.intra_inter_cdf,
                sref, fc.newmv_cdf, fc.zeromv_cdf, fc.refmv_cdf,
                fc.drl_cdf, fc.nmv_joints_cdf.reshape(1, -1)] + comp_tables
        (CDF_PART, CDF_SKIP, CDF_II, CDF_SREF, CDF_NEWMV, CDF_ZEROMV,
         CDF_REFMV, CDF_DRL, CDF_JOINT) = range(9)
        for t in cdfs:
            assert t.flags["C_CONTIGUOUS"] and t.dtype == np.uint16

        # --- coeff bundles (inter ext-tx sets) ---
        e32c, e16c, e8c = (txsize_entropy_ctx(t) for t in (tx32, tx16, tx8))

        def inter_ext(tx, sqr_is16):
            set_type = 1 if tx == tx32 else (4 if sqr_is16 else 5)
            nsyms = int(NUM_EXT_TX_SET[set_type])
            eset = EXT_TX_SET_INDEX_INTER[set_type]
            row = np.ascontiguousarray(
                fc.inter_ext_tx_cdf[eset][int(TXSIZE_SQR[tx])])
            fc.inter_ext_tx_cdf[eset][int(TXSIZE_SQR[tx])] = row
            return row, nsyms, int(EXT_TX_IND[set_type][0])

        ext32, n32, s32sym = inter_ext(tx32, False)
        ext16, n16, s16sym = inter_ext(tx16, True)
        self._ext_keep = (ext32, ext16)

        def nz(tx):
            return np.ascontiguousarray(tables.get(f"nz_map_ctx_offset_ts{tx}"),
                                        np.int32)

        bundles = [
            make_bundle(fc.txb_skip_cdf[e32c], fc.eob_flag_cdf1024[0][0],
                        fc.eob_extra_cdf[e32c][0],
                        fc.coeff_base_eob_cdf[e32c][0],
                        fc.coeff_base_cdf[e32c][0],
                        fc.coeff_br_cdf[min(e32c, 3)][0], fc.dc_sign_cdf[0],
                        scan32, nz(tx32), 5 + int(TXSIZE_LOG2_MINUS4[tx32]),
                        32, ext32, n32, s32sym, 0),
            make_bundle(fc.txb_skip_cdf[e16c], fc.eob_flag_cdf256[0][0],
                        fc.eob_extra_cdf[e16c][0],
                        fc.coeff_base_eob_cdf[e16c][0],
                        fc.coeff_base_cdf[e16c][0],
                        fc.coeff_br_cdf[min(e16c, 3)][0], fc.dc_sign_cdf[0],
                        scan16, nz(tx16), 5 + int(TXSIZE_LOG2_MINUS4[tx16]),
                        16, ext16, n16, s16sym, 0),
            make_bundle(fc.txb_skip_cdf[e16c], fc.eob_flag_cdf256[1][0],
                        fc.eob_extra_cdf[e16c][1],
                        fc.coeff_base_eob_cdf[e16c][1],
                        fc.coeff_base_cdf[e16c][1],
                        fc.coeff_br_cdf[min(e16c, 3)][1], fc.dc_sign_cdf[1],
                        scan16, nz(tx16), 5 + int(TXSIZE_LOG2_MINUS4[tx16]),
                        16),
            make_bundle(fc.txb_skip_cdf[e8c], fc.eob_flag_cdf64[1][0],
                        fc.eob_extra_cdf[e8c][1],
                        fc.coeff_base_eob_cdf[e8c][1],
                        fc.coeff_base_cdf[e8c][1],
                        fc.coeff_br_cdf[min(e8c, 3)][1], fc.dc_sign_cdf[1],
                        scan8, nz(tx8), 5 + int(TXSIZE_LOG2_MINUS4[tx8]),
                        8),
        ]
        BND_Y32, BND_Y16, BND_UV16, BND_UV8 = range(4)
        # flat levels store: [y32 | y16 | u16 | v16 | u8 | v8]; op2 indexes
        # are in units of the bundle's own n (every region size is a
        # multiple of 64/256/1024, so offsets stay integral)
        lv_list = [np.ascontiguousarray(plan["y_levels32"], np.int32)
                   .reshape(-1),
                   np.ascontiguousarray(plan["y_levels16"], np.int32)
                   .reshape(-1)]
        if self.nplanes > 1:
            lv_list += [
                np.ascontiguousarray(plan["uv_levels16"][0], np.int32)
                .reshape(-1),
                np.ascontiguousarray(plan["uv_levels16"][1], np.int32)
                .reshape(-1),
                np.ascontiguousarray(plan["uv_levels8"][0], np.int32)
                .reshape(-1),
                np.ascontiguousarray(plan["uv_levels8"][1], np.int32)
                .reshape(-1)]
        lv_base = np.concatenate(lv_list)
        # element offsets of each region
        roff = np.cumsum([0] + [x.size for x in lv_list])
        # per-bundle index = (region_offset + block*n) / n must be integral
        # -> guaranteed since region sizes are multiples of their own n;
        # but regions of other sizes may misalign a later region. Check:
        idx_div = {BND_Y32: 1024, BND_Y16: 256, BND_UV16: 256, BND_UV8: 64}

        def lv_index(region, block, bnd):
            o = roff[region] + block * idx_div[bnd]
            assert o % idx_div[bnd] == 0
            return o // idx_div[bnd]

        # --- rolling contexts ---
        mi_rows, mi_cols = self.mi_rows, self.mi_cols
        ncols = (mi_cols + 15) // 16 * 16
        above_part = np.zeros(ncols, np.int32)
        left_part = np.zeros(16, np.int32)
        aent = [np.zeros(ncols, np.uint8) for _ in range(3)]
        lent = [np.zeros(16, np.uint8) for _ in range(3)]
        mi = np.full((mi_rows, mi_cols), None, object)
        self.mi = mi
        self.tile_mi_row_start = 0
        self.tile_mi_col_start = 0
        self.tile_mi_row_end = mi_rows
        self.tile_mi_col_end = mi_cols

        ops = []
        op = ops.append
        pa32, pl32 = int(PARTITION_CTX_ABOVE[_B32]), \
            int(PARTITION_CTX_LEFT[_B32])
        pa16, pl16 = int(PARTITION_CTX_ABOVE[_B16]), \
            int(PARTITION_CTX_LEFT[_B16])

        def txb_op(bnd, region, block, eob, skip_ctx, dctx):
            op((2, bnd | (skip_ctx << 8) | (dctx << 16),
                lv_index(region, block, bnd), int(eob), 0))

        def ent_update(plane, acol, lrow, wu, cul, vis_w, vis_h):
            a, l = aent[plane], lent[plane]
            a[acol : acol + vis_w] = cul
            a[acol + vis_w : acol + wu] = 0
            l[lrow : lrow + vis_h] = cul
            l[lrow + vis_h : lrow + wu] = 0

        def block_ops(mi_row, mi_col, bs):
            r32, c32 = mi_row // 8, mi_col // 8
            r16, c16 = mi_row // 4, mi_col // 4
            up, left = mi_row > 0, mi_col > 0
            above = mi[mi_row - 1, mi_col] if up else None
            left_mb = mi[mi_row, mi_col - 1] if left else None

            if bs == 32:
                skip = bool(skip32[r32, c32])
                mv = mv8[2 * r32, 2 * c32]
            else:
                skip = bool(skip16[r16, c16])
                mv = mv8[r16, c16]
            mv = (int(mv[0]), int(mv[1]))
            bsize = _B32 if bs == 32 else _B16

            mbmi = MR.MbInfo()
            mbmi.bsize = bsize
            mbmi.mi_row, mbmi.mi_col = mi_row, mi_col
            mbmi.interp_y = mbmi.interp_x = 0
            mbmi.ref_frame = [MR.LAST_FRAME, MR.NONE_FRAME]
            mi[mi_row, mi_col] = mbmi   # _has_top_right reads the current
            xd = MR.XdCtx(mi, mi_row, mi_col, bsize,
                          (0, mi_rows, 0, mi_cols), mi_rows, mi_cols)
            stack, weights, count, mode_ctx, mv_ref_list, gm_mv = \
                MR.find_mv_refs(self, xd, mbmi, MR.LAST_FRAME)
            lower = lambda m: MR.lower_mv_precision(m, False, False)
            nearest = lower(mv_ref_list[0])
            near = lower(mv_ref_list[1])
            gmv = gm_mv[0]
            if mv == nearest:
                mode = MR.NEARESTMV
            elif mv == near:
                mode = MR.NEARMV
            elif mv == gmv:
                mode = MR.GLOBALMV
            else:
                mode = MR.NEWMV
            newmv_ref = nearest if count <= 1 else stack[0][0]
            mbmi.mode = mode
            mbmi.mv[0] = mv
            mbmi.ref_mv_idx = 0
            mbmi.skip_txfm = int(skip)

            # ---- syntax (decoder parse order) ----
            skip_ctx = ((above.skip_txfm if up else 0)
                        + (left_mb.skip_txfm if left else 0))
            op((0, CDF_SKIP, skip_ctx, int(skip), 2))
            if up and left:
                ai, li = not above.is_inter, not left_mb.is_inter
                ctx = 3 if (ai and li) else int(ai or li)
            elif up or left:
                e = above if up else left_mb
                ctx = 2 * int(not e.is_inter)
            else:
                ctx = 0
            op((0, CDF_II, ctx, 1, 2))          # is_inter = 1
            counts = IT.collect_neighbors_ref_counts(self, above, left_mb)
            op((0, CDF_SREF, IT.ctx_single_p1(counts) * 6 + 0, 0, 2))
            op((0, CDF_SREF, IT.ctx_ll2_or_l3gld(counts) * 6 + 2, 0, 2))
            op((0, CDF_SREF, IT.ctx_last_or_last2(counts) * 6 + 3, 0, 2))
            # inter mode
            ctx = mode_ctx & MR.NEWMV_CTX_MASK
            op((0, CDF_NEWMV, ctx, int(mode != MR.NEWMV), 2))
            if mode != MR.NEWMV:
                ctx = (mode_ctx >> MR.GLOBALMV_OFFSET) & MR.GLOBALMV_CTX_MASK
                op((0, CDF_ZEROMV, ctx, int(mode != MR.GLOBALMV), 2))
                if mode != MR.GLOBALMV:
                    ctx = (mode_ctx >> MR.REFMV_OFFSET) & MR.REFMV_CTX_MASK
                    op((0, CDF_REFMV, ctx, int(mode != MR.NEARESTMV), 2))
            # drl (ref_mv_idx always 0)
            if mode == MR.NEWMV:
                if count > 1:
                    op((0, CDF_DRL, MR.drl_ctx(weights, 0), 0, 2))
            elif mode == MR.NEARMV:
                if count > 2:
                    op((0, CDF_DRL, MR.drl_ctx(weights, 1), 0, 2))
            if mode == MR.NEWMV:
                self._mv_ops(op, mv, newmv_ref)

            # ---- store MI ----
            n4 = bs // 4
            r1 = min(mi_row + n4, mi_rows)
            c1 = min(mi_col + n4, mi_cols)
            mi[mi_row:r1, mi_col:c1] = mbmi

            # ---- residual ----
            wu = bs // 4
            cwu = wu // 2
            acol, lrow = mi_col, mi_row & 15
            cacol, clrow = mi_col >> 1, (mi_row & 15) >> 1
            vis_w = min(wu, mi_cols - mi_col)
            vis_h = min(wu, mi_rows - mi_row)
            cvw = min(cwu, ((vis_w * 4) >> 1) >> 2)
            cvh = min(cwu, ((vis_h * 4) >> 1) >> 2)
            if skip:
                ent_update(0, acol, lrow, wu, 0, wu, wu)
                if self.nplanes > 1:
                    ent_update(1, cacol, clrow, cwu, 0, cwu, cwu)
                    ent_update(2, cacol, clrow, cwu, 0, cwu, cwu)
                return
            dctx = _dc_sign_ctx(list(aent[0][acol : acol + wu])
                                + list(lent[0][lrow : lrow + wu]))
            if bs == 32:
                blk = r32 * Cc + c32
                txb_op(BND_Y32, 0, blk, ye32[r32, c32], 0, dctx)
                cul = int(cul_y32[r32, c32])
            else:
                blk = r16 * C2 + c16
                txb_op(BND_Y16, 1, blk, ye16[r16, c16], 0, dctx)
                cul = int(cul_y16[r16, c16])
            ent_update(0, acol, lrow, wu, cul, vis_w, vis_h)
            if self.nplanes > 1:
                for pl in (1, 2):
                    a = aent[pl][cacol : cacol + cwu]
                    l = lent[pl][clrow : clrow + cwu]
                    sctx = (int(a.any()) + int(l.any())) + 7
                    dctx = _dc_sign_ctx(list(a) + list(l))
                    if bs == 32:
                        e = int((ue16[pl - 1])[r32, c32])
                        txb_op(BND_UV16, 1 + pl, blk, e, sctx, dctx)
                        cul = int((cul_u16 if pl == 1 else cul_v16)
                                  [r32, c32])
                    else:
                        e = int((ue8[pl - 1])[r16, c16])
                        txb_op(BND_UV8, 3 + pl, blk, e, sctx, dctx)
                        cul = int((cul_u8 if pl == 1 else cul_v8)
                                  [r16, c16])
                    ent_update(pl, cacol, clrow, cwu, cul, cvw, cvh)

        def part_ops(mi_row, mi_col, bsize):
            if mi_row >= mi_rows or mi_col >= mi_cols:
                return
            bsl = (bsize - 3) // 3
            mi_w = 2 << bsl
            hbs = mi_w // 2
            has_rows = mi_row + hbs < mi_rows
            has_cols = mi_col + hbs < mi_cols
            if bsize == _B16:
                partition = 0
            elif bsize == _B32:
                partition = 3 if split[mi_row // 8, mi_col // 8] else 0
            else:
                partition = 3
            above = (above_part[mi_col] >> bsl) & 1
            lft = (left_part[mi_row & 15] >> bsl) & 1
            ctx = (lft * 2 + above) + bsl * 4
            if has_rows and has_cols:
                op((0, CDF_PART, ctx, partition, 10))
            elif not has_rows and not has_cols:
                pass
            else:
                op((3, CDF_PART, ctx, int(partition == 3),
                    int(not has_cols)))
            if partition == 0:
                block_ops(mi_row, mi_col, 32 if bsize == _B32 else 16)
                pa = pa32 if bsize == _B32 else pa16
                pl = pl32 if bsize == _B32 else pl16
                above_part[mi_col : mi_col + mi_w] = pa
                for i in range(mi_w):
                    left_part[(mi_row + i) & 15] = pl
            else:
                sub = bsize - 3
                part_ops(mi_row, mi_col, sub)
                part_ops(mi_row, mi_col + hbs, sub)
                part_ops(mi_row + hbs, mi_col, sub)
                part_ops(mi_row + hbs, mi_col + hbs, sub)

        for r0 in range(0, mi_rows, 16):
            left_part[:] = 0
            for l in lent:
                l[:] = 0
            for c0 in range(0, mi_cols, 16):
                part_ops(r0, c0, _B64)

        enc = NativeEncoder()
        enc.allow_update = not fh.disable_cdf_update
        self._cdf_keep = cdfs
        self._lv_keep = lv_base
        native_run_script(
            enc, np.asarray(ops, np.int32).reshape(-1, 5), cdfs, bundles,
            lv_base, tables.get("eob_group_start"),
            tables.get("eob_offset_bits"))
        return enc.done()

    # ------------------------------------------------------------------
    def _mv_ops(self, op, mv, ref_mv):
        """encode_mv (av1/encoder/encodemv.c) as script ops."""
        CDF_JOINT = 8
        dr = mv[0] - ref_mv[0]
        dc = mv[1] - ref_mv[1]
        joint = 2 * int(dr != 0) + int(dc != 0)
        op((0, CDF_JOINT, 0, joint, 4))
        for comp, diff in ((0, dr), (1, dc)):
            if diff == 0:
                continue
            base_id = 9 + comp * 8
            (SIGN, CLASSES, CLASS0, BITS, C0FP, FP, C0HP, HP) = range(8)
            sign = int(diff < 0)
            mag = -diff if sign else diff
            z = mag - 1
            mv_class = _mv_class(z)
            cbase = 0 if mv_class == 0 else (CLASS0_SIZE << (mv_class + 2))
            offset = z - cbase
            d = offset >> 3
            fr = (offset >> 1) & 3
            hp = offset & 1
            op((0, base_id + SIGN, 0, sign, 2))
            op((0, base_id + CLASSES, 0, mv_class, MV_CLASSES))
            if mv_class == 0:
                op((0, base_id + CLASS0, 0, d, CLASS0_SIZE))
            else:
                n = mv_class + CLASS0_BITS - 1
                for i in range(n):
                    op((0, base_id + BITS, i, (d >> i) & 1, 2))
            # use_subpel (precision=1): fr always, hp only if precision>1
            if mv_class == 0:
                op((0, base_id + C0FP, d, fr, 4))
            else:
                op((0, base_id + FP, 0, fr, 4))


def _ref_chain_planes(enc):
    """The post-LPF (post-CDEF) reference planes an encoded frame leaves
    behind (== the decoder's reference buffer state for that frame); a
    uniform-grid KEY frame leaves its pre-LPF plan recon, as the
    reference's does."""
    out = getattr(enc, "ref_planes_out", None)   # inter frames
    if out is None:
        out = getattr(enc, "ref_planes_dev", None)  # KEY, partition path
    if out is None:
        out = enc.plan["recon_dev"]              # uniform-grid fallback
    return out


def displayed_encoders(encs):
    """The encoder whose reference chain each displayed frame shows, in
    display order, for the ``encs`` of a GOP encode: a non-shown ARF
    shows nothing; the show_existing packet after its group (``None`` in
    ``encs``) shows that ARF."""
    out, arf = [], None
    for e in encs:
        if e is None:
            out.append(arf)
        elif getattr(e, "show", True):
            out.append(e)
        else:
            arf = e
    return out


def encode_video(frames, cfg: EncoderConfig, path: str | None = None,
                 key_interval: int = 0, forward_cdf: bool = True,
                 kf_q_offset: int = 60, tf_key: bool = True,
                 cdef: bool = True, device="cuda"):
    """IPPP GOP driver (``encode_video_tpu``): a device KEY frame, then
    device inter frames on a LAST recon chain. With ``forward_cdf``
    (default), every inter frame inherits the previous frame's
    end-of-frame entropy state via primary_ref_frame. KEY frames encode at
    base_q_idx - ``kf_q_offset`` (floor 8) and, with ``tf_key``, from the
    temporally filtered source (``encoder/temporal_filter``).
    ``key_interval`` > 0 places a KEY frame every that many frames.
    ``cdef`` turns on the quantizer-derived CDEF on every frame (the
    reference chain carries it). Returns (packets, encs); a KEY encoder
    carries the filter's host-clock seconds as ``tf_s`` (None when
    unfiltered)."""
    from ..bitstream.containers import write_ivf
    packets = []
    encs = []
    ref_planes = None
    seq = None
    prev_fc = None
    if cdef and not cfg.search_cdef:
        cfg = dataclasses.replace(cfg, cdef_fixed=True)
    kf_cfg = dataclasses.replace(
        cfg, base_q_idx=max(8, cfg.base_q_idx - kf_q_offset)) \
        if kf_q_offset else cfg
    for i, frame in enumerate(frames):
        is_key = i == 0 or (key_interval > 0 and i % key_interval == 0)
        if is_key:
            tf_s = None
            if tf_key and len(frames) > 1:
                # multi-frame KEY denoise (temporal_filter.c:833-841)
                t0 = time.perf_counter()
                frame = TF.filter_key_frame(frames, i, kf_cfg.base_q_idx,
                                            device=device)
                tf_s = time.perf_counter() - t0
            enc = GpuFrameEncoder(frame, kf_cfg, device=device)
            enc.tf_s = tf_s
            packets.append(enc.encode(include_seq=(i == 0)))
            seq = enc.seq
        else:
            enc = GpuInterFrameEncoder(frame, cfg, seq, ref_planes,
                                       frames[0].width, frames[0].height,
                                       prev_fc=prev_fc, device=device)
            packets.append(enc.encode())
        encs.append(enc)
        ref_planes = _ref_chain_planes(enc)
        prev_fc = enc.saved_fc if forward_cdf else None
    if path is not None:
        write_ivf(path, packets, frames[0].width, frames[0].height)
    return packets, encs


def encode_video_arf(frames, cfg: EncoderConfig, path: str | None = None,
                     group: int = 4, kf_q_offset: int = 60,
                     arf_q_offset: int = 48, tf_strength: int = 2,
                     forward_cdf: bool = True, device="cuda"):
    """ARF star-group GOP (``encode_video_tpu_arf``; depth-1 pyramid,
    av1/encoder/gop_structure.c + encode_strategy.c:718 analogue).

    Per group of ``group`` display frames: the LAST frame of the group is
    temporally filtered on the device (``encoder/temporal_filter``, the psy
    strength-2 rule of temporal_filter.c:815-831), coded as a non-shown
    showable ALTREF at base_q_idx - arf_q_offset, and every middle frame
    references the ARF (a star: drift-free, mutually independent). The
    ARF's display position is a show_existing_frame header. The KEY frame
    is temporally filtered when there is more than one frame. Returns
    (packets, encs) — ``encs`` has one entry per PACKET (None for
    show_existing packets); the KEY and ARF encoders carry the filter's
    host-clock seconds as ``tf_s`` (None when unfiltered).
    """
    from ..bitstream.containers import write_ivf

    T = len(frames)
    kf_cfg = dataclasses.replace(
        cfg, base_q_idx=max(8, cfg.base_q_idx - kf_q_offset))
    arf_cfg = dataclasses.replace(
        cfg, base_q_idx=max(8, cfg.base_q_idx - arf_q_offset))
    packets, encs = [], []

    # KEY
    if not cfg.search_cdef:
        cfg = dataclasses.replace(cfg, cdef_fixed=True)
        kf_cfg = dataclasses.replace(kf_cfg, cdef_fixed=True)
        arf_cfg = dataclasses.replace(arf_cfg, cdef_fixed=True)
    t0 = time.perf_counter()
    key_src = TF.filter_key_frame(frames, 0, kf_cfg.base_q_idx,
                                  device=device) if T > 1 else frames[0]
    tf_s = time.perf_counter() - t0 if T > 1 else None
    key = GpuFrameEncoder(key_src, kf_cfg, device=device)
    key.tf_s = tf_s
    packets.append(key.encode(include_seq=True))
    encs.append(key)
    seq = key.seq
    cur_slot = 0                       # slot holding the last DISPLAYED recon
    slot_planes = {0: _ref_chain_planes(key), 1: _ref_chain_planes(key)}
    slot_fc = {0: key.saved_fc, 1: key.saved_fc}

    w0, h0 = frames[0].width, frames[0].height
    s_idx = 1
    while s_idx < T:
        e_idx = min(s_idx + group, T)
        arf_slot = 1 - cur_slot

        # ---- ARF: temporally filtered group-end frame, non-shown ----
        center = e_idx - 1
        span = frames[max(s_idx, center - 2) : min(T, center + 3)]
        c_rel = center - max(s_idx, center - 2)
        tf_s = None
        if len(span) >= 2:
            t0 = time.perf_counter()
            planes_list = TF.upload([f.planes() for f in span], device)
            noise = [max(TF.estimate_noise_level(pl), 0.0)
                     for pl in planes_list[c_rel]]
            # q_factor at the GROUP's quality level (av1_get_q analogue):
            # the boosted ARF q would put q_decay near zero and disable
            # the filter entirely
            qf = max(1, tables.ac_quant(max(cfg.base_q_idx, 1)) // 4)
            y, u, v = TF.temporal_filter_frames(
                planes_list, c_rel, qf, tf_strength,
                noise_levels=tuple(noise), device=device)
            arf_src = Frame(y, u, v)
            tf_s = time.perf_counter() - t0
        else:
            arf_src = frames[center]
        enc_arf = GpuInterFrameEncoder(
            arf_src, arf_cfg, seq, slot_planes[cur_slot], w0, h0,
            prev_fc=slot_fc[cur_slot] if forward_cdf else None,
            ref_slot=cur_slot, refresh_flags=1 << arf_slot, show=False,
            device=device)
        enc_arf.tf_s = tf_s
        packets.append(enc_arf.encode())
        encs.append(enc_arf)
        slot_planes[arf_slot] = _ref_chain_planes(enc_arf)
        slot_fc[arf_slot] = enc_arf.saved_fc

        # ---- middles: star-reference the ARF, refresh nothing ----
        for i in range(s_idx, e_idx - 1):
            enc_p = GpuInterFrameEncoder(
                frames[i], cfg, seq, slot_planes[arf_slot], w0, h0,
                prev_fc=slot_fc[arf_slot] if forward_cdf else None,
                ref_slot=arf_slot, refresh_flags=0, show=True, device=device)
            packets.append(enc_p.encode())
            encs.append(enc_p)

        # ---- ARF display position: show_existing_frame ----
        fh_se = FrameHeader(width=w0, height=h0)
        fh_se.show_existing_frame = True
        fh_se.frame_to_show_map_idx = arf_slot
        w = BitWriter()
        write_frame_header(w, seq, fh_se)
        w.trailing_bits()
        payload = w.data()
        pkt = bytes([0x12, 0x00]) + bytes([0x1A]) \
            + write_leb128(len(payload)) + payload
        packets.append(pkt)
        encs.append(None)

        cur_slot = arf_slot
        s_idx = e_idx
    if path is not None:
        write_ivf(path, packets, w0, h0)
    return packets, encs


# ----------------------------------------------------------------------
# Rate control v1 — one-pass VBR-lite (CQ/VBR subset of
# av1/encoder/ratectrl.c: av1_rc_regulate_q / update-after-encode model).
# The arithmetic is the reference's host numpy, line for line: equal
# packets give equal q.
# ----------------------------------------------------------------------
def _qindex_for_qstep(qstep: float, bd: int = 8) -> int:
    """Smallest qindex whose AC quant step is >= qstep (bisection over the
    monotone ac_quant table — av1_rc_bits_per_mb's inverse role)."""
    lo, hi = 1, 255
    if qstep <= tables.ac_quant(1):
        return 1
    if qstep >= tables.ac_quant(255):
        return 255
    while lo < hi:
        mid = (lo + hi) // 2
        if tables.ac_quant(mid) < qstep:
            lo = mid + 1
        else:
            hi = mid
    return lo


def encode_video_cbr(frames, target_bps: float, fps: float = 30.0,
                     buffer_ms: int = 1000, initial_ms: int = 500,
                     optimal_pct: int = 60, start_q: int = 120,
                     min_q: int = 8, max_q: int = 250,
                     max_step: int = 40, kf_q_offset: int = 40,
                     path: str | None = None, device="cuda"):
    """One-pass CBR with a leaky-bucket buffer model
    (``encode_video_tpu_cbr``; av1/encoder/ratectrl.c one-pass CBR:
    av1_calc_pframe_target_size_one_pass_cbr's buffer-deviation target +
    update_buffer_level).

    The decoder buffer fills at target_bps and drains by each coded
    frame; the per-frame bit target is the per-frame bandwidth corrected
    by the deviation from the optimal buffer fullness, and the quantizer
    follows the same online power-law rate model as ``encode_video_rc``,
    with per-frame q clamps. Returns (packets, encs, qs, buffer_trace).
    """
    from ..bitstream.containers import write_ivf
    avg_bits = target_bps / fps
    buffer_sz = target_bps * buffer_ms / 1000.0
    optimal = buffer_sz * optimal_pct / 100.0
    level = target_bps * initial_ms / 1000.0
    obs = {}
    packets, encs, qs, trace = [], [], [], []

    def want_q(ftype, tgt):
        pts = obs.get(ftype)
        if not pts:
            return None
        lq1, lb1 = pts[-1]
        beta = 1.2
        if len(pts) == 2 and abs(pts[0][0] - lq1) > 1e-3:
            beta = float(np.clip((pts[0][1] - lb1) / (lq1 - pts[0][0]),
                                 0.4, 3.0))
        lqw = lq1 + (lb1 - np.log(max(tgt, 1.0))) / beta
        return _qindex_for_qstep(float(np.exp(lqw)))

    ref_planes = None
    seq = None
    prev_fc = None
    q = int(np.clip(start_q, min_q, max_q))
    for i, frame in enumerate(frames):
        is_key = i == 0
        ftype = "key" if is_key else "inter"
        # target: per-frame bandwidth corrected toward the optimal
        # fullness over ~one buffer's worth of frames (the reference's
        # buffer-deviation term); KEY frames get a bounded boost
        correction = (level - optimal) / max(fps, 1.0)
        tgt = max(avg_bits * 0.25, avg_bits + correction)
        if is_key:
            tgt = min(4.0 * avg_bits, buffer_sz * 0.5)
        want = want_q(ftype, tgt)
        if want is None:
            want = max(8, q - kf_q_offset) if is_key else q
        step = int(np.clip(want - q, -max_step, max_step))
        q_frame = int(np.clip(q + step, min_q, max_q))
        if not is_key:
            q = q_frame
        cfg_i = EncoderConfig(base_q_idx=q_frame, cdef_fixed=True)
        if is_key:
            enc = GpuFrameEncoder(frame, cfg_i, device=device)
            pkt = enc.encode(include_seq=(i == 0))
            seq = enc.seq
        else:
            enc = GpuInterFrameEncoder(frame, cfg_i, seq, ref_planes,
                                       frames[0].width, frames[0].height,
                                       prev_fc=prev_fc, device=device)
            pkt = enc.encode()
        bits = len(pkt) * 8
        # leaky bucket: fill at the channel rate, drain by coded bits
        level = float(np.clip(level + avg_bits - bits, 0.0, buffer_sz))
        pt = (float(np.log(tables.ac_quant(q_frame))),
              float(np.log(max(bits, 1))))
        obs[ftype] = (obs.get(ftype, []) + [pt])[-2:]
        packets.append(pkt)
        encs.append(enc)
        qs.append(q_frame)
        trace.append(level)
        ref_planes = _ref_chain_planes(enc)
        prev_fc = enc.saved_fc
    if path is not None:
        write_ivf(path, packets, frames[0].width, frames[0].height)
    return packets, encs, qs, trace


def encode_video_rc(frames, target_bps: float, fps: float = 30.0,
                    key_interval: int = 0, start_q: int = 120,
                    min_q: int = 8, max_q: int = 250,
                    max_step: int = 32, path: str | None = None,
                    device="cuda"):
    """One-pass target-bitrate GOP encode (``encode_video_tpu_rc``).

    A local power-law rate model ``bits ~ c * qstep**-beta`` (the family
    behind av1_rc_bits_per_mb, av1/encoder/ratectrl.c:1741) is fitted
    online per frame type from coded sizes: the elasticity ``beta`` comes
    from a secant through the last two (log qstep, log bits) observations.
    The next frame's qindex is the one whose AC step meets its share of the
    remaining budget; per-frame q moves are clamped to ``max_step``. CDF
    forwarding stays on. Returns (packets, encs, qs).
    """
    from ..bitstream.containers import write_ivf
    n = len(frames)
    budget = target_bps * n / fps
    spent = 0.0
    obs = {}              # frame-type -> last two (log qstep, log bits)
    packets, encs, qs = [], [], []

    def _want_q(ftype, tgt, cur_q):
        pts = obs.get(ftype)
        if not pts:
            return None
        lq1, lb1 = pts[-1]
        beta = 1.2
        if len(pts) == 2 and abs(pts[0][0] - lq1) > 1e-3:
            beta = (pts[0][1] - lb1) / (lq1 - pts[0][0])
            beta = float(np.clip(beta, 0.4, 3.0))
        lqw = lq1 + (lb1 - np.log(tgt)) / beta
        return _qindex_for_qstep(float(np.exp(lqw)))
    ref_planes = None
    seq = None
    prev_fc = None
    q = int(np.clip(start_q, min_q, max_q))
    # KEY frames are budgeted at kf_boost x the per-frame average
    # (gop-level allocation, av1/encoder/pass2_strategy.c's kf share)
    kf_boost = 4.0
    for i, frame in enumerate(frames):
        is_key = i == 0 or (key_interval > 0 and i % key_interval == 0)
        ftype = "key" if is_key else "inter"
        weight = kf_boost if is_key else 1.0
        frames_left_w = sum(
            (kf_boost if (j == 0 or (key_interval > 0
                                     and j % key_interval == 0)) else 1.0)
            for j in range(i, n))
        tgt = max(64.0, (budget - spent) * weight / frames_left_w)
        # no same-type observation yet -> hold q
        want = _want_q(ftype, tgt, q)
        if want is None:
            want = q
        step = int(np.clip(want - q, -max_step, max_step))
        q = int(np.clip(q + step, min_q, max_q))
        cfg_i = EncoderConfig(base_q_idx=q, cdef_fixed=True)
        if is_key:
            enc = GpuFrameEncoder(frame, cfg_i, device=device)
            pkt = enc.encode(include_seq=(i == 0))
            seq = enc.seq
        else:
            enc = GpuInterFrameEncoder(frame, cfg_i, seq, ref_planes,
                                       frames[0].width, frames[0].height,
                                       prev_fc=prev_fc, device=device)
            pkt = enc.encode()
        bits = len(pkt) * 8
        spent += bits
        pt = (float(np.log(tables.ac_quant(q))), float(np.log(max(bits, 1))))
        obs[ftype] = (obs.get(ftype, []) + [pt])[-2:]
        packets.append(pkt)
        encs.append(enc)
        qs.append(q)
        ref_planes = _ref_chain_planes(enc)
        prev_fc = enc.saved_fc
    if path is not None:
        write_ivf(path, packets, frames[0].width, frames[0].height)
    return packets, encs, qs
