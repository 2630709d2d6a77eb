"""Inter frames and the GOP encodes on the port — torch counterpart of
``aom_av1_psy_tpu/encoder/tpu_interframe.py`` (``TpuInterFrameEncoder``,
and ``encode_video_tpu`` / ``_arf`` / ``_cbr`` / ``_rc`` as
``encode_video`` / ``encode_video_arf`` / ``encode_video_cbr`` /
``encode_video_rc``).

Per P-frame: the batched inter plan on the device
(``tpu_inter.plan_inter_frame``: kernels KE, KD, KB), the device
loop-filter ladder around the inter first guess (``ops/deblock_torch``,
kernel KC), the device CDEF on the reference chain (``tpu_frame.
apply_cdef_refs``, kernel KF), then the symbol-script pack: one native
walk builds the frame's script ops (``native/ec.cpp``
``ec_inter_script_walk``: the MV reference stacks, the contexts and the
symbols, with no Python object a block) and the native range coder plays
them. ``script_ops_plain`` is that walk in Python, kept for the tests. The
reference chain (``ref_planes_out``) stays on the device, post-LPF and
post-CDEF like the decoder's.

With ``tune_vmaf`` the source luma is first unsharpened on the device
(``tune_vmaf.preprocess_frame``: kernels KG and KH), as the reference's
encoder does; in the GOP the KEY frame is temporally filtered first, then
unsharpened.

The host code is carried over from the reference module: the MV-class
helpers and constants (``tpu_interframe.py:
38-68``), ``make_headers``, ``_mi_skip_map``, ``_pack_script``'s walk (as
``script_ops_plain``) and ``_mv_ops`` (``:165-671``, over
``normative/mvref.find_mv_refs`` and ``decoder/inter``),
``_ref_chain_planes``, the GOP loops and the rate control arithmetic
(``:673-1044``). The temporal filters of the KEY frame
and of each ARF run on the device (``encoder/temporal_filter``: kernels KJ
and KK). ``_warm_transfer`` is a TPU-platform workaround and is
dropped. The host layers under it (headers, the range coder, the
decoder's inter prediction, ``normative/mvref``) are the port's own copies.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..bitstream.bitio import BitWriter, write_leb128
from ..bitstream.headers import FrameHeader, TileInfo, write_frame_header
from ..decoder import inter as IT
from ..ec.context import FrameContext
from ..ec.native_coder import (NativeEncoder, available, make_bundle,
                               native_inter_script_walk, native_run_script)
from .frame import EncoderConfig
from ..normative import mvref as MR
from ..normative import tables
from ..normative.blocks import (EXT_TX_IND, EXT_TX_SET_INDEX_INTER,
                                NUM_EXT_TX_SET, PARTITION_CTX_ABOVE,
                                PARTITION_CTX_LEFT)
from ..normative.enums import BlockSize, TxSize
from ..normative.txsize import (TXSIZE_LOG2_MINUS4, TXSIZE_SQR,
                                txsize_entropy_ctx)
from ..utils import trace
from ..utils.frame import Frame
from .. import convert
from ..device import resolve_device
from . import temporal_filter as TF
from . import tpu_inter, tune_vmaf
from .tpu_frame import (GpuFrameEncoder, _pad_plane, apply_cdef_refs,
                        cdef_fixed_strengths, lpf_search)

MV_CLASSES = 11
CLASS0_BITS = 1
CLASS0_SIZE = 1 << CLASS0_BITS

# an inter frame's record (``timings``): its spans' seconds (the plan, the
# pack, the script and the script's three stages), host-device copies that
# block the host, the Python collections inside it (count, seconds), and
# the script walk's engagement: 1 where the native walk built the ops, and
# the blocks it walked
PACK_STAGES = ("script_s", "script_prep_s", "script_walk_s", "script_code_s")
INTER_TIMINGS = ("plan_s", "pack_s") + PACK_STAGES + (
    "syncs", "gc_n", "gc_s", "script_native", "script_blocks")

_B64, _B32, _B16 = (int(BlockSize.BLOCK_64X64), int(BlockSize.BLOCK_32X32),
                    int(BlockSize.BLOCK_16X16))


def _mv_class(z: int) -> int:
    n = z >> 3
    c = n.bit_length() - 1 if n > 0 else 0
    return min(c, MV_CLASSES - 1)


def _cul_levels(levels, eobs, n):
    """Vectorized cul_level per block: min(sum|l|,7) + dc-sign bits
    (set_dc_sign), 0 where eob==0; int32."""
    flat = levels.reshape(-1, n)
    s = np.minimum(np.abs(flat).sum(-1), 7)
    dc = flat[:, 0]
    s = s + np.where(dc > 0, 2 << 3, np.where(dc < 0, 1 << 3, 0))
    s = np.where(eobs.reshape(-1) > 0, s, 0)
    return s.reshape(eobs.shape).astype(np.int32)


def _block_skips(plan, nplanes: int) -> tuple:
    """Each 32x32 and each 16x16 block's skip flag (no coefficient in any
    plane) from the plan's eobs."""
    skip32 = plan["y_eob32"] == 0
    skip16 = plan["y_eob16"] == 0
    if nplanes > 1:
        skip32 &= (plan["uv_eob16"] == 0).all(0)
        skip16 &= (plan["uv_eob8"] == 0).all(0)
    return skip32, skip16


def _dc_sign_ctx(vals):
    """dc_sign_ctx_from: vals = concatenated above+left ent bytes."""
    signs = {0: 0, 1: -1, 2: 1}
    s = sum(signs[v >> 3] for v in vals)
    return 0 if s == 0 else (1 if s < 0 else 2)


class GpuInterFrameEncoder:
    """One INTER frame against a single LAST reference through the device
    plan + symbol-script pack. API mirror of ``TpuInterFrameEncoder``:
    ``ref_planes_dev`` are the reference's int32 planes on ``device``;
    after ``encode()`` it holds ``plan``, ``seq``, ``fh``, ``saved_fc``,
    ``ref_planes_out`` (post-LPF, post-CDEF planes on ``device``),
    ``timings`` (``INTER_TIMINGS``) and ``pack_stages`` (``PACK_STAGES``:
    the script's span and its stages, also in ``timings``). The ARF slot
    plumbing (``ref_slot``, ``refresh_flags``, ``show``, ``primary_ref``)
    serves ``encode_video_arf``."""

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
            with trace.span("vmaf") as sp:
                self.vmaf_unsharp_amount, frame = tune_vmaf.preprocess_frame(
                    frame, self.device)
            self.vmaf_s = sp.s
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
        with trace.frame() as rec:
            pkt = self._encode()
        self.timings = rec.pick(INTER_TIMINGS)
        self.pack_stages = {k: self.timings[k] for k in PACK_STAGES}
        return pkt

    def _encode(self) -> bytes:
        seq, fh = self.make_headers()
        self.seq, self.fh = seq, fh
        if self.prev_fc is not None:
            fc = self.prev_fc.copy()
        else:
            fc = FrameContext(self.cfg.base_q_idx)
        self.fc = fc
        with trace.span("plan", into="plan_s"):
            plan = tpu_inter.plan_inter_frame(
                self.srcp, self.ref_planes_dev, self.cfg.base_q_idx,
                self.rdmult, self.mi_rows, self.mi_cols, self.crop_w,
                self.crop_h, device=self.device)
        # pack_s, split under a profiler: the LPF pick (KC), apply_cdef_refs
        # (KF and its one wait for the gate's sums), the symbol script and
        # the native coder (``script_s``, itself split into PACK_STAGES)
        with trace.span("pack", into="pack_s"):
            self.plan = plan
            fh.interp_filter = int(plan.get("interp_filter", 0))
            with trace.span("lpf"):
                if not self.zero_lpf:
                    self._lpf_device(fh)
                else:
                    self.ref_planes_out = list(plan["recon_dev"])
            with trace.span("cdef"):
                if getattr(self.seq, "enable_cdef", False) and \
                        not self.zero_lpf:
                    self.ref_planes_out = apply_cdef_refs(
                        self.ref_planes_out, self._mi_skip_map(), fh,
                        self.mi_rows, self.mi_cols, self.nplanes,
                        srcs=self.device_sources())
            with trace.span("script", into="script_s"):
                tile_data = self._pack_script(plan, fc, fh)
            self.saved_fc = fc
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
        skip32, skip16 = _block_skips(p, self.nplanes)
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
        split16 = convert.to_device(np.repeat(np.repeat(sp, 2, 0), 2, 1), dev)
        self.ref_planes_out = list(lpf_search(
            fh, self.plan["recon_dev"][: self.nplanes], self.device_sources(),
            split16, w=self.mi_cols * 4, h=self.mi_rows * 4,
            nplanes=self.nplanes, device=dev))

    # ------------------------------------------------------------------
    def _pack_script(self, plan, fc, fh) -> bytes:
        # three stages, consecutive spans: the vectorised preparation (the
        # slice check, skip flags, culs, the level store, the CDF registry
        # and the bundles), the native walk that builds the script ops, the
        # native coder with the end-of-frame context save
        with trace.stages() as stage:
            stage("script.prep", into="script_prep_s")
            check_walk_slice(fh)
            inputs = script_inputs(plan, self.nplanes)
            cdfs, bundles = script_tables(fc)
            stage("script.walk", into="script_walk_s")
            ops, blocks = script_ops(inputs, self.mi_rows, self.mi_cols,
                                     self.nplanes)
            trace.add("script_native", 1)
            trace.add("script_blocks", blocks)
            stage("script.code", into="script_code_s")
            data = code_script(ops, cdfs, bundles, inputs["levels"], fc,
                               not fh.disable_cdf_update)
            # the script's buffers are freed inside the stage, not after it
            del inputs, cdfs, bundles, ops
        return data


# ----------------------------------------------------------------------
# The P-frame symbol script: the decoder's parse order of a frame of the
# device inter plan as ops (``native/ec.cpp`` ``ec_enc_run_script``),
# built by one native walk (``ec_inter_script_walk``); ``script_ops_plain``
# is the same walk in Python, over ``normative/mvref.find_mv_refs``.
# ----------------------------------------------------------------------
# the script's CDF registry (``script_tables``) and coefficient bundles
(CDF_PART, CDF_SKIP, CDF_II, CDF_SREF, CDF_NEWMV, CDF_ZEROMV, CDF_REFMV,
 CDF_DRL, CDF_JOINT, CDF_COMP0) = range(10)
BND_Y32, BND_Y16, BND_UV16, BND_UV8 = range(4)
# the level store's regions [y32 | y16 | u16 | v16 | u8 | v8], each in
# units of its bundle's levels a block
REGION_N = (1024, 256, 256, 256, 64, 64)


def check_walk_slice(fh) -> None:
    """Raise ``NotImplementedError`` where the frame header leaves the
    slice of AV1 that the symbol walk codes, the state ``make_headers``
    fixes: one tile, a single reference (no compound prediction, no skip
    mode), identity global motion, no reference-frame MVs, quarter-pel MVs
    (neither high precision nor integer MVs), a frame-wide interpolation
    filter and simple motion."""
    t = fh.tiles
    outside = [name for name, off in (
        ("tiles", not t.uniform_spacing or t.tile_cols_log2
         or t.tile_rows_log2),
        ("reference_select", fh.reference_select),
        ("skip_mode_present", fh.skip_mode_present),
        ("global_motion", any(g.wmtype != MR.IDENTITY
                              for g in fh.global_motion or ())),
        ("allow_ref_frame_mvs", fh.allow_ref_frame_mvs),
        ("allow_high_precision_mv", fh.allow_high_precision_mv),
        ("force_integer_mv", fh.force_integer_mv),
        ("is_filter_switchable", fh.is_filter_switchable),
        ("is_motion_mode_switchable", fh.is_motion_mode_switchable)) if off]
    if outside:
        raise NotImplementedError(
            "the inter symbol walk codes no frame with " + ", ".join(outside))


def script_inputs(plan, nplanes: int) -> dict:
    """The walk's inputs from an inter plan, vectorised: the split flags,
    the 16-level MVs, each block's skip flag, its eobs and the culs
    (entropy-context bytes) of its transform blocks, and the coder's flat
    level store ``levels`` with each region's element offset ``roff``
    (``REGION_N``; monochrome stores the luma regions only)."""
    ye32, ye16 = plan["y_eob32"], plan["y_eob16"]
    skip32, skip16 = _block_skips(plan, nplanes)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    inp = {"split32": np.ascontiguousarray(plan["split32"], np.uint8),
           "mv8": i32(plan["mv8"]),
           "skip32": skip32.astype(np.uint8),
           "skip16": skip16.astype(np.uint8),
           "y_eob32": i32(ye32), "y_eob16": i32(ye16),
           "cul_y32": _cul_levels(plan["y_levels32"], ye32, 1024),
           "cul_y16": _cul_levels(plan["y_levels16"], ye16, 256)}
    stores = [plan["y_levels32"], plan["y_levels16"]]
    if nplanes > 1:
        ue16, ue8 = plan["uv_eob16"], plan["uv_eob8"]
        inp.update(uv_eob16=i32(ue16), uv_eob8=i32(ue8))
        for pl, c in enumerate("uv"):
            inp[f"cul_{c}16"] = _cul_levels(plan["uv_levels16"][pl],
                                            ue16[pl], 256)
            inp[f"cul_{c}8"] = _cul_levels(plan["uv_levels8"][pl], ue8[pl], 64)
        stores += [plan["uv_levels16"][0], plan["uv_levels16"][1],
                   plan["uv_levels8"][0], plan["uv_levels8"][1]]
    sizes = [x.size for x in stores]
    roff = np.cumsum([0] + sizes)
    # a txb's level index is its element offset over its region's n
    if any(int(o) % n for o, n in zip(roff, REGION_N)):
        raise ValueError(f"level-store regions {sizes} misalign their blocks")
    inp["roff"] = np.resize(roff[:-1], len(REGION_N)).astype(np.int64)
    inp["levels"] = np.concatenate(
        [np.asarray(x, np.int32).reshape(-1) for x in stores])
    return inp


def script_tables(fc) -> tuple:
    """The script's CDF registry (``CDF_*`` ids, each a C-contiguous uint16
    table of ``fc`` adapted in place by the coder) and its coefficient
    bundles (``BND_*``: the inter ext-tx sets of TX_32X32 and TX_16X16
    luma, chroma TX_16X16 and TX_8X8)."""
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
    for t in cdfs:
        assert t.flags["C_CONTIGUOUS"] and t.dtype == np.uint16

    tx32, tx16, tx8 = (int(TxSize.TX_32X32), int(TxSize.TX_16X16),
                       int(TxSize.TX_8X8))
    e32c, e16c, e8c = (txsize_entropy_ctx(t) for t in (tx32, tx16, tx8))

    def inter_ext(tx, sqr_is16):
        set_type = 1 if tx == tx32 else (4 if sqr_is16 else 5)
        nsyms = int(NUM_EXT_TX_SET[set_type])
        eset = EXT_TX_SET_INDEX_INTER[set_type]
        row = np.ascontiguousarray(
            fc.inter_ext_tx_cdf[eset][int(TXSIZE_SQR[tx])])
        fc.inter_ext_tx_cdf[eset][int(TXSIZE_SQR[tx])] = row
        return row, nsyms, int(EXT_TX_IND[set_type][0])

    def scan(tx):
        return np.ascontiguousarray(tables.scan_table(tx, 0), np.int32)

    def nz(tx):
        return np.ascontiguousarray(
            tables.get(f"nz_map_ctx_offset_ts{tx}"), np.int32)

    def bundle(tx, e, eob, plane, width, ext=()):
        return make_bundle(
            fc.txb_skip_cdf[e], eob[plane][0], fc.eob_extra_cdf[e][plane],
            fc.coeff_base_eob_cdf[e][plane], fc.coeff_base_cdf[e][plane],
            fc.coeff_br_cdf[min(e, 3)][plane], fc.dc_sign_cdf[plane],
            scan(tx), nz(tx), 5 + int(TXSIZE_LOG2_MINUS4[tx]), width, *ext)

    bundles = [
        bundle(tx32, e32c, fc.eob_flag_cdf1024, 0, 32,
               inter_ext(tx32, False) + (0,)),
        bundle(tx16, e16c, fc.eob_flag_cdf256, 0, 16,
               inter_ext(tx16, True) + (0,)),
        bundle(tx16, e16c, fc.eob_flag_cdf256, 1, 16),
        bundle(tx8, e8c, fc.eob_flag_cdf64, 1, 8)]
    return cdfs, bundles


def script_ops(inputs: dict, mi_rows: int, mi_cols: int,
               nplanes: int) -> tuple:
    """The frame's script ops, (N, 5) int32, and the number of blocks
    walked: one native call (``native_inter_script_walk``)."""
    return native_inter_script_walk(
        inputs, mi_rows, mi_cols, nplanes,
        [int(PARTITION_CTX_ABOVE[_B32]), int(PARTITION_CTX_LEFT[_B32]),
         int(PARTITION_CTX_ABOVE[_B16]), int(PARTITION_CTX_LEFT[_B16])])


def code_script(ops, cdfs, bundles, levels, fc, allow_update: bool) -> bytes:
    """Play ``ops`` into a new native range coder (``native_run_script``),
    then reset ``fc``'s adaptation counters as the decoder does before it
    stores the end-of-frame context (``decoder/obu.py``:
    ``_update_ref_slots``); the script adapted ``fc``'s tables in place.
    Returns the tile's bytes."""
    enc = NativeEncoder()
    enc.allow_update = allow_update
    native_run_script(enc, ops, cdfs, bundles, levels,
                      tables.get("eob_group_start"),
                      tables.get("eob_offset_bits"))
    fc.reset_counters()
    return enc.done()


def script_ops_plain(inputs: dict, mi_rows: int, mi_cols: int,
                     nplanes: int) -> tuple:
    """``script_ops`` in Python: the walk over a grid of ``MbInfo``
    records and ``normative/mvref.find_mv_refs``; the plain version the
    tests hold the native walk to. Returns the same (ops, blocks)."""
    split, mv8 = inputs["split32"].astype(bool), inputs["mv8"]
    skip32, skip16 = inputs["skip32"], inputs["skip16"]
    ye32, ye16 = inputs["y_eob32"], inputs["y_eob16"]
    ue16, ue8 = inputs.get("uv_eob16"), inputs.get("uv_eob8")
    culs = {k: inputs[k] for k in inputs if k.startswith("cul_")}
    roff = inputs["roff"]
    Cc = split.shape[1]
    C2 = 2 * Cc
    # the cm duck-type ``find_mv_refs`` reads: the slice ``check_walk_slice``
    # admits, one tile over the frame
    mi = np.full((mi_rows, mi_cols), None, object)
    cm = types.SimpleNamespace(
        mi_rows=mi_rows, mi_cols=mi_cols, mi=mi, sb_mi=16,
        allow_high_precision_mv=False, force_integer_mv=False,
        global_motion=[MR.WarpModel() for _ in range(8)],
        ref_frame_sign_bias=[0] * 8, allow_ref_frame_mvs=False)
    ncols = (mi_cols + 15) // 16 * 16
    above_part = np.zeros(ncols, np.int32)
    left_part = np.zeros(16, np.int32)
    aent = [np.zeros(ncols, np.uint8) for _ in range(3)]
    lent = [np.zeros(16, np.uint8) for _ in range(3)]
    ops = []
    op = ops.append
    blocks = [0]
    pa32, pl32 = int(PARTITION_CTX_ABOVE[_B32]), int(PARTITION_CTX_LEFT[_B32])
    pa16, pl16 = int(PARTITION_CTX_ABOVE[_B16]), int(PARTITION_CTX_LEFT[_B16])

    def txb_op(bnd, region, block, eob, skip_ctx, dctx):
        n = REGION_N[region]
        op((2, bnd | (skip_ctx << 8) | (dctx << 16),
            (int(roff[region]) + block * n) // n, int(eob), 0))

    def ent_update(plane, acol, lrow, wu, cul, vis_w, vis_h):
        a, l = aent[plane], lent[plane]
        a[acol : acol + vis_w] = cul
        a[acol + vis_w : acol + wu] = 0
        l[lrow : lrow + vis_h] = cul
        l[lrow + vis_h : lrow + wu] = 0

    def block_ops(mi_row, mi_col, bs):
        blocks[0] += 1
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
            MR.find_mv_refs(cm, xd, mbmi, MR.LAST_FRAME)
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
        counts = IT.collect_neighbors_ref_counts(cm, above, left_mb)
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
            _mv_ops(op, mv, newmv_ref)

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
            if nplanes > 1:
                ent_update(1, cacol, clrow, cwu, 0, cwu, cwu)
                ent_update(2, cacol, clrow, cwu, 0, cwu, cwu)
            return
        dctx = _dc_sign_ctx(list(aent[0][acol : acol + wu])
                            + list(lent[0][lrow : lrow + wu]))
        if bs == 32:
            blk = r32 * Cc + c32
            txb_op(BND_Y32, 0, blk, ye32[r32, c32], 0, dctx)
            cul = int(culs["cul_y32"][r32, c32])
        else:
            blk = r16 * C2 + c16
            txb_op(BND_Y16, 1, blk, ye16[r16, c16], 0, dctx)
            cul = int(culs["cul_y16"][r16, c16])
        ent_update(0, acol, lrow, wu, cul, vis_w, vis_h)
        if nplanes > 1:
            for pl, c in ((1, "u"), (2, "v")):
                a = aent[pl][cacol : cacol + cwu]
                l = lent[pl][clrow : clrow + cwu]
                sctx = (int(a.any()) + int(l.any())) + 7
                dctx = _dc_sign_ctx(list(a) + list(l))
                if bs == 32:
                    e = int((ue16[pl - 1])[r32, c32])
                    txb_op(BND_UV16, 1 + pl, blk, e, sctx, dctx)
                    cul = int(culs[f"cul_{c}16"][r32, c32])
                else:
                    e = int((ue8[pl - 1])[r16, c16])
                    txb_op(BND_UV8, 3 + pl, blk, e, sctx, dctx)
                    cul = int(culs[f"cul_{c}8"][r16, c16])
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
            op((3, CDF_PART, ctx, int(partition == 3), int(not has_cols)))
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
    return np.asarray(ops, np.int32).reshape(-1, 5), blocks[0]


def _mv_ops(op, mv, ref_mv):
    """encode_mv (av1/encoder/encodemv.c) as script ops."""
    dr = mv[0] - ref_mv[0]
    dc = mv[1] - ref_mv[1]
    joint = 2 * int(dr != 0) + int(dc != 0)
    op((0, CDF_JOINT, 0, joint, 4))
    for comp, diff in ((0, dr), (1, dc)):
        if diff == 0:
            continue
        base_id = CDF_COMP0 + comp * 8
        (SIGN, CLASSES, CLASS0, BITS, C0FP, FP, C0HP, HP) = range(8)
        sign = int(diff < 0)
        mag = -diff if sign else diff
        z = mag - 1
        mv_class = _mv_class(z)
        cbase = 0 if mv_class == 0 else (CLASS0_SIZE << (mv_class + 2))
        offset = z - cbase
        d = offset >> 3
        fr = (offset >> 1) & 3
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


class _Chain:
    """A GOP's frames on one reference chain, with their packets and
    encoders: the KEY's ``seq``, the last frame's ``_ref_chain_planes``
    and its ``saved_fc`` (``prev_fc``; None without ``forward_cdf``)."""

    def __init__(self, frames, forward_cdf: bool, device):
        self.w0, self.h0 = frames[0].width, frames[0].height
        self.forward_cdf = forward_cdf
        self.device = device
        self.seq = self.ref_planes = self.prev_fc = None
        self.packets, self.encs = [], []

    def step(self, frame, cfg: EncoderConfig, key: bool,
             include_seq: bool = False):
        """Encode ``frame`` at ``cfg`` as a KEY or an inter frame on the
        chain; returns its encoder (its packet is ``packets[-1]``)."""
        if key:
            enc = GpuFrameEncoder(frame, cfg, device=self.device)
            self.packets.append(enc.encode(include_seq=include_seq))
            self.seq = enc.seq
        else:
            enc = GpuInterFrameEncoder(frame, cfg, self.seq, self.ref_planes,
                                       self.w0, self.h0,
                                       prev_fc=self.prev_fc,
                                       device=self.device)
            self.packets.append(enc.encode())
        self.encs.append(enc)
        self.ref_planes = _ref_chain_planes(enc)
        self.prev_fc = enc.saved_fc if self.forward_cdf else None
        return enc

    def key(self, frames, i: int, cfg: EncoderConfig, filtered: bool):
        """``step`` of KEY frame ``frames[i]``, temporally filtered where
        ``filtered`` (temporal_filter.c:833-841), its seconds as ``tf_s``."""
        frame, tf_s = frames[i], None
        if filtered:
            with trace.span("tf") as tf_sp:
                frame = TF.filter_key_frame(frames, i, cfg.base_q_idx,
                                            device=self.device)
            tf_s = tf_sp.s
        enc = self.step(frame, cfg, key=True, include_seq=i == 0)
        enc.tf_s = tf_s
        return enc

    def write(self, path: str | None) -> None:
        """The chain's packets as an IVF file at ``path`` (None: none)."""
        if path is not None:
            from ..bitstream.containers import write_ivf
            write_ivf(path, self.packets, self.w0, self.h0)


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
    chain = _Chain(frames, forward_cdf, device)
    if cdef and not cfg.search_cdef:
        cfg = dataclasses.replace(cfg, cdef_fixed=True)
    kf_cfg = dataclasses.replace(
        cfg, base_q_idx=max(8, cfg.base_q_idx - kf_q_offset)) \
        if kf_q_offset else cfg
    for i, frame in enumerate(frames):
        if i == 0 or (key_interval > 0 and i % key_interval == 0):
            chain.key(frames, i, kf_cfg, tf_key and len(frames) > 1)
        else:
            chain.step(frame, cfg, key=False)
    chain.write(path)
    return chain.packets, chain.encs


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
    T = len(frames)
    if not cfg.search_cdef:
        cfg = dataclasses.replace(cfg, cdef_fixed=True)
    kf_cfg = dataclasses.replace(
        cfg, base_q_idx=max(8, cfg.base_q_idx - kf_q_offset))
    arf_cfg = dataclasses.replace(
        cfg, base_q_idx=max(8, cfg.base_q_idx - arf_q_offset))
    chain = _Chain(frames, forward_cdf, device)
    packets, encs = chain.packets, chain.encs

    key = chain.key(frames, 0, kf_cfg, T > 1)
    seq = chain.seq
    cur_slot = 0                       # slot holding the last DISPLAYED recon
    slot_planes = {0: chain.ref_planes, 1: chain.ref_planes}
    slot_fc = {0: key.saved_fc, 1: key.saved_fc}

    w0, h0 = chain.w0, chain.h0
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
            with trace.span("tf") as tf_sp:
                planes_list = TF.upload([f.planes() for f in span], device)
                noise = [max(TF.estimate_noise_level(pl), 0.0)
                         for pl in planes_list[c_rel]]
                # q_factor at the GROUP's quality level (av1_get_q
                # analogue): the boosted ARF q would put q_decay near zero
                # and disable the filter entirely
                qf = max(1, tables.ac_quant(max(cfg.base_q_idx, 1)) // 4)
                y, u, v = TF.temporal_filter_frames(
                    planes_list, c_rel, qf, tf_strength,
                    noise_levels=tuple(noise), device=device)
                arf_src = Frame(y, u, v)
            tf_s = tf_sp.s
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
    chain.write(path)
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


class _RateModel:
    """The online rate model of the CBR and RC drivers: a local power law
    ``bits ~ c * qstep**-beta`` (the family behind av1_rc_bits_per_mb,
    av1/encoder/ratectrl.c:1741) fitted per frame type from coded sizes,
    over the last two (log qstep, log bits) observations."""

    def __init__(self):
        self.obs = {}         # frame type -> last two (log qstep, log bits)

    def want_q(self, ftype: str, tgt: float) -> int | None:
        """The qindex whose AC step meets ``tgt`` bits on the model of
        ``ftype``; None before its first observation. The elasticity
        ``beta`` is the secant through the two observations, clipped to
        [0.4, 3.0] (1.2 with one, or two at one qstep)."""
        pts = self.obs.get(ftype)
        if not pts:
            return None
        lq1, lb1 = pts[-1]
        beta = 1.2
        if len(pts) == 2 and abs(pts[0][0] - lq1) > 1e-3:
            beta = float(np.clip((pts[0][1] - lb1) / (lq1 - pts[0][0]),
                                 0.4, 3.0))
        lqw = lq1 + (lb1 - np.log(max(tgt, 1.0))) / beta
        return _qindex_for_qstep(float(np.exp(lqw)))

    def observe(self, ftype: str, q: int, bits: int) -> None:
        """Add a frame of ``ftype`` coded at qindex ``q`` in ``bits``."""
        pt = (float(np.log(tables.ac_quant(q))), float(np.log(max(bits, 1))))
        self.obs[ftype] = (self.obs.get(ftype, []) + [pt])[-2:]


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
    avg_bits = target_bps / fps
    buffer_sz = target_bps * buffer_ms / 1000.0
    optimal = buffer_sz * optimal_pct / 100.0
    level = target_bps * initial_ms / 1000.0
    model = _RateModel()
    chain = _Chain(frames, True, device)
    qs, buffer_trace = [], []
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
        want = model.want_q(ftype, tgt)
        if want is None:
            want = max(8, q - kf_q_offset) if is_key else q
        step = int(np.clip(want - q, -max_step, max_step))
        q_frame = int(np.clip(q + step, min_q, max_q))
        if not is_key:
            q = q_frame
        chain.step(frame, EncoderConfig(base_q_idx=q_frame, cdef_fixed=True),
                   key=is_key, include_seq=i == 0)
        bits = len(chain.packets[-1]) * 8
        # leaky bucket: fill at the channel rate, drain by coded bits
        level = float(np.clip(level + avg_bits - bits, 0.0, buffer_sz))
        model.observe(ftype, q_frame, bits)
        qs.append(q_frame)
        buffer_trace.append(level)
    chain.write(path)
    return chain.packets, chain.encs, qs, buffer_trace


def encode_video_rc(frames, target_bps: float, fps: float = 30.0,
                    key_interval: int = 0, start_q: int = 120,
                    min_q: int = 8, max_q: int = 250,
                    max_step: int = 32, path: str | None = None,
                    device="cuda"):
    """One-pass target-bitrate GOP encode (``encode_video_tpu_rc``).

    A local power-law rate model (``_RateModel``) is fitted online per
    frame type from coded sizes. The next frame's qindex is the one whose
    AC step meets its share of the remaining budget; per-frame q moves are
    clamped to ``max_step``. CDF forwarding stays on. Returns (packets,
    encs, qs).
    """
    n = len(frames)
    budget = target_bps * n / fps
    spent = 0.0
    model = _RateModel()
    chain = _Chain(frames, True, device)
    qs = []
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
        want = model.want_q(ftype, tgt)
        if want is None:
            want = q
        step = int(np.clip(want - q, -max_step, max_step))
        q = int(np.clip(q + step, min_q, max_q))
        chain.step(frame, EncoderConfig(base_q_idx=q, cdef_fixed=True),
                   key=is_key, include_seq=i == 0)
        bits = len(chain.packets[-1]) * 8
        spent += bits
        model.observe(ftype, q, bits)
        qs.append(q)
    chain.write(path)
    return chain.packets, chain.encs, qs
