"""The all-intra KEY-frame encoder on the port — torch counterpart of
``aom_av1_psy_tpu/encoder/tpu_frame.py`` (``TpuFrameEncoder``).

Pipeline: the two-level 32 -> 16 partition plan on the device
(``tpu_intra.plan_frame_part``; with tile columns, the T equal SB-aligned
slabs batched through one wavefront, ``parallel/mesh.tile_plans_batched``,
or with ``GpuFrameEncoder.mesh`` set, tile t planned on card t,
``parallel/mesh.tile_plans_sharded``),
ONE native pack call over the plan (per tile: ``native/ec.cpp
ec_enc_pack_kf_part2`` through ``ec.native_coder``), the device
loop-filter ladder (``ops/deblock_torch.lpf_pick_and_filter``) and, with
``cdef_fixed``, the quantizer-derived CDEF applied on the device
(``apply_cdef_refs``, kernel KF); with ``search_cdef``, the host strength
search on the post-LPF recon. When the mi dims leave a partial leaf at the
edge (mi = 2 mod 8) or ``block_size`` < 16, the uniform-grid fallback
runs instead: ``tpu_intra.plan_frame`` and ONE ``ec_enc_pack_kf_uniform``
call, with no device loop filter (the reference keeps the pre-LPF plan
recon there). The host code (headers, the rdmult grids, the tile
geometry, the packs' array marshalling, the smooth-64 fallback, the CDEF
strengths, gate and search) is carried over from the reference module;
the host layers it stands on (headers, the range coder, the decoder, the
normative tables) are the port's own copies.

With ``tune_vmaf`` the source luma is first unsharpened on the device
(``tune_vmaf.preprocess_frame``: kernels KG and KH), as the reference's
encoder does. Lossless, outside the port, raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bitstream.bitio import BitWriter, write_leb128
from ..decoder.obu import Av1Decoder
from ..bitstream.headers import (FrameHeader, SequenceHeader, TileInfo,
                                 write_frame_header)
from ..ec.context import FrameContext
from ..ec.native_coder import (NativeEncoder, available, native_pack_kf_part2,
                               native_pack_kf_uniform)
from .frame import EncoderConfig
from ..normative import tables
from ..normative.blocks import (EXT_TX_IND, EXT_TX_SET_INDEX_INTRA,
                                INTRA_MODE_CONTEXT, NUM_EXT_TX_SET,
                                PARTITION_CTX_ABOVE, PARTITION_CTX_LEFT)
from ..normative.enums import BlockSize, TxSize
from ..normative.txsize import (TXSIZE_LOG2_MINUS4, TXSIZE_SQR,
                                txsize_entropy_ctx)
from ..utils.frame import Frame
from .. import convert
from ..device import on_device, resolve_device
from ..ops import deblock_torch as DT
from ..utils import trace
from . import tpu_intra, tune_vmaf

_BS_TO_BSIZE = {8: int(BlockSize.BLOCK_8X8), 16: int(BlockSize.BLOCK_16X16),
                32: int(BlockSize.BLOCK_32X32)}
_BS_TO_TX = {8: int(TxSize.TX_8X8), 16: int(TxSize.TX_16X16),
             32: int(TxSize.TX_32X32)}
# ``timings`` of a KEY frame: the spans' seconds (the plan, split into its
# inputs, its wavefronts' submit and its fetch; the pack with the LPF
# pick; the LPF pick alone) and the frame's counts (kernel launches in
# the plan's submit, 1 where the submit replayed a captured CUDA graph of
# the wavefronts, host-device copies that block the host, and the Python
# collections inside the frame with their seconds)
KEY_TIMINGS = ("plan_s", "plan_inputs_s", "plan_submit_s", "plan_fetch_s",
               "plan_launches", "plan_graph", "pack_s", "lpf_s", "syncs",
               "gc_n", "gc_s")


def lpf_search(fh: FrameHeader, recs, srcs, split16, *, w: int, h: int,
               nplanes: int, device) -> tuple:
    """The device loop-filter search of a KEY or an inter frame (kernel
    KC): the ladder around ``fh``'s first guess, a level per plane into
    ``fh.lf``. Returns the filtered planes."""
    g = fh.lf.filter_level[0]
    cands = convert.to_device(np.array(
        [0, g // 2, max(g - 2, 0), g, min(g + 2, 63), min(g * 2, 63)],
        np.int32), device)
    levels, outs = DT.lpf_pick_and_filter(tuple(recs), srcs, split16, cands,
                                          w=w, h=h, nplanes=nplanes)
    lv = [int(x) for x in convert.to_host(levels)]
    fh.lf.filter_level = (lv[0], lv[0])
    fh.lf.filter_level_u = lv[1]
    fh.lf.filter_level_v = lv[2]
    return outs


def _pad_plane(src: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-replicate src up to (h, w), int32."""
    out = np.empty((h, w), np.int32)
    sh, sw = src.shape
    out[:sh, :sw] = src
    if sw < w:
        out[:sh, sw:] = out[:sh, sw - 1:sw]
    if sh < h:
        out[sh:, :] = out[sh - 1:sh, :]
    return out


class GpuFrameEncoder:
    """Encodes one all-intra KEY frame through the device plan + native
    pack + device loop filter. API mirror of ``TpuFrameEncoder``; after
    ``encode()`` it holds ``plan`` (the first tile's with tile columns;
    ``tile_plans`` holds every tile's), ``seq``, ``fh``, ``saved_fc``,
    ``mi_skip``, ``timings`` (``KEY_TIMINGS``) and, on the partition
    path, ``ref_planes_dev`` (post-LPF planes on ``device``); with
    ``tune_vmaf``, ``vmaf_unsharp_amount`` and ``vmaf_s`` (the
    preprocessing's seconds) from construction on. The encoder's kernels
    run with ``device`` current."""

    # optional ``parallel.mesh.Mesh`` of tile_T devices of the encoder's
    # type: the tiled plan runs tile t on mesh.devices[t]; set on the class,
    # it reaches the KEY frames of encode_video and the other GOP encoders
    mesh = None

    def __init__(self, frame: Frame, cfg: EncoderConfig, device="cuda"):
        if not available():
            raise RuntimeError("the encoder requires the native EC library")
        if cfg.lossless or cfg.base_q_idx == 0:
            raise NotImplementedError("lossless uses FrameEncoder (WHT)")
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.tune_vmaf:
            # av1_vmaf_frame_preprocessing analogue: encode the unsharpened
            # source (kernels KG/KH); vmaf_s is its host-clock time
            with on_device(self.device), trace.span("vmaf") as sp:
                self.vmaf_unsharp_amount, frame = tune_vmaf.preprocess_frame(
                    frame, self.device)
            self.vmaf_s = sp.s
        self.src = frame
        self.w, self.h = frame.width, frame.height
        self.mi_cols = (self.w + 7) // 8 * 2
        self.mi_rows = (self.h + 7) // 8 * 2
        self.nplanes = 1 if frame.monochrome else 3
        pw, ph = self.mi_cols * 4, self.mi_rows * 4

        # two-level partition plan (32 -> 16) unless the caller forces a
        # small uniform grid or the mi dims leave a partial square leaf at
        # the edge (tpu_intra.plan_part_supported)
        self.use_part = (
            cfg.block_size >= int(BlockSize.BLOCK_16X16)
            and tpu_intra.plan_part_supported(self.mi_rows, self.mi_cols))
        self.tile_T = 1
        if self.use_part:
            # blocks may overhang the mi area at the frame edge (legal:
            # the decoder clips recon writes); pad source to 32 multiples
            pw32 = (pw + 31) // 32 * 32
            ph32 = (ph + 31) // 32 * 32
            sb_cols = (self.mi_cols + 15) // 16
            T = 1 << cfg.tile_cols_log2
            if T > 1 and sb_cols % T == 0:
                # SB-aligned equal tile columns: pad width to whole SBs so
                # every tile slab has the same (batchable) shape
                self.tile_T = T
                self.tile_sb = sb_cols // T
                self.tile_mi = self.tile_sb * 16
                self.tile_pw = self.tile_sb * 64
                pw32 = self.tile_pw * T
            self.bs = 16                     # rdmult-grid granularity
            self.R, self.C = ph32 // 16, pw32 // 16
        else:
            want = {int(BlockSize.BLOCK_8X8): 8,
                    int(BlockSize.BLOCK_16X16): 16,
                    int(BlockSize.BLOCK_32X32): 32}.get(cfg.block_size, 16)
            bs = want
            while bs > 8 and (pw % bs or ph % bs):
                bs //= 2
            assert pw % bs == 0 and ph % bs == 0
            self.bs = bs
            self.R, self.C = ph // bs, pw // bs
            pw32, ph32 = pw, ph
        planes = frame.planes()
        self.srcp = [_pad_plane(planes[0].astype(np.int32), ph32, pw32)]
        if self.nplanes > 1:
            for p in (1, 2):
                self.srcp.append(_pad_plane(planes[p].astype(np.int32),
                                            ph32 // 2, pw32 // 2))
        self._srcs_dev = None

        from ..ec import costs as EC_costs
        self.rdmult = EC_costs.compute_rd_mult(cfg.base_q_idx)
        if cfg.tune_psy:
            # per-block SSIM/psy rdmult grid (av1_set_ssim_rdmult,
            # encodeframe_utils.c:20; factors encoder_utils.c:1281)
            from . import psy as psy_mod
            f = psy_mod.ssim_rdmult_scaling_factors(planes[0])
            self.rdmult = self._rdmult_grid(self.rdmult, f)
        elif cfg.tune_butteraugli:
            from . import psy as psy_mod
            f = psy_mod.butteraugli_lite_factors(planes[0])
            self.rdmult = self._rdmult_grid(self.rdmult, f)

    def _rdmult_grid(self, rdmult: int, factors: np.ndarray) -> np.ndarray:
        """(R, C) per-block lambda from per-16x16 SSIM factors: the 16
        factors as they are, repeated 2x2 for 8x8 blocks, and their
        geometric mean over each 2x2 for 32x32 blocks."""
        R, C, bs = self.R, self.C, self.bs
        fr, fc_ = factors.shape
        logs = np.log(factors)
        if bs == 16:
            g = logs
        elif bs == 8:
            g = np.repeat(np.repeat(logs, 2, 0), 2, 1)
        else:  # bs == 32: geometric mean over the covered 2x2 cells
            r2, c2 = (fr + 1) // 2 * 2, (fc_ + 1) // 2 * 2
            pad = np.pad(logs, ((0, r2 - fr), (0, c2 - fc_)), mode="edge")
            g = pad.reshape(r2 // 2, 2, c2 // 2, 2).mean((1, 3))
        out = np.full((R, C), np.log(1.0), np.float64)
        rr, cc = min(R, g.shape[0]), min(C, g.shape[1])
        out[:rr, :cc] = g[:rr, :cc]
        if rr < R:
            out[rr:, :] = out[rr - 1:rr, :]
        if cc < C:
            out[:, cc:] = out[:, cc - 1:cc]
        return (rdmult * np.exp(out)).astype(np.float32)

    def _tile_masks(self, t: int) -> int:
        """Effective mi width of tile t for its edge-cell masks (interior
        tiles have no column edge; the last tile sees the frame's right
        edge)."""
        col0 = t * self.tile_mi
        if col0 + self.tile_mi < self.mi_cols:
            return self.tile_pw // 32 * 8 + 8   # beyond any cell: no edge
        return self.mi_cols - col0

    def _tile_slabs(self) -> list:
        """The T equal SB-aligned tile slabs with their lambda grids and
        availability geometry, as the reference's ``_plan_tiles`` cuts
        them."""
        tpw = self.tile_pw
        rd = self.rdmult
        if np.ndim(rd) == 0:
            rd = np.full((self.R, self.C), float(rd), np.float32)
        slabs = []
        for t in range(self.tile_T):
            sl = {
                "y": self.srcp[0][:, t * tpw:(t + 1) * tpw],
                "rd": rd[:, t * (tpw // 16):(t + 1) * (tpw // 16)],
                "mi_cols_eff": self._tile_masks(t),
                # tiles are prediction-independent: top-right never
                # crosses the tile's actual right edge; the last tile also
                # sees the frame's visible edge
                "tile_mi_w": self.tile_mi,
                "vis_mi_w": min(self.tile_mi,
                                self.mi_cols - t * self.tile_mi),
            }
            if self.nplanes > 1:
                sl["u"] = self.srcp[1][:, t * tpw // 2:(t + 1) * tpw // 2]
                sl["v"] = self.srcp[2][:, t * tpw // 2:(t + 1) * tpw // 2]
            slabs.append(sl)
        return slabs

    def _plan_tiles(self) -> list:
        """Per-tile partition plans: with ``mesh``, tile t on
        ``mesh.devices[t]`` (``parallel/mesh.tile_plans_sharded``); else the
        slabs batched through one pair of wavefronts on the device
        (``parallel/mesh.tile_plans_batched``)."""
        with trace.span("plan.inputs", into="plan_inputs_s"):
            from ..parallel.mesh import tile_plans_batched, tile_plans_sharded
            slabs = self._tile_slabs()
        if self.mesh is not None:
            return tile_plans_sharded(self.mesh, slabs, self.cfg.base_q_idx,
                                      self.mi_rows)
        return tile_plans_batched(slabs, self.cfg.base_q_idx, self.mi_rows,
                                  device=self.device)

    def _check_mesh(self) -> None:
        """A mesh reaches only the partition path with tile columns, on
        devices of the encoder's type."""
        if not self.use_part:
            raise ValueError("a mesh is set, but the frame takes the "
                             "uniform grid, which has no tiles")
        if self.tile_T == 1:
            raise ValueError("a mesh is set, but the frame has one tile")
        if self.mesh.type != self.device.type:
            raise ValueError(f"mesh of {self.mesh.type} devices for an "
                             f"encoder on {self.device}")

    # -- headers (mirrors FrameEncoder.make_headers for this feature set) --
    def make_headers(self) -> tuple[SequenceHeader, FrameHeader]:
        use_cdef = bool(self.cfg.search_cdef or self.cfg.cdef_fixed)
        seq = SequenceHeader(
            max_frame_width=self.w, max_frame_height=self.h,
            frame_width_bits=max(self.w - 1, 1).bit_length(),
            frame_height_bits=max(self.h - 1, 1).bit_length(),
            enable_filter_intra=False, enable_intra_edge_filter=True,
            enable_cdef=use_cdef, enable_restoration=False,
            monochrome=self.nplanes == 1)
        fh = FrameHeader(width=self.w, height=self.h,
                         render_width=self.w, render_height=self.h)
        fh.quant.base_q_idx = self.cfg.base_q_idx
        if use_cdef:
            # damping derivation: av1/encoder/pickcdef.c:745
            fh.cdef.damping = 3 + (self.cfg.base_q_idx >> 6)
        fh.tx_mode_select = False  # TX_MODE_LARGEST
        if self.tile_T > 1:
            lg = self.tile_T.bit_length() - 1
            fh.tiles = TileInfo(tile_cols_log2=lg, tile_cols=self.tile_T)
        else:
            fh.tiles = TileInfo()
        # keyframe first-guess filter level (av1/encoder/picklpf.c:247)
        q = tables.ac_quant(self.cfg.base_q_idx)
        guess = (q * 17563 - 421574 + (1 << 17)) >> 18
        lvl = int(np.clip(guess, 0, 63))
        fh.lf.filter_level = (lvl, lvl)
        fh.lf.filter_level_u = lvl
        fh.lf.filter_level_v = lvl
        return seq, fh

    # ------------------------------------------------------------------
    def encode(self, include_seq: bool = True) -> bytes:
        if self.mesh is not None:
            self._check_mesh()
        with on_device(self.device), trace.frame() as rec:
            pkt = self._encode(include_seq)
        self.timings = rec.pick(KEY_TIMINGS)
        return pkt

    def _encode(self, include_seq: bool) -> bytes:
        seq, fh = self.make_headers()
        self.seq, self.fh = seq, fh
        fc = FrameContext(self.cfg.base_q_idx)

        with trace.span("plan", into="plan_s"):
            if self.tile_T > 1:
                self.tile_plans = self._plan_tiles()
                plan = self.tile_plans[0]
            elif self.use_part:
                plan = tpu_intra.plan_frame_part(
                    self.srcp, self.cfg.base_q_idx, fc, self.rdmult,
                    self.mi_rows, self.mi_cols, device=self.device)
            else:
                plan = tpu_intra.plan_frame(self.srcp, self.cfg.base_q_idx,
                                            self.bs, fc, self.rdmult,
                                            device=self.device)
        with trace.span("pack", into="pack_s"):
            self.plan = plan
            if self.tile_T > 1:
                fc, tile_data = self._pack_tiles(self.tile_plans, fh)
            elif self.use_part:
                tile_data = self._pack2(plan, fc, fh)
            else:
                tile_data = self._pack(plan, fc, fh)
            if self.use_part:
                # device LPF: pick per-plane levels on the device and keep
                # the post-LPF recon there — it is the inter reference
                # chain (the uniform grid keeps its pre-LPF plan recon, as
                # the reference)
                self._lpf_device(fh)
        if seq.enable_cdef:
            if self.cfg.search_cdef:
                # frame-level strengths picked on the post-LPF recon
                # (header bits only: cdef_bits = 0)
                self._search_cdef_fused(fh)
            else:
                # cdef_fixed: quantizer-derived strengths
                cdef_fixed_strengths(fh, self.cfg.base_q_idx)
        if seq.enable_cdef and self.use_part:
            # the reference chain is made post-CDEF like the decoder's,
            # with the normative directions (and the A/B gate for
            # cdef_fixed)
            self.ref_planes_dev = apply_cdef_refs(
                self.ref_planes_dev, self.mi_skip, fh, self.mi_rows,
                self.mi_cols, self.nplanes,
                srcs=None if self.cfg.search_cdef else self.device_sources())
        # end-of-frame entropy state, counter-reset as the decoder's
        # _update_ref_slots does (a following INTER frame forwards it)
        fc.reset_counters()
        self.saved_fc = fc

        td = bytes([0x12, 0x00])
        seq_obu = b""
        if include_seq:
            w = BitWriter()
            seq.write(w)
            w.trailing_bits()
            payload = w.data()
            seq_obu = bytes([0x0A]) + write_leb128(len(payload)) + payload
        w = BitWriter()
        write_frame_header(w, seq, fh)
        w.byte_align()
        frame_payload = w.data() + tile_data
        frame_obu = bytes([0x32]) + write_leb128(len(frame_payload)) \
            + frame_payload
        pkt = td + seq_obu + frame_obu
        self.picked_smooth64 = False
        if self._smooth64_eligible():
            pkt = self._pick_smooth64(pkt, include_seq)
        return pkt

    # ------------------------------------------------------------------
    def _smooth64_eligible(self) -> bool:
        """Cheap gate for the uniform-64 fallback: only frames whose
        high-frequency energy is far below typical noise can win with
        64x64 DC/SMOOTH coding."""
        if not (self.cfg.try_smooth64 and self.use_part
                and self.tile_T == 1 and min(self.w, self.h) >= 64):
            return False
        y = self.src.planes()[0].astype(np.float32)
        p = np.pad(y, 1, mode="edge")
        b = sum(p[r:r + y.shape[0], c:c + y.shape[1]]
                for r in range(3) for c in range(3)) / 9.0
        hf = float(np.mean((y - b) ** 2))
        return hf < 10.0

    def _pick_smooth64(self, pkt_fused: bytes, include_seq: bool) -> bytes:
        """Frame-level RD pick between the fused 32/16 stream and a uniform
        BLOCK_64X64 + TX_64X64 stream from the host ``FrameEncoder``. Both
        are decoded with the in-repo decoder for the exact in-loop
        distortion; the winner's recon/entropy/header state is kept."""
        import dataclasses
        from .frame import FrameEncoder

        cfg64 = dataclasses.replace(
            self.cfg, block_size=int(BlockSize.BLOCK_64X64),
            adaptive_partition=False, search_cdef=False, cdef_fixed=False,
            tile_cols_log2=0, try_smooth64=False, tune_vmaf=False)
        host = FrameEncoder(self.src, cfg64)
        pkt64 = host.encode(include_seq=include_seq)

        def _dist(pkt, seq):
            data = pkt
            if not include_seq:
                w = BitWriter()
                seq.write(w)
                w.trailing_bits()
                payload = w.data()
                data = pkt[:2] + bytes([0x0A]) \
                    + write_leb128(len(payload)) + payload + pkt[2:]
            rec = Av1Decoder().decode_packet(data)[0]
            sse = 0.0
            for a, b in zip(rec.planes()[: self.nplanes],
                            self.src.planes()[: self.nplanes]):
                d = a.astype(np.float64) - b.astype(np.float64)
                sse += float((d * d).sum())
            return sse, rec

        sse_f, _ = _dist(pkt_fused, self.seq)
        sse_6, rec_6 = _dist(pkt64, host.seq)
        from ..ec import costs as EC_costs
        lam = float(EC_costs.compute_rd_mult(self.cfg.base_q_idx))
        rd_f = 2048.0 * sse_f + lam / 512.0 * 8.0 * len(pkt_fused)
        rd_6 = 2048.0 * sse_6 + lam / 512.0 * 8.0 * len(pkt64)
        self.picked_smooth64 = bool(rd_6 < rd_f)
        if not self.picked_smooth64:
            return pkt_fused
        self.seq, self.fh = host.seq, host.fh
        host.fc.reset_counters()
        self.saved_fc = host.fc
        pads = []
        for i, pl in enumerate(rec_6.planes()[: self.nplanes]):
            th, tw = self.srcp[i].shape
            a = np.asarray(pl, np.int32)
            a = np.pad(a, ((0, th - a.shape[0]), (0, tw - a.shape[1])),
                       mode="edge")
            pads.append(convert.plane(a, self.device))
        self.ref_planes_dev = pads
        return pkt64

    # ------------------------------------------------------------------
    def _pack_tiles(self, plans: list, fh: FrameHeader):
        """One part2 pack per tile column, each from a fresh entropy state;
        returns the frame-end state (``context_update_tile_id``'s) and the
        tile group: the tile_start_and_end_present bit, then each tile but
        the last prefixed by its tile_size_bytes size."""
        datas, tile_fcs, tile_skips = [], [], []
        for t, p in enumerate(plans):
            col0 = t * self.tile_mi
            vis = min(self.tile_mi, self.mi_cols - col0)
            tfc = FrameContext(self.cfg.base_q_idx)
            datas.append(self._pack2(p, tfc, fh, mi_col_off=col0,
                                     mi_cols_vis=vis))
            tile_fcs.append(tfc)
            tile_skips.append(self._last_skip_blk)
        # frame skip map stitched from the tile columns
        skip_blk = np.concatenate(tile_skips, axis=1)
        self.mi_skip = np.repeat(
            np.repeat(skip_blk.astype(np.int32), 4, 0),
            4, 1)[: self.mi_rows, : self.mi_cols]
        nb = fh.tiles.tile_size_bytes
        tile_data = b""
        for t, d in enumerate(datas):
            if t < len(datas) - 1:
                tile_data += (len(d) - 1).to_bytes(nb, "little")
            tile_data += d
        # OBU_FRAME with > 1 tile: tile_start_and_end_present = 0 bit
        bw = BitWriter()
        bw.f(0, 1)
        bw.byte_align()
        return (tile_fcs[fh.tiles.context_update_tile_id],
                bw.data() + tile_data)

    def _cdef_grids(self):
        """Per-mi (tx_size_y, bsize, tx_size_uv) grids from the plan, for
        the host deblocker (av1_loopfilter.c set_lpf_parameters inputs)."""
        if self.use_part:
            sp = self._split16_frame()                 # per-16px cell
            ytx = np.where(sp, int(TxSize.TX_16X16), int(TxSize.TX_32X32))
            uvtx = np.where(sp, int(TxSize.TX_8X8), int(TxSize.TX_16X16))
            bsz = np.where(sp, int(BlockSize.BLOCK_16X16),
                           int(BlockSize.BLOCK_32X32))
            f = 4
        else:
            R, C = self.R, self.C
            ytx = np.full((R, C), _BS_TO_TX[self.bs], np.int32)
            uvtx = np.full((R, C), _BS_TO_TX.get(self.bs // 2,
                                                 int(TxSize.TX_4X4)),
                           np.int32)
            bsz = np.full((R, C), _BS_TO_BSIZE[self.bs], np.int32)
            f = self.bs // 4

        def up(a):
            return np.repeat(np.repeat(a, f, 0), f,
                             1)[: self.mi_rows, : self.mi_cols]

        return up(ytx), up(bsz), up(uvtx)

    def _split16_frame(self) -> np.ndarray:
        """(2R, 2C) per-16px-cell split map, stitched over tile columns."""
        if self.tile_T > 1:
            sp = np.concatenate([p["split32"] for p in self.tile_plans],
                                axis=1)
        else:
            sp = self.plan["split32"]
        return np.repeat(np.repeat(sp.astype(bool), 2, 0), 2, 1)

    def _recon_dev_frame(self):
        """Frame recon planes on the device (tile columns concatenated; a
        tile planned on another card is copied to ``device`` first)."""
        if self.tile_T > 1:
            return [torch.cat([pl["recon_dev"][p].to(self.device)
                               for pl in self.tile_plans], dim=1)
                    for p in range(self.nplanes)]
        return list(self.plan["recon_dev"])

    def device_sources(self) -> tuple:
        """The source planes on the device, uploaded once per frame and
        shared by the loop-filter pick and the CDEF gate."""
        if self._srcs_dev is None:
            self._srcs_dev = tuple(convert.plane(p, self.device)
                                   for p in self.srcp[: self.nplanes])
        return self._srcs_dev

    def _lpf_device(self, fh: FrameHeader) -> None:
        """Pick + apply the loop filter on the device. With
        ``cfg.search_lpf`` a 6-rung ladder around the q-derived first guess
        is evaluated per plane; otherwise the first guess is applied.
        Sets ``fh.lf`` and ``self.ref_planes_dev`` (post-LPF recon). The
        span ``lpf`` (``lpf_s``), the levels' read included."""
        with trace.span("lpf", into="lpf_s"):
            dev = self.device
            split16 = convert.to_device(self._split16_frame(), dev)
            recs = self._recon_dev_frame()
            w, h = self.mi_cols * 4, self.mi_rows * 4
            if self.cfg.search_lpf:
                outs = lpf_search(fh, recs, self.device_sources(), split16,
                                  w=w, h=h, nplanes=self.nplanes, device=dev)
            else:
                lv = [fh.lf.filter_level[0], fh.lf.filter_level_u,
                      fh.lf.filter_level_v]
                outs = DT.lpf_apply(tuple(recs), split16,
                                    convert.to_device(np.array(lv, np.int32),
                                                      dev),
                                    w=w, h=h, nplanes=self.nplanes)
            self.ref_planes_dev = list(outs)

    def _host_lpf_planes(self, fh: FrameHeader, search: bool) -> list:
        """The uniform grid's loop-filtered planes, made on the host as the
        reference's legacy branch makes them (``ops/deblock`` over the plan
        recon, ``tpu_frame.py:564-614``); with ``search``, the brute-force
        level ladder around the q-derived first guess sets ``fh.lf`` first
        (av1_pick_filter_level, av1/encoder/picklpf.c:247). These are the
        planes the decoder shows before CDEF."""
        from ..ops import deblock
        src, dims = self._crop_src()
        mi_tx, mi_bsz, mi_uv = self._cdef_grids()
        pre = [np.array(convert.to_host(r)[:h, :w], np.int32)
               for r, (h, w) in zip(self.plan["recon_dev"], dims)]
        info = deblock.DeblockInfo(mi_tx, mi_bsz, self.mi_skip,
                                   np.zeros_like(self.mi_skip),
                                   self.mi_rows, self.mi_cols)

        def filtered(p):
            buf = pre[p].copy()
            deblock.loop_filter_plane(buf, p, info, fh, self.seq,
                                      uv_tx_grid=mi_uv)
            return buf

        if search:
            lf = fh.lf
            guess = lf.filter_level[0]
            cands = sorted({0, guess // 2, max(guess - 2, 0), guess,
                            min(guess + 2, 63), min(guess * 2, 63)})

            def eval_plane(p, setter):
                best = None
                for lvl in cands:
                    setter(lvl)
                    d = filtered(p).astype(np.int64) - src[p]
                    e = int((d * d).sum())
                    if best is None or e < best[0]:
                        best = (e, lvl)
                setter(best[1])

            eval_plane(0, lambda v: setattr(lf, "filter_level", (v, v)))
            if self.nplanes > 1:
                if lf.filter_level == (0, 0):
                    # chroma only codable with a nonzero luma level
                    lf.filter_level_u = lf.filter_level_v = 0
                else:
                    eval_plane(1, lambda v: setattr(lf, "filter_level_u", v))
                    eval_plane(2, lambda v: setattr(lf, "filter_level_v", v))
        return [filtered(p) for p in range(self.nplanes)]

    def _crop_src(self):
        """Source planes cropped to the mi area, and their (h, w)."""
        mh, mw = self.mi_rows * 4, self.mi_cols * 4
        dims = [(mh, mw)] + [(mh // 2, mw // 2)] * (self.nplanes - 1)
        return [s[:h, :w] for s, (h, w) in zip(self.srcp, dims)], dims

    def _search_cdef_fused(self, fh: FrameHeader) -> None:
        """Frame-level CDEF strength pick (the reference's
        ``_search_cdef_fused``, ``ops/cdef.search_strengths`` on the host).
        Partition path: on the post-LPF recon, copied once from the device.
        Uniform grid (no device LPF): on ``_host_lpf_planes``, whose ladder
        also sets ``fh.lf`` with ``cfg.search_lpf``."""
        from ..ops import cdef as cdef_ops
        src, dims = self._crop_src()
        if self.use_part:
            planes = [np.array(convert.to_host(r)[:h, :w], np.int32)
                      for r, (h, w) in zip(self.ref_planes_dev, dims)]
        else:
            planes = self._host_lpf_planes(fh, self.cfg.search_lpf)
        yp, ys, up_, us = cdef_ops.search_strengths(
            planes, src, self.mi_skip, self.mi_rows, self.mi_cols,
            fh.cdef.damping)
        c = fh.cdef
        c.bits = 0
        c.y_pri, c.y_sec = [yp], [min(ys, 3)]
        c.uv_pri, c.uv_sec = [up_], [min(us, 3)]

    # ------------------------------------------------------------------
    def _pack(self, plan: dict, fc: FrameContext, fh: FrameHeader) -> bytes:
        """Uniform-grid pack: one native call over the whole tile
        (native/ec.cpp ec_enc_pack_kf_uniform)."""
        bs = self.bs
        R, C = self.R, self.C
        y_txs = _BS_TO_TX[bs]
        y_ectx = txsize_entropy_ctx(y_txs)
        y_ems = int(TXSIZE_LOG2_MINUS4[y_txs])
        plan_modes = np.asarray(tpu_intra.PLAN_MODES, np.int32)

        y_mode = np.ascontiguousarray(plan_modes[plan["y_mode"]], np.int32)
        y_levels = np.ascontiguousarray(plan["y_levels"], np.int32)
        y_eob = np.ascontiguousarray(plan["y_eob"], np.int32)
        skip = (y_eob == 0)
        uv_txs = _BS_TO_TX.get(bs // 2, int(TxSize.TX_4X4))
        if self.nplanes > 1:
            uv_mode = np.ascontiguousarray(plan_modes[plan["uv_mode"]],
                                           np.int32)
            uv_levels = np.ascontiguousarray(plan["uv_levels"], np.int32)
            uv_eob = np.ascontiguousarray(plan["uv_eob"], np.int32)
            skip = skip & (uv_eob[0] == 0) & (uv_eob[1] == 0)
        else:
            uv_mode, uv_levels, uv_eob = y_mode, y_levels, y_eob
        uv_ectx = txsize_entropy_ctx(uv_txs)
        uv_ems = int(TXSIZE_LOG2_MINUS4[uv_txs])
        skip = np.ascontiguousarray(skip.astype(np.uint8))
        self.mi_skip = np.repeat(np.repeat(skip.astype(np.int32), bs // 4, 0),
                                 bs // 4, 1)[: self.mi_rows, : self.mi_cols]

        # luma tx-type coding (FrameEncoder._write_tx_type): coded for
        # TX_8X8/TX_16X16 (sqr_up < TX_32X32), DCT_DCT symbol
        if bs <= 16:
            set_type = 2 if int(TXSIZE_SQR[y_txs]) == int(TxSize.TX_16X16) \
                else 3
            eset = EXT_TX_SET_INDEX_INTRA[set_type]
            ext_tx_cdf = np.ascontiguousarray(
                fc.intra_ext_tx_cdf[eset][int(TXSIZE_SQR[y_txs])])
            tx_type_nsyms = int(NUM_EXT_TX_SET[set_type])
            tx_type_sym = int(EXT_TX_IND[set_type][0])
            # writes adapt this slice in place
            fc.intra_ext_tx_cdf[eset][int(TXSIZE_SQR[y_txs])] = ext_tx_cdf
        else:
            ext_tx_cdf = np.zeros((13, 17), np.uint16)
            tx_type_nsyms = 0
            tx_type_sym = 0

        def eob_cdf(ems, pt):
            return getattr(fc, f"eob_flag_cdf{16 << ems}")[pt][0], 5 + ems

        y_eob_cdf, y_eob_nsyms = eob_cdf(y_ems, 0)
        uv_eob_cdf, uv_eob_nsyms = eob_cdf(uv_ems, 1)

        arrays = {
            "y_mode": y_mode, "uv_mode": uv_mode, "skip": skip,
            "y_levels": y_levels, "y_eob": y_eob,
            "uv_levels": uv_levels, "uv_eob": uv_eob,
            "y_scan": np.ascontiguousarray(tables.scan_table(y_txs, 0),
                                           np.int32),
            "uv_scan": np.ascontiguousarray(tables.scan_table(uv_txs, 0),
                                            np.int32),
            "y_nzoff": np.ascontiguousarray(
                tables.get(f"nz_map_ctx_offset_ts{y_txs}"), np.int32),
            "uv_nzoff": np.ascontiguousarray(
                tables.get(f"nz_map_ctx_offset_ts{uv_txs}"), np.int32),
            "eob_group_start": np.ascontiguousarray(
                tables.get("eob_group_start"), np.int32),
            "eob_offset_bits": np.ascontiguousarray(
                tables.get("eob_offset_bits"), np.int32),
            "intra_mode_ctx": np.ascontiguousarray(INTRA_MODE_CONTEXT,
                                                   np.int32),
            "part_cdf": fc.partition_cdf, "skip_cdf": fc.skip_txfm_cdfs,
            "kf_y_cdf": fc.kf_y_cdf, "angle_cdf": fc.angle_delta_cdf,
            "uv_cdf": np.ascontiguousarray(fc.uv_mode_cdf[1]),
            "ext_tx_cdf": ext_tx_cdf,
            "y_txb_skip": np.ascontiguousarray(fc.txb_skip_cdf[y_ectx]),
            "uv_txb_skip": np.ascontiguousarray(fc.txb_skip_cdf[uv_ectx]),
            "y_eob_cdf": np.ascontiguousarray(y_eob_cdf),
            "uv_eob_cdf": np.ascontiguousarray(uv_eob_cdf),
            "y_eob_extra": np.ascontiguousarray(fc.eob_extra_cdf[y_ectx][0]),
            "uv_eob_extra": np.ascontiguousarray(
                fc.eob_extra_cdf[uv_ectx][1]),
            "y_base_eob": np.ascontiguousarray(
                fc.coeff_base_eob_cdf[y_ectx][0]),
            "uv_base_eob": np.ascontiguousarray(
                fc.coeff_base_eob_cdf[uv_ectx][1]),
            "y_base": np.ascontiguousarray(fc.coeff_base_cdf[y_ectx][0]),
            "uv_base": np.ascontiguousarray(fc.coeff_base_cdf[uv_ectx][1]),
            "y_br": np.ascontiguousarray(
                fc.coeff_br_cdf[min(y_ectx, 3)][0]),
            "uv_br": np.ascontiguousarray(
                fc.coeff_br_cdf[min(uv_ectx, 3)][1]),
            "y_dc_sign": np.ascontiguousarray(fc.dc_sign_cdf[0]),
            "uv_dc_sign": np.ascontiguousarray(fc.dc_sign_cdf[1]),
        }
        self._keepalive = arrays  # numpy buffers must outlive the call
        scalars = {
            "R": R, "C": C, "bs": bs,
            "mi_rows": self.mi_rows, "mi_cols": self.mi_cols,
            "nplanes": self.nplanes,
            "y_eob_nsyms": y_eob_nsyms, "uv_eob_nsyms": uv_eob_nsyms,
            "tx_type_nsyms": tx_type_nsyms, "tx_type_sym": tx_type_sym,
            "block_bsize": _BS_TO_BSIZE[bs],
            "part_ctx_above": int(PARTITION_CTX_ABOVE[_BS_TO_BSIZE[bs]]),
            "part_ctx_left": int(PARTITION_CTX_LEFT[_BS_TO_BSIZE[bs]]),
        }
        enc = NativeEncoder()
        enc.allow_update = not fh.disable_cdf_update
        native_pack_kf_uniform(enc, arrays, scalars)
        return enc.done()

    # ------------------------------------------------------------------
    def _pack2(self, plan: dict, fc: FrameContext, fh: FrameHeader,
               mi_col_off: int = 0, mi_cols_vis: int | None = None) -> bytes:
        """Two-level partition pack: one native call over the 32/16 tree
        (native/ec.cpp ec_enc_pack_kf_part2). ``mi_col_off`` /
        ``mi_cols_vis`` select a tile column (the visit bound is
        tile-relative; frame-edge rules use absolute frame bounds)."""
        if mi_cols_vis is None:
            mi_cols_vis = self.mi_cols
        plan_modes = np.asarray(tpu_intra.PLAN_MODES, np.int32)
        R2, C2 = plan["y_mode16"].shape
        Rc, Cc = R2 // 2, C2 // 2

        def av1_modes(idx):
            # chroma plans store extension-free PLAN indices; luma modes
            # come out of the wavefront as AV1 ids already
            return np.ascontiguousarray(plan_modes[idx], np.int32)

        tx32, tx16, tx8 = (int(TxSize.TX_32X32), int(TxSize.TX_16X16),
                           int(TxSize.TX_8X8))
        e32, e16, e8 = (txsize_entropy_ctx(t) for t in (tx32, tx16, tx8))
        # TX_16X16 luma tx-type coding (set 2, DCT symbol)
        set_type = 2
        eset = EXT_TX_SET_INDEX_INTRA[set_type]
        ext_tx16 = np.ascontiguousarray(
            fc.intra_ext_tx_cdf[eset][int(TXSIZE_SQR[tx16])])
        fc.intra_ext_tx_cdf[eset][int(TXSIZE_SQR[tx16])] = ext_tx16

        if self.nplanes > 1:
            uv_mode16 = av1_modes(plan["uv_mode16"])
            uv_mode8 = av1_modes(plan["uv_mode8"])
            uv_lv16 = np.ascontiguousarray(plan["uv_levels16"], np.int32)
            uv_lv8 = np.ascontiguousarray(plan["uv_levels8"], np.int32)
            uv_eob16 = np.ascontiguousarray(plan["uv_eob16"], np.int32)
            uv_eob8 = np.ascontiguousarray(plan["uv_eob8"], np.int32)
        else:
            uv_mode16 = np.zeros((Rc, Cc), np.int32)
            uv_mode8 = np.zeros((R2, C2), np.int32)
            uv_lv16 = np.zeros((2, Rc, Cc, 256), np.int32)
            uv_lv8 = np.zeros((2, R2, C2, 64), np.int32)
            uv_eob16 = np.zeros((2, Rc, Cc), np.int32)
            uv_eob8 = np.zeros((2, R2, C2), np.int32)

        # per-mi skip map (for filter searches / debug)
        skip32 = (plan["y_eob32"] == 0) & (uv_eob16 == 0).all(0)
        skip16 = (plan["y_eob16"] == 0) & (uv_eob8 == 0).all(0)
        sp = plan["split32"].astype(bool)
        skip_blk = np.where(np.repeat(np.repeat(sp, 2, 0), 2, 1), skip16,
                            np.repeat(np.repeat(skip32, 2, 0), 2, 1))
        self._last_skip_blk = skip_blk  # per tile; stitched by encode()
        if mi_col_off == 0 and mi_cols_vis == self.mi_cols:
            self.mi_skip = np.repeat(
                np.repeat(skip_blk.astype(np.int32), 4, 0),
                4, 1)[: self.mi_rows, : self.mi_cols]

        arrays = {
            "split32": np.ascontiguousarray(plan["split32"], np.uint8),
            "y_mode32": np.ascontiguousarray(plan["y_mode32"], np.int32),
            "y_mode16": np.ascontiguousarray(plan["y_mode16"], np.int32),
            "y_delta32": np.ascontiguousarray(plan["y_delta32"], np.int32),
            "y_delta16": np.ascontiguousarray(plan["y_delta16"], np.int32),
            "y_lv32": np.ascontiguousarray(plan["y_levels32"], np.int32),
            "y_lv16": np.ascontiguousarray(plan["y_levels16"], np.int32),
            "y_eob32": np.ascontiguousarray(plan["y_eob32"], np.int32),
            "y_eob16": np.ascontiguousarray(plan["y_eob16"], np.int32),
            "uv_mode16": uv_mode16, "uv_mode8": uv_mode8,
            "uv_lv16": uv_lv16, "uv_lv8": uv_lv8,
            "uv_eob16": uv_eob16, "uv_eob8": uv_eob8,
            "scan32": np.ascontiguousarray(tables.scan_table(tx32, 0),
                                           np.int32),
            "scan16": np.ascontiguousarray(tables.scan_table(tx16, 0),
                                           np.int32),
            "scan8": np.ascontiguousarray(tables.scan_table(tx8, 0),
                                          np.int32),
            "nzoff32": np.ascontiguousarray(
                tables.get(f"nz_map_ctx_offset_ts{tx32}"), np.int32),
            "nzoff16": np.ascontiguousarray(
                tables.get(f"nz_map_ctx_offset_ts{tx16}"), np.int32),
            "nzoff8": np.ascontiguousarray(
                tables.get(f"nz_map_ctx_offset_ts{tx8}"), np.int32),
            "eob_group_start": np.ascontiguousarray(
                tables.get("eob_group_start"), np.int32),
            "eob_offset_bits": np.ascontiguousarray(
                tables.get("eob_offset_bits"), np.int32),
            "intra_mode_ctx": np.ascontiguousarray(INTRA_MODE_CONTEXT,
                                                   np.int32),
            "part_cdf": fc.partition_cdf, "skip_cdf": fc.skip_txfm_cdfs,
            "kf_y_cdf": fc.kf_y_cdf, "angle_cdf": fc.angle_delta_cdf,
            "uv_cdf": np.ascontiguousarray(fc.uv_mode_cdf[1]),
            "ext_tx16": ext_tx16,
            "txb_skip_y32": fc.txb_skip_cdf[e32],
            "txb_skip_y16": fc.txb_skip_cdf[e16],
            "txb_skip_uv16": fc.txb_skip_cdf[e16],
            "txb_skip_uv8": fc.txb_skip_cdf[e8],
            "eob_y32": fc.eob_flag_cdf1024[0][0],
            "eob_y16": fc.eob_flag_cdf256[0][0],
            "eob_uv16": fc.eob_flag_cdf256[1][0],
            "eob_uv8": fc.eob_flag_cdf64[1][0],
            "eobex_y32": fc.eob_extra_cdf[e32][0],
            "eobex_y16": fc.eob_extra_cdf[e16][0],
            "eobex_uv16": fc.eob_extra_cdf[e16][1],
            "eobex_uv8": fc.eob_extra_cdf[e8][1],
            "beob_y32": fc.coeff_base_eob_cdf[e32][0],
            "beob_y16": fc.coeff_base_eob_cdf[e16][0],
            "beob_uv16": fc.coeff_base_eob_cdf[e16][1],
            "beob_uv8": fc.coeff_base_eob_cdf[e8][1],
            "base_y32": fc.coeff_base_cdf[e32][0],
            "base_y16": fc.coeff_base_cdf[e16][0],
            "base_uv16": fc.coeff_base_cdf[e16][1],
            "base_uv8": fc.coeff_base_cdf[e8][1],
            "br_y32": fc.coeff_br_cdf[min(e32, 3)][0],
            "br_y16": fc.coeff_br_cdf[min(e16, 3)][0],
            "br_uv16": fc.coeff_br_cdf[min(e16, 3)][1],
            "br_uv8": fc.coeff_br_cdf[min(e8, 3)][1],
            "dcs_y": fc.dc_sign_cdf[0],
            "dcs_uv": fc.dc_sign_cdf[1],
        }
        for k, v in arrays.items():
            assert v.flags["C_CONTIGUOUS"], k
        self._keepalive = arrays
        bs32 = int(BlockSize.BLOCK_32X32)
        bs16 = int(BlockSize.BLOCK_16X16)
        scalars = {
            "R": Rc, "C": Cc,
            "mi_rows": self.mi_rows, "mi_cols": mi_cols_vis,
            "mi_col_off": mi_col_off, "mi_cols_frame": self.mi_cols,
            "nplanes": self.nplanes,
            "eobn_y32": 5 + int(TXSIZE_LOG2_MINUS4[tx32]),
            "eobn_y16": 5 + int(TXSIZE_LOG2_MINUS4[tx16]),
            "eobn_uv16": 5 + int(TXSIZE_LOG2_MINUS4[tx16]),
            "eobn_uv8": 5 + int(TXSIZE_LOG2_MINUS4[tx8]),
            "txt16_nsyms": int(NUM_EXT_TX_SET[set_type]),
            "txt16_sym": int(EXT_TX_IND[set_type][0]),
            "pctx_a32": int(PARTITION_CTX_ABOVE[bs32]),
            "pctx_l32": int(PARTITION_CTX_LEFT[bs32]),
            "pctx_a16": int(PARTITION_CTX_ABOVE[bs16]),
            "pctx_l16": int(PARTITION_CTX_LEFT[bs16]),
        }
        enc = NativeEncoder()
        enc.allow_update = not fh.disable_cdf_update
        native_pack_kf_part2(enc, arrays, scalars)
        return enc.done()


def cdef_fixed_strengths(fh: FrameHeader, q: int) -> None:
    """Quantizer-derived frame-level CDEF strengths (encoder heuristic;
    any signalled strength conforms). Carried over from the reference
    (``tpu_frame.py:883-893``)."""
    c = fh.cdef
    c.bits = 0
    ypri = int(np.clip((q - 16) // 48, 0, 8))
    ysec = 1 if q >= 80 else 0
    c.y_pri, c.y_sec = [ypri], [ysec]
    c.uv_pri, c.uv_sec = [max(ypri - 1, 0)], [ysec]
    fh.cdef.damping = 3 + (q >> 6)


def apply_cdef_refs(planes_dev, mi_skip, fh: FrameHeader, mi_rows: int,
                    mi_cols: int, nplanes: int, srcs=None):
    """Apply the frame's CDEF to the (post-LPF) reference planes on the
    device: one frame pass (``ops/cdef_torch.cdef_frame``, kernel KF) that
    finds the NORMATIVE directions (exact integer costs), filters the
    planes and, with ``srcs``, sums the gate's squared errors. No plane
    goes to the host; ``skip8`` goes up once. Returns new device planes.
    Carried over from the reference (``tpu_frame.py:896-946``), whose
    direction search runs on the host.

    When ``srcs`` (source planes: tensors on the planes' device, or numpy)
    are given, the strengths are A/B gated: if the filtered frame's source
    error is not clearly lower, the strengths are zeroed in ``fh`` and the
    input planes returned. The reference sums each plane's squared error
    in float32; here each is exact (int64, one device->host copy of the 2 x
    nplanes sums), converted to float32, and the planes are added in the
    reference's order before ``e1 < 0.98 * e0`` in float32."""
    from ..ops import cdef_torch as CT
    c = fh.cdef
    ysec = c.y_sec[0] + (c.y_sec[0] == 3)
    usec = c.uv_sec[0] + (c.uv_sec[0] == 3)
    if c.y_pri[0] == 0 and ysec == 0 and c.uv_pri[0] == 0 and usec == 0:
        return planes_dev
    dev = planes_dev[0].device
    nbr, nbc = mi_rows // 2, mi_cols // 2
    sk = np.ones((nbr * 2, nbc * 2), np.int32)
    sk[:mi_rows, :mi_cols] = mi_skip
    skip8 = sk.reshape(nbr, 2, nbc, 2).all((1, 3))
    if srcs is not None:
        srcs = tuple(s if torch.is_tensor(s) else convert.plane(s, dev)
                     for s in srcs[:nplanes])
    outs, _, _, sums = CT.cdef_frame(
        tuple(planes_dev[:nplanes]), convert.to_device(skip8, dev),
        c.y_pri[0], ysec, c.uv_pri[0], usec, c.damping, mi_rows=mi_rows,
        mi_cols=mi_cols, nplanes=nplanes, srcs=srcs)
    if srcs is not None:
        e = convert.to_host(sums).astype(np.float32)
        e0, e1 = e[0, 0], e[1, 0]
        for i in range(1, nplanes):
            e0 = e0 + e[0, i]
            e1 = e1 + e[1, i]
        # require a clear win: marginal filtering denoises the recon at
        # the cost of re-coding that noise in every following frame
        if not e1 < np.float32(0.98) * e0:
            c.y_pri, c.y_sec = [0], [0]
            c.uv_pri, c.uv_sec = [0], [0]
            return planes_dev
    return list(outs)


def encode_ivf(frames: list, cfg: EncoderConfig, path: str,
               device="cuda") -> None:
    """All-intra IVF file: every frame a KEY frame of ``GpuFrameEncoder``
    (the reference's ``encode_ivf_tpu``, ``tpu_frame.py:949-952``)."""
    packets = [GpuFrameEncoder(f, cfg, device=device).encode()
               for f in frames]
    from ..bitstream.containers import write_ivf
    write_ivf(path, packets, frames[0].width, frames[0].height)
