"""OBU-level decode driver (av1/decoder/obu.c analogue).

Parses a temporal unit's OBUs, reads headers, dispatches tile groups to the
FrameDecoder, returns decoded frames. Owns the 8-slot reference frame map
(decoder.c ref management), the per-slot saved entropy contexts
(REFRESH_FRAME_CONTEXT_BACKWARD), saved loop-filter deltas / global motion
(primary-ref inheritance), and per-slot 8x8 MV grids for temporal MVP.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.bitio import BitReader, read_leb128
from ..bitstream.headers import (SequenceHeader, FrameHeader,
                                 read_frame_header, PRIMARY_REF_NONE)
from ..ec.context import FrameContext
from .frame import FrameDecoder

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_PADDING = 15


class Av1Decoder:
    """Stateful packet decoder: feed temporal units, collect frames."""

    def __init__(self) -> None:
        self.seq: SequenceHeader | None = None
        self.fh: FrameHeader | None = None
        self.fdec: FrameDecoder | None = None
        self.tiles_parsed = 0
        self.ref_slots = [None] * 8  # RefCntBuffer analogues

    # ---- ref_state protocol for read_frame_header ----
    def inspect(self):
        """Per-mi inspection snapshot of the most recently decoded frame
        (av1/decoder/inspection.h analogue; see decoder/inspect.py)."""
        from .inspect import snapshot
        assert self.fdec is not None, "no frame decoded yet"
        return snapshot(self)

    def slot_order_hint(self, idx: int):
        s = self.ref_slots[idx]
        return s["order_hint"] if s else None

    def slot_size(self, idx: int):
        s = self.ref_slots[idx]
        return (s["upscaled_width"], s["height"], s["render_width"],
                s["render_height"])

    def slot_global_motion(self, idx: int):
        s = self.ref_slots[idx]
        return s["global_motion"] if s else None

    def slot_lf_deltas(self, idx: int):
        s = self.ref_slots[idx]
        return s["lf_deltas"] if s else None

    def decode_packet(self, data: bytes) -> list:
        """Decode one temporal unit (e.g. an IVF packet). Returns frames.

        Error contract (aom/internal/aom_codec_internal.h:368 /
        test/invalid_file_test.cc analogue): malformed input raises
        ``Av1CorruptFrameError``; legal-but-unimplemented syntax raises
        ``Av1UnsupportedBitstreamError``; no other exception escapes."""
        from ..errors import (Av1Error, Av1CorruptFrameError,
                              Av1UnsupportedBitstreamError)
        if not isinstance(data, (bytes, bytearray, memoryview)):
            from ..errors import Av1InvalidParamError
            raise Av1InvalidParamError("packet must be bytes")
        try:
            return self._decode_packet(bytes(data))
        except Av1Error:
            raise
        except NotImplementedError as e:
            raise Av1UnsupportedBitstreamError(str(e)) from e
        except Exception as e:
            # the decode state may be mid-frame; poison it so a later
            # packet can't run on half-updated references
            self.fdec = None
            raise Av1CorruptFrameError(
                f"{type(e).__name__}: {e}") from e

    def _decode_packet(self, data: bytes) -> list:
        frames = []
        pos = 0
        while pos < len(data):
            if pos + 1 > len(data):
                break
            hdr = data[pos]
            assert (hdr >> 7) == 0, "forbidden bit set"
            obu_type = (hdr >> 3) & 0xF
            ext_flag = (hdr >> 2) & 1
            has_size = (hdr >> 1) & 1
            pos += 1
            if ext_flag:
                pos += 1
            if has_size:
                size, pos = read_leb128(data, pos)
            else:
                size = len(data) - pos
            if size < 0 or pos + size > len(data):
                from ..errors import Av1CorruptFrameError
                raise Av1CorruptFrameError(
                    f"OBU size {size} overruns packet ({len(data)} bytes)")
            payload = data[pos : pos + size]
            pos += size
            self._handle_obu(obu_type, payload, frames)
        return frames

    # ------------------------------------------------------------------
    def _handle_obu(self, obu_type: int, payload: bytes, frames: list) -> None:
        if obu_type in (OBU_TEMPORAL_DELIMITER, OBU_PADDING, OBU_METADATA,
                        OBU_REDUNDANT_FRAME_HEADER):
            return
        if obu_type == OBU_SEQUENCE_HEADER:
            self.seq = SequenceHeader.read(BitReader(payload))
            return
        if obu_type == OBU_FRAME_HEADER:
            r = BitReader(payload)
            fh = read_frame_header(r, self.seq, ref_state=self)
            if fh.show_existing_frame:
                self._show_existing(fh, frames)
            else:
                self._start_frame(fh)
            return
        if obu_type == OBU_FRAME:
            r = BitReader(payload)
            fh = read_frame_header(r, self.seq, ref_state=self)
            self._start_frame(fh)
            r.byte_align()
            self._tile_group(payload[r.byte_offset() :], frames)
            return
        if obu_type == OBU_TILE_GROUP:
            self._tile_group_obu(payload, frames)
            return
        raise NotImplementedError(f"OBU type {obu_type}")

    # ------------------------------------------------------------------
    def _show_existing(self, fh: FrameHeader, frames: list) -> None:
        """show_existing_frame (decodeframe.c:4485)."""
        slot = self.ref_slots[fh.frame_to_show_map_idx]
        assert slot is not None, "show_existing of an empty slot"
        frames.append(self._grain_output(slot["frame"], slot["film_grain"]))
        if slot["frame_type"] == 0:  # KEY: reset state (6.8.2)
            slot["showable"] = False
            for i in range(8):
                if i != fh.frame_to_show_map_idx:
                    self.ref_slots[i] = dict(slot)

    def _start_frame(self, fh: FrameHeader) -> None:
        self.fh = fh
        # resolve reference slots (LAST..ALTREF -> 1..7)
        refs = [None] * 8
        sign_bias = [0] * 8
        if fh.frame_type not in (0, 2):
            from ..normative.mvref import get_relative_dist
            for i in range(7):
                refs[1 + i] = self.ref_slots[fh.ref_frame_idx[i]]
            if self.seq.enable_order_hint:
                for rf in range(1, 8):
                    if refs[rf] is not None:
                        sign_bias[rf] = int(get_relative_dist(
                            True, self.seq.order_hint_bits,
                            refs[rf]["order_hint"], fh.order_hint) > 0)
        self.fdec = FrameDecoder(self.seq, fh, refs=refs,
                                 ref_sign_bias=sign_bias)
        # av1_calculate_ref_frame_side (for av1_copy_frame_mvs)
        if self.seq.enable_order_hint and fh.frame_type not in (0, 2):
            from ..normative.mvref import get_relative_dist
            side = [0] * 8
            for rf in range(1, 8):
                hint = refs[rf]["order_hint"] if refs[rf] else 0
                d = get_relative_dist(True, self.seq.order_hint_bits, hint,
                                      fh.order_hint)
                if d > 0:
                    side[rf] = 1
                elif hint == fh.order_hint:
                    side[rf] = -1
            self.fdec.ref_frame_side = side
        if fh.allow_ref_frame_mvs:
            self._setup_motion_field(fh, refs)
        self.tiles_parsed = 0
        # entropy context: defaults, or the primary ref's saved context
        if fh.primary_ref_frame == PRIMARY_REF_NONE or fh.frame_type in (0, 2):
            self.frame_fc = FrameContext(fh.quant.base_q_idx)
        else:
            slot = self.ref_slots[fh.ref_frame_idx[fh.primary_ref_frame]]
            self.frame_fc = slot["fc"].copy()

    def _setup_motion_field(self, fh, refs) -> None:
        from ..normative import mvref as MR
        mvs_r = (self.fdec.mi_rows + 1) >> 1
        mvs_c = (self.fdec.mi_cols + 1) >> 1
        tpl = {"mv": np.full((mvs_r, mvs_c, 2), 0, np.int32),
               "offset": np.zeros((mvs_r, mvs_c), np.int32),
               "valid": np.zeros((mvs_r, mvs_c), np.int32)}
        bits = self.seq.order_hint_bits
        cur = fh.order_hint

        def rel(a, b):
            return MR.get_relative_dist(True, bits, a, b)

        def project(start_rf, dir_):
            slot = refs[start_rf]
            if slot is None or slot["frame_type"] in (0, 2):
                return 0
            if slot["mi_rows"] != self.fdec.mi_rows or \
                    slot["mi_cols"] != self.fdec.mi_cols:
                return 0
            start_hint = slot["order_hint"]
            s2c = rel(start_hint, cur)
            if dir_ == 2:
                s2c = -s2c
            ref_offsets = [0] * 8
            for rf in range(1, 8):
                ref_offsets[rf] = rel(start_hint,
                                      slot["ref_order_hints"][rf - 1])
            mref = slot["mvs_ref"]
            mmv = slot["mvs"]
            for br in range(mvs_r):
                for bc in range(mvs_c):
                    rf = int(mref[br, bc])
                    if rf <= 0:
                        continue
                    roff = ref_offsets[rf]
                    if not (0 < roff <= MR.MAX_FRAME_DISTANCE
                            and abs(s2c) <= MR.MAX_FRAME_DISTANCE):
                        continue
                    fwd = (int(mmv[br, bc, 0]), int(mmv[br, bc, 1]))
                    pmv = MR.get_mv_projection(fwd, s2c, roff)
                    # get_block_position
                    # offsets in 8x8-block units: 1/8-pel mv >> (4 +
                    # MI_SIZE_LOG2) (mvref_common.c get_block_position)
                    ro = (pmv[0] >> 6) if pmv[0] >= 0 else -((-pmv[0]) >> 6)
                    co = (pmv[1] >> 6) if pmv[1] >= 0 else -((-pmv[1]) >> 6)
                    r = br - ro if (dir_ >> 1) == 1 else br + ro
                    c = bc - co if (dir_ >> 1) == 1 else bc + co
                    if not (0 <= r < (self.fdec.mi_rows >> 1)
                            and 0 <= c < (self.fdec.mi_cols >> 1)):
                        continue
                    base_r = (br >> 3) << 3
                    base_c = (bc >> 3) << 3
                    if r < base_r or r >= base_r + 8 or \
                            c < base_c - 8 or c >= base_c + 16:
                        continue
                    tpl["mv"][r, c] = fwd
                    tpl["offset"][r, c] = roff
                    tpl["valid"][r, c] = 1
            return 1

        ref_hint = [refs[rf]["order_hint"] if refs[rf] else 0
                    for rf in range(8)]
        ref_stamp = MR.MFMV_STACK_SIZE - 1
        if refs[MR.LAST_FRAME] is not None:
            alt_of_lst = refs[MR.LAST_FRAME]["ref_order_hints"][
                MR.ALTREF_FRAME - MR.LAST_FRAME]
            if alt_of_lst != ref_hint[MR.GOLDEN_FRAME]:
                project(MR.LAST_FRAME, 2)
            ref_stamp -= 1
        if rel(ref_hint[MR.BWDREF_FRAME], cur) > 0:
            if project(MR.BWDREF_FRAME, 0):
                ref_stamp -= 1
        if rel(ref_hint[MR.ALTREF2_FRAME], cur) > 0:
            if project(MR.ALTREF2_FRAME, 0):
                ref_stamp -= 1
        if rel(ref_hint[MR.ALTREF_FRAME], cur) > 0 and ref_stamp >= 0:
            if project(MR.ALTREF_FRAME, 0):
                ref_stamp -= 1
        if ref_stamp >= 0:
            project(MR.LAST2_FRAME, 2)
        self.fdec.tpl_mvs = tpl

    def _tile_group_obu(self, payload: bytes, frames: list) -> None:
        t = self.fh.tiles
        num_tiles = t.tile_cols * t.tile_rows
        r = BitReader(payload)
        tg_start, tg_end = 0, num_tiles - 1
        if num_tiles > 1:
            if r.f(1):  # tile_start_and_end_present
                bits = t.tile_cols_log2 + t.tile_rows_log2
                tg_start = r.f(bits)
                tg_end = r.f(bits)
        r.byte_align()
        self._tiles(payload[r.byte_offset() :], tg_start, tg_end, frames)

    def _tile_group(self, payload: bytes, frames: list) -> None:
        # OBU_FRAME: tile group with no start/end syntax for single group
        t = self.fh.tiles
        num_tiles = t.tile_cols * t.tile_rows
        r = BitReader(payload)
        if num_tiles > 1:
            r.f(1)  # tile_start_and_end_present must be 0 in OBU_FRAME
        r.byte_align()
        self._tiles(payload[r.byte_offset() :], 0, num_tiles - 1, frames)

    def _tiles(self, data: bytes, tg_start: int, tg_end: int,
               frames: list) -> None:
        t = self.fh.tiles
        pos = 0
        for tnum in range(tg_start, tg_end + 1):
            row, col = divmod(tnum, t.tile_cols)
            if tnum == tg_end:
                tile_data = data[pos:]
            else:
                sz = int.from_bytes(data[pos : pos + t.tile_size_bytes],
                                    "little") + 1
                pos += t.tile_size_bytes
                tile_data = data[pos : pos + sz]
                pos += sz
            fc = self.frame_fc.copy()
            self.fdec.decode_tile(tile_data, row, col, fc)
            if tnum == t.context_update_tile_id:
                self._context_update_fc = fc
            self.tiles_parsed += 1
        if self.tiles_parsed == t.tile_cols * t.tile_rows:
            self.fdec.apply_loop_filter()
            self._update_ref_slots()
            if self.fh.show_frame:
                frames.append(self._grain_output(self.fdec.output_frame(),
                                                 self.fh.film_grain))

    def _update_ref_slots(self) -> None:
        fh = self.fh
        if fh.refresh_frame_flags == 0:
            return
        fdec = self.fdec
        frame = fdec.output_frame()
        if fh.disable_frame_end_update_cdf:
            saved_fc = self.frame_fc
        else:
            saved_fc = self._context_update_fc
        saved_fc.reset_counters()
        ref_order_hints = [fdec.ref_order_hint(rf) for rf in range(1, 8)]
        slot = {
            "frame": frame,
            "planes": [p for p in fdec.planes],
            "order_hint": fh.order_hint,
            "ref_order_hints": ref_order_hints,
            "frame_type": fh.frame_type,
            "showable": fh.showable_frame or fh.show_frame,
            "width": fh.width,
            "height": fh.height,
            "upscaled_width": fh.upscaled_width,
            "render_width": fh.render_width,
            "render_height": fh.render_height,
            "mi_rows": fdec.mi_rows,
            "mi_cols": fdec.mi_cols,
            "global_motion": fh.global_motion,
            "lf_deltas": (tuple(fh.lf.ref_deltas), tuple(fh.lf.mode_deltas)),
            "fc": saved_fc,
            "film_grain": fh.film_grain,
            "mvs_ref": fdec.frame_mvs_ref,
            "mvs": fdec.frame_mvs,
        }
        for i in range(8):
            if (fh.refresh_frame_flags >> i) & 1:
                self.ref_slots[i] = slot

    def _grain_output(self, frame, fg):
        """Post-decode grain application (av1_dx_iface.c:465 grain apply;
        output only — reference buffers stay grain-free)."""
        if fg is None or not fg.apply_grain:
            return frame
        from ..ops.grain import apply_film_grain
        from ..utils.frame import Frame
        y, u, v = frame.y, frame.u, frame.v
        h, w = y.shape
        eh, ew = (h + 1) & ~1, (w + 1) & ~1
        if (eh, ew) != (h, w):  # extend_even (grain_synthesis.c:884)
            y = np.pad(y, ((0, eh - h), (0, ew - w)), mode="edge")
        mc_identity = (self.seq.color_description_present
                       and self.seq.matrix_coefficients == 0)
        oy, ou, ov = apply_film_grain(
            fg, y, u, v, ss_x=self.seq.subsampling_x,
            ss_y=self.seq.subsampling_y, mc_identity=mc_identity)
        return Frame(oy[:h, :w], ou, ov)


def decode_ivf(path: str) -> list:
    from ..bitstream.containers import read_ivf
    from ..errors import Av1Error, Av1CorruptFrameError
    dec = Av1Decoder()
    frames = []
    # stream the container: each packet is pulled lazily so a large file is
    # never buffered whole; container-level corruption in the iterator is
    # mapped to the typed error surface per packet
    it = iter(read_ivf(path))
    while True:
        try:
            pkt = next(it)
        except StopIteration:
            break
        except OSError:
            raise
        except Av1Error:
            raise
        except Exception as e:
            raise Av1CorruptFrameError(f"bad IVF container: {e}") from e
        frames.extend(dec.decode_packet(pkt))
    return frames
