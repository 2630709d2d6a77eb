"""AV1 sequence / frame header syntax (uncompressed, MSB-first bits).

Covers the intra/still and single-tile-group feature set used by this
framework's encoder plus what stock aomenc emits for all-intra encodes
(reference: ``av1/decoder/obu.c`` read side, ``av1/encoder/bitstream.c``
write side). Unsupported tool combinations raise ``NotImplementedError``
so conformance gaps are loud, not silent.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bitio import BitReader, BitWriter
from ..ops.grain import FilmGrainParams

PRIMARY_REF_NONE = 7
SUPERRES_DENOM_BITS = 3
SUPERRES_DENOM_MIN = 9
SUPERRES_NUM = 8


@dataclasses.dataclass
class SequenceHeader:
    profile: int = 0
    still_picture: bool = False
    reduced_still_picture_header: bool = False
    operating_point_idc: int = 0
    seq_level_idx: int = 0
    seq_tier: int = 0
    frame_width_bits: int = 16
    frame_height_bits: int = 16
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: bool = False
    delta_frame_id_length: int = 0
    additional_frame_id_length: int = 0
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = True
    enable_intra_edge_filter: bool = True
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = False
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    seq_force_screen_content_tools: int = 0  # 0/1 fixed, 2 = per-frame
    seq_force_integer_mv: int = 2
    order_hint_bits: int = 0
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    # color config
    high_bitdepth: bool = False
    twelve_bit: bool = False
    monochrome: bool = False
    color_description_present: bool = False
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: bool = False
    film_grain_params_present: bool = False

    @property
    def bit_depth(self) -> int:
        if self.high_bitdepth:
            return 12 if self.twelve_bit else 10
        return 8

    @property
    def sb_size(self) -> int:
        return 128 if self.use_128x128_superblock else 64

    def write(self, w: BitWriter) -> None:
        w.f(self.profile, 3)
        w.f(int(self.still_picture), 1)
        w.f(int(self.reduced_still_picture_header), 1)
        if self.reduced_still_picture_header:
            w.f(self.seq_level_idx, 5)
        else:
            w.f(0, 1)  # timing_info_present_flag
            w.f(0, 1)  # initial_display_delay_present_flag
            w.f(0, 5)  # operating_points_cnt_minus_1
            w.f(self.operating_point_idc, 12)
            w.f(self.seq_level_idx, 5)
            if self.seq_level_idx > 7:
                w.f(self.seq_tier, 1)
        w.f(self.frame_width_bits - 1, 4)
        w.f(self.frame_height_bits - 1, 4)
        w.f(self.max_frame_width - 1, self.frame_width_bits)
        w.f(self.max_frame_height - 1, self.frame_height_bits)
        if not self.reduced_still_picture_header:
            w.f(int(self.frame_id_numbers_present), 1)
            if self.frame_id_numbers_present:
                raise NotImplementedError("frame_id numbers")
        w.f(int(self.use_128x128_superblock), 1)
        w.f(int(self.enable_filter_intra), 1)
        w.f(int(self.enable_intra_edge_filter), 1)
        if not self.reduced_still_picture_header:
            w.f(int(self.enable_interintra_compound), 1)
            w.f(int(self.enable_masked_compound), 1)
            w.f(int(self.enable_warped_motion), 1)
            w.f(int(self.enable_dual_filter), 1)
            w.f(int(self.enable_order_hint), 1)
            if self.enable_order_hint:
                w.f(int(self.enable_jnt_comp), 1)
                w.f(int(self.enable_ref_frame_mvs), 1)
            if self.seq_force_screen_content_tools == 2:
                w.f(1, 1)
            else:
                w.f(0, 1)
                w.f(self.seq_force_screen_content_tools, 1)
            if self.seq_force_screen_content_tools > 0:
                if self.seq_force_integer_mv == 2:
                    w.f(1, 1)
                else:
                    w.f(0, 1)
                    w.f(self.seq_force_integer_mv, 1)
            if self.enable_order_hint:
                w.f(self.order_hint_bits - 1, 3)
        w.f(int(self.enable_superres), 1)
        w.f(int(self.enable_cdef), 1)
        w.f(int(self.enable_restoration), 1)
        # color_config
        w.f(int(self.high_bitdepth), 1)
        if self.profile == 2 and self.high_bitdepth:
            w.f(int(self.twelve_bit), 1)
        if self.profile != 1:
            w.f(int(self.monochrome), 1)
        w.f(int(self.color_description_present), 1)
        if self.color_description_present:
            w.f(self.color_primaries, 8)
            w.f(self.transfer_characteristics, 8)
            w.f(self.matrix_coefficients, 8)
        if self.monochrome:
            w.f(self.color_range, 1)
        else:
            # identity-matrix shortcut only for mc==0
            if self.matrix_coefficients == 0:
                raise NotImplementedError("MATRIX_COEFFICIENTS_IDENTITY")
            w.f(self.color_range, 1)
            if self.profile == 0:
                pass  # 420
            elif self.profile == 1:
                pass  # 444
            else:
                raise NotImplementedError("profile 2 subsampling")
            if self.subsampling_x and self.subsampling_y:
                w.f(self.chroma_sample_position, 2)
            w.f(int(self.separate_uv_delta_q), 1)
        w.f(int(self.film_grain_params_present), 1)

    @classmethod
    def read(cls, r: BitReader) -> "SequenceHeader":
        s = cls()
        s.profile = r.f(3)
        s.still_picture = bool(r.f(1))
        s.reduced_still_picture_header = bool(r.f(1))
        if s.reduced_still_picture_header:
            s.seq_level_idx = r.f(5)
        else:
            if r.f(1):
                raise NotImplementedError("timing_info")
            if r.f(1):
                raise NotImplementedError("initial_display_delay")
            op_cnt = r.f(5) + 1
            for i in range(op_cnt):
                idc = r.f(12)
                lvl = r.f(5)
                tier = r.f(1) if lvl > 7 else 0
                if i == 0:
                    s.operating_point_idc = idc
                    s.seq_level_idx = lvl
                    s.seq_tier = tier
        s.frame_width_bits = r.f(4) + 1
        s.frame_height_bits = r.f(4) + 1
        s.max_frame_width = r.f(s.frame_width_bits) + 1
        s.max_frame_height = r.f(s.frame_height_bits) + 1
        if not s.reduced_still_picture_header:
            s.frame_id_numbers_present = bool(r.f(1))
            if s.frame_id_numbers_present:
                s.delta_frame_id_length = r.f(4) + 2
                s.additional_frame_id_length = r.f(3) + 1
        s.use_128x128_superblock = bool(r.f(1))
        s.enable_filter_intra = bool(r.f(1))
        s.enable_intra_edge_filter = bool(r.f(1))
        if not s.reduced_still_picture_header:
            s.enable_interintra_compound = bool(r.f(1))
            s.enable_masked_compound = bool(r.f(1))
            s.enable_warped_motion = bool(r.f(1))
            s.enable_dual_filter = bool(r.f(1))
            s.enable_order_hint = bool(r.f(1))
            if s.enable_order_hint:
                s.enable_jnt_comp = bool(r.f(1))
                s.enable_ref_frame_mvs = bool(r.f(1))
            s.seq_force_screen_content_tools = 2 if r.f(1) else r.f(1)
            if s.seq_force_screen_content_tools > 0:
                s.seq_force_integer_mv = 2 if r.f(1) else r.f(1)
            else:
                s.seq_force_integer_mv = 2
            if s.enable_order_hint:
                s.order_hint_bits = r.f(3) + 1
        else:
            s.seq_force_screen_content_tools = 2
            s.seq_force_integer_mv = 2
        s.enable_superres = bool(r.f(1))
        s.enable_cdef = bool(r.f(1))
        s.enable_restoration = bool(r.f(1))
        s.high_bitdepth = bool(r.f(1))
        if s.profile == 2 and s.high_bitdepth:
            s.twelve_bit = bool(r.f(1))
        s.monochrome = bool(r.f(1)) if s.profile != 1 else False
        s.color_description_present = bool(r.f(1))
        if s.color_description_present:
            s.color_primaries = r.f(8)
            s.transfer_characteristics = r.f(8)
            s.matrix_coefficients = r.f(8)
        if s.monochrome:
            s.color_range = r.f(1)
            s.subsampling_x = s.subsampling_y = 1
        elif (s.color_primaries == 1 and s.transfer_characteristics == 13
              and s.matrix_coefficients == 0):
            s.subsampling_x = s.subsampling_y = 0
        else:
            s.color_range = r.f(1)
            if s.profile == 0:
                s.subsampling_x = s.subsampling_y = 1
            elif s.profile == 1:
                s.subsampling_x = s.subsampling_y = 0
            else:
                raise NotImplementedError("profile 2 subsampling")
            if s.subsampling_x and s.subsampling_y:
                s.chroma_sample_position = r.f(2)
        if not s.monochrome:
            s.separate_uv_delta_q = bool(r.f(1))
        s.film_grain_params_present = bool(r.f(1))
        return s


@dataclasses.dataclass
class TileInfo:
    uniform_spacing: bool = True
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    tile_cols: int = 1
    tile_rows: int = 1
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4
    # explicit col/row starts in SB units (uniform derives these)
    col_starts: list = dataclasses.field(default_factory=list)
    row_starts: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class QuantizationParams:
    base_q_idx: int = 0
    y_dc_delta_q: int = 0
    u_dc_delta_q: int = 0
    u_ac_delta_q: int = 0
    v_dc_delta_q: int = 0
    v_ac_delta_q: int = 0
    using_qmatrix: bool = False
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0


@dataclasses.dataclass
class LoopFilterParams:
    filter_level: tuple = (0, 0)
    filter_level_u: int = 0
    filter_level_v: int = 0
    sharpness: int = 0
    delta_enabled: bool = False
    delta_update: bool = False
    ref_deltas: tuple = (1, 0, 0, 0, -1, 0, -1, -1)
    mode_deltas: tuple = (0, 0)


@dataclasses.dataclass
class CdefParams:
    damping: int = 3
    bits: int = 0
    y_pri: list = dataclasses.field(default_factory=lambda: [0])
    y_sec: list = dataclasses.field(default_factory=lambda: [0])
    uv_pri: list = dataclasses.field(default_factory=lambda: [0])
    uv_sec: list = dataclasses.field(default_factory=lambda: [0])


@dataclasses.dataclass
class FrameHeader:
    frame_type: int = 0  # KEY
    show_frame: bool = True
    showable_frame: bool = False
    error_resilient_mode: bool = True
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    force_integer_mv: bool = False
    frame_size_override: bool = False
    order_hint: int = 0
    # inter-frame fields (read_uncompressed_header, decodeframe.c:4452)
    show_existing_frame: bool = False
    frame_to_show_map_idx: int = -1
    primary_ref_frame: int = PRIMARY_REF_NONE
    ref_frame_idx: list = dataclasses.field(default_factory=lambda: [0] * 7)
    allow_ref_frame_mvs: bool = False
    reference_select: bool = False
    skip_mode_present: bool = False
    skip_mode_frames: tuple = (-1, -1)
    allow_warped_motion: bool = False
    global_motion: list = None  # 8 WarpModel (index by ref frame 1..7)
    refresh_frame_context_backward: bool = False
    width: int = 0
    height: int = 0
    render_width: int = 0
    render_height: int = 0
    use_superres: bool = False
    superres_denom: int = 8
    upscaled_width: int = 0  # == width unless use_superres
    allow_intrabc: bool = False
    refresh_frame_flags: int = 0xFF
    allow_high_precision_mv: bool = False
    is_filter_switchable: bool = True
    interp_filter: int = 0
    is_motion_mode_switchable: bool = False
    disable_frame_end_update_cdf: bool = False
    tiles: TileInfo = dataclasses.field(default_factory=TileInfo)
    quant: QuantizationParams = dataclasses.field(
        default_factory=QuantizationParams)
    segmentation_enabled: bool = False
    delta_q_present: bool = False
    delta_q_res: int = 0
    delta_lf_present: bool = False
    delta_lf_res: int = 0
    delta_lf_multi: bool = False
    lf: LoopFilterParams = dataclasses.field(default_factory=LoopFilterParams)
    cdef: CdefParams = dataclasses.field(default_factory=CdefParams)
    lr_type: tuple = (0, 0, 0)  # RESTORE_NONE per plane
    lr_unit_shift: int = 0
    lr_uv_shift: int = 0
    tx_mode_select: bool = False
    reduced_tx_set: bool = False
    film_grain: FilmGrainParams = None

    @property
    def coded_lossless(self) -> bool:
        q = self.quant
        return (q.base_q_idx == 0 and q.y_dc_delta_q == 0
                and q.u_dc_delta_q == 0 and q.u_ac_delta_q == 0
                and q.v_dc_delta_q == 0 and q.v_ac_delta_q == 0)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def _read_delta_q(r: BitReader) -> int:
    return r.su(7) if r.f(1) else 0


def _write_delta_q(w: BitWriter, v: int) -> None:
    if v:
        w.f(1, 1)
        w.su(v, 7)
    else:
        w.f(0, 1)


def _derive_uniform_tiles(t: TileInfo, sb_cols: int, sb_rows: int) -> None:
    t.tile_cols = (sb_cols + (1 << t.tile_cols_log2) - 1) >> t.tile_cols_log2
    size_sb = (sb_cols + t.tile_cols - 1) // t.tile_cols
    # uniform spacing per spec: tileWidthSb = (sbCols + (1<<log2) - 1) >> log2
    tw = (sb_cols + (1 << t.tile_cols_log2) - 1) >> t.tile_cols_log2
    t.col_starts = list(range(0, sb_cols, tw)) + [sb_cols]
    t.tile_cols = len(t.col_starts) - 1
    th = (sb_rows + (1 << t.tile_rows_log2) - 1) >> t.tile_rows_log2
    t.row_starts = list(range(0, sb_rows, th)) + [sb_rows]
    t.tile_rows = len(t.row_starts) - 1
    del size_sb


def read_tile_info(r: BitReader, seq: SequenceHeader, width: int,
                   height: int) -> TileInfo:
    """tile_info() (spec 5.9.15; obu.c read_tile_info_max_tile)."""
    t = TileInfo()
    sb_shift = 7 if seq.use_128x128_superblock else 6
    sb_size_log2 = sb_shift
    mi_cols = (width + 7) >> 3 << 1
    mi_rows = (height + 7) >> 3 << 1
    sb_cols = (mi_cols + (1 << (sb_size_log2 - 2)) - 1) >> (sb_size_log2 - 2)
    sb_rows = (mi_rows + (1 << (sb_size_log2 - 2)) - 1) >> (sb_size_log2 - 2)
    sb_sz = 1 << (sb_size_log2 - 2)  # in MI units
    del sb_sz
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))

    t.uniform_spacing = bool(r.f(1))
    if t.uniform_spacing:
        t.tile_cols_log2 = min_log2_cols
        while t.tile_cols_log2 < max_log2_cols and r.f(1):
            t.tile_cols_log2 += 1
        min_log2_rows = max(min_log2_tiles - t.tile_cols_log2, 0)
        t.tile_rows_log2 = min_log2_rows
        while t.tile_rows_log2 < max_log2_rows and r.f(1):
            t.tile_rows_log2 += 1
        _derive_uniform_tiles(t, sb_cols, sb_rows)
    else:
        raise NotImplementedError("explicit tile spacing")
    if t.tile_cols_log2 > 0 or t.tile_rows_log2 > 0:
        t.context_update_tile_id = r.f(t.tile_rows_log2 + t.tile_cols_log2)
        t.tile_size_bytes = r.f(2) + 1
    return t


def write_tile_info(w: BitWriter, seq: SequenceHeader, t: TileInfo,
                    width: int, height: int) -> None:
    sb_size_log2 = 7 if seq.use_128x128_superblock else 6
    mi_cols = (width + 7) >> 3 << 1
    mi_rows = (height + 7) >> 3 << 1
    sb_cols = (mi_cols + (1 << (sb_size_log2 - 2)) - 1) >> (sb_size_log2 - 2)
    sb_rows = (mi_rows + (1 << (sb_size_log2 - 2)) - 1) >> (sb_size_log2 - 2)
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    assert t.uniform_spacing
    w.f(1, 1)
    assert t.tile_cols_log2 >= min_log2_cols
    for _ in range(t.tile_cols_log2 - min_log2_cols):
        w.f(1, 1)
    if t.tile_cols_log2 < max_log2_cols:
        w.f(0, 1)
    min_log2_rows = max(min_log2_tiles - t.tile_cols_log2, 0)
    assert t.tile_rows_log2 >= min_log2_rows
    for _ in range(t.tile_rows_log2 - min_log2_rows):
        w.f(1, 1)
    if t.tile_rows_log2 < max_log2_rows:
        w.f(0, 1)
    _derive_uniform_tiles(t, sb_cols, sb_rows)
    if t.tile_cols_log2 > 0 or t.tile_rows_log2 > 0:
        w.f(t.context_update_tile_id, t.tile_rows_log2 + t.tile_cols_log2)
        w.f(t.tile_size_bytes - 1, 2)


def _read_signed_refsubexpfin(r: BitReader, n: int, k: int, ref: int) -> int:
    """aom_rb_read_signed_primitive_refsubexpfin over raw header bits."""
    from ..ec.binary_codes import inv_recenter_finite_nonneg

    class _Rb:
        def read_bit(self):
            return r.f(1)

        def read_literal(self, bits):
            return r.f(bits)

    rb = _Rb()
    ref += n - 1
    n2 = 2 * n - 1
    # read_primitive_subexpfin over rb bits
    i = 0
    mk = 0
    v = None
    while True:
        b = (k + i - 1) if i else k
        a = 1 << b
        if n2 <= mk + 3 * a:
            # quniform
            nn = n2 - mk
            if nn <= 1:
                v = mk
                break
            length = nn.bit_length()
            m = (1 << length) - nn
            q = rb.read_literal(length - 1)
            v = (q if q < m else (q << 1) - m + rb.read_bit()) + mk
            break
        if not rb.read_bit():
            v = rb.read_literal(b) + mk
            break
        i += 1
        mk += a
    return inv_recenter_finite_nonneg(n2, ref, v) - n + 1


def _read_global_motion_params(r: BitReader, ref_params, allow_hp: bool):
    """read_global_motion_params (decodeframe.c:4264)."""
    from ..normative import mvref as MR
    typ = r.f(1)
    if typ != 0:
        if r.f(1):
            typ = MR.ROTZOOM
        else:
            typ = MR.TRANSLATION if r.f(1) else MR.AFFINE
    params = MR.WarpModel()
    params.wmtype = typ
    if typ >= MR.ROTZOOM:
        params.wmmat[2] = _read_signed_refsubexpfin(
            r, MR.GM_ALPHA_MAX + 1, MR.SUBEXPFIN_K,
            (ref_params.wmmat[2] >> MR.GM_ALPHA_PREC_DIFF)
            - (1 << MR.GM_ALPHA_PREC_BITS)) * MR.GM_ALPHA_DECODE_FACTOR \
            + (1 << MR.WARPEDMODEL_PREC_BITS)
        params.wmmat[3] = _read_signed_refsubexpfin(
            r, MR.GM_ALPHA_MAX + 1, MR.SUBEXPFIN_K,
            ref_params.wmmat[3] >> MR.GM_ALPHA_PREC_DIFF) \
            * MR.GM_ALPHA_DECODE_FACTOR
    if typ >= MR.AFFINE:
        params.wmmat[4] = _read_signed_refsubexpfin(
            r, MR.GM_ALPHA_MAX + 1, MR.SUBEXPFIN_K,
            ref_params.wmmat[4] >> MR.GM_ALPHA_PREC_DIFF) \
            * MR.GM_ALPHA_DECODE_FACTOR
        params.wmmat[5] = _read_signed_refsubexpfin(
            r, MR.GM_ALPHA_MAX + 1, MR.SUBEXPFIN_K,
            (ref_params.wmmat[5] >> MR.GM_ALPHA_PREC_DIFF)
            - (1 << MR.GM_ALPHA_PREC_BITS)) * MR.GM_ALPHA_DECODE_FACTOR \
            + (1 << MR.WARPEDMODEL_PREC_BITS)
    elif typ >= MR.ROTZOOM:
        params.wmmat[4] = -params.wmmat[3]
        params.wmmat[5] = params.wmmat[2]
    if typ >= MR.TRANSLATION:
        if typ == MR.TRANSLATION:
            trans_bits = MR.GM_ABS_TRANS_ONLY_BITS - (not allow_hp)
            trans_dec_factor = (MR.GM_TRANS_ONLY_DECODE_FACTOR
                                * (1 << (not allow_hp)))
            trans_prec_diff = MR.GM_TRANS_ONLY_PREC_DIFF + (not allow_hp)
        else:
            trans_bits = MR.GM_ABS_TRANS_BITS
            trans_dec_factor = MR.GM_TRANS_DECODE_FACTOR
            trans_prec_diff = MR.GM_TRANS_PREC_DIFF
        params.wmmat[0] = _read_signed_refsubexpfin(
            r, (1 << trans_bits) + 1, MR.SUBEXPFIN_K,
            ref_params.wmmat[0] >> trans_prec_diff) * trans_dec_factor
        params.wmmat[1] = _read_signed_refsubexpfin(
            r, (1 << trans_bits) + 1, MR.SUBEXPFIN_K,
            ref_params.wmmat[1] >> trans_prec_diff) * trans_dec_factor
    if typ >= MR.ROTZOOM:
        # the shear check (av1_get_shear_params) of a warped model; an
        # identity or translation model always passes it
        from ..errors import outside_the_port
        raise outside_the_port("non-translational global motion")
    return params


def read_frame_header(r: BitReader, seq: SequenceHeader,
                      ref_state=None) -> FrameHeader:
    """uncompressed_header() (spec 5.9.2; decodeframe.c:4452
    read_uncompressed_header). For inter frames ``ref_state`` supplies the
    decoder's reference-slot info: an object with ``slot_order_hint(idx)``,
    ``slot_size(idx)`` -> (upscaled_w, h, render_w, render_h),
    ``slot_global_motion(slot)`` and ``slot_frame_type(idx)``."""
    fh = FrameHeader()
    if not seq.reduced_still_picture_header:
        if r.f(1):
            fh.show_existing_frame = True
            fh.frame_to_show_map_idx = r.f(3)
            if seq.frame_id_numbers_present:
                raise NotImplementedError("frame ids")
            return fh
        fh.frame_type = r.f(2)
        fh.show_frame = bool(r.f(1))
        fh.showable_frame = fh.frame_type != 0
        if not fh.show_frame:
            fh.showable_frame = bool(r.f(1))
        if fh.frame_type == 3 or (fh.frame_type == 0 and fh.show_frame):
            fh.error_resilient_mode = True
        else:
            fh.error_resilient_mode = bool(r.f(1))
    else:
        fh.frame_type = 0
        fh.show_frame = True
    frame_is_intra = fh.frame_type in (0, 2)
    fh.disable_cdf_update = bool(r.f(1))
    if seq.seq_force_screen_content_tools == 2:
        fh.allow_screen_content_tools = bool(r.f(1))
    else:
        fh.allow_screen_content_tools = bool(seq.seq_force_screen_content_tools)
    if fh.allow_screen_content_tools:
        if seq.seq_force_integer_mv == 2:
            fh.force_integer_mv = bool(r.f(1))
        else:
            fh.force_integer_mv = bool(seq.seq_force_integer_mv)
    else:
        fh.force_integer_mv = False
    if frame_is_intra:
        fh.force_integer_mv = True
    if seq.frame_id_numbers_present:
        raise NotImplementedError("frame ids")
    if not seq.reduced_still_picture_header:
        fh.frame_size_override = bool(r.f(1))
        if seq.enable_order_hint:
            fh.order_hint = r.f(seq.order_hint_bits)
        if not fh.error_resilient_mode and not frame_is_intra:
            fh.primary_ref_frame = r.f(3)
    if fh.frame_type == 0:  # KEY
        fh.refresh_frame_flags = 0xFF if fh.show_frame else r.f(8)
    elif fh.frame_type == 2:  # INTRA_ONLY
        fh.refresh_frame_flags = r.f(8)
    else:
        fh.refresh_frame_flags = 0xFF if fh.frame_type == 3 else r.f(8)
    if (not frame_is_intra or fh.refresh_frame_flags != 0xFF) \
            and fh.error_resilient_mode and seq.enable_order_hint:
        for _ in range(8):
            r.f(seq.order_hint_bits)

    def frame_size():
        if fh.frame_size_override:
            fh.width = r.f(seq.frame_width_bits) + 1
            fh.height = r.f(seq.frame_height_bits) + 1
        else:
            fh.width = seq.max_frame_width
            fh.height = seq.max_frame_height
        fh.upscaled_width = fh.width
        superres_params()

    def superres_params():
        if seq.enable_superres:
            fh.use_superres = bool(r.f(1))
        if fh.use_superres:
            fh.superres_denom = r.f(SUPERRES_DENOM_BITS) + SUPERRES_DENOM_MIN
            fh.width = (fh.upscaled_width * SUPERRES_NUM
                        + fh.superres_denom // 2) // fh.superres_denom

    def render_size():
        if r.f(1):
            fh.render_width = r.f(16) + 1
            fh.render_height = r.f(16) + 1
        else:
            fh.render_width = fh.upscaled_width
            fh.render_height = fh.height

    if frame_is_intra:
        frame_size()
        render_size()
        if fh.allow_screen_content_tools and not fh.use_superres:
            fh.allow_intrabc = bool(r.f(1))
            if fh.allow_intrabc:
                raise NotImplementedError("intrabc")
    else:
        frame_refs_short_signaling = False
        if seq.enable_order_hint:
            frame_refs_short_signaling = bool(r.f(1))
        if frame_refs_short_signaling:
            raise NotImplementedError("frame_refs_short_signaling")
        for i in range(7):
            fh.ref_frame_idx[i] = r.f(3)
        if fh.frame_size_override and not fh.error_resilient_mode:
            # setup_frame_size_with_refs (decodeframe.c:1993)
            found = False
            for i in range(7):
                if r.f(1):
                    (fh.upscaled_width, fh.height, fh.render_width,
                     fh.render_height) = ref_state.slot_size(
                         fh.ref_frame_idx[i])
                    fh.width = fh.upscaled_width
                    superres_params()
                    found = True
                    break
            if not found:
                frame_size()
                render_size()
        else:
            frame_size()
            render_size()
        if fh.force_integer_mv:
            fh.allow_high_precision_mv = False
        else:
            fh.allow_high_precision_mv = bool(r.f(1))
        # read_frame_interp_filter
        fh.is_filter_switchable = bool(r.f(1))
        fh.interp_filter = 4 if fh.is_filter_switchable else r.f(2)
        fh.is_motion_mode_switchable = bool(r.f(1))
        if fh.error_resilient_mode or not seq.enable_ref_frame_mvs \
                or not seq.enable_order_hint:
            fh.allow_ref_frame_mvs = False
        else:
            fh.allow_ref_frame_mvs = bool(r.f(1))
    if seq.reduced_still_picture_header or fh.disable_cdf_update:
        fh.disable_frame_end_update_cdf = True
    else:
        fh.disable_frame_end_update_cdf = bool(r.f(1))
    fh.refresh_frame_context_backward = not fh.disable_frame_end_update_cdf
    fh.tiles = read_tile_info(r, seq, fh.width, fh.height)
    # quantization_params()
    q = fh.quant
    q.base_q_idx = r.f(8)
    q.y_dc_delta_q = _read_delta_q(r)
    if not seq.monochrome:
        diff_uv = bool(r.f(1)) if seq.separate_uv_delta_q else False
        q.u_dc_delta_q = _read_delta_q(r)
        q.u_ac_delta_q = _read_delta_q(r)
        if diff_uv:
            q.v_dc_delta_q = _read_delta_q(r)
            q.v_ac_delta_q = _read_delta_q(r)
        else:
            q.v_dc_delta_q = q.u_dc_delta_q
            q.v_ac_delta_q = q.u_ac_delta_q
    q.using_qmatrix = bool(r.f(1))
    if q.using_qmatrix:
        q.qm_y = r.f(4)
        q.qm_u = r.f(4)
        if not seq.separate_uv_delta_q:
            q.qm_v = q.qm_u
        else:
            q.qm_v = r.f(4)
    # segmentation_params()
    fh.segmentation_enabled = bool(r.f(1))
    if fh.segmentation_enabled:
        raise NotImplementedError("segmentation")
    # delta_q_params()
    if q.base_q_idx > 0:
        fh.delta_q_present = bool(r.f(1))
    if fh.delta_q_present:
        fh.delta_q_res = r.f(2)
    # delta_lf_params()
    if fh.delta_q_present:
        if not fh.allow_intrabc:
            fh.delta_lf_present = bool(r.f(1))
        if fh.delta_lf_present:
            fh.delta_lf_res = r.f(2)
            fh.delta_lf_multi = bool(r.f(1))
    coded_lossless = fh.coded_lossless and not fh.delta_q_present
    # loop_filter_params(); ref/mode deltas inherit from the primary ref
    # frame's saved values (decodeframe.c setup_loopfilter "if cm->prev_frame")
    lf = fh.lf
    if fh.primary_ref_frame != PRIMARY_REF_NONE and ref_state is not None:
        prev = ref_state.slot_lf_deltas(
            fh.ref_frame_idx[fh.primary_ref_frame])
        if prev is not None:
            lf.ref_deltas, lf.mode_deltas = tuple(prev[0]), tuple(prev[1])
    if not (coded_lossless or fh.allow_intrabc):
        l0 = r.f(6)
        l1 = r.f(6)
        lf.filter_level = (l0, l1)
        if not seq.monochrome and (l0 or l1):
            lf.filter_level_u = r.f(6)
            lf.filter_level_v = r.f(6)
        lf.sharpness = r.f(3)
        lf.delta_enabled = bool(r.f(1))
        if lf.delta_enabled:
            lf.delta_update = bool(r.f(1))
            if lf.delta_update:
                refs = list(lf.ref_deltas)
                modes = list(lf.mode_deltas)
                for i in range(8):
                    if r.f(1):
                        refs[i] = r.su(7)
                for i in range(2):
                    if r.f(1):
                        modes[i] = r.su(7)
                lf.ref_deltas = tuple(refs)
                lf.mode_deltas = tuple(modes)
    # cdef_params()
    if seq.enable_cdef and not coded_lossless and not fh.allow_intrabc:
        c = fh.cdef
        c.damping = r.f(2) + 3
        c.bits = r.f(2)
        n = 1 << c.bits
        c.y_pri, c.y_sec, c.uv_pri, c.uv_sec = [], [], [], []
        for _ in range(n):
            c.y_pri.append(r.f(4))
            c.y_sec.append(r.f(2))
            if not seq.monochrome:
                c.uv_pri.append(r.f(4))
                c.uv_sec.append(r.f(2))
    # lr_params()
    all_lossless = coded_lossless  # (no superres)
    if seq.enable_restoration and not all_lossless and not fh.allow_intrabc:
        kinds = []
        uses_lr = False
        uses_chroma_lr = False
        nplanes = 1 if seq.monochrome else 3
        for p in range(nplanes):
            k = r.f(2)
            kinds.append(k)
            if k:
                uses_lr = True
                if p:
                    uses_chroma_lr = True
        fh.lr_type = tuple(kinds + [0] * (3 - len(kinds)))
        if uses_lr:
            if seq.use_128x128_superblock:
                fh.lr_unit_shift = r.f(1) + 1
            else:
                fh.lr_unit_shift = r.f(1)
                if fh.lr_unit_shift:
                    fh.lr_unit_shift += r.f(1)
            if seq.subsampling_x and seq.subsampling_y and uses_chroma_lr:
                fh.lr_uv_shift = r.f(1)
    # read_tx_mode()
    if coded_lossless:
        fh.tx_mode_select = False
    else:
        fh.tx_mode_select = bool(r.f(1))
    # frame_reference_mode (decodeframe.c:133)
    if not frame_is_intra:
        fh.reference_select = bool(r.f(1))
        # skip_mode_params: av1_setup_skip_mode_allowed (mvref_common.c)
        allowed, pair = _skip_mode_allowed(fh, seq, ref_state)
        fh.skip_mode_frames = pair
        fh.skip_mode_present = bool(r.f(1)) if allowed else False
        if (not fh.error_resilient_mode and seq.enable_warped_motion):
            fh.allow_warped_motion = bool(r.f(1))
    fh.reduced_tx_set = bool(r.f(1))
    if not frame_is_intra:
        # global motion params per ref frame (decodeframe.c:4336); reference
        # params come from the primary ref frame's saved models
        from ..normative import mvref as MR
        fh.global_motion = [MR.WarpModel() for _ in range(8)]
        for frame in range(1, 8):
            if fh.primary_ref_frame != PRIMARY_REF_NONE and \
                    ref_state is not None:
                prev = ref_state.slot_global_motion(
                    fh.ref_frame_idx[fh.primary_ref_frame])
                ref_params = prev[frame] if prev else MR.WarpModel()
            else:
                ref_params = MR.WarpModel()
            fh.global_motion[frame] = _read_global_motion_params(
                r, ref_params, fh.allow_high_precision_mv)
    if seq.film_grain_params_present and (fh.show_frame or fh.showable_frame):
        fh.film_grain = read_film_grain_params(r, seq, fh)
    return fh


def _skip_mode_allowed(fh: FrameHeader, seq: SequenceHeader, ref_state):
    """av1_setup_skip_mode_allowed: nearest fwd+bwd (or two fwd) refs."""
    if not seq.enable_order_hint or fh.frame_type in (0, 2) \
            or not fh.reference_select:
        return False, (-1, -1)
    from ..normative.mvref import get_relative_dist
    bits = seq.order_hint_bits
    cur = fh.order_hint

    def dist(a, b):
        return get_relative_dist(True, bits, a, b)

    ref_hints = [ref_state.slot_order_hint(fh.ref_frame_idx[i])
                 for i in range(7)]
    fwd, bwd = -1, -1
    fwd_hint, bwd_hint = -1, 1 << 30
    for i, h in enumerate(ref_hints):
        if h is None:
            continue
        if dist(h, cur) < 0:
            if fwd == -1 or dist(h, fwd_hint) > 0:
                fwd, fwd_hint = i, h
        elif dist(h, cur) > 0:
            if bwd == -1 or dist(h, bwd_hint) < 0:
                bwd, bwd_hint = i, h
    if fwd >= 0 and bwd >= 0:
        return True, (min(fwd, bwd), max(fwd, bwd))
    if fwd >= 0:
        snd, snd_hint = -1, -1
        for i, h in enumerate(ref_hints):
            if h is None:
                continue
            if dist(h, fwd_hint) < 0 and (snd == -1 or dist(h, snd_hint) > 0):
                snd, snd_hint = i, h
        if snd >= 0:
            return True, (min(fwd, snd), max(fwd, snd))
    return False, (-1, -1)


def read_film_grain_params(r: BitReader, seq: SequenceHeader,
                           fh: FrameHeader) -> FilmGrainParams:
    """film_grain_params() (spec 5.9.30; av1_read_film_grain_params
    decodeframe.c:3870). Intra frames always update parameters."""
    p = FilmGrainParams(bit_depth=seq.bit_depth)
    p.apply_grain = r.f(1)
    if not p.apply_grain:
        return p
    p.random_seed = r.f(16)
    if fh.frame_type == 1:  # INTER
        p.update_parameters = r.f(1)
    else:
        p.update_parameters = 1
    if not p.update_parameters:
        raise NotImplementedError("film grain params ref inheritance")
    p.num_y_points = r.f(4)
    p.scaling_points_y = np.zeros((14, 2), np.int64)
    for i in range(p.num_y_points):
        p.scaling_points_y[i, 0] = r.f(8)
        p.scaling_points_y[i, 1] = r.f(8)
    p.chroma_scaling_from_luma = 0 if seq.monochrome else r.f(1)
    p.scaling_points_cb = np.zeros((10, 2), np.int64)
    p.scaling_points_cr = np.zeros((10, 2), np.int64)
    if (seq.monochrome or p.chroma_scaling_from_luma
            or (seq.subsampling_x == 1 and seq.subsampling_y == 1
                and p.num_y_points == 0)):
        p.num_cb_points = p.num_cr_points = 0
    else:
        p.num_cb_points = r.f(4)
        for i in range(p.num_cb_points):
            p.scaling_points_cb[i, 0] = r.f(8)
            p.scaling_points_cb[i, 1] = r.f(8)
        p.num_cr_points = r.f(4)
        for i in range(p.num_cr_points):
            p.scaling_points_cr[i, 0] = r.f(8)
            p.scaling_points_cr[i, 1] = r.f(8)
    p.scaling_shift = r.f(2) + 8
    p.ar_coeff_lag = r.f(2)
    num_pos_luma = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    num_pos_chroma = num_pos_luma + (1 if p.num_y_points > 0 else 0)
    p.ar_coeffs_y = np.zeros(24, np.int64)
    p.ar_coeffs_cb = np.zeros(25, np.int64)
    p.ar_coeffs_cr = np.zeros(25, np.int64)
    if p.num_y_points:
        for i in range(num_pos_luma):
            p.ar_coeffs_y[i] = r.f(8) - 128
    if p.num_cb_points or p.chroma_scaling_from_luma:
        for i in range(num_pos_chroma):
            p.ar_coeffs_cb[i] = r.f(8) - 128
    if p.num_cr_points or p.chroma_scaling_from_luma:
        for i in range(num_pos_chroma):
            p.ar_coeffs_cr[i] = r.f(8) - 128
    p.ar_coeff_shift = r.f(2) + 6
    p.grain_scale_shift = r.f(2)
    if p.num_cb_points:
        p.cb_mult = r.f(8)
        p.cb_luma_mult = r.f(8)
        p.cb_offset = r.f(9)
    if p.num_cr_points:
        p.cr_mult = r.f(8)
        p.cr_luma_mult = r.f(8)
        p.cr_offset = r.f(9)
    p.overlap_flag = r.f(1)
    p.clip_to_restricted_range = r.f(1)
    return p


def write_film_grain_params(w: BitWriter, seq: SequenceHeader,
                            fh: FrameHeader, p: FilmGrainParams) -> None:
    """Mirror of read_film_grain_params (av1/encoder/bitstream.c
    write_film_grain_params)."""
    w.f(int(p.apply_grain), 1)
    if not p.apply_grain:
        return
    w.f(p.random_seed, 16)
    if fh.frame_type == 1:
        w.f(int(p.update_parameters), 1)
    assert p.update_parameters or fh.frame_type == 1
    if not p.update_parameters:
        raise NotImplementedError("film grain params ref inheritance")
    w.f(p.num_y_points, 4)
    for i in range(p.num_y_points):
        w.f(int(p.scaling_points_y[i, 0]), 8)
        w.f(int(p.scaling_points_y[i, 1]), 8)
    if not seq.monochrome:
        w.f(int(p.chroma_scaling_from_luma), 1)
    if not (seq.monochrome or p.chroma_scaling_from_luma
            or (seq.subsampling_x == 1 and seq.subsampling_y == 1
                and p.num_y_points == 0)):
        w.f(p.num_cb_points, 4)
        for i in range(p.num_cb_points):
            w.f(int(p.scaling_points_cb[i, 0]), 8)
            w.f(int(p.scaling_points_cb[i, 1]), 8)
        w.f(p.num_cr_points, 4)
        for i in range(p.num_cr_points):
            w.f(int(p.scaling_points_cr[i, 0]), 8)
            w.f(int(p.scaling_points_cr[i, 1]), 8)
    w.f(p.scaling_shift - 8, 2)
    w.f(p.ar_coeff_lag, 2)
    num_pos_luma = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    num_pos_chroma = num_pos_luma + (1 if p.num_y_points > 0 else 0)
    if p.num_y_points:
        for i in range(num_pos_luma):
            w.f(int(p.ar_coeffs_y[i]) + 128, 8)
    if p.num_cb_points or p.chroma_scaling_from_luma:
        for i in range(num_pos_chroma):
            w.f(int(p.ar_coeffs_cb[i]) + 128, 8)
    if p.num_cr_points or p.chroma_scaling_from_luma:
        for i in range(num_pos_chroma):
            w.f(int(p.ar_coeffs_cr[i]) + 128, 8)
    w.f(p.ar_coeff_shift - 6, 2)
    w.f(p.grain_scale_shift, 2)
    if p.num_cb_points:
        w.f(p.cb_mult, 8)
        w.f(p.cb_luma_mult, 8)
        w.f(p.cb_offset, 9)
    if p.num_cr_points:
        w.f(p.cr_mult, 8)
        w.f(p.cr_luma_mult, 8)
        w.f(p.cr_offset, 9)
    w.f(int(p.overlap_flag), 1)
    w.f(int(p.clip_to_restricted_range), 1)


def write_frame_header(w: BitWriter, seq: SequenceHeader,
                       fh: FrameHeader) -> None:
    if not seq.reduced_still_picture_header:
        if fh.show_existing_frame:
            # display a previously-coded showable frame (ARF display
            # position, spec 5.9.2; no frame-id numbers / film grain in
            # our sequence headers, so the header is just the map idx)
            w.f(1, 1)
            w.f(fh.frame_to_show_map_idx, 3)
            return
        w.f(0, 1)  # show_existing_frame
        w.f(fh.frame_type, 2)
        w.f(int(fh.show_frame), 1)
        if not fh.show_frame:
            w.f(int(fh.showable_frame), 1)
        if not (fh.frame_type == 3 or (fh.frame_type == 0 and fh.show_frame)):
            w.f(int(fh.error_resilient_mode), 1)
    frame_is_intra = fh.frame_type in (0, 2)
    w.f(int(fh.disable_cdf_update), 1)
    if seq.seq_force_screen_content_tools == 2:
        w.f(int(fh.allow_screen_content_tools), 1)
    if fh.allow_screen_content_tools and seq.seq_force_integer_mv == 2:
        w.f(int(fh.force_integer_mv), 1)
    if not seq.reduced_still_picture_header:
        w.f(int(fh.frame_size_override), 1)
    if seq.enable_order_hint:
        w.f(fh.order_hint, seq.order_hint_bits)
    if not seq.reduced_still_picture_header and not fh.error_resilient_mode \
            and not frame_is_intra:
        w.f(fh.primary_ref_frame, 3)
    if fh.frame_type == 2:
        w.f(fh.refresh_frame_flags, 8)
    elif fh.frame_type == 1:
        w.f(fh.refresh_frame_flags, 8)
    if (not frame_is_intra or fh.refresh_frame_flags != 0xFF) \
            and fh.error_resilient_mode and seq.enable_order_hint:
        for _ in range(8):
            w.f(0, seq.order_hint_bits)
    if not frame_is_intra:
        if seq.enable_order_hint:
            w.f(0, 1)  # frame_refs_short_signaling
        for i in range(7):
            w.f(fh.ref_frame_idx[i], 3)
        if fh.frame_size_override and not fh.error_resilient_mode:
            raise NotImplementedError("frame size with refs write")
    if fh.frame_size_override:
        w.f((fh.upscaled_width or fh.width) - 1, seq.frame_width_bits)
        w.f(fh.height - 1, seq.frame_height_bits)
    if seq.enable_superres:
        w.f(int(fh.use_superres), 1)
        if fh.use_superres:
            w.f(fh.superres_denom - SUPERRES_DENOM_MIN, SUPERRES_DENOM_BITS)
    w.f(0, 1)  # render_and_frame_size_different
    if frame_is_intra:
        if fh.allow_screen_content_tools and not fh.use_superres:
            w.f(int(fh.allow_intrabc), 1)
    else:
        if not fh.force_integer_mv:
            w.f(int(fh.allow_high_precision_mv), 1)
        w.f(int(fh.is_filter_switchable), 1)
        if not fh.is_filter_switchable:
            w.f(fh.interp_filter, 2)
        w.f(int(fh.is_motion_mode_switchable), 1)
        if not fh.error_resilient_mode and seq.enable_ref_frame_mvs \
                and seq.enable_order_hint:
            w.f(int(fh.allow_ref_frame_mvs), 1)
    if not (seq.reduced_still_picture_header or fh.disable_cdf_update):
        w.f(int(fh.disable_frame_end_update_cdf), 1)
    write_tile_info(w, seq, fh.tiles, fh.width, fh.height)
    q = fh.quant
    w.f(q.base_q_idx, 8)
    _write_delta_q(w, q.y_dc_delta_q)
    if not seq.monochrome:
        if seq.separate_uv_delta_q:
            diff = (q.v_dc_delta_q != q.u_dc_delta_q
                    or q.v_ac_delta_q != q.u_ac_delta_q)
            w.f(int(diff), 1)
        else:
            diff = False
        _write_delta_q(w, q.u_dc_delta_q)
        _write_delta_q(w, q.u_ac_delta_q)
        if diff:
            _write_delta_q(w, q.v_dc_delta_q)
            _write_delta_q(w, q.v_ac_delta_q)
    w.f(int(q.using_qmatrix), 1)
    assert not q.using_qmatrix
    w.f(int(fh.segmentation_enabled), 1)
    assert not fh.segmentation_enabled
    if q.base_q_idx > 0:
        w.f(int(fh.delta_q_present), 1)
    if fh.delta_q_present:
        w.f(fh.delta_q_res, 2)
        if not fh.allow_intrabc:
            w.f(int(fh.delta_lf_present), 1)
        if fh.delta_lf_present:
            w.f(fh.delta_lf_res, 2)
            w.f(int(fh.delta_lf_multi), 1)
    coded_lossless = fh.coded_lossless and not fh.delta_q_present
    lf = fh.lf
    if not (coded_lossless or fh.allow_intrabc):
        w.f(lf.filter_level[0], 6)
        w.f(lf.filter_level[1], 6)
        if not seq.monochrome and (lf.filter_level[0] or lf.filter_level[1]):
            w.f(lf.filter_level_u, 6)
            w.f(lf.filter_level_v, 6)
        w.f(lf.sharpness, 3)
        w.f(int(lf.delta_enabled), 1)
        if lf.delta_enabled:
            w.f(int(lf.delta_update), 1)
            assert not lf.delta_update
    if seq.enable_cdef and not coded_lossless and not fh.allow_intrabc:
        c = fh.cdef
        w.f(c.damping - 3, 2)
        w.f(c.bits, 2)
        for i in range(1 << c.bits):
            w.f(c.y_pri[i], 4)
            w.f(c.y_sec[i], 2)
            if not seq.monochrome:
                w.f(c.uv_pri[i], 4)
                w.f(c.uv_sec[i], 2)
    if seq.enable_restoration and not coded_lossless and not fh.allow_intrabc:
        nplanes = 1 if seq.monochrome else 3
        uses_lr = any(fh.lr_type[:nplanes])
        uses_chroma_lr = any(fh.lr_type[1:nplanes])
        for p in range(nplanes):
            w.f(fh.lr_type[p], 2)
        if uses_lr:
            if seq.use_128x128_superblock:
                w.f(fh.lr_unit_shift - 1, 1)
            else:
                w.f(min(fh.lr_unit_shift, 1), 1)
                if fh.lr_unit_shift:
                    w.f(fh.lr_unit_shift - 1, 1)
            if seq.subsampling_x and seq.subsampling_y and uses_chroma_lr:
                w.f(fh.lr_uv_shift, 1)
    if not coded_lossless:
        w.f(int(fh.tx_mode_select), 1)
    if not frame_is_intra:
        w.f(int(fh.reference_select), 1)
        # skip_mode_params: with order hints disabled or reference_select
        # off, skip mode is never allowed -> no bit (av1_setup_skip_mode_allowed)
        if seq.enable_order_hint and fh.reference_select:
            raise NotImplementedError("skip-mode-present write")
        if not fh.error_resilient_mode and seq.enable_warped_motion:
            w.f(int(fh.allow_warped_motion), 1)
    w.f(int(fh.reduced_tx_set), 1)
    if not frame_is_intra:
        # global motion params: identity models only on the write side
        for frame in range(1, 8):
            gm = fh.global_motion[frame] if fh.global_motion else None
            assert gm is None or gm.wmtype == 0, "non-identity GM write"
            w.f(0, 1)  # is_global
    if seq.film_grain_params_present and (fh.show_frame or fh.showable_frame):
        write_film_grain_params(w, seq, fh,
                                fh.film_grain or FilmGrainParams(
                                    apply_grain=0, bit_depth=seq.bit_depth))
