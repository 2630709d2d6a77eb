"""Motion vector prediction: the reference-MV stack, temporal (TPL) MV
projection, global-motion MV derivation and skip-mode pair selection.

Reimplements ``av1/common/mvref_common.c`` (setup_ref_mv_list :474,
av1_find_mv_refs :786, motion_field_projection :911, av1_setup_motion_field
:1006, av1_setup_skip_mode_allowed) and the ``mv.h`` helpers
(gm_get_motion_vector :249, lower_mv_precision, clamp_mv_ref).

Decoder and encoder share this module; it operates on an object grid of
``MbInfo`` records (one shared instance per coded block, mirroring the C
``mi_grid_base`` pointer sharing).
"""
from __future__ import annotations

import numpy as np

from .blocks import MI_W, MI_H

# ---- constants (av1/common/mv.h, mvref_common.h, enums.h) ----
NONE_FRAME = -1
INTRA_FRAME = 0
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7
REF_FRAMES = 8
INTER_REFS_PER_FRAME = 7
FWD_REFS = 4
BWD_REFS = 3
MODE_CTX_REF_FRAMES = REF_FRAMES + FWD_REFS * BWD_REFS + 9  # + unidir comps

MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
REF_CAT_LEVEL = 640
MVREF_ROW_COLS = 3
MV_BORDER = 16 << 3
MV_LOW = -(1 << 15) + 1  # spec: mv in (-2^15+1, 2^15-1)... (mv.h MV_LOW)
MV_UPP = (1 << 15) - 1
INVALID_MV = 1 << 31
REFMVS_LIMIT = (1 << 12) - 1
MAX_FRAME_DISTANCE = 31
MFMV_STACK_SIZE = 3

NEWMV_CTX_MASK = (1 << 3) - 1
GLOBALMV_OFFSET = 3
GLOBALMV_CTX_MASK = (1 << (4 - 3)) - 1  # 1 (mvref_common.h)
REFMV_OFFSET = 4
REFMV_CTX_MASK = (1 << 4) - 1
COMP_NEWMV_CTXS = 5

# prediction modes (enums.h) - inter portion
NEARESTMV = 13
NEARMV = 14
GLOBALMV = 15
NEWMV = 16
NEAREST_NEARESTMV = 17
NEAR_NEARMV = 18
NEAREST_NEWMV = 19
NEW_NEARESTMV = 20
NEAR_NEWMV = 21
NEW_NEARMV = 22
GLOBAL_GLOBALMV = 23
NEW_NEWMV = 24

# warp model types
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = 0, 1, 2, 3
WARPEDMODEL_PREC_BITS = 16
GM_TRANS_PREC_BITS = 6
GM_ABS_TRANS_BITS = 12
GM_ABS_TRANS_ONLY_BITS = GM_ABS_TRANS_BITS - GM_TRANS_PREC_BITS + 3
GM_TRANS_PREC_DIFF = WARPEDMODEL_PREC_BITS - GM_TRANS_PREC_BITS
GM_TRANS_ONLY_PREC_DIFF = WARPEDMODEL_PREC_BITS - 3
GM_TRANS_DECODE_FACTOR = 1 << GM_TRANS_PREC_DIFF
GM_TRANS_ONLY_DECODE_FACTOR = 1 << GM_TRANS_ONLY_PREC_DIFF
GM_ALPHA_PREC_BITS = 15
GM_ABS_ALPHA_BITS = 12
GM_ALPHA_PREC_DIFF = WARPEDMODEL_PREC_BITS - GM_ALPHA_PREC_BITS
GM_ALPHA_DECODE_FACTOR = 1 << GM_ALPHA_PREC_DIFF
GM_ALPHA_MAX = 1 << GM_ABS_ALPHA_BITS
SUBEXPFIN_K = 3

# div_mult table for mv projection (mvref_common.c:19)
DIV_MULT = [0, 16384, 8192, 5461, 4096, 3276, 2730, 2340,
            2048, 1820, 1638, 1489, 1365, 1260, 1170, 1092,
            1024, 963, 910, 862, 819, 780, 744, 712,
            682, 655, 630, 606, 585, 564, 546, 528]

# compound ref pair map (mvref_common.h ref_frame_map)
REF_FRAME_PAIR_MAP = [
    (LAST_FRAME, BWDREF_FRAME), (LAST2_FRAME, BWDREF_FRAME),
    (LAST3_FRAME, BWDREF_FRAME), (GOLDEN_FRAME, BWDREF_FRAME),
    (LAST_FRAME, ALTREF2_FRAME), (LAST2_FRAME, ALTREF2_FRAME),
    (LAST3_FRAME, ALTREF2_FRAME), (GOLDEN_FRAME, ALTREF2_FRAME),
    (LAST_FRAME, ALTREF_FRAME), (LAST2_FRAME, ALTREF_FRAME),
    (LAST3_FRAME, ALTREF_FRAME), (GOLDEN_FRAME, ALTREF_FRAME),
    (LAST_FRAME, LAST2_FRAME), (LAST_FRAME, LAST3_FRAME),
    (LAST_FRAME, GOLDEN_FRAME), (BWDREF_FRAME, ALTREF_FRAME),
    (LAST2_FRAME, LAST3_FRAME), (LAST2_FRAME, GOLDEN_FRAME),
    (LAST3_FRAME, GOLDEN_FRAME), (BWDREF_FRAME, ALTREF2_FRAME),
    (ALTREF2_FRAME, ALTREF_FRAME),
]

COMPOUND_MODE_CTX_MAP = [
    [0, 1, 1, 1, 1],
    [1, 2, 3, 4, 4],
    [4, 4, 5, 6, 7],
]


class WarpModel:
    """WarpedMotionParams (mv.h:130)."""
    __slots__ = ("wmtype", "wmmat", "invalid",
                 "alpha", "beta", "gamma", "delta")

    def __init__(self):
        self.wmtype = IDENTITY
        self.wmmat = [0, 0, 1 << WARPEDMODEL_PREC_BITS, 0,
                      0, 1 << WARPEDMODEL_PREC_BITS]
        self.invalid = False
        self.alpha = self.beta = self.gamma = self.delta = 0

    def copy(self):
        w = WarpModel()
        w.wmtype = self.wmtype
        w.wmmat = list(self.wmmat)
        w.invalid = self.invalid
        w.alpha, w.beta = self.alpha, self.beta
        w.gamma, w.delta = self.gamma, self.delta
        return w


class MbInfo:
    """Per-coded-block mode info (MB_MODE_INFO subset the normative decode
    path needs). One instance is shared by every mi cell the block covers."""
    __slots__ = (
        "bsize", "mode", "uv_mode", "angle_y", "angle_uv", "filter_intra",
        "cfl_idx", "cfl_signs", "partition", "segment_id",
        "skip_txfm", "skip_mode", "ref_frame", "mv", "ref_mv_idx",
        "interp_y", "interp_x", "motion_mode", "use_intrabc",
        "comp_group_idx", "compound_idx", "comp_type", "wedge_index",
        "wedge_sign", "mask_type", "interintra_mode", "use_wedge_interintra",
        "interintra_wedge_index", "tx_size", "num_proj_ref", "wm_params",
        "mi_row", "mi_col", "current_qindex", "palette_sizes")

    def __init__(self):
        self.bsize = 0
        self.mode = 0
        self.uv_mode = 0
        self.angle_y = 0
        self.angle_uv = 0
        self.filter_intra = -1
        self.cfl_idx = 0
        self.cfl_signs = 0
        self.partition = 0
        self.segment_id = 0
        self.skip_txfm = 0
        self.skip_mode = 0
        self.ref_frame = [INTRA_FRAME, NONE_FRAME]
        self.mv = [(0, 0), (0, 0)]  # (row, col) 1/8-pel
        self.ref_mv_idx = 0
        self.interp_y = 0
        self.interp_x = 0
        self.motion_mode = 0
        self.use_intrabc = 0
        self.comp_group_idx = 0
        self.compound_idx = 1
        self.comp_type = 0  # COMPOUND_AVERAGE
        self.wedge_index = 0
        self.wedge_sign = 0
        self.mask_type = 0
        self.interintra_mode = 0
        self.use_wedge_interintra = 0
        self.interintra_wedge_index = 0
        self.tx_size = 0
        self.num_proj_ref = 0
        self.wm_params = None
        self.mi_row = 0
        self.mi_col = 0
        self.current_qindex = 0
        self.palette_sizes = (0, 0)

    @property
    def is_inter(self) -> bool:
        return self.use_intrabc or self.ref_frame[0] > INTRA_FRAME

    @property
    def is_compound(self) -> bool:
        return self.ref_frame[1] > INTRA_FRAME


def get_relative_dist(enable_order_hint: bool, bits: int, a: int,
                      b: int) -> int:
    if not enable_order_hint:
        return 0
    diff = a - b
    m = 1 << (bits - 1)
    return (diff & (m - 1)) - (diff & m)


def lower_mv_precision(mv, allow_hp: bool, is_integer: bool):
    row, col = mv
    if is_integer:
        def integer_prec(v):
            mod = int(np.fmod(v, 8))  # C % (truncation)
            if mod != 0:
                v -= mod
                if abs(mod) > 4:
                    v += 8 if mod > 0 else -8
            return v
        return (integer_prec(row), integer_prec(col))
    if not allow_hp:
        if row & 1:
            row += -1 if row > 0 else 1
        if col & 1:
            col += -1 if col > 0 else 1
    return (row, col)


def clamp(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def clamp_mv_ref(mv, bw_px: int, bh_px: int, xd) -> tuple:
    lo_col = xd.mb_to_left_edge - (bw_px << 3) - MV_BORDER
    hi_col = xd.mb_to_right_edge + (bw_px << 3) + MV_BORDER
    lo_row = xd.mb_to_top_edge - (bh_px << 3) - MV_BORDER
    hi_row = xd.mb_to_bottom_edge + (bh_px << 3) + MV_BORDER
    return (clamp(mv[0], lo_row, hi_row), clamp(mv[1], lo_col, hi_col))


def get_uni_comp_ref_idx(rf) -> int:
    if rf[1] <= INTRA_FRAME:
        return -1
    if rf[0] < BWDREF_FRAME and rf[1] >= BWDREF_FRAME:
        return -1
    uni = [(BWDREF_FRAME, ALTREF_FRAME), (LAST_FRAME, LAST2_FRAME),
           (LAST_FRAME, LAST3_FRAME), (LAST_FRAME, GOLDEN_FRAME)]
    # TOTAL_UNIDIR_COMP_REFS order: comp_ref0/comp_ref1 lookup
    uni_pairs = [(LAST_FRAME, LAST2_FRAME), (LAST_FRAME, LAST3_FRAME),
                 (LAST_FRAME, GOLDEN_FRAME), (BWDREF_FRAME, ALTREF_FRAME),
                 (LAST2_FRAME, LAST3_FRAME), (LAST2_FRAME, GOLDEN_FRAME),
                 (LAST3_FRAME, GOLDEN_FRAME), (LAST2_FRAME, ALTREF_FRAME),
                 (LAST3_FRAME, ALTREF_FRAME)]
    del uni
    for idx, (r0, r1) in enumerate(uni_pairs):
        if rf[0] == r0 and rf[1] == r1:
            return idx
    return -1


def av1_ref_frame_type(rf) -> int:
    if rf[1] > INTRA_FRAME:
        uni = get_uni_comp_ref_idx(rf)
        if uni >= 0:
            return REF_FRAMES + FWD_REFS * BWD_REFS + uni
        return (REF_FRAMES + (rf[0] - LAST_FRAME)
                + (rf[1] - BWDREF_FRAME) * FWD_REFS)
    return rf[0]


def av1_set_ref_frame(ref_frame_type: int):
    if ref_frame_type >= REF_FRAMES:
        return list(REF_FRAME_PAIR_MAP[ref_frame_type - REF_FRAMES])
    return [ref_frame_type, NONE_FRAME]


def mode_context_analyzer(mode_context, rf) -> int:
    ref_frame = av1_ref_frame_type(rf)
    if rf[1] <= INTRA_FRAME:
        return mode_context[ref_frame]
    newmv_ctx = mode_context[ref_frame] & NEWMV_CTX_MASK
    refmv_ctx = (mode_context[ref_frame] >> REFMV_OFFSET) & REFMV_CTX_MASK
    return COMPOUND_MODE_CTX_MAP[refmv_ctx >> 1][min(newmv_ctx,
                                                     COMP_NEWMV_CTXS - 1)]


def drl_ctx(ref_mv_weight, ref_idx: int) -> int:
    a = ref_mv_weight[ref_idx] >= REF_CAT_LEVEL
    b = ref_mv_weight[ref_idx + 1] >= REF_CAT_LEVEL
    if a and b:
        return 0
    if a and not b:
        return 1
    if not a and not b:
        return 2
    return 0


def have_newmv_in_inter_mode(mode: int) -> bool:
    return mode in (NEWMV, NEW_NEWMV, NEAREST_NEWMV, NEW_NEARESTMV,
                    NEAR_NEWMV, NEW_NEARMV)


def have_nearmv_in_inter_mode(mode: int) -> bool:
    return mode in (NEARMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV)


def is_inter_compound_mode(mode: int) -> bool:
    return NEAREST_NEARESTMV <= mode <= NEW_NEWMV


def compound_ref0_mode(mode: int) -> int:
    m = {NEAREST_NEARESTMV: NEARESTMV, NEAR_NEARMV: NEARMV,
         NEAREST_NEWMV: NEARESTMV, NEW_NEARESTMV: NEWMV,
         NEAR_NEWMV: NEARMV, NEW_NEARMV: NEWMV,
         GLOBAL_GLOBALMV: GLOBALMV, NEW_NEWMV: NEWMV}
    return m.get(mode, mode)


def compound_ref1_mode(mode: int) -> int:
    m = {NEAREST_NEARESTMV: NEARESTMV, NEAR_NEARMV: NEARMV,
         NEAREST_NEWMV: NEWMV, NEW_NEARESTMV: NEARESTMV,
         NEAR_NEWMV: NEWMV, NEW_NEARMV: NEARMV,
         GLOBAL_GLOBALMV: GLOBALMV, NEW_NEWMV: NEWMV}
    return m.get(mode, -1)


def round2s(v: int, bits: int) -> int:
    """ROUND_POWER_OF_TWO_SIGNED."""
    if v < 0:
        return -((-v + (1 << (bits - 1))) >> bits)
    return (v + (1 << (bits - 1))) >> bits


def convert_to_trans_prec(allow_hp: bool, coor: int) -> int:
    if allow_hp:
        return round2s(coor, WARPEDMODEL_PREC_BITS - 3)
    return round2s(coor, WARPEDMODEL_PREC_BITS - 2) * 2


def gm_get_motion_vector(gm: WarpModel, allow_hp: bool, bsize: int,
                         mi_col: int, mi_row: int,
                         is_integer: bool) -> tuple:
    """mv.h:249. Note the spec's reversed row/col for TRANSLATION."""
    if gm.wmtype == IDENTITY:
        return (0, 0)
    mat = gm.wmmat
    if gm.wmtype == TRANSLATION:
        mv = (mat[0] >> GM_TRANS_ONLY_PREC_DIFF,
              mat[1] >> GM_TRANS_ONLY_PREC_DIFF)
        return lower_mv_precision(mv, allow_hp, is_integer)
    bw = int(MI_W[bsize]) * 4
    bh = int(MI_H[bsize]) * 4
    x = mi_col * 4 + bw // 2 - 1
    y = mi_row * 4 + bh // 2 - 1
    xc = (mat[2] - (1 << WARPEDMODEL_PREC_BITS)) * x + mat[3] * y + mat[0]
    yc = mat[4] * x + (mat[5] - (1 << WARPEDMODEL_PREC_BITS)) * y + mat[1]
    tx = convert_to_trans_prec(allow_hp, xc)
    ty = convert_to_trans_prec(allow_hp, yc)
    mv = (ty, tx)
    if is_integer:
        mv = lower_mv_precision(mv, allow_hp, True)
    return mv


def is_global_mv_block(mbmi: MbInfo, wmtype: int) -> bool:
    block_size_allowed = (int(MI_W[mbmi.bsize]) >= 2
                          and int(MI_H[mbmi.bsize]) >= 2)
    return (mbmi.mode in (GLOBALMV, GLOBAL_GLOBALMV)
            and wmtype > TRANSLATION and block_size_allowed)


def get_mv_projection(ref_mv, num: int, den: int):
    den = min(den, MAX_FRAME_DISTANCE)
    num = min(num, MAX_FRAME_DISTANCE) if num > 0 else max(
        num, -MAX_FRAME_DISTANCE)
    row = round2s(ref_mv[0] * num * DIV_MULT[den], 14)
    col = round2s(ref_mv[1] * num * DIV_MULT[den], 14)
    return (clamp(row, MV_LOW + 1, MV_UPP - 1),
            clamp(col, MV_LOW + 1, MV_UPP - 1))


# ---------------------------------------------------------------------------
# setup_ref_mv_list and friends
# ---------------------------------------------------------------------------

class XdCtx:
    """The MACROBLOCKD subset needed for MV prediction: set by the caller
    per coded block."""
    __slots__ = ("mi", "mi_row", "mi_col", "width", "height",
                 "up_available", "left_available", "tile_row_start",
                 "tile_row_end", "tile_col_start", "tile_col_end",
                 "mb_to_left_edge", "mb_to_right_edge", "mb_to_top_edge",
                 "mb_to_bottom_edge", "is_last_vertical_rect",
                 "is_first_horizontal_rect")

    def __init__(self, mi_grid, mi_row, mi_col, bsize, tile, mi_rows,
                 mi_cols):
        self.mi = mi_grid
        self.mi_row = mi_row
        self.mi_col = mi_col
        self.width = int(MI_W[bsize])
        self.height = int(MI_H[bsize])
        (self.tile_row_start, self.tile_row_end,
         self.tile_col_start, self.tile_col_end) = tile
        self.up_available = mi_row > self.tile_row_start
        self.left_available = mi_col > self.tile_col_start
        # set_mi_row_col edge distances in 1/8 pel
        self.mb_to_top_edge = -(mi_row * 4 * 8)
        self.mb_to_bottom_edge = ((mi_rows - self.height - mi_row) * 4) * 8
        self.mb_to_left_edge = -(mi_col * 4 * 8)
        self.mb_to_right_edge = ((mi_cols - self.width - mi_col) * 4) * 8
        # set_mi_row_col (av1_common_int.h:1401)
        self.is_last_vertical_rect = (
            self.width < self.height
            and not ((mi_col + self.width) & (self.height - 1)))
        self.is_first_horizontal_rect = (
            self.width > self.height and not (mi_row & (self.width - 1)))


def _is_inside(xd: XdCtx, row_off: int, col_off: int) -> bool:
    r = xd.mi_row + row_off
    c = xd.mi_col + col_off
    return (r >= xd.tile_row_start and c >= xd.tile_col_start
            and r < xd.tile_row_end and c < xd.tile_col_end)


def _add_ref_mv_candidate(cand: MbInfo, rf, state, gm_mv, gm_params, weight):
    if not cand.is_inter:
        return
    stack, weights = state["stack"], state["weights"]
    if rf[1] == NONE_FRAME:
        for ref in range(2):
            if cand.ref_frame[ref] == rf[0]:
                is_gm = is_global_mv_block(cand, gm_params[rf[0]].wmtype)
                this_mv = gm_mv[0] if is_gm else tuple(cand.mv[ref])
                index = None
                for i in range(state["count"]):
                    if stack[i][0] == this_mv:
                        weights[i] += weight
                        index = i
                        break
                if index is None and state["count"] < MAX_REF_MV_STACK_SIZE:
                    stack[state["count"]] = (this_mv, (0, 0))
                    weights[state["count"]] = weight
                    state["count"] += 1
                if have_newmv_in_inter_mode(cand.mode):
                    state["newmv"] += 1
                state["match"] += 1
    else:
        if cand.ref_frame[0] == rf[0] and cand.ref_frame[1] == rf[1]:
            mv0 = (gm_mv[0] if is_global_mv_block(cand, gm_params[rf[0]].wmtype)
                   else tuple(cand.mv[0]))
            mv1 = (gm_mv[1] if is_global_mv_block(cand, gm_params[rf[1]].wmtype)
                   else tuple(cand.mv[1]))
            index = None
            for i in range(state["count"]):
                if stack[i][0] == mv0 and stack[i][1] == mv1:
                    weights[i] += weight
                    index = i
                    break
            if index is None and state["count"] < MAX_REF_MV_STACK_SIZE:
                stack[state["count"]] = (mv0, mv1)
                weights[state["count"]] = weight
                state["count"] += 1
            if have_newmv_in_inter_mode(cand.mode):
                state["newmv"] += 1
            state["match"] += 1


def _scan_row(cm, xd, rf, row_offset, state, gm_mv, max_row_offset,
              processed):
    end_mi = min(xd.width, cm.mi_cols - xd.mi_col)
    end_mi = min(end_mi, 16)
    col_offset = 0
    if abs(row_offset) > 1:
        col_offset = 1
        if (xd.mi_col & 1) and xd.width < 2:
            col_offset -= 1
    use_step_16 = xd.width >= 16
    i = 0
    while i < end_mi:
        cand = xd.mi[xd.mi_row + row_offset, xd.mi_col + col_offset + i]
        n4_w = int(MI_W[cand.bsize])
        length = min(xd.width, n4_w)
        if use_step_16:
            length = max(4, length)
        elif abs(row_offset) > 1:
            length = max(length, 2)
        weight = 2
        if xd.width >= 2 and xd.width <= n4_w:
            inc = min(-max_row_offset + row_offset + 1,
                      int(MI_H[cand.bsize]))
            weight = max(weight, inc)
            processed[0] = inc - row_offset - 1
        # state keys: match->row match counter handled by caller binding
        _add_ref_mv_candidate(cand, rf, state, gm_mv, cm.global_motion,
                              length * weight)
        i += length


def _scan_col(cm, xd, rf, col_offset, state, gm_mv, max_col_offset,
              processed):
    end_mi = min(xd.height, cm.mi_rows - xd.mi_row)
    end_mi = min(end_mi, 16)
    row_offset = 0
    if abs(col_offset) > 1:
        row_offset = 1
        if (xd.mi_row & 1) and xd.height < 2:
            row_offset -= 1
    use_step_16 = xd.height >= 16
    i = 0
    while i < end_mi:
        cand = xd.mi[xd.mi_row + row_offset + i, xd.mi_col + col_offset]
        n4_h = int(MI_H[cand.bsize])
        length = min(xd.height, n4_h)
        if use_step_16:
            length = max(4, length)
        elif abs(col_offset) > 1:
            length = max(length, 2)
        weight = 2
        if xd.height >= 2 and xd.height <= n4_h:
            inc = min(-max_col_offset + col_offset + 1,
                      int(MI_W[cand.bsize]))
            weight = max(weight, inc)
            processed[0] = inc - col_offset - 1
        _add_ref_mv_candidate(cand, rf, state, gm_mv, cm.global_motion,
                              length * weight)
        i += length


def _scan_blk(cm, xd, rf, row_offset, col_offset, state, gm_mv):
    if _is_inside(xd, row_offset, col_offset):
        cand = xd.mi[xd.mi_row + row_offset, xd.mi_col + col_offset]
        _add_ref_mv_candidate(cand, rf, state, gm_mv, cm.global_motion, 2 * 2)


def _has_top_right(cm, xd, bs: int) -> bool:
    sb_mi = cm.sb_mi
    mask_row = xd.mi_row & (sb_mi - 1)
    mask_col = xd.mi_col & (sb_mi - 1)
    if bs > 16:
        return False
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = False
                break
        else:
            break
        b <<= 1
    if xd.width < xd.height:
        if not xd.is_last_vertical_rect:
            has_tr = True
    if xd.width > xd.height:
        if not xd.is_first_horizontal_rect:
            has_tr = False
    if xd.mi[xd.mi_row, xd.mi_col].partition == 6:  # PARTITION_VERT_A
        if xd.width == xd.height and (mask_row & bs):
            has_tr = False
    return has_tr


def _check_sb_border(mi_row, mi_col, row_offset, col_offset) -> bool:
    sb_mi = 16
    row = mi_row & (sb_mi - 1)
    col = mi_col & (sb_mi - 1)
    return (0 <= row + row_offset < sb_mi and 0 <= col + col_offset < sb_mi)


def _add_tpl_ref_mv(cm, xd, ref_frame, blk_row, blk_col, gm_mv, state,
                    mode_context):
    pos_row = blk_row if (xd.mi_row & 1) else blk_row + 1
    pos_col = blk_col if (xd.mi_col & 1) else blk_col + 1
    if not _is_inside(xd, pos_row, pos_col):
        return 0
    tr = (xd.mi_row + pos_row) >> 1
    tc = (xd.mi_col + pos_col) >> 1
    mf = cm.tpl_mvs
    if mf is None or mf["mv"][tr, tc, 0] == INVALID_MV or \
            mf["valid"][tr, tc] == 0:
        return 0
    rf = av1_set_ref_frame(ref_frame)
    cur_idx = cm.cur_order_hint
    frame0_idx = cm.ref_order_hint(rf[0])
    cur_offset_0 = get_relative_dist(cm.enable_order_hint,
                                     cm.order_hint_bits, cur_idx, frame0_idx)
    mfmv = (int(mf["mv"][tr, tc, 0]), int(mf["mv"][tr, tc, 1]))
    ref_frame_offset = int(mf["offset"][tr, tc])
    this_refmv = get_mv_projection(mfmv, cur_offset_0, ref_frame_offset)
    this_refmv = lower_mv_precision(this_refmv, cm.allow_high_precision_mv,
                                    cm.force_integer_mv)
    stack, weights = state["stack"], state["weights"]
    if rf[1] == NONE_FRAME:
        if blk_row == 0 and blk_col == 0:
            if abs(this_refmv[0] - gm_mv[0][0]) >= 16 or \
                    abs(this_refmv[1] - gm_mv[0][1]) >= 16:
                mode_context[ref_frame] |= (1 << GLOBALMV_OFFSET)
        for idx in range(state["count"]):
            if this_refmv == stack[idx][0]:
                weights[idx] += 2
                return 1
        if state["count"] < MAX_REF_MV_STACK_SIZE:
            stack[state["count"]] = (this_refmv, (0, 0))
            weights[state["count"]] = 2
            state["count"] += 1
        return 1
    frame1_idx = cm.ref_order_hint(rf[1])
    cur_offset_1 = get_relative_dist(cm.enable_order_hint,
                                     cm.order_hint_bits, cur_idx, frame1_idx)
    comp_refmv = get_mv_projection(mfmv, cur_offset_1, ref_frame_offset)
    comp_refmv = lower_mv_precision(comp_refmv, cm.allow_high_precision_mv,
                                    cm.force_integer_mv)
    if blk_row == 0 and blk_col == 0:
        if (abs(this_refmv[0] - gm_mv[0][0]) >= 16
                or abs(this_refmv[1] - gm_mv[0][1]) >= 16
                or abs(comp_refmv[0] - gm_mv[1][0]) >= 16
                or abs(comp_refmv[1] - gm_mv[1][1]) >= 16):
            mode_context[ref_frame] |= (1 << GLOBALMV_OFFSET)
    for idx in range(state["count"]):
        if this_refmv == stack[idx][0] and comp_refmv == stack[idx][1]:
            weights[idx] += 2
            return 1
    if state["count"] < MAX_REF_MV_STACK_SIZE:
        stack[state["count"]] = (this_refmv, comp_refmv)
        weights[state["count"]] = 2
        state["count"] += 1
    return 1


def setup_ref_mv_list(cm, xd: XdCtx, ref_frame: int, gm_mv):
    """mvref_common.c:474. Returns (stack, weights, count, mode_ctx_val,
    mv_ref_list)."""
    bs = max(xd.width, xd.height)
    has_tr = _has_top_right(cm, xd, bs)
    rf = av1_set_ref_frame(ref_frame)
    mode_context = {}
    mode_context[ref_frame] = 0
    row_adj = (xd.height < 2) and (xd.mi_row & 1)
    col_adj = (xd.width < 2) and (xd.mi_col & 1)
    max_row_offset = 0
    max_col_offset = 0
    if xd.up_available:
        max_row_offset = -(MVREF_ROW_COLS << 1) + row_adj
        if xd.height < 2:
            max_row_offset = -(2 << 1) + row_adj
        max_row_offset = clamp(max_row_offset,
                               xd.tile_row_start - xd.mi_row,
                               xd.tile_row_end - xd.mi_row - 1)
    if xd.left_available:
        max_col_offset = -(MVREF_ROW_COLS << 1) + col_adj
        if xd.width < 2:
            max_col_offset = -(2 << 1) + col_adj
        max_col_offset = clamp(max_col_offset,
                               xd.tile_col_start - xd.mi_col,
                               xd.tile_col_end - xd.mi_col - 1)

    stack = [((0, 0), (0, 0))] * MAX_REF_MV_STACK_SIZE
    weights = [0] * MAX_REF_MV_STACK_SIZE
    state = {"stack": stack, "weights": weights, "count": 0,
             "match": 0, "newmv": 0}
    processed_rows = [0]
    processed_cols = [0]

    row_match = col_match = 0
    newmv_count = 0
    if abs(max_row_offset) >= 1:
        state["match"] = 0
        _scan_row(cm, xd, rf, -1, state, gm_mv, max_row_offset,
                  processed_rows)
        row_match += state["match"]
    if abs(max_col_offset) >= 1:
        state["match"] = 0
        _scan_col(cm, xd, rf, -1, state, gm_mv, max_col_offset,
                  processed_cols)
        col_match += state["match"]
    if has_tr:
        state["match"] = 0
        _scan_blk(cm, xd, rf, -1, xd.width, state, gm_mv)
        row_match += state["match"]
    newmv_count = state["newmv"]

    nearest_match = (row_match > 0) + (col_match > 0)
    nearest_refmv_count = state["count"]
    for idx in range(nearest_refmv_count):
        weights[idx] += REF_CAT_LEVEL

    mode_ctx = mode_context

    if cm.allow_ref_frame_mvs:
        is_available = 0
        voffset = max(2, xd.height)
        hoffset = max(2, xd.width)
        blk_row_end = min(xd.height, 16)
        blk_col_end = min(xd.width, 16)
        tpl_sample_pos = [(voffset, -2), (voffset, hoffset),
                          (voffset - 2, hoffset)]
        allow_extension = (xd.height >= 2 and xd.height < 16
                           and xd.width >= 2 and xd.width < 16)
        step_h = 4 if xd.height >= 16 else 2
        step_w = 4 if xd.width >= 16 else 2
        for blk_row in range(0, blk_row_end, step_h):
            for blk_col in range(0, blk_col_end, step_w):
                ret = _add_tpl_ref_mv(cm, xd, ref_frame, blk_row, blk_col,
                                      gm_mv, state, mode_ctx)
                if blk_row == 0 and blk_col == 0:
                    is_available = ret
        if is_available == 0:
            mode_ctx[ref_frame] |= (1 << GLOBALMV_OFFSET)
        if allow_extension:
            for (blk_row, blk_col) in tpl_sample_pos:
                if not _check_sb_border(xd.mi_row, xd.mi_col, blk_row,
                                        blk_col):
                    continue
                _add_tpl_ref_mv(cm, xd, ref_frame, blk_row, blk_col, gm_mv,
                                state, mode_ctx)

    # second outer area
    state["newmv"] = 0  # dummy counter from here on
    state["match"] = 0
    _scan_blk(cm, xd, rf, -1, -1, state, gm_mv)
    row_match += state["match"]
    for idx in range(2, MVREF_ROW_COLS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if abs(row_offset) <= abs(max_row_offset) and \
                abs(row_offset) > processed_rows[0]:
            state["match"] = 0
            _scan_row(cm, xd, rf, row_offset, state, gm_mv, max_row_offset,
                      processed_rows)
            row_match += state["match"]
        if abs(col_offset) <= abs(max_col_offset) and \
                abs(col_offset) > processed_cols[0]:
            state["match"] = 0
            _scan_col(cm, xd, rf, col_offset, state, gm_mv, max_col_offset,
                      processed_cols)
            col_match += state["match"]

    ref_match_count = (row_match > 0) + (col_match > 0)
    if nearest_match == 0:
        if ref_match_count >= 1:
            mode_ctx[ref_frame] |= 1
        if ref_match_count == 1:
            mode_ctx[ref_frame] |= (1 << REFMV_OFFSET)
        elif ref_match_count >= 2:
            mode_ctx[ref_frame] |= (2 << REFMV_OFFSET)
    elif nearest_match == 1:
        mode_ctx[ref_frame] |= 2 if newmv_count > 0 else 3
        if ref_match_count == 1:
            mode_ctx[ref_frame] |= (3 << REFMV_OFFSET)
        elif ref_match_count >= 2:
            mode_ctx[ref_frame] |= (4 << REFMV_OFFSET)
    else:
        mode_ctx[ref_frame] |= 4 if newmv_count >= 1 else 5
        mode_ctx[ref_frame] |= (5 << REFMV_OFFSET)

    # stable-ish bubble sort per reference
    def sort_range(lo, hi):
        length = hi
        while length > lo:
            nr_len = lo
            for idx in range(lo + 1, length):
                if weights[idx - 1] < weights[idx]:
                    stack[idx - 1], stack[idx] = stack[idx], stack[idx - 1]
                    weights[idx - 1], weights[idx] = (weights[idx],
                                                      weights[idx - 1])
                    nr_len = idx
            length = nr_len

    sort_range(0, nearest_refmv_count)
    sort_range(nearest_refmv_count, state["count"])

    mi_width = min(16, xd.width, cm.mi_cols - xd.mi_col)
    mi_height = min(16, xd.height, cm.mi_rows - xd.mi_row)
    mi_size = min(mi_width, mi_height)
    mv_ref_list = [(0, 0)] * MAX_MV_REF_CANDIDATES
    bw_px = xd.width * 4
    bh_px = xd.height * 4
    if rf[1] > NONE_FRAME:
        if state["count"] < MAX_MV_REF_CANDIDATES:
            ref_id = [[], []]
            ref_diff = [[], []]

            def process_comp(cand):
                for rf_idx in range(2):
                    can_rf = cand.ref_frame[rf_idx]
                    for cmp_idx in range(2):
                        if can_rf == rf[cmp_idx] and len(ref_id[cmp_idx]) < 2:
                            ref_id[cmp_idx].append(tuple(cand.mv[rf_idx]))
                        elif can_rf > INTRA_FRAME and \
                                len(ref_diff[cmp_idx]) < 2:
                            mv = tuple(cand.mv[rf_idx])
                            if cm.ref_frame_sign_bias[can_rf] != \
                                    cm.ref_frame_sign_bias[rf[cmp_idx]]:
                                mv = (-mv[0], -mv[1])
                            ref_diff[cmp_idx].append(mv)

            idx = 0
            while abs(max_row_offset) >= 1 and idx < mi_size:
                cand = xd.mi[xd.mi_row - 1, xd.mi_col + idx]
                process_comp(cand)
                idx += int(MI_W[cand.bsize])
            idx = 0
            while abs(max_col_offset) >= 1 and idx < mi_size:
                cand = xd.mi[xd.mi_row + idx, xd.mi_col - 1]
                process_comp(cand)
                idx += int(MI_H[cand.bsize])

            comp_list = [[None, None] for _ in range(MAX_MV_REF_CANDIDATES)]
            for idx in range(2):
                comp_idx = 0
                for mv in ref_id[idx]:
                    if comp_idx >= MAX_MV_REF_CANDIDATES:
                        break
                    comp_list[comp_idx][idx] = mv
                    comp_idx += 1
                for mv in ref_diff[idx]:
                    if comp_idx >= MAX_MV_REF_CANDIDATES:
                        break
                    comp_list[comp_idx][idx] = mv
                    comp_idx += 1
                while comp_idx < MAX_MV_REF_CANDIDATES:
                    comp_list[comp_idx][idx] = gm_mv[idx]
                    comp_idx += 1

            if state["count"]:
                if comp_list[0][0] == stack[0][0] and \
                        comp_list[0][1] == stack[0][1]:
                    stack[state["count"]] = (comp_list[1][0], comp_list[1][1])
                else:
                    stack[state["count"]] = (comp_list[0][0], comp_list[0][1])
                weights[state["count"]] = 2
                state["count"] += 1
            else:
                for idx in range(MAX_MV_REF_CANDIDATES):
                    stack[state["count"]] = (comp_list[idx][0],
                                             comp_list[idx][1])
                    weights[state["count"]] = 2
                    state["count"] += 1
        for idx in range(state["count"]):
            stack[idx] = (clamp_mv_ref(stack[idx][0], bw_px, bh_px, xd),
                          clamp_mv_ref(stack[idx][1], bw_px, bh_px, xd))
    else:
        def process_single(cand):
            for rf_idx in range(2):
                if cand.ref_frame[rf_idx] > INTRA_FRAME:
                    mv = tuple(cand.mv[rf_idx])
                    if cm.ref_frame_sign_bias[cand.ref_frame[rf_idx]] != \
                            cm.ref_frame_sign_bias[ref_frame]:
                        mv = (-mv[0], -mv[1])
                    found = False
                    for i in range(state["count"]):
                        if mv == stack[i][0]:
                            found = True
                            break
                    if not found:
                        # note: the C code does not re-check the cap inside
                        # one candidate, so both rf entries may be added
                        stack[state["count"]] = (mv, (0, 0))
                        weights[state["count"]] = 2
                        state["count"] += 1

        idx = 0
        while abs(max_row_offset) >= 1 and idx < mi_size and \
                state["count"] < MAX_MV_REF_CANDIDATES:
            cand = xd.mi[xd.mi_row - 1, xd.mi_col + idx]
            process_single(cand)
            idx += int(MI_W[cand.bsize])
        idx = 0
        while abs(max_col_offset) >= 1 and idx < mi_size and \
                state["count"] < MAX_MV_REF_CANDIDATES:
            cand = xd.mi[xd.mi_row + idx, xd.mi_col - 1]
            process_single(cand)
            idx += int(MI_H[cand.bsize])

        for idx in range(state["count"]):
            stack[idx] = (clamp_mv_ref(stack[idx][0], bw_px, bh_px, xd),
                          stack[idx][1])

        for idx in range(MAX_MV_REF_CANDIDATES):
            mv_ref_list[idx] = gm_mv[0]
        for idx in range(min(MAX_MV_REF_CANDIDATES, state["count"])):
            mv_ref_list[idx] = stack[idx][0]

    return stack, weights, state["count"], mode_ctx[ref_frame], mv_ref_list


def find_mv_refs(cm, xd: XdCtx, mbmi: MbInfo, ref_frame: int):
    """av1_find_mv_refs (mvref_common.c:786). Returns
    (stack, weights, count, mode_ctx, mv_ref_list, gm_mv)."""
    if ref_frame == INTRA_FRAME:
        gm_mv = [(0, 0), (0, 0)]
    else:
        allow_hp = cm.allow_high_precision_mv
        fim = cm.force_integer_mv
        if ref_frame < REF_FRAMES:
            gm_mv = [gm_get_motion_vector(cm.global_motion[ref_frame],
                                          allow_hp, mbmi.bsize, xd.mi_col,
                                          xd.mi_row, fim), (0, 0)]
        else:
            rf = av1_set_ref_frame(ref_frame)
            gm_mv = [gm_get_motion_vector(cm.global_motion[rf[0]], allow_hp,
                                          mbmi.bsize, xd.mi_col, xd.mi_row,
                                          fim),
                     gm_get_motion_vector(cm.global_motion[rf[1]], allow_hp,
                                          mbmi.bsize, xd.mi_col, xd.mi_row,
                                          fim)]
    stack, weights, count, mode_ctx, mv_ref_list = setup_ref_mv_list(
        cm, xd, ref_frame, gm_mv)
    return stack, weights, count, mode_ctx, mv_ref_list, gm_mv


# ---------------------------------------------------------------------------
# Warp sample selection (av1_findSamples / av1_selectSamples,
# mvref_common.c:1083)
# ---------------------------------------------------------------------------
LEAST_SQUARES_SAMPLES_MAX = 8


def _record_sample(mb: MbInfo, row_offset, sign_r, col_offset, sign_c):
    bw = int(MI_W[mb.bsize]) * 4
    bh = int(MI_H[mb.bsize]) * 4
    x = col_offset * 4 + sign_c * bw // 2 - 1
    y = row_offset * 4 + sign_r * bh // 2 - 1
    pt = (x * 8, y * 8)
    return pt, (pt[0] + mb.mv[0][1], pt[1] + mb.mv[0][0])


def find_samples(cm, xd: XdCtx, mbmi: MbInfo):
    """av1_findSamples: returns (np, pts, pts_inref) at 1/8-pel."""
    ref_frame = mbmi.ref_frame[0]
    pts, pts_inref = [], []
    do_tl = do_tr = True
    if xd.up_available:
        mb = xd.mi[xd.mi_row - 1, xd.mi_col]
        sbw = int(MI_W[mb.bsize])
        if xd.width <= sbw:
            col_offset = -(xd.mi_col % sbw)
            if col_offset < 0:
                do_tl = False
            if col_offset + sbw > xd.width:
                do_tr = False
            if mb.ref_frame[0] == ref_frame and mb.ref_frame[1] == NONE_FRAME:
                p, q = _record_sample(mb, 0, -1, col_offset, 1)
                pts.append(p)
                pts_inref.append(q)
                if len(pts) >= LEAST_SQUARES_SAMPLES_MAX:
                    return len(pts), pts, pts_inref
        else:
            i = 0
            while i < min(xd.width, cm.mi_cols - xd.mi_col):
                mb = xd.mi[xd.mi_row - 1, xd.mi_col + i]
                sbw = int(MI_W[mb.bsize])
                if mb.ref_frame[0] == ref_frame and \
                        mb.ref_frame[1] == NONE_FRAME:
                    p, q = _record_sample(mb, 0, -1, i, 1)
                    pts.append(p)
                    pts_inref.append(q)
                    if len(pts) >= LEAST_SQUARES_SAMPLES_MAX:
                        return len(pts), pts, pts_inref
                i += sbw
    if xd.left_available:
        mb = xd.mi[xd.mi_row, xd.mi_col - 1]
        sbh = int(MI_H[mb.bsize])
        if xd.height <= sbh:
            row_offset = -(xd.mi_row % sbh)
            if row_offset < 0:
                do_tl = False
            if mb.ref_frame[0] == ref_frame and mb.ref_frame[1] == NONE_FRAME:
                p, q = _record_sample(mb, row_offset, 1, 0, -1)
                pts.append(p)
                pts_inref.append(q)
                if len(pts) >= LEAST_SQUARES_SAMPLES_MAX:
                    return len(pts), pts, pts_inref
        else:
            i = 0
            while i < min(xd.height, cm.mi_rows - xd.mi_row):
                mb = xd.mi[xd.mi_row + i, xd.mi_col - 1]
                sbh = int(MI_H[mb.bsize])
                if mb.ref_frame[0] == ref_frame and \
                        mb.ref_frame[1] == NONE_FRAME:
                    p, q = _record_sample(mb, i, 1, 0, -1)
                    pts.append(p)
                    pts_inref.append(q)
                    if len(pts) >= LEAST_SQUARES_SAMPLES_MAX:
                        return len(pts), pts, pts_inref
                i += sbh
    if do_tl and xd.left_available and xd.up_available:
        mb = xd.mi[xd.mi_row - 1, xd.mi_col - 1]
        if mb.ref_frame[0] == ref_frame and mb.ref_frame[1] == NONE_FRAME:
            p, q = _record_sample(mb, 0, -1, 0, -1)
            pts.append(p)
            pts_inref.append(q)
            if len(pts) >= LEAST_SQUARES_SAMPLES_MAX:
                return len(pts), pts, pts_inref
    if do_tr and _has_top_right(cm, xd, max(xd.width, xd.height)):
        if _is_inside(xd, -1, xd.width):
            mb = xd.mi[xd.mi_row - 1, xd.mi_col + xd.width]
            if mb.ref_frame[0] == ref_frame and \
                    mb.ref_frame[1] == NONE_FRAME:
                p, q = _record_sample(mb, 0, -1, xd.width, 1)
                pts.append(p)
                pts_inref.append(q)
    return len(pts), pts, pts_inref
