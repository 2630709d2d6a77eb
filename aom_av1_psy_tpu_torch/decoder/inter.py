"""Inter-frame mode parse and motion-compensated reconstruction.

Reimplements the decoder side of inter coding: ``av1/decoder/decodemv.c``
(read_inter_block_mode_info :1272, read_ref_frames :937, assign_mv :1113,
read_mv :885), ``av1/common/pred_common.c`` (neighbor-count reference
contexts), and ``av1/common/reconinter_template.inc`` (sub8x8 + 8x8-and-
bigger predictor builds) wired onto the batched subpel convolve kernels in
``ops/convolve`` / ``ops/compound``.
"""
from __future__ import annotations

import numpy as np

from ..normative import mvref as MR
from ..normative.blocks import MI_W, MI_H, get_plane_block_size
from ..normative.enums import BLOCK_WIDTH, BLOCK_HEIGHT
from ..ops import convolve as CONV
from ..ops import compound as COMP
from ..errors import outside_the_port

SWITCHABLE_FILTERS = 3
SWITCHABLE = 4
INTER_FILTER_COMP_OFFSET = SWITCHABLE_FILTERS + 1
INTER_FILTER_DIR_OFFSET = (SWITCHABLE_FILTERS + 1) * 2

# size_group_lookup (blockd.h)
SIZE_GROUP = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
                       0, 0, 1, 1, 2, 2], np.int32)

MV_JOINTS = 4
MV_CLASSES = 11
CLASS0_BITS = 1
CLASS0_SIZE = 1 << CLASS0_BITS
MV_FP_SIZE = 4

SIMPLE_TRANSLATION, OBMC_CAUSAL, WARPED_CAUSAL = 0, 1, 2
COMPOUND_AVERAGE, COMPOUND_DISTWTD, COMPOUND_WEDGE, COMPOUND_DIFFWTD = \
    0, 1, 2, 3


def is_inter(mb) -> bool:
    return mb is not None and mb.is_inter


def collect_neighbors_ref_counts(dec, above, left):
    counts = np.zeros(8, np.int32)
    for mb in (above, left):
        if mb is not None and mb.is_inter:
            counts[mb.ref_frame[0]] += 1
            if mb.ref_frame[1] > MR.INTRA_FRAME:
                counts[mb.ref_frame[1]] += 1
    return counts


# ---------------------------------------------------------------------------
# Reference-frame contexts (pred_common.c)
# ---------------------------------------------------------------------------

def _is_bwd(rf):
    return MR.BWDREF_FRAME <= rf <= MR.ALTREF_FRAME


def _has_uni_comp(mb):
    return mb.ref_frame[1] > MR.INTRA_FRAME and not (
        mb.ref_frame[0] < MR.BWDREF_FRAME
        and mb.ref_frame[1] >= MR.BWDREF_FRAME)


def reference_mode_context(above, left, up, lf):
    if up and lf:
        a2, l2 = above.is_compound, left.is_compound
        if not a2 and not l2:
            return int(_is_bwd(above.ref_frame[0]) ^ _is_bwd(left.ref_frame[0]))
        if not a2:
            return 2 + int(_is_bwd(above.ref_frame[0]) or not above.is_inter)
        if not l2:
            return 2 + int(_is_bwd(left.ref_frame[0]) or not left.is_inter)
        return 4
    if up or lf:
        e = above if up else left
        if not e.is_compound:
            return int(_is_bwd(e.ref_frame[0]))
        return 3
    return 1


def comp_reference_type_context(above, left, up, lf):
    if up and lf:
        ai, li = not above.is_inter, not left.is_inter
        if ai and li:
            return 2
        if ai or li:
            inter = left if ai else above
            if not inter.is_compound:
                return 2
            return 1 + 2 * int(_has_uni_comp(inter))
        a_sg = not above.is_compound
        l_sg = not left.is_compound
        frfa, frfl = above.ref_frame[0], left.ref_frame[0]
        if a_sg and l_sg:
            return 1 + 2 * int(not (_is_bwd(frfa) ^ _is_bwd(frfl)))
        if l_sg or a_sg:
            uni = _has_uni_comp(left) if a_sg else _has_uni_comp(above)
            if not uni:
                return 1
            return 3 + int(not (_is_bwd(frfa) ^ _is_bwd(frfl)))
        au, lu = _has_uni_comp(above), _has_uni_comp(left)
        if not au and not lu:
            return 0
        if not au or not lu:
            return 2
        return 3 + int(not ((frfa == MR.BWDREF_FRAME)
                            ^ (frfl == MR.BWDREF_FRAME)))
    if up or lf:
        e = above if up else left
        if not e.is_inter:
            return 2
        if not e.is_compound:
            return 2
        return 4 * int(_has_uni_comp(e))
    return 2


def _vote(a, b):
    return 1 if a == b else (0 if a < b else 2)


def ctx_single_p1(c):
    fwd = c[1] + c[2] + c[3] + c[4]
    bwd = c[5] + c[6] + c[7]
    return _vote(fwd, bwd)


def ctx_brfarf2_or_arf(c):
    return _vote(c[5] + c[6], c[7])


def ctx_ll2_or_l3gld(c):
    return _vote(c[1] + c[2], c[3] + c[4])


def ctx_last_or_last2(c):
    return _vote(c[1], c[2])


def ctx_last3_or_gld(c):
    return _vote(c[3], c[4])


def ctx_brf_or_arf2(c):
    return _vote(c[5], c[6])


def ctx_uni_p(c):
    return _vote(c[1] + c[2] + c[3] + c[4], c[5] + c[6] + c[7])


def ctx_uni_p1(c):
    return _vote(c[2], c[3] + c[4])


def ctx_uni_p2(c):
    return _vote(c[3], c[4])


# ---------------------------------------------------------------------------
# Mode-info reads
# ---------------------------------------------------------------------------

def read_ref_frames(dec, mbmi, counts, above, left, up, lf):
    """read_ref_frames (decodemv.c:937)."""
    fc = dec.fc
    rd = dec._read_symbol
    if mbmi.skip_mode:
        p = dec.fh.skip_mode_frames
        mbmi.ref_frame = [MR.LAST_FRAME + p[0], MR.LAST_FRAME + p[1]]
        return
    bw, bh = int(BLOCK_WIDTH[mbmi.bsize]), int(BLOCK_HEIGHT[mbmi.bsize])
    comp_allowed = bw >= 8 and bh >= 8
    if dec.fh.reference_select and comp_allowed:
        ctx = reference_mode_context(above, left, up, lf)
        comp = rd(fc.comp_inter_cdf[ctx], 2)
    else:
        comp = 0
    if comp:
        ctx = comp_reference_type_context(above, left, up, lf)
        uni = rd(fc.comp_ref_type_cdf[ctx], 2) == 0
        if uni:
            if rd(fc.uni_comp_ref_cdf[ctx_uni_p(counts)][0], 2):
                mbmi.ref_frame = [MR.BWDREF_FRAME, MR.ALTREF_FRAME]
            elif rd(fc.uni_comp_ref_cdf[ctx_uni_p1(counts)][1], 2):
                if rd(fc.uni_comp_ref_cdf[ctx_uni_p2(counts)][2], 2):
                    mbmi.ref_frame = [MR.LAST_FRAME, MR.GOLDEN_FRAME]
                else:
                    mbmi.ref_frame = [MR.LAST_FRAME, MR.LAST3_FRAME]
            else:
                mbmi.ref_frame = [MR.LAST_FRAME, MR.LAST2_FRAME]
            return
        if rd(fc.comp_ref_cdf[ctx_ll2_or_l3gld(counts)][0], 2) == 0:
            r0 = (MR.LAST2_FRAME
                  if rd(fc.comp_ref_cdf[ctx_last_or_last2(counts)][1], 2)
                  else MR.LAST_FRAME)
        else:
            r0 = (MR.GOLDEN_FRAME
                  if rd(fc.comp_ref_cdf[ctx_last3_or_gld(counts)][2], 2)
                  else MR.LAST3_FRAME)
        if rd(fc.comp_bwdref_cdf[ctx_brfarf2_or_arf(counts)][0], 2) == 0:
            r1 = (MR.ALTREF2_FRAME
                  if rd(fc.comp_bwdref_cdf[ctx_brf_or_arf2(counts)][1], 2)
                  else MR.BWDREF_FRAME)
        else:
            r1 = MR.ALTREF_FRAME
        mbmi.ref_frame = [r0, r1]
        return
    # single
    if rd(fc.single_ref_cdf[ctx_single_p1(counts)][0], 2):
        if not rd(fc.single_ref_cdf[ctx_brfarf2_or_arf(counts)][1], 2):
            r0 = (MR.ALTREF2_FRAME
                  if rd(fc.single_ref_cdf[ctx_brf_or_arf2(counts)][5], 2)
                  else MR.BWDREF_FRAME)
        else:
            r0 = MR.ALTREF_FRAME
    else:
        if rd(fc.single_ref_cdf[ctx_ll2_or_l3gld(counts)][2], 2):
            r0 = (MR.GOLDEN_FRAME
                  if rd(fc.single_ref_cdf[ctx_last3_or_gld(counts)][4], 2)
                  else MR.LAST3_FRAME)
        else:
            r0 = (MR.LAST2_FRAME
                  if rd(fc.single_ref_cdf[ctx_last_or_last2(counts)][3], 2)
                  else MR.LAST_FRAME)
    mbmi.ref_frame = [r0, MR.NONE_FRAME]


def read_inter_mode(dec, mode_ctx):
    fc = dec.fc
    ctx = mode_ctx & MR.NEWMV_CTX_MASK
    if dec._read_symbol(fc.newmv_cdf[ctx], 2) == 0:
        return MR.NEWMV
    ctx = (mode_ctx >> MR.GLOBALMV_OFFSET) & MR.GLOBALMV_CTX_MASK
    if dec._read_symbol(fc.zeromv_cdf[ctx], 2) == 0:
        return MR.GLOBALMV
    ctx = (mode_ctx >> MR.REFMV_OFFSET) & MR.REFMV_CTX_MASK
    if dec._read_symbol(fc.refmv_cdf[ctx], 2) == 0:
        return MR.NEARESTMV
    return MR.NEARMV


def read_drl_idx(dec, mbmi, ref_mv_count, weights):
    fc = dec.fc
    mbmi.ref_mv_idx = 0
    if mbmi.mode in (MR.NEWMV, MR.NEW_NEWMV):
        for idx in range(2):
            if ref_mv_count > idx + 1:
                ctx = MR.drl_ctx(weights, idx)
                drl = dec._read_symbol(fc.drl_cdf[ctx], 2)
                mbmi.ref_mv_idx = idx + drl
                if not drl:
                    return
    if MR.have_nearmv_in_inter_mode(mbmi.mode):
        for idx in range(1, 3):
            if ref_mv_count > idx + 1:
                ctx = MR.drl_ctx(weights, idx)
                drl = dec._read_symbol(fc.drl_cdf[ctx], 2)
                mbmi.ref_mv_idx = idx + drl - 1
                if not drl:
                    return


def read_mv_component(dec, comp: int, use_subpel, usehp):
    """read_mv_component (decodemv.c:845). comp: 0 = row, 1 = col."""
    fc = dec.fc
    rd = dec._read_symbol
    g = lambda name: getattr(fc, f"nmv_comp{comp}_{name}_cdf")
    sign = rd(g("sign"), 2)
    mv_class = rd(g("classes"), MV_CLASSES)
    class0 = mv_class == 0
    if class0:
        d = rd(g("class0"), CLASS0_SIZE)
        mag = 0
    else:
        n = mv_class + CLASS0_BITS - 1
        d = 0
        bits_cdf = g("bits")
        for i in range(n):
            d |= rd(bits_cdf[i], 2) << i
        mag = CLASS0_SIZE << (mv_class + 2)
    if use_subpel:
        fr = rd(g("class0_fp")[d] if class0 else g("fp"), MV_FP_SIZE)
        hp = rd(g("class0_hp") if class0 else g("hp"), 2) if usehp else 1
    else:
        fr = 3
        hp = 1
    mag += ((d << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def read_mv(dec, ref_mv, precision):
    """precision: 0=int only, 1=low (no hp), 2=subpel+hp."""
    fc = dec.fc
    joint = dec._read_symbol(fc.nmv_joints_cdf, MV_JOINTS)
    dr = dc = 0
    if joint in (2, 3):  # vertical component present
        dr = read_mv_component(dec, 0, precision > 0, precision > 1)
    if joint in (1, 3):
        dc = read_mv_component(dec, 1, precision > 0, precision > 1)
    return (ref_mv[0] + dr, ref_mv[1] + dc)


def assign_mv(dec, mbmi, ref_mv, nearest_mv, near_mv, gm_mv, precision):
    mode = mbmi.mode
    if mode == MR.NEWMV:
        mbmi.mv[0] = read_mv(dec, ref_mv[0], precision)
    elif mode == MR.NEARESTMV:
        mbmi.mv[0] = nearest_mv[0]
    elif mode == MR.NEARMV:
        mbmi.mv[0] = near_mv[0]
    elif mode == MR.GLOBALMV:
        mbmi.mv[0] = gm_mv[0]
    elif mode == MR.NEW_NEWMV:
        mbmi.mv[0] = read_mv(dec, ref_mv[0], precision)
        mbmi.mv[1] = read_mv(dec, ref_mv[1], precision)
    elif mode == MR.NEAREST_NEARESTMV:
        mbmi.mv = [nearest_mv[0], nearest_mv[1]]
    elif mode == MR.NEAR_NEARMV:
        mbmi.mv = [near_mv[0], near_mv[1]]
    elif mode == MR.NEW_NEARESTMV:
        mbmi.mv[0] = read_mv(dec, ref_mv[0], precision)
        mbmi.mv[1] = nearest_mv[1]
    elif mode == MR.NEAREST_NEWMV:
        mbmi.mv[0] = nearest_mv[0]
        mbmi.mv[1] = read_mv(dec, ref_mv[1], precision)
    elif mode == MR.NEAR_NEWMV:
        mbmi.mv[0] = near_mv[0]
        mbmi.mv[1] = read_mv(dec, ref_mv[1], precision)
    elif mode == MR.NEW_NEARMV:
        mbmi.mv[0] = read_mv(dec, ref_mv[0], precision)
        mbmi.mv[1] = near_mv[1]
    elif mode == MR.GLOBAL_GLOBALMV:
        mbmi.mv = [gm_mv[0], gm_mv[1]]
    else:
        raise AssertionError(f"bad inter mode {mode}")


def switchable_interp_ctx(dec, mbmi, above, left, up, lf, direction):
    """av1_get_pred_context_switchable_interp (pred_common.c:30)."""
    ctx_offset = int(mbmi.ref_frame[1] > MR.INTRA_FRAME) \
        * INTER_FILTER_COMP_OFFSET
    ref_frame = mbmi.ref_frame[0]

    def ref_filter_type(mb):
        if mb.ref_frame[0] == ref_frame or mb.ref_frame[1] == ref_frame:
            return mb.interp_x if (direction & 1) else mb.interp_y
        return SWITCHABLE_FILTERS

    left_type = ref_filter_type(left) if lf else SWITCHABLE_FILTERS
    above_type = ref_filter_type(above) if up else SWITCHABLE_FILTERS
    ctx = ctx_offset + (direction & 1) * INTER_FILTER_DIR_OFFSET
    if left_type == above_type:
        return ctx + left_type
    if left_type == SWITCHABLE_FILTERS:
        return ctx + above_type
    if above_type == SWITCHABLE_FILTERS:
        return ctx + left_type
    return ctx + SWITCHABLE_FILTERS


def is_interp_needed(dec, mbmi):
    """av1_is_interp_needed (reconinter.c): no filter signaled for
    skip-mode blocks, warped blocks, or non-translational global motion
    (which includes IDENTITY models — any wmtype other than TRANSLATION)."""
    if mbmi.skip_mode:
        return False
    if mbmi.motion_mode == WARPED_CAUSAL:
        return False
    # is_nontrans_global_motion
    if mbmi.mode in (MR.GLOBALMV, MR.GLOBAL_GLOBALMV) \
            and min(int(MI_W[mbmi.bsize]), int(MI_H[mbmi.bsize])) >= 2:
        nontrans = True
        for ref in range(1 + int(mbmi.is_compound)):
            if dec.global_motion[mbmi.ref_frame[ref]].wmtype == \
                    MR.TRANSLATION:
                nontrans = False
        if nontrans:
            return False
    return True


def read_mb_interp_filter(dec, mbmi, above, left, up, lf):
    fh = dec.fh
    if not is_interp_needed(dec, mbmi):
        mbmi.interp_y = mbmi.interp_x = (
            0 if fh.interp_filter == SWITCHABLE else fh.interp_filter)
        return
    if fh.interp_filter != SWITCHABLE:
        mbmi.interp_y = mbmi.interp_x = fh.interp_filter
        return
    filters = [0, 0]
    for direction in range(2):
        ctx = switchable_interp_ctx(dec, mbmi, above, left, up, lf, direction)
        filters[direction] = dec._read_symbol(
            dec.fc.switchable_interp_cdf[ctx], SWITCHABLE_FILTERS)
        if not dec.seq.enable_dual_filter:
            filters[1] = filters[0]
            break
    mbmi.interp_y = filters[0]  # vertical
    mbmi.interp_x = filters[1]  # horizontal


def count_overlappable_neighbors(dec, xd, bsize):
    """av1_count_overlappable_neighbors + obmc.h iterators. Gated on
    is_motion_variation_allowed_bsize — sub-8x8 blocks skip the scan (their
    4x4 pair partner may not be decoded yet)."""
    count = 0
    if int(BLOCK_WIDTH[bsize]) < 8 or int(BLOCK_HEIGHT[bsize]) < 8:
        return 0
    if xd.up_available:
        end_col = min(xd.mi_col + xd.width, dec.mi_cols)
        col = xd.mi_col
        while col < end_col:
            mb = xd.mi[xd.mi_row - 1, col]
            step = min(int(MI_W[mb.bsize]), 16)
            if step == 1:
                col &= ~1
                mb = xd.mi[xd.mi_row - 1, col + 1]
                step = 2
            if mb.is_inter:
                count += 1
            col += step
    if count:
        return count
    if xd.left_available:
        end_row = min(xd.mi_row + xd.height, dec.mi_rows)
        row = xd.mi_row
        while row < end_row:
            mb = xd.mi[row, xd.mi_col - 1]
            step = min(int(MI_H[mb.bsize]), 16)
            if step == 1:
                row &= ~1
                mb = xd.mi[row + 1, xd.mi_col - 1]
                step = 2
            if mb.is_inter:
                count += 1
            row += step
    return count


def motion_mode_allowed(dec, xd, mbmi, overlappable):
    if not overlappable:
        return SIMPLE_TRANSLATION
    if not dec.fh.force_integer_mv:
        if MR.is_global_mv_block(
                mbmi, dec.global_motion[mbmi.ref_frame[0]].wmtype):
            return SIMPLE_TRANSLATION
    bw, bh = int(BLOCK_WIDTH[mbmi.bsize]), int(BLOCK_HEIGHT[mbmi.bsize])
    if bw >= 8 and bh >= 8 and mbmi.mode >= MR.NEARESTMV \
            and mbmi.mode <= MR.NEWMV and mbmi.ref_frame[1] != MR.INTRA_FRAME \
            and not mbmi.is_compound:
        ref_slot = dec.refs[mbmi.ref_frame[0]]
        ref_scaled = (ref_slot["upscaled_width"] != dec.fh.width
                      or ref_slot["height"] != dec.fh.height)
        # motion_mode_allowed (av1/common/reconinter.h): WARPED_CAUSAL
        # additionally requires an UNSCALED reference — with a scaled ref
        # the coded symbol is the 2-ary obmc_cdf, not the 3-ary
        # motion_mode_cdf (parse-level, resize-mode streams)
        if mbmi.num_proj_ref >= 1 and dec.fh.allow_warped_motion \
                and not dec.fh.force_integer_mv and not ref_scaled:
            return WARPED_CAUSAL
        return OBMC_CAUSAL
    return SIMPLE_TRANSLATION


def read_motion_mode(dec, xd, mbmi, overlappable):
    if not dec.fh.is_motion_mode_switchable:
        return SIMPLE_TRANSLATION
    if mbmi.skip_mode:
        return SIMPLE_TRANSLATION
    last = motion_mode_allowed(dec, xd, mbmi, overlappable)
    if last == SIMPLE_TRANSLATION:
        return SIMPLE_TRANSLATION
    if last == OBMC_CAUSAL:
        return dec._read_symbol(dec.fc.obmc_cdf[mbmi.bsize], 2)
    return dec._read_symbol(dec.fc.motion_mode_cdf[mbmi.bsize], 3)


# ---------------------------------------------------------------------------
# Motion compensation (reconinter_template.inc)
# ---------------------------------------------------------------------------
AOM_INTERP_EXTEND = 4


def _clamp_mv_to_umv_border(mv, xd, bw, bh, ss_x, ss_y):
    """clamp_mv_to_umv_border_sb: returns q4 (1/16-pel) MV."""
    spel_left = (AOM_INTERP_EXTEND + bw) << 4
    spel_right = spel_left - (1 << 4)
    spel_top = (AOM_INTERP_EXTEND + bh) << 4
    spel_bottom = spel_top - (1 << 4)
    row = mv[0] * (1 << (1 - ss_y))
    col = mv[1] * (1 << (1 - ss_x))
    lo_col = (xd.mb_to_left_edge << (1 - ss_x)) - spel_left
    hi_col = (xd.mb_to_right_edge << (1 - ss_x)) + spel_right
    lo_row = (xd.mb_to_top_edge << (1 - ss_y)) - spel_top
    hi_row = (xd.mb_to_bottom_edge << (1 - ss_y)) + spel_bottom
    return (MR.clamp(row, lo_row, hi_row), MR.clamp(col, lo_col, hi_col))


def _fetch_ref_block(ref_plane, crop_w, crop_h, x0, y0, w, h):
    """Fetch (h, w) region at (y0, x0) with border replication beyond the
    crop (extend_mc_border / aom frame border semantics)."""
    ys = np.clip(np.arange(y0, y0 + h), 0, crop_h - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, crop_w - 1)
    return ref_plane[np.ix_(ys, xs)]


def _scaled_value(val: int, scale_fp: int) -> int:
    """av1_scaled_x/y (scale.h:36): q4 position -> q10 scaled position.
    ROUND_POWER_OF_TWO_SIGNED_64 rounds the magnitude (C truncation
    semantics), not the floor."""
    off = (scale_fp - (1 << 14)) * (1 << 3)   # (SUBPEL_BITS - 1)
    tval = val * scale_fp + off
    r = 1 << 7   # REF_SCALE_SHIFT - SCALE_EXTRA_BITS = 8
    if tval >= 0:
        return (tval + r) >> 8
    return -((-tval + r) >> 8)


def _predict_one_scaled(dec, mbmi, ref_slot, mv, xd, plane, pre_x, pre_y,
                        bw, bh, ss_x, ss_y):
    """Scaled-reference single prediction (av1_is_scaled path of
    dec_calc_subpel_params, decodeframe.c:546 + av1_convolve_2d_scale,
    av1/common/convolve.c:371). The reference's dims differ from the
    current frame's; positions walk the ref in 1/1024 units."""
    ref_w, ref_h = ref_slot["upscaled_width"], ref_slot["height"]
    cur_w, cur_h = dec.fh.width, dec.fh.height
    x_fp = ((ref_w << 14) + cur_w // 2) // cur_w
    y_fp = ((ref_h << 14) + cur_h // 2) // cur_h
    xs = (x_fp + 8) >> 4     # fixed_point_scale_to_coarse_point_scale
    ys = (y_fp + 8) >> 4
    orig_pos_y = (pre_y << 4) + mv[0] * (1 << (1 - ss_y))
    orig_pos_x = (pre_x << 4) + mv[1] * (1 << (1 - ss_x))
    pos_y = _scaled_value(orig_pos_y, y_fp) + 32   # SCALE_EXTRA_OFF
    pos_x = _scaled_value(orig_pos_x, x_fp) + 32
    plane_buf = ref_slot["planes"][plane]
    crop_w = (ref_w + ss_x) >> ss_x
    crop_h = (ref_h + ss_y) >> ss_y
    top = -(((288 >> ss_y) - 4) << 10)   # AOM_LEFT_TOP_MARGIN_SCALED
    left = -(((288 >> ss_x) - 4) << 10)
    bottom = (crop_h + 4) << 10          # pre_buf dims + AOM_INTERP_EXTEND
    right = (crop_w + 4) << 10
    pos_y = min(max(pos_y, top), bottom)
    pos_x = min(max(pos_x, left), right)
    subpel_x = pos_x & 1023
    subpel_y = pos_y & 1023
    x0 = pos_x >> 10
    y0 = pos_y >> 10
    x1 = ((pos_x + (bw - 1) * xs) >> 10) + 1
    y1 = ((pos_y + (bh - 1) * ys) >> 10) + 1
    region = _fetch_ref_block(plane_buf, crop_w, crop_h, x0 - 3, y0 - 3,
                              x1 - x0 + 8, y1 - y0 + 8).astype(np.int32)
    kx = np.asarray(CONV.filter_kernels(mbmi.interp_x, bw), np.int64)
    ky = np.asarray(CONV.filter_kernels(mbmi.interp_y, bh), np.int64)
    return CONV.convolve_2d_scale(region, 3, 3, bw, bh, kx, ky,
                                  subpel_x, xs, subpel_y, ys,
                                  bd=dec.bd).astype(np.int32)


def _predict_one(dec, mbmi, ref_slot, mv, xd, plane, pre_x, pre_y, bw, bh,
                 ss_x, ss_y, is_compound):
    """Single-reference prediction for one plane region of (bh, bw) px at
    plane coords (pre_x, pre_y). Returns int32 (bh, bw) pixels (single) or
    the CONV_BUF-domain first pass (compound)."""
    if (ref_slot["upscaled_width"] != dec.fh.width
            or ref_slot["height"] != dec.fh.height):
        if is_compound:
            raise NotImplementedError("compound with scaled reference")
        return _predict_one_scaled(dec, mbmi, ref_slot, mv, xd, plane,
                                   pre_x, pre_y, bw, bh, ss_x, ss_y)
    mv_q4 = _clamp_mv_to_umv_border(mv, xd, bw, bh, ss_x, ss_y)
    pos_x = (pre_x << 4) + mv_q4[1]
    pos_y = (pre_y << 4) + mv_q4[0]
    x0 = (pos_x >> 4) - 3
    y0 = (pos_y >> 4) - 3
    subpel_x = mv_q4[1] & 15
    subpel_y = mv_q4[0] & 15
    plane_buf = ref_slot["planes"][plane]
    crop_w = (ref_slot["upscaled_width"] + ss_x) >> ss_x
    crop_h = (ref_slot["height"] + ss_y) >> ss_y
    region = _fetch_ref_block(plane_buf, crop_w, crop_h, x0, y0,
                              bw + 7, bh + 7).astype(np.int32)
    kx = CONV.filter_kernels(mbmi.interp_x, bw)[subpel_x]
    ky = CONV.filter_kernels(mbmi.interp_y, bh)[subpel_y]
    if not is_compound:
        if subpel_x and subpel_y:
            return CONV.convolve_2d_sr(region, bw, bh, kx, ky, bd=dec.bd)
        if subpel_x:
            return CONV.convolve_x_sr(region[3 : 3 + bh, :], bw, bh, kx,
                                      bd=dec.bd)
        if subpel_y:
            return CONV.convolve_y_sr(region[:, 3 : 3 + bw], bw, bh, ky,
                                      bd=dec.bd)
        return region[3 : 3 + bh, 3 : 3 + bw].astype(np.int32)
    return COMP._first_pass(region, bw, bh, subpel_x, subpel_y, kx, ky,
                            bd=dec.bd)


def dist_wtd_comp_weights(dec, mbmi):
    """av1_dist_wtd_comp_weight_assign (reconinter.c:680)."""
    if mbmi.compound_idx:
        return 8, 8, False
    quant_dist_weight = [(2, 3), (2, 5), (2, 7)]
    quant_dist_lookup = [(9, 7), (11, 5), (12, 4), (13, 3)]
    cur = dec.cur_order_hint
    bck = dec.ref_order_hint(mbmi.ref_frame[0])
    fwd = dec.ref_order_hint(mbmi.ref_frame[1])
    d0 = MR.clamp(abs(MR.get_relative_dist(dec.enable_order_hint,
                                           dec.order_hint_bits, fwd, cur)),
                  0, MR.MAX_FRAME_DISTANCE)
    d1 = MR.clamp(abs(MR.get_relative_dist(dec.enable_order_hint,
                                           dec.order_hint_bits, cur, bck)),
                  0, MR.MAX_FRAME_DISTANCE)
    order = int(d0 <= d1)
    if d0 == 0 or d1 == 0:
        i = 2
    else:
        for i in range(3):
            c0 = quant_dist_weight[i][order]
            c1 = quant_dist_weight[i][1 - order]
            d0_c0, d1_c1 = d0 * c0, d1 * c1
            if (d0 > d1 and d0_c0 < d1_c1) or (d0 <= d1 and d0_c0 > d1_c1):
                break
        else:
            i = 3
    fwd_o = quant_dist_lookup[i][order]
    bck_o = quant_dist_lookup[i][1 - order]
    return fwd_o, bck_o, True


def build_inter_predictors(dec, xd, mbmi, plane, dst, dst_x, dst_y):
    """build_inter_predictors (reconinter_template.inc): writes the plane
    prediction for the whole block into dst (the frame plane) at plane
    pixel coords (dst_x, dst_y)."""
    bsize = mbmi.bsize
    ss_x, ss_y = dec.ss[plane]
    bw_px = int(BLOCK_WIDTH[bsize])
    bh_px = int(BLOCK_HEIGHT[bsize])
    is_sub4_x = bw_px == 4 and ss_x
    is_sub4_y = bh_px == 4 and ss_y
    sub8x8 = False
    if plane and (is_sub4_x or is_sub4_y) and not mbmi.use_intrabc:
        sub8x8 = True
        row_start = -1 if is_sub4_y else 0
        col_start = -1 if is_sub4_x else 0
        for row in range(row_start, 1):
            for col in range(col_start, 1):
                mb = xd.mi[xd.mi_row + row, xd.mi_col + col]
                if not mb.is_inter or mb.use_intrabc:
                    sub8x8 = False
    if sub8x8:
        b4_w = bw_px >> ss_x
        b4_h = bh_px >> ss_y
        pb = get_plane_block_size(bsize, ss_x, ss_y)
        b8_w = int(BLOCK_WIDTH[pb])
        b8_h = int(BLOCK_HEIGHT[pb])
        row_start = -1 if is_sub4_y else 0
        col_start = -1 if is_sub4_x else 0
        row = row_start
        for y in range(0, b8_h, b4_h):
            col = col_start
            for x in range(0, b8_w, b4_w):
                mb = xd.mi[xd.mi_row + row, xd.mi_col + col]
                ref_slot = dec.refs[mb.ref_frame[0]]
                pre_x = ((xd.mi_col + col_start) * 4 >> ss_x) + x
                pre_y = ((xd.mi_row + row_start) * 4 >> ss_y) + y
                # note: per-sub-block mbmi supplies mv + interp filters
                pred = _predict_one(dec, mb, ref_slot, mb.mv[0], xd, plane,
                                    pre_x, pre_y, b4_w, b4_h, ss_x, ss_y,
                                    False)
                dst[dst_y + y : dst_y + y + b4_h,
                    dst_x + x : dst_x + x + b4_w] = pred
                col += 1
            row += 1
        return
    bw = bw_px >> ss_x if not (plane and is_sub4_x) else bw_px
    bh = bh_px >> ss_y if not (plane and is_sub4_y) else bh_px
    # 8x8-and-bigger path: pre origin shifts for sub-8 chroma
    row_start = -1 if (plane and is_sub4_y) else 0
    col_start = -1 if (plane and is_sub4_x) else 0
    pre_x = ((xd.mi_col + col_start) * 4) >> ss_x
    pre_y = ((xd.mi_row + row_start) * 4) >> ss_y
    if plane:
        pbs = get_plane_block_size(bsize, ss_x, ss_y) if not (
            is_sub4_x or is_sub4_y) else None
        if pbs is not None:
            bw = int(BLOCK_WIDTH[pbs])
            bh = int(BLOCK_HEIGHT[pbs])
    is_compound = mbmi.is_compound
    if not is_compound:
        # av1_init_warp_params + av1_allow_warp: warp only when this plane's
        # region is >= 8x8, MVs are fractional-capable, and the local/global
        # model is valid; otherwise plain translational MC
        use_warp = False
        wm = None
        ref_scaled = (dec.refs[mbmi.ref_frame[0]]["upscaled_width"]
                      != dec.fh.width
                      or dec.refs[mbmi.ref_frame[0]]["height"]
                      != dec.fh.height)
        if bw >= 8 and bh >= 8 and not dec.force_integer_mv \
                and not ref_scaled:
            # av1_allow_warp additionally requires an UNSCALED reference
            # (reconinter.c: av1_is_scaled -> no warp); the WARPED_CAUSAL
            # syntax still parses, prediction falls back to translation
            if mbmi.motion_mode == WARPED_CAUSAL and mbmi.wm_params is not None \
                    and not mbmi.wm_params.invalid:
                use_warp, wm = True, mbmi.wm_params
            elif MR.is_global_mv_block(
                    mbmi, dec.global_motion[mbmi.ref_frame[0]].wmtype) \
                    and not dec.global_motion[mbmi.ref_frame[0]].invalid:
                use_warp, wm = True, dec.global_motion[mbmi.ref_frame[0]]
        if use_warp:
            pred = _predict_warp(dec, xd, mbmi, wm, plane, pre_x, pre_y,
                                 bw, bh, ss_x, ss_y)
        else:
            ref_slot = dec.refs[mbmi.ref_frame[0]]
            pred = _predict_one(dec, mbmi, ref_slot, mbmi.mv[0], xd, plane,
                                pre_x, pre_y, bw, bh, ss_x, ss_y, False)
        dst[dst_y : dst_y + bh, dst_x : dst_x + bw] = pred
        return
    # compound: two first-pass buffers then average / dist-wtd / masked
    convs = []
    for ref in range(2):
        ref_slot = dec.refs[mbmi.ref_frame[ref]]
        convs.append(_predict_one(dec, mbmi, ref_slot, mbmi.mv[ref], xd,
                                  plane, pre_x, pre_y, bw, bh, ss_x, ss_y,
                                  True))
    if mbmi.comp_type in (COMPOUND_AVERAGE, COMPOUND_DISTWTD):
        fwd_o, bck_o, use_dw = dist_wtd_comp_weights(dec, mbmi)
        pred = COMP.dist_wtd_avg(convs[0], convs[1], fwd_o, bck_o, use_dw,
                                 bd=dec.bd)
    else:
        pred = _masked_blend(dec, mbmi, convs[0], convs[1], plane, bw, bh,
                             ss_x, ss_y)
    dst[dst_y : dst_y + bh, dst_x : dst_x + bw] = pred


def _masked_blend(dec, mbmi, conv0, conv1, plane, bw, bh, ss_x, ss_y):
    """Wedge / diff-wtd compound (av1_make_masked_inter_predictor): the
    luma-sized mask is built once on plane 0 (diffwtd from the plane-0
    CONV_BUF intermediates) and reused subsampled for chroma."""
    from ..ops import compound as CP
    if plane == 0:
        if mbmi.comp_type == COMPOUND_WEDGE:
            dec._seg_mask = CP.wedge_mask(mbmi.bsize, mbmi.wedge_index,
                                          mbmi.wedge_sign)
        else:
            dec._seg_mask = CP.build_compound_diffwtd_mask_d16(
                conv0, conv1, mbmi.mask_type == 1, bd=dec.bd)
    return CP.blend_a64_d16_mask(conv0, conv1, dec._seg_mask,
                                 ss_x if plane else 0, ss_y if plane else 0,
                                 bd=dec.bd)


def _predict_warp(dec, xd, mbmi, wm, plane, pre_x, pre_y, bw, bh, ss_x,
                  ss_y):
    """Warped motion / non-translational global motion prediction
    (av1_warp_plane): no stream the port writes uses it."""
    raise outside_the_port("warped prediction")


# ---------------------------------------------------------------------------
# OBMC (overlapped block motion compensation) — av1_build_obmc_inter_
# prediction + dec_build_prediction_by_{above,left}_preds
# ---------------------------------------------------------------------------
OBMC_MASKS = {
    1: [64],
    2: [45, 64],
    4: [39, 50, 59, 64],
    8: [36, 42, 48, 53, 57, 61, 64, 64],
    16: [34, 37, 40, 43, 46, 49, 52, 54, 56, 58, 60, 61, 64, 64, 64, 64],
    32: [33, 35, 36, 38, 40, 41, 43, 44, 45, 47, 48, 50, 51, 52, 53, 55,
         56, 57, 58, 59, 60, 60, 61, 62, 64, 64, 64, 64, 64, 64, 64, 64],
}
MAX_NEIGHBOR_OBMC = [0, 1, 2, 3, 4, 4]


class _ObmcXd:
    """Edge-clamp context for a neighbor's OBMC prediction."""
    __slots__ = ("mb_to_left_edge", "mb_to_right_edge", "mb_to_top_edge",
                 "mb_to_bottom_edge")


def _skip_u4x4(bsize, ss_x, ss_y, direction):
    pb = get_plane_block_size(bsize, ss_x, ss_y)
    if pb in (0, 1, 2):  # 4x4, 4x8, 8x4
        return direction == 0
    return False


def obmc_predict(dec, xd, mbmi, is_chroma_ref):
    """Blend above/left neighbor predictions into the current block's MC
    prediction (in the frame planes)."""
    bsize = mbmi.bsize
    bw4, bh4 = int(MI_W[bsize]), int(MI_H[bsize])
    bw_px, bh_px = int(BLOCK_WIDTH[bsize]), int(BLOCK_HEIGHT[bsize])
    mi_row, mi_col = xd.mi_row, xd.mi_col

    def predict_nb(nb, nb_mi_row, nb_mi_col, plane, pre_x, pre_y, w, h,
                   ss_x, ss_y, edges):
        nxd = _ObmcXd()
        (nxd.mb_to_left_edge, nxd.mb_to_right_edge,
         nxd.mb_to_top_edge, nxd.mb_to_bottom_edge) = edges
        ref_slot = dec.refs[nb.ref_frame[0]]
        return _predict_one(dec, nb, ref_slot, nb.mv[0], nxd, plane,
                            pre_x, pre_y, w, h, ss_x, ss_y, False)

    # ---- above pass ----
    if xd.up_available:
        nb_max = MAX_NEIGHBOR_OBMC[bw4.bit_length() - 1]
        this_height = bh4 * 4
        pred_height = min(this_height // 2, 32)
        overlap = min(bh_px, 64) >> 1
        nb_count = 0
        end_col = min(mi_col + bw4, dec.mi_cols)
        col = mi_col
        while col < end_col and nb_count < nb_max:
            nb = xd.mi[mi_row - 1, col]
            step = min(int(MI_W[nb.bsize]), 16)
            if step == 1:
                col &= ~1
                nb = xd.mi[mi_row - 1, col + 1]
                step = 2
            if nb.is_inter:
                nb_count += 1
                rel_col = col - mi_col
                op = min(bw4, step)
                nb2 = _shallow_nb(nb)
                for plane in range(dec.nplanes):
                    if plane and not is_chroma_ref:
                        break
                    ss_x, ss_y = dec.ss[plane]
                    if _skip_u4x4(bsize, ss_x, ss_y, 0):
                        continue
                    w = (op * 4) >> ss_x
                    h = MR.clamp(bh_px >> (ss_y + 1), 4, 32 >> ss_y)
                    pre_x = ((mi_col + rel_col) * 4) >> ss_x
                    pre_y = (mi_row * 4) >> ss_y
                    edges = (
                        -((mi_col + rel_col) * 32),
                        (dec.mi_cols - bw4 - mi_col) * 32
                        + (bw4 - rel_col - op) * 32,
                        -(mi_row * 32),
                        (dec.mi_rows - bh4 - mi_row) * 32
                        + (this_height - pred_height) * 8,
                    )
                    pred = predict_nb(nb2, mi_row, mi_col + rel_col, plane,
                                      pre_x, pre_y, w, h, ss_x, ss_y, edges)
                    # blend with vertical obmc mask over bh_ov rows
                    bh_ov = overlap >> ss_y
                    mask = np.array(OBMC_MASKS[bh_ov], np.int32)[:, None]
                    buf = dec.planes[plane]
                    y0 = (mi_row * 4) >> ss_y
                    x0 = ((mi_col + rel_col) * 4) >> ss_x
                    cur = buf[y0 : y0 + bh_ov, x0 : x0 + w].astype(np.int64)
                    tmp = pred[:bh_ov].astype(np.int64)
                    buf[y0 : y0 + bh_ov, x0 : x0 + w] = \
                        (mask * cur + (64 - mask) * tmp + 32) >> 6
            col += step

    # ---- left pass ----
    if xd.left_available:
        nb_max = MAX_NEIGHBOR_OBMC[bh4.bit_length() - 1]
        this_width = bw4 * 4
        pred_width = min(this_width // 2, 32)
        overlap = min(bw_px, 64) >> 1
        nb_count = 0
        end_row = min(mi_row + bh4, dec.mi_rows)
        row = mi_row
        while row < end_row and nb_count < nb_max:
            nb = xd.mi[row, mi_col - 1]
            step = min(int(MI_H[nb.bsize]), 16)
            if step == 1:
                row &= ~1
                nb = xd.mi[row + 1, mi_col - 1]
                step = 2
            if nb.is_inter:
                nb_count += 1
                rel_row = row - mi_row
                op = min(bh4, step)
                nb2 = _shallow_nb(nb)
                for plane in range(dec.nplanes):
                    if plane and not is_chroma_ref:
                        break
                    ss_x, ss_y = dec.ss[plane]
                    if _skip_u4x4(bsize, ss_x, ss_y, 1):
                        continue
                    w = MR.clamp(bw_px >> (ss_x + 1), 4, 32 >> ss_x)
                    h = (op * 4) >> ss_y
                    pre_x = (mi_col * 4) >> ss_x
                    pre_y = ((mi_row + rel_row) * 4) >> ss_y
                    edges = (
                        -(mi_col * 32),
                        (dec.mi_cols - bw4 - mi_col) * 32
                        + (this_width - pred_width) * 8,
                        -((mi_row + rel_row) * 32),
                        (dec.mi_rows - bh4 - mi_row) * 32
                        + (bh4 - rel_row - op) * 32,
                    )
                    pred = predict_nb(nb2, mi_row + rel_row, mi_col, plane,
                                      pre_x, pre_y, w, h, ss_x, ss_y, edges)
                    bw_ov = overlap >> ss_x
                    mask = np.array(OBMC_MASKS[bw_ov], np.int32)[None, :]
                    buf = dec.planes[plane]
                    y0 = ((mi_row + rel_row) * 4) >> ss_y
                    x0 = (mi_col * 4) >> ss_x
                    cur = buf[y0 : y0 + h, x0 : x0 + bw_ov].astype(np.int64)
                    tmp = pred[:, :bw_ov].astype(np.int64)
                    buf[y0 : y0 + h, x0 : x0 + bw_ov] = \
                        (mask * cur + (64 - mask) * tmp + 32) >> 6
            row += step


def _shallow_nb(nb):
    """av1_modify_neighbor_predictor_for_obmc on a copy."""
    from ..normative.mvref import MbInfo
    c = MbInfo()
    for s in MbInfo.__slots__:
        try:
            setattr(c, s, getattr(nb, s))
        except AttributeError:
            pass
    c.ref_frame = [nb.ref_frame[0], MR.NONE_FRAME]
    c.mv = list(nb.mv)
    c.comp_type = COMPOUND_AVERAGE
    return c
