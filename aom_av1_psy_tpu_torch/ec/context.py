"""Frame entropy context — the FRAME_CONTEXT analogue.

Holds every adaptive CDF group as a mutable numpy array, initialized from
the normative defaults (entropymode.c ``av1_init_mode_probs`` +
``av1_default_coef_probs`` with the 4-way qindex bucketing,
av1/common/entropy.c:31). Layouts mirror ``av1/common/entropymode.h:71-167``
exactly (icdf convention with trailing counter slot).
"""
from __future__ import annotations

import numpy as np

from ..normative import tables

# mode-CDF fields copied verbatim from the defaults table dump
_MODE_FIELDS = [
    "newmv_cdf", "zeromv_cdf", "refmv_cdf", "drl_cdf",
    "inter_compound_mode_cdf", "compound_type_cdf", "wedge_idx_cdf",
    "interintra_cdf", "wedge_interintra_cdf", "interintra_mode_cdf",
    "motion_mode_cdf", "obmc_cdf", "palette_y_size_cdf",
    "palette_uv_size_cdf", "palette_y_color_index_cdf",
    "palette_uv_color_index_cdf", "palette_y_mode_cdf",
    "palette_uv_mode_cdf", "comp_inter_cdf", "single_ref_cdf",
    "comp_ref_type_cdf", "uni_comp_ref_cdf", "comp_ref_cdf",
    "comp_bwdref_cdf", "txfm_partition_cdf", "compound_index_cdf",
    "comp_group_idx_cdf", "skip_mode_cdfs", "skip_txfm_cdfs",
    "intra_inter_cdf", "intrabc_cdf", "filter_intra_cdfs",
    "filter_intra_mode_cdf", "switchable_restore_cdf",
    "wiener_restore_cdf", "sgrproj_restore_cdf", "y_mode_cdf",
    "uv_mode_cdf", "partition_cdf", "switchable_interp_cdf", "kf_y_cdf",
    "angle_delta_cdf", "tx_size_cdf", "delta_q_cdf", "delta_lf_multi_cdf",
    "delta_lf_cdf", "intra_ext_tx_cdf", "inter_ext_tx_cdf", "cfl_sign_cdf",
    "cfl_alpha_cdf", "seg_pred_cdf", "seg_spatial_pred_cdf",
]

_NMV_FIELDS = [
    "joints_cdf", "comp0_classes_cdf", "comp0_class0_fp_cdf", "comp0_fp_cdf",
    "comp0_sign_cdf", "comp0_class0_hp_cdf", "comp0_hp_cdf",
    "comp0_class0_cdf", "comp0_bits_cdf", "comp1_classes_cdf",
    "comp1_class0_fp_cdf", "comp1_fp_cdf", "comp1_sign_cdf",
    "comp1_class0_hp_cdf", "comp1_hp_cdf", "comp1_class0_cdf",
    "comp1_bits_cdf",
]

# coefficient fields: dumped with a leading qctx dimension
_COEF_FIELDS = {
    "txb_skip_cdf": "coef_txb_skip_cdf",
    "eob_extra_cdf": "coef_eob_extra_cdf",
    "dc_sign_cdf": "coef_dc_sign_cdf",
    "coeff_br_cdf": "coef_br_cdf",
    "coeff_base_cdf": "coef_base_cdf",
    "coeff_base_eob_cdf": "coef_base_eob_cdf",
    "eob_flag_cdf16": "coef_eob_flag_cdf16",
    "eob_flag_cdf32": "coef_eob_flag_cdf32",
    "eob_flag_cdf64": "coef_eob_flag_cdf64",
    "eob_flag_cdf128": "coef_eob_flag_cdf128",
    "eob_flag_cdf256": "coef_eob_flag_cdf256",
    "eob_flag_cdf512": "coef_eob_flag_cdf512",
    "eob_flag_cdf1024": "coef_eob_flag_cdf1024",
}


class FrameContext:
    """Mutable per-tile CDF state (one instance per tile decode/encode)."""

    def __init__(self, base_qindex: int):
        for f in _MODE_FIELDS:
            setattr(self, f, tables.get(f).copy())
        for pfx in ("nmv", "ndv"):
            for f in _NMV_FIELDS:
                setattr(self, f"{pfx}_{f}", tables.get(f"{pfx}_{f}").copy())
        qctx = tables.coef_q_ctx(base_qindex)
        for attr, key in _COEF_FIELDS.items():
            setattr(self, attr, tables.get(key)[qctx].copy())

    def reset_counters(self) -> None:
        """av1_reset_cdf_symbol_counters (entropy.c:86): zero the adaptation
        counter of every cdf row — the reference does this when saving a
        frame context for future frames. The counter lives at row index
        ``nsymbs``, which for most tables is the last element; tables whose
        rows are wider than their symbol count (variable-nsymbs families)
        need the C function's special-cased indices."""
        import numpy as np
        special = {
            # partition_cdf: ctx<4 -> 4 syms, 4..15 -> 10, >=16 -> 8
            "partition_cdf": None,
            "uv_mode_cdf": None,
            "tx_size_cdf": None,
            "intra_ext_tx_cdf": None,
            "inter_ext_tx_cdf": None,
            "palette_y_color_index_cdf": None,
            "palette_uv_color_index_cdf": None,
        }
        for k, v in self.__dict__.items():
            if not isinstance(v, np.ndarray):
                continue
            if k not in special:
                v[..., -1] = 0
        p = self.partition_cdf
        p[:4, 4] = 0
        p[4:16, 10] = 0
        p[16:, 8] = 0
        self.uv_mode_cdf[0, :, 13] = 0
        self.uv_mode_cdf[1, :, 14] = 0
        self.tx_size_cdf[0, :, 2] = 0
        self.tx_size_cdf[1:, :, 3] = 0
        self.intra_ext_tx_cdf[1, ..., 7] = 0
        self.intra_ext_tx_cdf[2, ..., 5] = 0
        self.inter_ext_tx_cdf[1, ..., 16] = 0
        self.inter_ext_tx_cdf[2, ..., 12] = 0
        self.inter_ext_tx_cdf[3, ..., 2] = 0
        for j in range(7):
            self.palette_y_color_index_cdf[j, :, j + 2] = 0
            self.palette_uv_color_index_cdf[j, :, j + 2] = 0

    def copy(self) -> "FrameContext":
        out = object.__new__(FrameContext)
        for k, v in self.__dict__.items():
            setattr(out, k, v.copy())
        return out
