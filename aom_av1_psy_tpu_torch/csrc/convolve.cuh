// The constants of the single-reference subpel prediction of
// av1_convolve_2d_facade, shared by kernels KL (csrc/convolve.cu) and KM
// (csrc/mvsearch.cu).
//
// The prediction is the reference's predict_subpel
// (aom_av1_psy_tpu/ops/convolve.py:119) with its four paths, each rounding
// as the reference rounds it:
// - 2-D (both phases set): x pass over the (h+7, w+7) region with the offset
//   1 << (bd + 6), round 3; y pass with the offset 1 << (bd + 11), round 11,
//   then the offset's two terms subtracted (convolve_2d_sr, :64);
// - x only: rows 3..3+h of the region, round 3, then round 4
//   (convolve_x_sr, :92);
// - y only: columns 3..3+w, round 7 (convolve_y_sr, :106);
// - copy: the region at (3, 3).
// All but the copy clip to [0, (1 << bd) - 1]. Sums are int32, as in the
// reference: at 8 bits the largest intermediate is about 2^21. `>>` of a
// negative sum is an arithmetic shift, as numpy's and jnp's are.
#pragma once

#include "common.cuh"

namespace av1conv {

constexpr int kFilterBits = 7, kRound0 = 3;

}  // namespace av1conv
