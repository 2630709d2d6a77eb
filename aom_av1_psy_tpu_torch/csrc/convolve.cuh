// The single-reference subpel prediction of av1_convolve_2d_facade, shared
// by kernels KL (csrc/convolve.cu) and KM (csrc/mvsearch.cu).
//
// It is the reference's predict_subpel (aom_av1_psy_tpu/ops/convolve.py:119)
// with its four paths, each rounding as the reference rounds it:
// - 2-D (both phases set): x pass over the (h+7, w+7) region with the offset
//   1 << (bd + 6), round 3; y pass with the offset 1 << (bd + 11), round 11,
//   then the offset's two terms subtracted (convolve_2d_sr, :64);
// - x only: rows 3..3+h of the region, round 3, then round 4
//   (convolve_x_sr, :92);
// - y only: columns 3..3+w, round 7 (convolve_y_sr, :106);
// - copy: the region at (3, 3).
// All clip to [0, (1 << bd) - 1]. Sums are int32, as in the reference: at
// 8 bits the largest intermediate is about 2^21. `>>` of a negative sum is
// an arithmetic shift, as numpy's and jnp's are.
#pragma once

#include "common.cuh"

namespace av1conv {

constexpr int kFilterBits = 7, kRound0 = 3;

__device__ __forceinline__ int round2(int v, int bits) {
  return (v + (1 << (bits - 1))) >> bits;
}

// Predict the (h, w) block whose (h+7, w+7) region starts at `reg` (row
// stride rs) at phases sx, sy (0..15) with the 8-tap kernels kx, ky. Every
// thread of the CTA takes part. `im` is (h+7) * w ints of scratch; `out`
// (row stride os) may be shared or device memory. Ends with a barrier, so
// `im` and `reg` may be rewritten after it.
__device__ void subpel_block(const int* reg, int rs, int w, int h, int sx,
                             int sy, const int* kx, const int* ky, int bd,
                             int* im, int* out, int os) {
  const int maxv = (1 << bd) - 1;
  if (sx && sy) {
    const int off = 1 << (bd + kFilterBits - 1);
    for (int p = threadIdx.x; p < (h + 7) * w; p += blockDim.x) {
      const int r = p / w, c = p % w;
      const int* s = reg + r * rs + c;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kx[k] * s[k];
      im[p] = round2(acc + off, kRound0);
    }
    __syncthreads();
    const int round1 = 2 * kFilterBits - kRound0;
    const int offset_bits = bd + 2 * kFilterBits - kRound0;
    const int sub = (1 << (offset_bits - round1)) +
                    (1 << (offset_bits - round1 - 1));
    for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
      const int r = p / w, c = p % w;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += ky[k] * im[(r + k) * w + c];
      const int v = round2(acc + (1 << offset_bits), round1) - sub;
      out[r * os + c] = clampi(v, 0, maxv);
    }
  } else if (sx) {
    for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
      const int r = p / w, c = p % w;
      const int* s = reg + (r + 3) * rs + c;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kx[k] * s[k];
      const int v = round2(round2(acc, kRound0), kFilterBits - kRound0);
      out[r * os + c] = clampi(v, 0, maxv);
    }
  } else if (sy) {
    for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
      const int r = p / w, c = p % w;
      const int* s = reg + r * rs + c + 3;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += ky[k] * s[k * rs];
      out[r * os + c] = clampi(round2(acc, kFilterBits), 0, maxv);
    }
  } else {
    for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
      const int r = p / w, c = p % w;
      out[r * os + c] = reg[(r + 3) * rs + c + 3];
    }
  }
  __syncthreads();
}

// Both 16 x 8 tap tables into shared memory (256 ints).
__device__ __forceinline__ void load_taps(const int* tabx, const int* taby,
                                          int* stab) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    stab[i] = i < 128 ? tabx[i] : taby[i - 128];
}

}  // namespace av1conv
