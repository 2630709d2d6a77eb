// Kernel KL: subpel_predict.
//
// Replaces the jnp branch of the reference's normative subpel prediction,
// predict_subpel and the convolve_2d_sr / convolve_x_sr / convolve_y_sr /
// copy paths it dispatches to (aom_av1_psy_tpu/ops/convolve.py:64-136), for a
// batch of blocks that each carry their own phases: the 9 half- or
// quarter-pel neighbours of a motion search, or the mode candidates of one
// block, go out in one launch. The arithmetic is av1conv::subpel_block
// (csrc/convolve.cuh), shared with KM.
//
// What bounds it: per output pixel at most 8 + 8 taps of 2 operations on
// int32 values; at the 1080p P-frame's 16x16 grid (B = 8160) that is ~70 M
// operations against ~17 MB of regions read and 8 MB written: bytes bound
// (about 8 us at 3.35 TB/s). Design: one CTA per block; the (h+7) x (w+7)
// region and the (h+7) x w intermediate sit in shared memory (38 KB at
// 64 x 64; dynamic above 48 KB), the CTA's threads stride over the pixels,
// and the 2 x 16 x 8 tap tables are copied into shared memory once.
#include "convolve.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    kl_kernel(const int* __restrict__ regions, int w, int h,
              const int* __restrict__ sx, const int* __restrict__ sy,
              const int* __restrict__ tabx, const int* __restrict__ taby,
              int bd, int* __restrict__ out) {
  extern __shared__ int sm[];
  const int rw = w + 7, rh = h + 7;
  int* reg = sm;             // (h+7, w+7)
  int* im = sm + rh * rw;    // (h+7, w)
  __shared__ int stab[256];  // tabx then taby, 16 x 8 each
  const long long b = blockIdx.x;
  const int* g = regions + b * rh * rw;
  for (int p = threadIdx.x; p < rh * rw; p += kThreads) reg[p] = g[p];
  av1conv::load_taps(tabx, taby, stab);
  __syncthreads();
  const int px = sx[b] & 15, py = sy[b] & 15;
  av1conv::subpel_block(reg, rw, w, h, px, py, stab + px * 8,
                        stab + 128 + py * 8, bd, im, out + b * h * w, w);
}

}  // namespace

AV1_EXPORT int subpel_predict(const int* regions, int B, int w, int h,
                              const int* sx, const int* sy, const int* tabx,
                              const int* taby, int bd, int* out,
                              void* stream) {
  if (B <= 0) return 0;
  if (w <= 0 || h <= 0 || w > 64 || h > 64 || bd < 8 || bd > 12)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)(h + 7) * (2 * w + 7);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kl_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      regions, w, h, sx, sy, tabx, taby, bd, out);
  return (int)cudaGetLastError();
}
