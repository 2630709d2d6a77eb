// Kernel KJ: fullpel_sad.
//
// Replaces the jnp branch of the reference's dense full-pel search,
// ops/mvsearch.py full_pel_grid_search / full_pel_hierarchical
// (aom_av1_psy_tpu/ops/mvsearch.py:48-134): the (B, n, n, h, w) candidate
// gather, |cand - src| summed over the block, the optional MV-cost grid,
// and the argmin over the flattened (dy-major) offsets. Ties go to the
// lowest flat index, as jnp.argmin's do: flat blocks tie on every offset.
//
// The windows are the caller's: the temporal filter fills them with 128
// outside the frame, so unlike KE (csrc/fullpel.cu) nothing is clamped
// here. The candidate at grid point (ky, kx) is the window's (h, w) patch
// at (ky * stride, kx * stride): stride 1 is the dense scan, stride `step`
// the coarse level of full_pel_hierarchical.
//
// What bounds it: at 1080p the temporal filter scores 33 x 33 offsets of
// 1024 pixels for each of 2040 blocks per reference frame, 2.3 G
// abs-diff-adds: integer ALU bound, every operand in shared memory.
// Design: one CTA per block; the window and the block sit in shared memory
// (dynamic: (wh*ww + h*w) ints, 20 KB at r = 16, h = w = 32); each thread
// owns offsets (strided), sums with __sad (|x - y| + z in one instruction)
// and keeps its best (sad, index); a warp-shuffle argmin, then a block
// argmin over the warps, keep the lowest index on ties.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool better(int s, int i, int bs, int bi) {
  return s < bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(kThreads)
    kj_kernel(const int* __restrict__ src, const int* __restrict__ win, int h,
              int w, int wh, int ww, int m, int stride,
              const int* __restrict__ cost, int* best_idx, int* best_sad) {
  extern __shared__ int sm[];
  int* swin = sm;             // (wh, ww)
  int* sblk = sm + wh * ww;   // (h, w)
  __shared__ int rs[kThreads / 32], ri[kThreads / 32];
  const long long b = blockIdx.x;
  const int* gw = win + b * wh * ww;
  const int* gs = src + b * h * w;
  for (int p = threadIdx.x; p < wh * ww; p += kThreads) swin[p] = gw[p];
  for (int p = threadIdx.x; p < h * w; p += kThreads) sblk[p] = gs[p];
  __syncthreads();

  int best = INT_MAX, bi = INT_MAX;
  for (int o = threadIdx.x; o < m * m; o += kThreads) {
    const int oy = (o / m) * stride, ox = (o % m) * stride;
    unsigned int s = 0;
    for (int i = 0; i < h; ++i) {
      const int* wr = swin + (oy + i) * ww + ox;
      const int* q = sblk + i * w;
#pragma unroll 8
      for (int j = 0; j < w; ++j) s = __sad(wr[j], q[j], s);
    }
    int t = (int)s;
    if (cost) t += cost[o];
    if (t < best) {  // offsets rise within a thread: keep the first
      best = t;
      bi = o;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(s, i, best, bi)) {
      best = s;
      bi = i;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    rs[warp] = best;
    ri[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k)
      if (better(rs[k], ri[k], best, bi)) {
        best = rs[k];
        bi = ri[k];
      }
    best_idx[b] = bi;
    best_sad[b] = best;
  }
}

}  // namespace

AV1_EXPORT int fullpel_sad(const int* src, const int* win, int B, int h,
                           int w, int wh, int ww, int m, int stride,
                           const int* cost, int* best_idx, int* best_sad,
                           void* stream) {
  if (B <= 0) return 0;
  if (h <= 0 || w <= 0 || m <= 0 || stride <= 0 ||
      wh < h + (m - 1) * stride || ww < w + (m - 1) * stride)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * ((size_t)wh * ww + (size_t)h * w);
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kj_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      src, win, h, w, wh, ww, m, stride, cost, best_idx, best_sad);
  return (int)cudaGetLastError();
}
