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
//
// Kernel KM: subpel_refine49.
//
// Replaces the jnp branch of the reference's batched_subpel_refine
// (aom_av1_psy_tpu/ops/mvsearch.py:195-223): the 49-point quarter-pel
// lattice around each block's full-pel winner, r8 = 8 + 2 * dr and
// c8 = 8 + 2 * dc for dr, dc in -3..3 (dr-major), each candidate predicted
// from the window's region at (r8 >> 3, c8 >> 3) with phases
// ((c8 & 7) << 1, (r8 & 7) << 1) through the facade path those phases
// select, its SAD against the block, and the first-index argmin. The
// prediction is av1conv::subpel_block (csrc/convolve.cuh), the code KL runs.
//
// What bounds it: at the 1080p P-frame's 16x16 grid (B = 8160) 49
// predictions of up to 16 + 16 tap operations and a 3-operation SAD per
// pixel, ~3.5 G integer operations against ~30 MB of windows and blocks:
// operation bound (about 0.05 ms at 67 T/s). Design: one CTA per block; the
// (h+9) x (w+9) window, the block, the intermediate and the prediction in
// shared memory (dynamic); the candidates run in turn, each a predict and
// a block-wide SAD; thread 0 takes the first-index argmin.
#include <limits.h>

#include "convolve.cuh"

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

namespace {

__global__ void __launch_bounds__(kThreads)
    km_kernel(const int* __restrict__ src, const int* __restrict__ win, int w,
              int h, const int* __restrict__ tabx,
              const int* __restrict__ taby, int bd, int* best_idx,
              int* best_sad) {
  extern __shared__ int sm[];
  const int ww = w + 9, wh = h + 9;
  int* swin = sm;                  // (h+9, w+9)
  int* sblk = swin + wh * ww;      // (h, w)
  int* im = sblk + h * w;          // (h+7, w)
  int* pred = im + (h + 7) * w;    // (h, w)
  __shared__ int stab[256], sads[49], red[kThreads / 32];
  const long long b = blockIdx.x;
  const int* gw = win + b * wh * ww;
  const int* gs = src + b * h * w;
  for (int p = threadIdx.x; p < wh * ww; p += kThreads) swin[p] = gw[p];
  for (int p = threadIdx.x; p < h * w; p += kThreads) sblk[p] = gs[p];
  av1conv::load_taps(tabx, taby, stab);
  __syncthreads();
  for (int c = 0; c < 49; ++c) {
    const int r8 = 8 + 2 * (c / 7 - 3), c8 = 8 + 2 * (c % 7 - 3);
    const int sr = (r8 & 7) << 1, sc = (c8 & 7) << 1;
    av1conv::subpel_block(swin + (r8 >> 3) * ww + (c8 >> 3), ww, w, h, sc,
                          sr, stab + sc * 8, stab + 128 + sr * 8, bd, im,
                          pred, w);
    int s = 0;
    for (int p = threadIdx.x; p < h * w; p += kThreads)
      s += abs(pred[p] - sblk[p]);
    s = block_sum(s, red);  // its barriers order pred's reads before reuse
    if (threadIdx.x == 0) sads[c] = s;
  }
  if (threadIdx.x == 0) {
    int bi = 0;
    for (int c = 1; c < 49; ++c)
      if (sads[c] < sads[bi]) bi = c;
    best_idx[b] = bi;
    best_sad[b] = sads[bi];
  }
}

}  // namespace

AV1_EXPORT int subpel_refine49(const int* src, const int* win, int B, int w,
                               int h, const int* tabx, const int* taby,
                               int bd, int* best_idx, int* best_sad,
                               void* stream) {
  if (B <= 0) return 0;
  if (w <= 0 || h <= 0 || w > 64 || h > 64 || bd < 8 || bd > 12)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(int) * ((size_t)(h + 9) * (w + 9) + (size_t)(3 * h + 7) * w);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        km_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  km_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      src, win, w, h, tabx, taby, bd, best_idx, best_sad);
  return (int)cudaGetLastError();
}
