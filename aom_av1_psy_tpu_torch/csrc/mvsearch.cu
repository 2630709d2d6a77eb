// Kernel KJ: fullpel_sad.
//
// Replaces the jnp branch of the reference's dense full-pel search,
// ops/mvsearch.py full_pel_grid_search / full_pel_hierarchical
// (aom_av1_psy_tpu/ops/mvsearch.py:48-134): the (B, n, n, h, w) candidate
// gather, |cand - src| summed over the block, the optional MV-cost grid,
// and the argmin over the flattened (dy-major) offsets. Ties go to the
// lowest flat index, as jnp.argmin's do: flat blocks tie on every offset.
//
// Two entries share one kernel body. `fullpel_sad` takes the caller's
// windows (B, wh, ww); `fullpel_sad_plane` reads each block's window where
// it lies in a plane, at the block's origin (oy, ox), so no window tensor
// is built (the temporal filter passes its frame padded with 128: nothing
// is clamped to a crop here, unlike KE in csrc/fullpel.cu). The candidate
// at grid point (ky, kx) is the window's (h, w) patch at (ky * stride,
// kx * stride): stride 1 is the dense scan, stride `step` the coarse level
// of full_pel_hierarchical.
//
// What bounds it: at 1080p the temporal filter scores 33 x 33 offsets of
// 1024 pixels for each of 1980 full blocks per reference frame, 2.2 G
// abs-diff-adds. A shared-memory read per operand (two 4-byte loads per
// pixel-SAD) would cap it at 16 pixel-SADs per clock per SM, so the design
// takes the operands from registers instead: one CTA per block, the window
// (zero past its width) and the block staged into shared memory with
// cp.async, and the offsets scored by the strip engine of csrc/strips.cuh
// (shared with KE): strips of 12 offsets in registers, four 8-bit samples
// to a word (one vabsdiff4 with accumulate per four pixel-SADs, about 0.5
// instructions per pixel-SAD) where the CTA finds every staged value in
// 0..255 and the candidate stride is 1, 32-bit strips otherwise; G = 2 row
// groups at 33 x 33 (198 of 224 threads busy, equal work each).
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
#include "strips.cuh"

namespace {

constexpr int kThreads = 256;   // KM
constexpr int kMaxThreads = 512;  // KJ

struct KJArgs {
  const int* src;      // (B, h, w)
  const int* win;      // (B, wh, ww) windows, or the plane (H, W)
  const int* oy;       // (B,) window origins in the plane, or null
  const int* ox;
  int H, W;            // the plane (origins clamp to it)
  int wh, ww;
  strips::Shape p;     // block (h, w), m, stride; kj_launch fills the rest
  const int* cost;     // (m * m,) or null
  int* best_idx;
  int* best_sad;
};

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Whether this thread's share of the staged values (rows wid, wid + nw, ...
// of warp wid of nw, columns lane, lane + 32, ...) lies in 0..255 (the
// CTA then agrees with __syncthreads_and).
__device__ __forceinline__ int fits(const strips::Shape& p,
                                    const strips::Smem& v, int wh, int ww,
                                    int wid, int nw, int lane) {
  int ok = 1;
  for (int r = wid; r < wh; r += nw)
    for (int c = lane; c < ww; c += 32)
      ok &= (unsigned)v.win[r * p.sw + c] <= 255u;
  for (int r = wid; r < p.h; r += nw)
    for (int c = lane; c < p.w; c += 32)
      ok &= (unsigned)v.blk[r * p.bs + c] <= 255u;
  return ok;
}

// Packs the staged values four 8-bit samples to a word (the CTA found that
// they fit); a barrier must follow before the words are read.
__device__ __forceinline__ void pack(const strips::Shape& p,
                                     const strips::Smem& v, int wh, int ww,
                                     int wid, int nw, int lane) {
  for (int r = wid; r < wh; r += nw)
    for (int k = lane; k < p.swp; k += 32) {
      unsigned x = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * k + e;
        x |= (unsigned)(c < ww ? v.win[r * p.sw + c] : 0) << (8 * e);
      }
      v.pwin[r * p.swp + k] = x;
    }
  for (int r = wid; r < p.h; r += nw)
    for (int k = lane; k < p.w / 4; k += 32) {
      const int* x = v.blk + r * p.bs + 4 * k;
      v.pblk[r * p.bsp + k] = (unsigned)x[0] | (unsigned)x[1] << 8 |
                              (unsigned)x[2] << 16 | (unsigned)x[3] << 24;
    }
}

__global__ void __launch_bounds__(kMaxThreads, 2) kj_kernel(KJArgs a) {
  extern __shared__ int sm[];
  __shared__ int rs[kMaxThreads / 32], ri[kMaxThreads / 32];
  const strips::Shape& p = a.p;
  const strips::Smem v(sm, p, a.wh);
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int* gw;
  long long ld;
  if (a.oy) {
    const int y = clampi(a.oy[b], 0, a.H - a.wh);
    const int x = clampi(a.ox[b], 0, a.W - a.ww);
    gw = a.win + (long long)y * a.W + x;
    ld = a.W;
  } else {
    gw = a.win + b * a.wh * a.ww;
    ld = a.ww;
  }
  const int* gs = a.src + b * p.h * p.w;
  for (int r = warp; r < a.wh; r += nw)
    for (int c = lane; c < p.sw; c += 32) {
      if (c < a.ww)
        cp_async4(v.win + r * p.sw + c, gw + r * ld + c);
      else
        v.win[r * p.sw + c] = 0;
    }
  for (int r = warp; r < p.h; r += nw)
    for (int c = lane; c < p.w; c += 32)
      cp_async4(v.blk + r * p.bs + c, gs + r * p.w + c);
  cp_async_wait_all();
  __syncthreads();

  bool packed = false;
  if (p.swp) {
    packed = __syncthreads_and(fits(p, v, a.wh, a.ww, warp, nw,
                                            lane));
    if (packed) {
      pack(p, v, a.wh, a.ww, warp, nw, lane);
      __syncthreads();
    }
  }
  int best, bi;
  const int* cost = a.cost;
  strips::best_of_strips<strips::Sad>(
      p, v, packed,
      [cost](unsigned sad, int o) {
        return cost ? (int)sad + cost[o] : (int)sad;
      },
      best, bi);
  strips::argmin_cta(best, bi, rs, ri);
  if (threadIdx.x == 0) {
    a.best_idx[b] = bi;
    a.best_sad[b] = best;
  }
}

// Fills the launch shape of `a` (strips, row groups, strides) and launches.
int kj_launch(KJArgs a, int B, void* stream) {
  strips::Shape& p = a.p;
  if (B <= 0) return 0;
  if (p.h <= 0 || p.w <= 0 || p.m <= 0 || p.stride <= 0 ||
      a.wh < p.h + (p.m - 1) * p.stride || a.ww < p.w + (p.m - 1) * p.stride)
    return (int)cudaErrorInvalidValue;
  const int ns = p.m * ((p.m + strips::kR - 1) / strips::kR);
  p.G = ns * 2 <= kMaxThreads ? 2 : 1;
  const int items = ns * p.G;
  const int threads = items >= kMaxThreads ? kMaxThreads
                                           : (items + 31) / 32 * 32;
  const size_t smem = sizeof(int) * (size_t)strips::plan(p, a.wh, a.ww);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kj_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

AV1_EXPORT int fullpel_sad(const int* src, const int* win, int B, int h,
                           int w, int wh, int ww, int m, int stride,
                           const int* cost, int* best_idx, int* best_sad,
                           void* stream) {
  KJArgs a{src, win, nullptr, nullptr, 0, 0, wh, ww,
           {h, w, m, stride}, cost, best_idx, best_sad};
  return kj_launch(a, B, stream);
}

// The windows (h + m - 1, w + m - 1) of plane (H, W) at origins oy/ox
// (B,), read where they lie; origins clamp to the plane.
AV1_EXPORT int fullpel_sad_plane(const int* src, const int* plane, int H,
                                 int W, const int* oy, const int* ox, int B,
                                 int h, int w, int m, const int* cost,
                                 int* best_idx, int* best_sad,
                                 void* stream) {
  if (h + m - 1 > H || w + m - 1 > W) return (int)cudaErrorInvalidValue;
  KJArgs a{src, plane, oy, ox, H, W, h + m - 1, w + m - 1, {h, w, m, 1},
           cost, best_idx, best_sad};
  return kj_launch(a, B, stream);
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
