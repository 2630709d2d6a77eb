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
// takes the operands from registers instead:
// - one CTA per block; the window (zero past its width) and the block are
//   staged into shared memory with cp.async;
// - a thread owns a strip of kR = 12 horizontally adjacent offsets of one
//   offset row (33 = 3 strips; the last strip of a row computes phantom
//   offsets that are never compared) and a row group g of G: block rows g,
//   g + G, ...; for each block row it reads each block value once (the
//   same address across the strips of a warp) and updates kR running
//   SADs;
// - 8-bit samples go four to a word where the CTA finds every staged value
//   in 0..255 (and the candidate stride is 1, the width a multiple of 4):
//   one vabsdiff4 with accumulate (`sad4`) scores four pixels of one
//   offset, the window words of the 12 offsets come from 4 words by byte
//   permutes, about 0.5 instructions per pixel-SAD; otherwise (a value
//   past 255, a width not a multiple of 4, the coarse level's stride) the
//   same strips run on 32-bit values, one shared read and one __sad per
//   pixel-SAD; the result is the same either way;
// - the G row groups of a strip sit in adjacent lanes and add their
//   partial SADs with xor shuffles; G = 2 at 33 x 33 (198 of 224 threads
//   busy, equal work each);
// - the shared-memory row strides spread the lanes of a warp (2 block
//   rows, 16 strips) over distinct banks or the same word;
// - the first strict `<` in a thread (offsets rise within it), then
//   better() (lowest index on ties) across lanes and warps.
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

constexpr int kThreads = 256;   // KM
constexpr int kR = 12;          // KJ: offsets per strip, a multiple of 4
constexpr int kMaxThreads = 512;

__device__ __forceinline__ bool better(int s, int i, int bs, int bi) {
  return s < bs || (s == bs && i < bi);
}

struct KJArgs {
  const int* src;      // (B, h, w)
  const int* win;      // (B, wh, ww) windows, or the plane (H, W)
  const int* oy;       // (B,) window origins in the plane, or null
  const int* ox;
  int H, W;            // the plane (origins clamp to it)
  int h, w, wh, ww, m, stride;
  int S, G;            // strips per offset row, row groups per strip
  int sw, bs;          // shared-memory row strides: window, block
  int swp, bsp;        // the same in words of four 8-bit samples; 0: the
                       // launch runs on 32-bit values only
  const int* cost;     // (m * m,) or null
  int* best_idx;
  int* best_sad;
};

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// d = c + |a0 - b0| + |a1 - b1| + |a2 - b2| + |a3 - b3| over the bytes
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

// kR running SADs of one block row on 8-bit samples four to a word: wr is
// the window row at the strip's first offset (a multiple of 4), q the
// block row, nq = w / 4 words. W[] holds the 16 window bytes that the 12
// offsets of 4 columns read.
__device__ __forceinline__ void strip_row_packed(const unsigned* wr,
                                                 const unsigned* q, int nq,
                                                 unsigned (&s)[kR]) {
  unsigned W[4];
  W[0] = wr[0];
  W[1] = wr[1];
  W[2] = wr[2];
  for (int k = 0; k < nq; ++k) {
    W[3] = wr[k + 3];
    const unsigned qv = q[k];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = r >> 2, sh = r & 3;
      const unsigned x =
          sh ? __byte_perm(W[i], W[i + 1], 0x3210 + sh * 0x1111) : W[i];
      s[r] = sad4(x, qv, s[r]);
    }
    W[0] = W[1];
    W[1] = W[2];
    W[2] = W[3];
  }
}

// kR running SADs of one block row on 32-bit values: wr is the window row
// at the strip's first offset, q the block row; the strip's offsets are
// `stride` apart (1 dense, `step` at the coarse level).
__device__ __forceinline__ void strip_row_strided(const int* wr, const int* q,
                                                  int w, int stride,
                                                  unsigned (&s)[kR]) {
  for (int j = 0; j < w; ++j) {
    const int qv = q[j];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = __sad(wr[r * stride + j], qv, s[r]);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2) kj_kernel(KJArgs a) {
  extern __shared__ int sm[];
  int* swin = sm;                   // (wh, sw), zero past ww
  int* sblk = sm + a.wh * a.sw;     // (h, bs)
  __shared__ int rs[kMaxThreads / 32], ri[kMaxThreads / 32];
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
  const int* gs = a.src + b * a.h * a.w;
  for (int r = warp; r < a.wh; r += nw)
    for (int c = lane; c < a.sw; c += 32) {
      if (c < a.ww)
        cp_async4(swin + r * a.sw + c, gw + r * ld + c);
      else
        swin[r * a.sw + c] = 0;
    }
  for (int r = warp; r < a.h; r += nw)
    for (int c = lane; c < a.w; c += 32)
      cp_async4(sblk + r * a.bs + c, gs + r * a.w + c);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // four 8-bit samples to a word where every staged value lies in 0..255
  unsigned* pwin = (unsigned*)(sblk + a.h * a.bs);  // (wh, swp)
  unsigned* pblk = pwin + a.wh * a.swp;             // (h, bsp)
  bool packed = false;
  if (a.swp) {
    int ok = 1;
    for (int r = warp; r < a.wh; r += nw)
      for (int c = lane; c < a.ww; c += 32)
        ok &= (unsigned)swin[r * a.sw + c] <= 255u;
    for (int r = warp; r < a.h; r += nw)
      for (int c = lane; c < a.w; c += 32)
        ok &= (unsigned)sblk[r * a.bs + c] <= 255u;
    packed = __syncthreads_and(ok);
  }
  if (packed) {
    for (int r = warp; r < a.wh; r += nw)
      for (int k = lane; k < a.swp; k += 32) {
        unsigned v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * k + e;
          v |= (unsigned)(c < a.ww ? swin[r * a.sw + c] : 0) << (8 * e);
        }
        pwin[r * a.swp + k] = v;
      }
    for (int r = warp; r < a.h; r += nw)
      for (int k = lane; k < a.w / 4; k += 32) {
        const int* x = sblk + r * a.bs + 4 * k;
        pblk[r * a.bsp + k] = (unsigned)x[0] | (unsigned)x[1] << 8 |
                              (unsigned)x[2] << 16 | (unsigned)x[3] << 24;
      }
    __syncthreads();
  }

  const int ns = a.m * a.S, items = ns * a.G;
  int best = INT_MAX, bi = INT_MAX;
  // the trip count is the same for every thread: the shuffles see full
  // warps (blockDim is a multiple of 32 and of G)
  for (int base = 0; base < items; base += blockDim.x) {
    const int it = base + threadIdx.x;
    const int strip = it / a.G, g = it - strip * a.G;
    const int ky = strip / a.S, ox0 = (strip - ky * a.S) * kR;
    unsigned s[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = 0;
    if (strip < ns && packed) {
      const unsigned* w0 = pwin + ky * a.swp + ox0 / 4;
      for (int i = g; i < a.h; i += a.G)
        strip_row_packed(w0 + i * a.swp, pblk + i * a.bsp, a.w / 4, s);
    } else if (strip < ns) {
      const int* w0 = swin + ky * a.stride * a.sw + ox0 * a.stride;
      for (int i = g; i < a.h; i += a.G)
        strip_row_strided(w0 + i * a.sw, sblk + i * a.bs, a.w, a.stride, s);
    }
    for (int off = 1; off < a.G; off <<= 1) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    }
    if (strip < ns && g == 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (ox0 + r < a.m) {
          const int o = ky * a.m + ox0 + r;
          int t = (int)s[r];
          if (a.cost) t += a.cost[o];
          if (t < best) {  // offsets rise within a thread: keep the first
            best = t;
            bi = o;
          }
        }
      }
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
  if (lane == 0) {
    rs[warp] = best;
    ri[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < nw; ++k)
      if (better(rs[k], ri[k], best, bi)) {
        best = rs[k];
        bi = ri[k];
      }
    a.best_idx[b] = bi;
    a.best_sad[b] = best;
  }
}

// Fills the launch shape of `a` (strips, row groups, strides) and launches.
int kj_launch(KJArgs a, int B, void* stream) {
  if (B <= 0) return 0;
  if (a.h <= 0 || a.w <= 0 || a.m <= 0 || a.stride <= 0 ||
      a.wh < a.h + (a.m - 1) * a.stride || a.ww < a.w + (a.m - 1) * a.stride)
    return (int)cudaErrorInvalidValue;
  a.S = (a.m + kR - 1) / kR;
  const int ns = a.m * a.S;
  a.G = ns * 2 <= kMaxThreads ? 2 : 1;
  const int items = ns * a.G;
  const int threads = items >= kMaxThreads ? kMaxThreads
                                           : (items + 31) / 32 * 32;
  // every strip's reads stay in the row: the last strip's last offset is
  // S * kR - 1, read up to w - 1 values past it
  const int need = a.ww > a.S * kR * a.stride + a.w
                       ? a.ww
                       : a.S * kR * a.stride + a.w;
  a.sw = need + (33 - need % 32) % 32;  // 1 mod 32
  a.bs = a.w | 1;                       // odd
  a.swp = a.bsp = 0;
  if (a.stride == 1 && a.w % 4 == 0) {
    // the last strip reads 3 words past the block's width; 9 mod 32
    const int words = (a.S * kR + a.w) / 4 + 1;
    a.swp = words + (41 - words % 32) % 32;
    a.bsp = (a.w / 4) | 1;
  }
  const size_t smem =
      sizeof(int) * ((size_t)a.wh * a.sw + (size_t)a.h * a.bs +
                     (size_t)a.wh * a.swp + (size_t)a.h * a.bsp);
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
  KJArgs a{src, win, nullptr, nullptr, 0, 0, h, w, wh, ww, m, stride,
           0, 0, 0, 0, 0, 0, cost, best_idx, best_sad};
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
  KJArgs a{src, plane, oy, ox, H, W, h, w, h + m - 1, w + m - 1, m, 1,
           0, 0, 0, 0, 0, 0, cost, best_idx, best_sad};
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
