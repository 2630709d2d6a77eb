// Kernel KE: fullpel_ssd.
//
// Replaces the reference's exhaustive full-pel search, tpu_inter.
// _fullpel_search (aom_av1_psy_tpu/encoder/tpu_inter.py:106-159): two
// grouped lax.conv_general_dilated calls (the window/source correlation
// and the window sum of squares) and the argmin over the 33 x 33 offsets.
//
// The reference's score sumsq - 2 * corr is an exact float32: every conv
// partial sum is a non-negative integer below 255^2 * 256 < 2^24, and the
// difference lies between -sum(src^2) and sum(win^2). So the integer SSD,
// which is that score plus the per-block constant sum(src^2), orders the
// offsets the same way and ties on the same offsets. Ties go to the lowest
// flat index (dy-major over 33 x 33), as jnp.argmin's do; flat blocks tie
// on every offset.
//
// What bounds it: at 1080p the fine stage scores 1089 offsets x 256 pixels
// for each of 8160 blocks (2.3 G multiply-adds), the coarse stage 1089 x 64
// over 8160 blocks on the half-resolution plane: integer ALU bound, with
// every operand in shared memory. Design: one CTA per block; the clamped
// (bw + 32)^2 window and the block sit in shared memory, each thread owns
// offsets (strided), keeps its best (ssd, index) and a block argmin with
// the lowest-index tie rule ends it. No convolution library is involved.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kRad = 16, kN = 2 * kRad + 1, kThreads = 256;

struct KEArgs {
  const int* src;      // (B, bw, bw)
  const int* plane;    // (H, W)
  int H, W, crop_h, crop_w;
  const int* by;       // (B,) block origins
  const int* bx;
  const int* cy;       // (B,) window centres (offsets) or null
  const int* cx;
  int* dy;             // (B,) out: full-pel offsets (centre included)
  int* dx;
};

__device__ __forceinline__ bool better(int s, int i, int bs, int bi) {
  return s < bs || (s == bs && i < bi);
}

template <int BW>
__global__ void __launch_bounds__(kThreads) ke_kernel(KEArgs a) {
  constexpr int WW = BW + 2 * kRad;
  __shared__ int win[WW * WW];
  __shared__ int blk[BW * BW];
  __shared__ int rs[32], ri[32];
  const int b = blockIdx.x;
  const int cy = a.cy ? a.cy[b] : 0, cx = a.cx ? a.cx[b] : 0;
  const int oy = a.by[b] + cy - kRad, ox = a.bx[b] + cx - kRad;
  for (int p = threadIdx.x; p < WW * WW; p += kThreads) {
    const int y = clampi(oy + p / WW, 0, a.crop_h - 1);
    const int x = clampi(ox + p % WW, 0, a.crop_w - 1);
    win[p] = a.plane[(long long)y * a.W + x];
  }
  for (int p = threadIdx.x; p < BW * BW; p += kThreads)
    blk[p] = a.src[(long long)b * BW * BW + p];
  __syncthreads();

  int best = INT_MAX, bi = INT_MAX;
  for (int o = threadIdx.x; o < kN * kN; o += kThreads) {
    const int oy2 = o / kN, ox2 = o % kN;
    int s = 0;
    for (int i = 0; i < BW; ++i) {
      const int* w = win + (oy2 + i) * WW + ox2;
      const int* q = blk + i * BW;
#pragma unroll
      for (int j = 0; j < BW; ++j) {
        const int d = w[j] - q[j];
        s += d * d;
      }
    }
    if (s < best) {  // offsets rise within a thread: keep the first
      best = s;
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
    for (int w = 1; w < kThreads / 32; ++w)
      if (better(rs[w], ri[w], best, bi)) {
        best = rs[w];
        bi = ri[w];
      }
    a.dy[b] = bi / kN - kRad + cy;
    a.dx[b] = bi % kN - kRad + cx;
  }
}

}  // namespace

AV1_EXPORT int fullpel_ssd(const int* src, const int* plane, int H, int W,
                           int crop_h, int crop_w, const int* by,
                           const int* bx, const int* cy, const int* cx,
                           int B, int bw, int* dy, int* dx, void* stream) {
  if (B <= 0) return 0;
  if (crop_h <= 0 || crop_w <= 0 || crop_h > H || crop_w > W)
    return (int)cudaErrorInvalidValue;
  KEArgs a{src, plane, H, W, crop_h, crop_w, by, bx, cy, cx, dy, dx};
  cudaStream_t st = (cudaStream_t)stream;
  switch (bw) {
    case 8: ke_kernel<8><<<B, kThreads, 0, st>>>(a); break;
    case 16: ke_kernel<16><<<B, kThreads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
