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
// on every offset. The kernel's sums are exact while an SSD stays below
// 2^31 (samples of up to 11 bits at bw 16).
//
// What bounds it: at 1080p the fine stage scores 1089 offsets x 256 pixels
// for each of 8160 blocks (2.3 G pixel-SSDs), the coarse stage 1089 x 64
// over 8160 blocks on the half-resolution plane: integer operations, with
// the window and the block in shared memory. Design: one CTA per block; one
// pass stages the block's (bw + 32)^2 window (centred on its origin plus
// the optional centre, clamped to the crop) and the block into shared
// memory, as 32-bit values and four 8-bit samples to a word at once, and
// checks their range; the strip engine of csrc/strips.cuh (shared with KJ)
// scores the offsets: strips of 12 offsets in registers, on words where the
// CTA finds every staged value in 0..255 (__vabsdiffu4, then
// __dp4a(d, d, acc)), on 32-bit values otherwise. One row group per strip:
// 99 strips, 128 threads, at both widths. No convolution library is
// involved.
#include "strips.cuh"

namespace {

constexpr int kRad = 16, kN = 2 * kRad + 1, kMaxThreads = 512;

struct KEArgs {
  const int* src;      // (B, bw, bw)
  const int* plane;    // (H, W)
  int W, crop_h, crop_w;
  const int* by;       // (B,) block origins
  const int* bx;
  const int* cy;       // (B,) window centres (offsets) or null
  const int* cx;
  int* dy;             // (B,) out: full-pel offsets (centre included)
  int* dx;
  strips::Shape p;
};

// Stages block b's clamped (WW, WW) window at (oy, ox) and its (BW, BW)
// source: 32-bit values into v.win / v.blk and the same four to a word
// into v.pwin / v.pblk (NWORDS words per window row, the words a strip row
// reads, zero past WW). Returns whether this thread's values lie in
// 0..255.
template <int BW>
__device__ __forceinline__ int stage(const KEArgs& a, const strips::Smem& v,
                                     long long b, int oy, int ox) {
  constexpr int WW = BW + 2 * kRad;
  constexpr int NWORDS = (3 * strips::kR + BW) / 4 + 1;
  const strips::Shape& p = a.p;
  int ok = 1;
  for (int it = threadIdx.x; it < WW * NWORDS; it += blockDim.x) {
    const int r = it / NWORDS, k = it - r * NWORDS;
    const int* row =
        a.plane + (long long)clampi(oy + r, 0, a.crop_h - 1) * a.W;
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * k + e;
      int x = 0;
      if (c < WW) {
        x = row[clampi(ox + c, 0, a.crop_w - 1)];
        ok &= (unsigned)x <= 255u;
      }
      v.win[r * p.sw + c] = x;
      word |= ((unsigned)x & 255u) << (8 * e);
    }
    v.pwin[r * p.swp + k] = word;
  }
  const int* gs = a.src + b * BW * BW;
  for (int it = threadIdx.x; it < BW * BW / 4; it += blockDim.x) {
    const int r = it / (BW / 4), k = it - r * (BW / 4);
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = gs[r * BW + 4 * k + e];
      ok &= (unsigned)x <= 255u;
      v.blk[r * p.bs + 4 * k + e] = x;
      word |= ((unsigned)x & 255u) << (8 * e);
    }
    v.pblk[r * p.bsp + k] = word;
  }
  return ok;
}

template <int BW>
__global__ void __launch_bounds__(kMaxThreads) ke_strip_kernel(KEArgs a) {
  constexpr int WW = BW + 2 * kRad;
  extern __shared__ int sm[];
  __shared__ int rs[kMaxThreads / 32], ri[kMaxThreads / 32];
  const strips::Shape& p = a.p;
  const strips::Smem v(sm, p, WW);
  const long long b = blockIdx.x;
  const int cy = a.cy ? a.cy[b] : 0, cx = a.cx ? a.cx[b] : 0;
  // p.swp is set: stride 1, BW a multiple of 4
  const bool packed = __syncthreads_and(
      stage<BW>(a, v, b, a.by[b] + cy - kRad, a.bx[b] + cx - kRad));
  int best, bi;
  strips::best_of_strips<strips::Ssd>(
      p, v, packed, [](unsigned s, int) { return (int)s; }, best, bi);
  strips::argmin_cta(best, bi, rs, ri);
  if (threadIdx.x == 0) {
    a.dy[b] = bi / kN - kRad + cy;
    a.dx[b] = bi % kN - kRad + cx;
  }
}

template <int BW>
int ke_launch(KEArgs a, int B, void* stream) {
  const int ww = BW + 2 * kRad;
  const size_t smem = sizeof(int) * (size_t)strips::plan(a.p, ww, ww);
  const int threads = (kN * a.p.S * a.p.G + 31) / 32 * 32;
  if (threads > kMaxThreads || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  ke_strip_kernel<BW><<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

AV1_EXPORT int fullpel_ssd(const int* src, const int* plane, int H, int W,
                           int crop_h, int crop_w, const int* by,
                           const int* bx, const int* cy, const int* cx,
                           int B, int bw, int* dy, int* dx,
                           void* stream) {
  if (B <= 0) return 0;
  if (crop_h <= 0 || crop_w <= 0 || crop_h > H || crop_w > W)
    return (int)cudaErrorInvalidValue;
  KEArgs a{src, plane, W, crop_h, crop_w, by, bx, cy, cx, dy, dx,
           strips::Shape{bw, bw, kN, 1, 1}};
  switch (bw) {
    case 8: return ke_launch<8>(a, B, stream);
    case 16: return ke_launch<16>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
