// Kernels KG, KH and KI: the tune_vmaf preprocessing and the VIF metric.
//
// Replace the reference's K11 device programs in
// aom_av1_psy_tpu/encoder/tune_vmaf.py:
//   KG gauss_blur     <- gaussian_blur (:49-71, jitted): the 8-tap separable
//                        blur (taps 0 8 30 52 30 8 0 0, av1 convolve rounding
//                        round0 = 3, round1 = 11, 8-bit offsets, clip to
//                        [0, 255]) with edge replicate (_pad_for_conv (3, 4));
//                        optionally the exact int64 moment sums
//                        sum s, sum s^2, sum d, sum d^2 with d = s - blur that
//                        frame_preprocessing's hf ratio needs (:151-152);
//   KH unsharp_apply  <- _unsharp (:74-78, eager): s + a * (s - b) in float32
//                        with the product and the sum rounded separately
//                        (the reference runs one op at a time), floor(v +
//                        0.5), clip, uint8;
//   KI vif_scale      <- _moments / _vif_scale (:81-108): 9x9 VALID box means
//                        and variances of r, d and r*d, g, sv and the two
//                        log2 terms, summed over the scale (num, den);
//      vif_down2      <- _down2 (:111-116): the 3x3 [1 2 1]^2 / 16 SAME blur
//                        (zero padding) and the ::2 decimation.
//
// What bounds them on the H100: KG and KH move a few bytes per pixel and do
// a few tens of integer / float operations on them: memory bound (1080p: KG
// reads 2.07 MB of uint8 and writes 8.29 MB of int32, ~3.1 us at 3.35 TB/s).
// KI's function needs ~118 operations per output pixel (three products,
// five separable 9x9 box means of 8 + 8 adds and a scale, ~30 for the
// variances, g, sv and the two log2 terms) on 8 bytes of input: memory bound
// (1080p: r and d are 16.6 MB, ~5 us at 3.35 TB/s; the operations take ~4 us
// at 67 TFLOP/s). This kernel is far from that bound: it sums all 81 taps of
// each box directly in float64 (~830 operations per pixel, ~50 us of work at
// the card's 34 TFLOP/s float64 rate); separable running sums are the way
// to close the gap.
//
// Design. KG: one CTA of 256 threads per 32 x 32 output tile; the (32+7)^2
// halo (rows and columns clamped to the frame: edge replicate) in shared
// memory, the horizontal pass into a shared int32 (32+7) x 32 tile, then the
// vertical pass, all integer and exact. The moments are accumulated per
// thread in int64, reduced over the block, and added with one atomicAdd per
// sum per block on unsigned long long (two's complement: a negative sum d
// wraps and comes back exact). KH: one thread per pixel, __fmul_rn and
// __fadd_rn (the library also builds with --fmad=false). KI: one CTA per
// 32 x 8 output tile with its (32+8) x (8+8) halo of r and d in shared
// memory; each thread sums its 81 taps times float(1/81) in float64 and
// rounds each box mean to float32 once (within an ulp of the reference's
// float32 convolution in any order; a float32 sum in row-major order missed
// the 1e-4 relative tolerance on a noise frame); the per-pixel log2
// terms are reduced over the block and added with one float atomicAdd per
// CTA (order free: KI is held to a relative tolerance). vif_down2: one
// thread per output pixel; the weights are powers of two and the inputs
// multiples of 16^-s below 256, so every sum is exact in float32 in any
// order: equal to the plain version.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kHalo = kTile + 7;
constexpr int kRound0 = 3;                         // ROUND0_BITS
constexpr int kFilterBits = 7;                     // FILTER_BITS
constexpr int kRound1 = 2 * kFilterBits - kRound0;
constexpr int kOff = 1 << (8 + kFilterBits - 1);
constexpr int kOffsetBits = 8 + 2 * kFilterBits - kRound0;
constexpr int kOutSub =
    (1 << (kOffsetBits - kRound1)) + (1 << (kOffsetBits - kRound1 - 1));
__constant__ int kGauss[8] = {0, 8, 30, 52, 30, 8, 0, 0};

template <typename T>
__global__ void kg_kernel(const T* __restrict__ src, int H, int W,
                          int* __restrict__ out,
                          unsigned long long* __restrict__ mom) {
  __shared__ int xs[kHalo][kHalo + 1];
  __shared__ int im[kHalo][kTile + 1];
  __shared__ long long scratch[32];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kHalo * kHalo; i += blockDim.x) {
    const int r = i / kHalo, c = i % kHalo;
    const int y = clampi(r0 + r - 3, 0, H - 1);
    const int x = clampi(c0 + c - 3, 0, W - 1);
    xs[r][c] = (int)src[(long long)y * W + x];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kHalo * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    int s = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) s += kGauss[t] * xs[r][c + t];
    im[r][c] = (s + kOff + (1 << (kRound0 - 1))) >> kRound0;
  }
  __syncthreads();
  long long ss = 0, ss2 = 0, sd = 0, sd2 = 0;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const int y = r0 + r, x = c0 + c;
    if (y >= H || x >= W) continue;
    int s = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) s += kGauss[t] * im[r + t][c];
    const int v = clampi(
        ((s + (1 << kOffsetBits) + (1 << (kRound1 - 1))) >> kRound1) -
            kOutSub,
        0, 255);
    out[(long long)y * W + x] = v;
    const long long p = xs[r + 3][c + 3], d = p - v;
    ss += p;
    ss2 += p * p;
    sd += d;
    sd2 += d * d;
  }
  if (mom == nullptr) return;  // uniform over the block
  ss = block_sum(ss, scratch);
  ss2 = block_sum(ss2, scratch);
  sd = block_sum(sd, scratch);
  sd2 = block_sum(sd2, scratch);
  if (threadIdx.x == 0) {
    atomicAdd(&mom[0], (unsigned long long)ss);
    atomicAdd(&mom[1], (unsigned long long)ss2);
    atomicAdd(&mom[2], (unsigned long long)sd);
    atomicAdd(&mom[3], (unsigned long long)sd2);
  }
}

__global__ void kh_kernel(const uint8_t* __restrict__ src,
                          const int* __restrict__ blur, float a, long long n,
                          uint8_t* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = src[i];
  const float v = __fadd_rn((float)s, __fmul_rn(a, (float)(s - blur[i])));
  const float f = floorf(__fadd_rn(v, 0.5f));
  out[i] = (uint8_t)(int)fminf(fmaxf(f, 0.0f), 255.0f);
}

constexpr int kVw = 32, kVh = 8, kWin = 9;

__global__ void ki_kernel(const float* __restrict__ r,
                          const float* __restrict__ d, int H, int W,
                          float* __restrict__ sums) {
  __shared__ float rs[kVh + kWin - 1][kVw + kWin - 1];
  __shared__ float ds[kVh + kWin - 1][kVw + kWin - 1];
  __shared__ float scratch[32];
  constexpr int hh = kVh + kWin - 1, hw = kVw + kWin - 1;
  const int Ho = H - kWin + 1, Wo = W - kWin + 1;
  const int by = blockIdx.y * kVh, bx = blockIdx.x * kVw;
  for (int i = threadIdx.x; i < hh * hw; i += blockDim.x) {
    const int y = by + i / hw, x = bx + i % hw;
    const bool in = y < H && x < W;
    rs[i / hw][i % hw] = in ? r[(long long)y * W + x] : 0.0f;
    ds[i / hw][i % hw] = in ? d[(long long)y * W + x] : 0.0f;
  }
  __syncthreads();
  const int ty = threadIdx.x / kVw, tx = threadIdx.x % kVw;
  float num = 0.0f, den = 0.0f;
  if (by + ty < Ho && bx + tx < Wo) {
    const double k = (double)(1.0f / 81.0f);
    double sr = 0.0, sd = 0.0, srr = 0.0, sdd = 0.0, srd = 0.0;
    for (int i = 0; i < kWin; ++i) {
      for (int j = 0; j < kWin; ++j) {
        const float a = rs[ty + i][tx + j], b = ds[ty + i][tx + j];
        sr += (double)a * k;
        sd += (double)b * k;
        srr += (double)__fmul_rn(a, a) * k;
        sdd += (double)__fmul_rn(b, b) * k;
        srd += (double)__fmul_rn(a, b) * k;
      }
    }
    const float mr = (float)sr, md = (float)sd, mrr = (float)srr,
                mdd = (float)sdd, mrd = (float)srd;
    const float var_r = fmaxf(mrr - mr * mr, 0.0f);
    const float var_d = fmaxf(mdd - md * md, 0.0f);
    const float cov = mrd - mr * md;
    const float g = cov / (var_r + 1e-10f);
    const float sv = fmaxf(var_d - g * cov, 0.0f);
    num = log2f(1.0f + g * g * var_r / (sv + 2.0f));
    den = log2f(1.0f + var_r / 2.0f);
  }
  num = block_sum(num, scratch);
  den = block_sum(den, scratch);
  if (threadIdx.x == 0) {
    atomicAdd(&sums[0], num);
    atomicAdd(&sums[1], den);
  }
}

__global__ void kd_kernel(const float* __restrict__ x, int H, int W,
                          float* __restrict__ out, int Ho, int Wo) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= Wo || oy >= Ho) return;
  const float k[3][3] = {{1.0f, 2.0f, 1.0f}, {2.0f, 4.0f, 2.0f},
                         {1.0f, 2.0f, 1.0f}};
  float s = 0.0f;
  for (int i = -1; i <= 1; ++i) {
    const int y = 2 * oy + i;
    for (int j = -1; j <= 1; ++j) {
      const int xx = 2 * ox + j;
      const float v =
          (y >= 0 && y < H && xx >= 0 && xx < W) ? x[(long long)y * W + xx]
                                                 : 0.0f;
      s += (k[i + 1][j + 1] / 16.0f) * v;
    }
  }
  out[(long long)oy * Wo + ox] = s;
}

}  // namespace

// src (H, W) uint8 (src_u8 = 1) or int32 pixels in [0, 255]; out (H, W)
// int32; mom null or 4 zeroed unsigned long long sums.
AV1_EXPORT int gauss_blur(const void* src, int src_u8, int H, int W, int* out,
                          unsigned long long* mom, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  if (src_u8)
    kg_kernel<uint8_t><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)src, H, W, out, mom);
  else
    kg_kernel<int><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int*)src, H, W, out, mom);
  return (int)cudaGetLastError();
}

// src uint8, blur int32, out uint8, n elements each.
AV1_EXPORT int unsharp_apply(const uint8_t* src, const int* blur, float a,
                             long long n, uint8_t* out, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + 255) / 256);
  kh_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(src, blur, a, n, out);
  return (int)cudaGetLastError();
}

// r, d (H, W) float32; sums: 2 zeroed floats (num, den) to add into.
AV1_EXPORT int vif_scale(const float* r, const float* d, int H, int W,
                         float* sums, void* stream) {
  if (H < kWin || W < kWin) return 0;
  const dim3 grid((W - kWin + 1 + kVw - 1) / kVw,
                  (H - kWin + 1 + kVh - 1) / kVh);
  ki_kernel<<<grid, kVw * kVh, 0, (cudaStream_t)stream>>>(r, d, H, W, sums);
  return (int)cudaGetLastError();
}

// x (H, W) float32 -> out ((H + 1) / 2, (W + 1) / 2) float32.
AV1_EXPORT int vif_down2(const float* x, int H, int W, float* out,
                         void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 block(32, 8);
  const dim3 grid((Wo + 31) / 32, (Ho + 7) / 8);
  kd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, H, W, out, Ho, Wo);
  return (int)cudaGetLastError();
}
