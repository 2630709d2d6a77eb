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
// KI's function needs ~118 operations per output pixel on 8 bytes of input:
// memory bound (1080p: r and d are 16.6 MB, ~5 us at 3.35 TB/s). Its float64
// sums cost conversions besides: a float32 <-> float64 conversion issues at
// 16 per clock per SM, a quarter of the float64 add rate, so KI converts
// each staged value's five quantities once and each output's five means
// back once (~13 conversions an output, not the 405 of 81 direct taps).
//
// KG design: a CTA owns a band of 128 columns and 64 rows; each of its eight
// warps a strip of 8 rows of the band, each lane 4 adjacent columns. Taps
// 0, 6 and 7 are 0, so an output needs the 5 x 5 window around it: a lane
// reads its columns' word (4 bytes, or 16 for int32 input) and the two
// beside it of each of its 12 rows (2 halo rows above and below; the rows
// and the frame's first and last word clamped: edge replicate), forms the
// horizontal pass in registers and keeps it, with the source, in a register
// window that the vertical pass reads: no shared tile, no barrier per row.
// The int32 blur goes out as one 16-byte store per lane and row. A width
// that is not a multiple of 4, or a pointer off its word, takes the same
// kernel with per-pixel clamped loads and stores. The moments: each lane
// adds its pixels' s, s^2, d and d^2 in int32 and the warp reduces them in
// int32 (a warp's strip is 1024 pixels, 1024 * 255^2 < 2^31); the CTA adds
// its eight warps in int64 and makes one atomicAdd per sum (unsigned long
// long, two's complement: a negative sum d wraps and comes back exact):
// 255 CTAs at 1080p, not one per 32 x 32 tile. Everything is integer and
// exact, in any order. encoder/tune_vmaf.py's KG_BAND / KG_ROWS state the
// same partition for the CPU test of the strips.
//
// KH: one thread per pixel, __fmul_rn and __fadd_rn (the library also
// builds with --fmad=false).
//
// KI design: one CTA of five warps per tile of 24 output columns x 32
// output rows. The warps stage the tile's 40 x 32 halo of r and d in shared
// memory (coalesced, every load in flight at once). Warp q then owns one of
// the five box quantities (r, d and, formed in float32 with __fmul_rn as
// the reference forms them, r*r, d*d, r*d): lane c walks down halo column
// c, converts each value to float64 once and keeps running vertical 9-sums
// (the entering value less the leaving one, from a 9-deep register window,
// added at each step: one dependent add), which it writes to shared memory;
// then lane y walks along output row y with running horizontal 9-sums of
// those, multiplies each unscaled box sum by (double)(1.0f / 81.0f) once
// and rounds it to float32 once, in place. Last, each thread takes up to
// five outputs (row = lane, columns q, q + 5, ...) through the per-pixel
// g, sv and the two log2 terms, in float32 as the reference's, side by
// side; num and den are reduced over the warp and the CTA and added with
// one float atomicAdd each per CTA (order free: KI is held to a relative
// tolerance). As built, the float32 tail (two IEEE divisions and two
// log2f polynomials an output) is most of KI's instructions.
//
// Why the order of the sums does not matter on vif_lite's pyramid: every
// value is an 8-bit pixel times 16^-s, s <= 3 (vif_down2 is exact), so r, d
// and the three rounded float32 products are multiples of 2^-24 below 2^16.
// Any sum of up to 81 such values, and any difference of two such sums, is
// a multiple of 2^-24 below 2^24, which float64's 53 bits hold exactly: the
// running sums (each step adds a difference), in any order, equal the
// exact box sum S, and the mean is RN_f32(RN_f64(S * f32(1/81))), the same
// rounding of the same S as the plain version's float64 convolution (which
// sums the exact products x * f32(1/81) in float64 and rounds to float32
// once): within an ulp of the reference's float32 convolution, as before.
// Off that grid (any float32 input) the float64 sums round at ~2^-53 of
// their size, far inside the 1e-4 relative tolerance.
//
// vif_down2: one thread per output pixel; the weights are powers of two and
// the inputs multiples of 16^-s below 256, so every sum is exact in float32
// in any order: equal to the plain version.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRound0 = 3;                         // ROUND0_BITS
constexpr int kFilterBits = 7;                     // FILTER_BITS
constexpr int kRound1 = 2 * kFilterBits - kRound0;
constexpr int kOff = 1 << (8 + kFilterBits - 1);
constexpr int kOffsetBits = 8 + 2 * kFilterBits - kRound0;
constexpr int kOutSub =
    (1 << (kOffsetBits - kRound1)) + (1 << (kOffsetBits - kRound1 - 1));

constexpr int kBand = 128;   // KG: columns per CTA (32 lanes x 4)
constexpr int kRows = 8;     // KG: output rows per warp
constexpr int kWarps = 8;    // KG: warps per CTA, stacked down the band

// The horizontal pass at x[2] (taps 8 30 52 30 8 on x[0..4]).
__device__ __forceinline__ int kg_h(const int* x) {
  return (8 * (x[0] + x[4]) + 30 * (x[1] + x[3]) + 52 * x[2] + kOff +
          (1 << (kRound0 - 1))) >>
         kRound0;
}

// The vertical pass on five horizontal results, rounded and clipped.
__device__ __forceinline__ int kg_v(int a, int b, int c, int d, int e) {
  const int s = 8 * (a + e) + 30 * (b + d) + 52 * c;
  return clampi(((s + (1 << kOffsetBits) + (1 << (kRound1 - 1))) >> kRound1) -
                    kOutSub,
                0, 255);
}

// Four adjacent pixels as one load: a 4-byte word of uint8, an int4 of
// int32.
__device__ __forceinline__ void kg_unpack(unsigned w, int (&p)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = (w >> (8 * k)) & 255;
}

__device__ __forceinline__ void kg_unpack(int4 w, int (&p)[4]) {
  p[0] = w.x;
  p[1] = w.y;
  p[2] = w.z;
  p[3] = w.w;
}

// Columns c - 2 .. c + 5 of one source row, clamped to [0, W - 1] (edge
// replicate). kVec: W % 4 == 0 and the row on its word, so the lane's
// columns are one word and its neighbours the words beside it.
template <bool kVec, typename T>
__device__ __forceinline__ void kg_load(const T* __restrict__ row, int c,
                                        int W, int (&x)[8]) {
  if (kVec) {
    using Word = typename std::conditional<sizeof(T) == 1, unsigned,
                                           int4>::type;
    const Word* w = reinterpret_cast<const Word*>(row);
    const int G = W >> 2, g = c >> 2;
    int l[4], o[4], r[4];
    kg_unpack(__ldg(w + max(min(g - 1, G - 1), 0)), l);
    kg_unpack(__ldg(w + min(g, G - 1)), o);
    kg_unpack(__ldg(w + min(g + 1, G - 1)), r);
    x[0] = l[2];
    x[1] = l[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[2 + k] = o[k];
    x[6] = r[0];
    x[7] = r[1];
    if (g == 0) x[0] = x[1] = x[2];
    if (g >= G - 1) x[6] = x[7] = x[5];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = row[clampi(c - 2 + k, 0, W - 1)];
  }
}

template <typename T, bool kVec, bool kMom>
__global__ void __launch_bounds__(kWarps * 32)
    kg_strip_kernel(const T* __restrict__ src, int H, int W,
                    int* __restrict__ out,
                    unsigned long long* __restrict__ mom) {
  __shared__ long long part[kWarps][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kBand + 4 * lane;
  const int y0 = (blockIdx.y * kWarps + warp) * kRows;
  int ss = 0, ss2 = 0, sd = 0, sd2 = 0;
  if (y0 < H) {  // uniform over the warp
    // row i of the window is source row y0 - 2 + i: its horizontal pass h
    // and its source pixels s (full unroll: every index is static)
    int h[kRows + 4][4], s[kRows + 4][4];
#pragma unroll
    for (int i = 0; i < kRows + 4; ++i) {
      const int y = clampi(y0 - 2 + i, 0, H - 1);
      int x[8];
      kg_load<kVec>(src + (long long)y * W, c, W, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[i][j] = kg_h(x + j);
        s[i][j] = x[j + 2];
      }
      const int yo = y0 + i - 4;
      if (i < 4 || yo >= H) continue;
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = kg_v(h[i - 4][j], h[i - 3][j], h[i - 2][j], h[i - 1][j],
                    h[i][j]);
      int* o = out + (long long)yo * W + c;
      if (kVec) {
        if (c < W) *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2],
                                                           v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < W) o[j] = v[j];
      }
      if (kMom) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j >= W) continue;
          const int p = s[i - 2][j], d = p - v[j];
          ss += p;
          ss2 += p * p;
          sd += d;
          sd2 += d * d;
        }
      }
    }
  }
  if (!kMom) return;
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
    ss2 += __shfl_xor_sync(0xffffffffu, ss2, o);
    sd += __shfl_xor_sync(0xffffffffu, sd, o);
    sd2 += __shfl_xor_sync(0xffffffffu, sd2, o);
  }
  if (lane == 0) {
    part[warp][0] = ss;
    part[warp][1] = ss2;
    part[warp][2] = sd;
    part[warp][3] = sd2;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    long long t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[w][threadIdx.x];
    atomicAdd(&mom[threadIdx.x], (unsigned long long)t);
  }
}

template <typename T>
void launch_kg(const T* src, int H, int W, int* out, unsigned long long* mom,
               bool vec, cudaStream_t st) {
  const dim3 grid((W + kBand - 1) / kBand,
                  (H + kWarps * kRows - 1) / (kWarps * kRows));
  const int nt = kWarps * 32;
  if (vec && mom)
    kg_strip_kernel<T, true, true><<<grid, nt, 0, st>>>(src, H, W, out, mom);
  else if (vec)
    kg_strip_kernel<T, true, false><<<grid, nt, 0, st>>>(src, H, W, out, mom);
  else if (mom)
    kg_strip_kernel<T, false, true><<<grid, nt, 0, st>>>(src, H, W, out, mom);
  else
    kg_strip_kernel<T, false, false><<<grid, nt, 0, st>>>(src, H, W, out,
                                                          mom);
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

constexpr int kWin = 9;
constexpr int kTileW = 24;                  // KI: output columns per tile
constexpr int kTileH = 32;                  // KI: output rows per tile
constexpr int kHaloW = kTileW + kWin - 1;   // 32: one halo column a lane
constexpr int kHaloH = kTileH + kWin - 1;   // 40
constexpr int kQ = 5;                       // r, d, r*r, d*d, r*d: a warp each
constexpr int kAhead = 8;                   // rows / columns read ahead
constexpr int kPer = (kTileW + kQ - 1) / kQ;  // tail outputs a thread
static_assert(kHaloH % kQ == 0, "staging: a row in five per warp");
static_assert(kHaloH % kAhead == 0 && kHaloW % kAhead == 0, "read-ahead");

struct KiSmem {
  float st[2][kHaloH][kHaloW];  // the tile's halo of r and d
  // warp q's quantity: its vertical 9-sums at each output row and halo
  // column, then, in place, its box means (float32) at each output; the
  // row stride of 33 doubles keeps the passes' accesses free of bank
  // conflicts
  double vs[kQ][kTileH][kHaloW + 1];
  float part[kQ][2];
};

// Lane = halo column: the running vertical 9-sums of quantity Q (r, d, r*r,
// d*d, r*d) down the column's 40 staged rows, into sm.vs[Q].
template <int Q>
__device__ __forceinline__ void ki_columns(KiSmem& sm, int lane) {
  const float* col = &sm.st[Q == 1 || Q == 3][0][lane];
  const float* colb = &sm.st[1][0][lane];
  double acc = 0.0, win[kWin];
#pragma unroll
  for (int i0 = 0; i0 < kHaloH; i0 += kAhead) {
    // this chunk's rows, read before its stores
    float a[kAhead], b[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      a[j] = col[(i0 + j) * kHaloW];
      if (Q == 4) b[j] = colb[(i0 + j) * kHaloW];
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int i = i0 + j;
      float v = a[j];
      if (Q == 2 || Q == 3) v = __fmul_rn(v, v);
      if (Q == 4) v = __fmul_rn(v, b[j]);
      const double v64 = (double)v;  // each staged value converted once
      acc += i >= kWin ? v64 - win[i % kWin] : v64;
      win[i % kWin] = v64;
      if (i >= kWin - 1) sm.vs[Q][i - (kWin - 1)][lane] = acc;
    }
  }
}

__global__ void __launch_bounds__(kQ * 32, 4)
    ki_tile_kernel(const float* __restrict__ r, const float* __restrict__ d,
                   int H, int W, float* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char ki_smem[];
  KiSmem& sm = *reinterpret_cast<KiSmem*>(ki_smem);
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int Ho = H - kWin + 1, Wo = W - kWin + 1;
  const int by = blockIdx.y * kTileH, bx = blockIdx.x * kTileW;
  // stage the halo of r and d (0 outside the frame: it reaches only outputs
  // that are not summed): warp q rows q, q + 5, ..., every load in flight
  // at once
  {
    const int x = bx + lane;
#pragma unroll
    for (int j = 0; j < kHaloH / kQ; ++j) {
      const int yy = q + kQ * j, y = by + yy;
      const bool in = x < W && y < H;
      const long long at = (long long)y * W + x;
      sm.st[0][yy][lane] = in ? __ldg(r + at) : 0.0f;
      sm.st[1][yy][lane] = in ? __ldg(d + at) : 0.0f;
    }
  }
  __syncthreads();
  switch (q) {  // uniform over the warp
    case 0: ki_columns<0>(sm, lane); break;
    case 1: ki_columns<1>(sm, lane); break;
    case 2: ki_columns<2>(sm, lane); break;
    case 3: ki_columns<3>(sm, lane); break;
    default: ki_columns<4>(sm, lane); break;
  }
  __syncthreads();
  {  // lane = output row: running sums along its 32 halo columns
    const double k = (double)(1.0f / 81.0f);
    double* row = sm.vs[q][lane];
    double acc = 0.0, win[kWin];
#pragma unroll
    for (int c0 = 0; c0 < kHaloW; c0 += kAhead) {
      double v[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) v[j] = row[c0 + j];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int c = c0 + j;
        acc += c >= kWin ? v[j] - win[c % kWin] : v[j];
        win[c % kWin] = v[j];
        // output column c - 8's mean, in a slot read in an earlier chunk
        if (c >= kWin - 1)
          *reinterpret_cast<float*>(row + c - (kWin - 1)) = (float)(acc * k);
      }
    }
  }
  __syncthreads();
  // the thread's outputs (row lane, columns q, q + 5, ...) side by side,
  // stage by stage (each division a branch of its own)
  float var_r[kPer], var_d[kPer], cov[kPer], g[kPer], t[kPer];
  bool ok[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int x = q + kQ * k;
    ok[k] = x < kTileW && by + lane < Ho && bx + x < Wo;
    float m[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      m[j] = *reinterpret_cast<const float*>(&sm.vs[j][lane][ok[k] ? x : 0]);
    var_r[k] = fmaxf(m[2] - m[0] * m[0], 0.0f);
    var_d[k] = fmaxf(m[3] - m[1] * m[1], 0.0f);
    cov[k] = m[4] - m[0] * m[1];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) g[k] = cov[k] / (var_r[k] + 1e-10f);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float sv = fmaxf(var_d[k] - g[k] * cov[k], 0.0f);
    t[k] = g[k] * g[k] * var_r[k] / (sv + 2.0f);
  }
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float tn = log2f(1.0f + t[k]);
    const float td = log2f(1.0f + var_r[k] / 2.0f);
    num += ok[k] ? tn : 0.0f;
    den += ok[k] ? td : 0.0f;
  }
  for (int o = 16; o > 0; o >>= 1) {
    num += __shfl_xor_sync(0xffffffffu, num, o);
    den += __shfl_xor_sync(0xffffffffu, den, o);
  }
  if (lane == 0) {
    sm.part[q][0] = num;
    sm.part[q][1] = den;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < kQ; ++j) t += sm.part[j][threadIdx.x];
    atomicAdd(&sums[threadIdx.x], t);
  }
}

__global__ void vif_down2_kernel(const float* __restrict__ x, int H, int W,
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
  const bool vec = W % 4 == 0 &&
                   (uintptr_t)src % (src_u8 ? 4 : 16) == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (src_u8)
    launch_kg((const uint8_t*)src, H, W, out, mom, vec, (cudaStream_t)stream);
  else
    launch_kg((const int*)src, H, W, out, mom, vec, (cudaStream_t)stream);
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
  const dim3 grid((W - kWin + 1 + kTileW - 1) / kTileW,
                  (H - kWin + 1 + kTileH - 1) / kTileH);
  const int smem = (int)sizeof(KiSmem);
  const cudaError_t e = cudaFuncSetAttribute(
      ki_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ki_tile_kernel<<<grid, kQ * 32, smem, (cudaStream_t)stream>>>(r, d, H, W,
                                                                sums);
  return (int)cudaGetLastError();
}

// x (H, W) float32 -> out ((H + 1) / 2, (W + 1) / 2) float32.
AV1_EXPORT int vif_down2(const float* x, int H, int W, float* out,
                         void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 block(32, 8);
  const dim3 grid((Wo + 31) / 32, (Ho + 7) / 8);
  vif_down2_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, H, W, out, Ho,
                                                             Wo);
  return (int)cudaGetLastError();
}
