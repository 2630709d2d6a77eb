// Kernels KN (block_reduce) and KO (satd8x8).
//
// KN replaces the jnp branches of the reference's batched reducers
// (aom_av1_psy_tpu/ops/metrics.py): sad :20, sad_x4 :26, sse :34, variance
// :41, block_error :52, the bilinear subpel_project / sub_pixel_variance /
// sub_pixel_avg_variance :151-193, obmc_sad / obmc_variance :203-219 and
// masked_sad :222. One template, instantiated per op: each item of the batch
// reduces its elementwise term into two int64 sums (the reference's numpy
// branch sums in int64; its jnp branch in int32, since JAX runs without
// x64), or, for the projection, writes the bilinear prediction itself.
//
// KO replaces hadamard8x8 :62 and satd :97: the 8-point Walsh-Hadamard
// butterflies of every row, then of every column, in the reference's own
// (in-place, natural) output order, in wrapping int32 as numpy's and jnp's
// int32 arithmetic wraps; satd sums the int32 |t| in int64.
//
// What bounds them: each reads its inputs once and does a few operations
// per element: bytes bound (the 1080p 16x16 grid's two int32 planes,
// 16 MB, about 5 us at 3.35 TB/s). Design: KN gives each item one warp
// (8 items per 256-thread CTA); the lanes stride over the item's elements
// and a warp shuffle adds the int64 partial sums, so no shared memory and
// no atomics. KO gives each 8x8 block one thread that holds it in 64
// registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;

enum Op {
  kSad = 0,        // sum |a - b|
  kSse = 1,        // sum (a - b)^2
  kVariance = 2,   // sum (a - b), sum (a - b)^2
  kBlockError = 3, // sum (a - b)^2, sum a^2
  kObmcSad = 4,    // r = round2signed(b - a * c, 12): sum |r|
  kObmcVar = 5,    // sum r, sum r^2
  kMaskedSad = 6,  // pred = (c * a + (64 - c) * b + 32) >> 6: sum |pred - d|
  kSubpelVar = 7,  // bilinear pred of a; (pred [+ c + 1 >> 1]) - b: sum, sq
  kProject = 8,    // bilinear pred of a, written out
};

struct KNArgs {
  const int* a;
  const int* b;
  const int* c;
  const int* d;
  int B, n, w;       // items, elements per item, row width of the output
  int bdiv;          // item i reads b's item i / bdiv (sad_x4: N refs)
  int a_rows, a_w;   // bilinear: a's item is (a_rows, a_w), stride a_w
  int t0, t1, u0, u1;  // bilinear horizontal and vertical taps
  int avg;           // sub_pixel_avg_variance: average with c first
  long long* s0;
  long long* s1;
  long long* out;    // kProject: (B, n)
};

__device__ __forceinline__ long long round2signed12(long long v) {
  const long long mag = ((v < 0 ? -v : v) + (1 << 11)) >> 12;
  return v < 0 ? -mag : mag;
}

// The bilinear two-pass projection at (r, c) (aom_var_filter_block2d_bil_*,
// round 7 after each pass).
__device__ __forceinline__ long long bil(const KNArgs& k, const int* a, int r,
                                         int c) {
  const int* p = a + r * k.a_w + c;
  const long long f0 = ((long long)p[0] * k.t0 + (long long)p[1] * k.t1 +
                        64) >> 7;
  const long long f1 = ((long long)p[k.a_w] * k.t0 +
                        (long long)p[k.a_w + 1] * k.t1 + 64) >> 7;
  return (f0 * k.u0 + f1 * k.u1 + 64) >> 7;
}

template <int OP>
__global__ void __launch_bounds__(kThreads) kn_kernel(KNArgs k) {
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= k.B) return;
  const long long base = item * k.n;
  const long long bbase = (item / k.bdiv) * k.n;
  const int* a = OP == kSubpelVar || OP == kProject
                     ? k.a + item * k.a_rows * k.a_w
                     : k.a + base;
  long long x = 0, y = 0;
  for (int e = lane; e < k.n; e += 32) {
    if (OP == kSad) {
      const long long v = (long long)a[e] - k.b[bbase + e];
      x += v < 0 ? -v : v;
    } else if (OP == kSse) {
      const long long v = (long long)a[e] - k.b[bbase + e];
      x += v * v;
    } else if (OP == kVariance) {
      const long long v = (long long)a[e] - k.b[bbase + e];
      x += v;
      y += v * v;
    } else if (OP == kBlockError) {
      const long long v = (long long)a[e] - k.b[bbase + e];
      x += v * v;
      y += (long long)a[e] * a[e];
    } else if (OP == kObmcSad || OP == kObmcVar) {
      const long long r = round2signed12(
          (long long)k.b[bbase + e] - (long long)a[e] * k.c[base + e]);
      if (OP == kObmcSad) {
        x += r < 0 ? -r : r;
      } else {
        x += r;
        y += r * r;
      }
    } else if (OP == kMaskedSad) {
      const long long m = k.c[base + e];
      const long long pred =
          (m * a[e] + (64 - m) * k.b[base + e] + 32) >> 6;
      const long long v = pred - k.d[base + e];
      x += v < 0 ? -v : v;
    } else {  // kSubpelVar, kProject
      long long pred = bil(k, a, e / k.w, e % k.w);
      if (OP == kProject) {
        k.out[base + e] = pred;
      } else {
        if (k.avg) pred = (pred + k.c[base + e] + 1) >> 1;
        const long long v = pred - k.b[base + e];
        x += v;
        y += v * v;
      }
    }
  }
  if (OP == kProject) return;
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, o);
    y += __shfl_down_sync(0xffffffffu, y, o);
  }
  if (lane == 0) {
    k.s0[item] = x;
    if (k.s1) k.s1[item] = y;
  }
}

// One length-8 Walsh-Hadamard pass over v[i * step], i = 0..7, in place:
// strides 1, 2, 4, each pair (j, j + stride) becoming (sum, difference).
// Unsigned arithmetic wraps as the reference's int32 does.
__device__ __forceinline__ void wht8(unsigned int* v, int step) {
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {
#pragma unroll
    for (int base = 0; base < 8; base += 2 * s) {
#pragma unroll
      for (int j = base; j < base + s; ++j) {
        const unsigned int p = v[j * step], q = v[(j + s) * step];
        v[j * step] = p + q;
        v[(j + s) * step] = p - q;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ko_kernel(const int* __restrict__ x, int B, int* __restrict__ t,
              long long* __restrict__ satd) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  unsigned int v[64];
  const int* g = x + b * 64;
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = (unsigned int)g[i];
#pragma unroll
  for (int r = 0; r < 8; ++r) wht8(v + 8 * r, 1);  // rows (last axis)
#pragma unroll
  for (int c = 0; c < 8; ++c) wht8(v + c, 8);      // then columns
  long long s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // |q| in int32 (wrapping at INT_MIN as numpy's abs does), then summed
    const unsigned int q = v[i];
    s += (int)((int)q < 0 ? 0u - q : q);
    if (t) t[b * 64 + i] = (int)q;
  }
  if (satd) satd[b] = s;
}

}  // namespace

AV1_EXPORT int block_reduce(int op, const int* a, const int* b, const int* c,
                            const int* d, int B, int n, int w, int bdiv,
                            int a_rows, int a_w, int t0, int t1, int u0,
                            int u1, int avg, long long* s0, long long* s1,
                            long long* out, void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || w <= 0 || bdiv <= 0 || op < kSad || op > kProject)
    return (int)cudaErrorInvalidValue;
  KNArgs k{a, b, c, d, B, n, w, bdiv, a_rows, a_w, t0, t1, u0, u1, avg,
           s0, s1, out};
  const int grid = (B + kWarps - 1) / kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case kSad: kn_kernel<kSad><<<grid, kThreads, 0, st>>>(k); break;
    case kSse: kn_kernel<kSse><<<grid, kThreads, 0, st>>>(k); break;
    case kVariance: kn_kernel<kVariance><<<grid, kThreads, 0, st>>>(k); break;
    case kBlockError:
      kn_kernel<kBlockError><<<grid, kThreads, 0, st>>>(k);
      break;
    case kObmcSad: kn_kernel<kObmcSad><<<grid, kThreads, 0, st>>>(k); break;
    case kObmcVar: kn_kernel<kObmcVar><<<grid, kThreads, 0, st>>>(k); break;
    case kMaskedSad:
      kn_kernel<kMaskedSad><<<grid, kThreads, 0, st>>>(k);
      break;
    case kSubpelVar:
      kn_kernel<kSubpelVar><<<grid, kThreads, 0, st>>>(k);
      break;
    default: kn_kernel<kProject><<<grid, kThreads, 0, st>>>(k); break;
  }
  return (int)cudaGetLastError();
}

AV1_EXPORT int satd8x8(const int* x, int B, int* t, long long* satd,
                       void* stream) {
  if (B <= 0) return 0;
  ko_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
              (cudaStream_t)stream>>>(x, B, t, satd);
  return (int)cudaGetLastError();
}
