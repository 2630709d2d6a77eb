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
// 16 MB, about 5 us at 3.35 TB/s; KO's 4 x 8160 int32 8x8 residuals,
// 8.4 MB, 2.5 us). Design: KN gives each item one warp (8 items per
// 256-thread CTA); the lanes stride over the item's elements and a warp
// shuffle adds the int64 partial sums, so no shared memory and no
// atomics. Both read their inputs in the caller's integer type (uint8,
// int8, int16 or int32: a template on the element type), so the wrapper
// launches no conversion kernel; KN takes its arguments as one struct by
// pointer, which the entry point copies into the launch.
//
// KO gives each row of an 8x8 block one lane: 8 lanes a block, 4 blocks a
// warp, 32 blocks a 256-thread CTA (1020 CTAs at B = 32640). A lane reads
// its row with vector loads (two 16-byte loads at int32, one at int16, one
// 8-byte load at 8 bits), so a warp reads 4 whole blocks that lie together
// (1 KB at int32) in as few wavefronts as the bytes allow, and runs the
// row butterflies in registers. The column butterflies are three
// __shfl_xor_sync rounds (masks 1, 2, 4) among the block's 8 lanes: lane r
// keeps mine + other where bit s of r is clear and takes other - mine
// where it is set, which is the reference's in-place (j, j + s) ->
// (sum, difference) order, in unsigned (wrapping) arithmetic. satd: each
// lane sums its 8 |t| in int64, and three shuffle rounds add the block's
// 8 lanes; the transform variant writes each lane's row with vector
// stores. A pointer off the vector alignment takes per-element loads and
// stores (kVec false); lanes of blocks past B load zeros, take part in the
// shuffles and store nothing.
#include "common.cuh"

// The argument block of block_reduce (mirrored by ops/metrics._KNArgs).
struct KNArgs {
  const void* a;
  const void* b;
  const void* c;
  const void* d;
  long long* s0;
  long long* s1;     // or null: ops with one sum
  long long* out;    // kProject: (B, n)
  int op;
  int dtype;         // element type of a, b, c, d: see Dtype
  int B, n, w;       // items, elements per item, row width of the output
  int bdiv;          // item i reads b's item i / bdiv (sad_x4: N refs)
  int a_rows, a_w;   // bilinear: a's item is (a_rows, a_w), stride a_w
  int t0, t1, u0, u1;  // bilinear horizontal and vertical taps
  int avg;           // sub_pixel_avg_variance: average with c first
};

enum Dtype { kU8 = 0, kI8 = 1, kI16 = 2, kI32 = 3 };

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

__device__ __forceinline__ long long round2signed12(long long v) {
  const long long mag = ((v < 0 ? -v : v) + (1 << 11)) >> 12;
  return v < 0 ? -mag : mag;
}

// The bilinear two-pass projection at (r, c) (aom_var_filter_block2d_bil_*,
// round 7 after each pass).
template <typename T>
__device__ __forceinline__ long long bil(const KNArgs& k, const T* a, int r,
                                         int c) {
  const T* p = a + r * k.a_w + c;
  const long long f0 = ((long long)p[0] * k.t0 + (long long)p[1] * k.t1 +
                        64) >> 7;
  const long long f1 = ((long long)p[k.a_w] * k.t0 +
                        (long long)p[k.a_w + 1] * k.t1 + 64) >> 7;
  return (f0 * k.u0 + f1 * k.u1 + 64) >> 7;
}

template <int OP, typename T>
__global__ void __launch_bounds__(kThreads) kn_kernel(KNArgs k) {
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= k.B) return;
  const long long base = item * k.n;
  const long long bbase = (item / k.bdiv) * k.n;
  const T* a = (const T*)k.a + (OP == kSubpelVar || OP == kProject
                                    ? item * k.a_rows * k.a_w
                                    : base);
  const T* b = (const T*)k.b;
  const T* c = (const T*)k.c;
  const T* d = (const T*)k.d;
  long long x = 0, y = 0;
  for (int e = lane; e < k.n; e += 32) {
    if (OP == kSad) {
      const long long v = (long long)a[e] - b[bbase + e];
      x += v < 0 ? -v : v;
    } else if (OP == kSse) {
      const long long v = (long long)a[e] - b[bbase + e];
      x += v * v;
    } else if (OP == kVariance) {
      const long long v = (long long)a[e] - b[bbase + e];
      x += v;
      y += v * v;
    } else if (OP == kBlockError) {
      const long long v = (long long)a[e] - b[bbase + e];
      x += v * v;
      y += (long long)a[e] * a[e];
    } else if (OP == kObmcSad || OP == kObmcVar) {
      const long long r = round2signed12(
          (long long)b[bbase + e] - (long long)a[e] * c[base + e]);
      if (OP == kObmcSad) {
        x += r < 0 ? -r : r;
      } else {
        x += r;
        y += r * r;
      }
    } else if (OP == kMaskedSad) {
      const long long m = c[base + e];
      const long long pred = (m * a[e] + (64 - m) * b[base + e] + 32) >> 6;
      const long long v = pred - d[base + e];
      x += v < 0 ? -v : v;
    } else {  // kSubpelVar, kProject
      long long pred = bil<T>(k, a, e / k.w, e % k.w);
      if (OP == kProject) {
        k.out[base + e] = pred;
      } else {
        if (k.avg) pred = (pred + c[base + e] + 1) >> 1;
        const long long v = pred - b[base + e];
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

// Row r of an 8x8 block as 8 unsigned (wrapping) int32 values. kVec: the
// row lies on its vector alignment (32 bytes at int32, 16 at int16, 8 at
// 8 bits); the words are split with sign or zero extension per type.
__device__ __forceinline__ void ko_load(const int* p, unsigned int (&v)[8]) {
  const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
  const int4 b = __ldcs(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void ko_load(const short* p,
                                        unsigned int (&v)[8]) {
  const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
  const int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = (unsigned int)((int)((unsigned int)w[i] << 16) >> 16);
    v[2 * i + 1] = (unsigned int)(w[i] >> 16);  // arithmetic shifts
  }
}

__device__ __forceinline__ void ko_load(const signed char* p,
                                        unsigned int (&v)[8]) {
  const int2 a = __ldcs(reinterpret_cast<const int2*>(p));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int w = i < 4 ? a.x : a.y;
    v[i] = (unsigned int)((int)((unsigned int)w << (24 - 8 * (i & 3))) >>
                          24);
  }
}

__device__ __forceinline__ void ko_load(const unsigned char* p,
                                        unsigned int (&v)[8]) {
  const int2 a = __ldcs(reinterpret_cast<const int2*>(p));
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = ((unsigned int)(i < 4 ? a.x : a.y) >> (8 * (i & 3))) & 0xffu;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    ko_kernel(const T* __restrict__ x, int B, int* __restrict__ t,
              long long* __restrict__ satd) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long b = g >> 3;   // the block; this lane holds its row r
  const int r = threadIdx.x & 7;
  const bool valid = b < B;     // the same for the block's 8 lanes
  unsigned int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (valid) {
    if (kVec) {
      ko_load(x + g * 8, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = (unsigned int)(int)x[g * 8 + i];
    }
  }
  wht8(v, 1);  // the row (last axis)
  // the columns: row r pairs with row r ^ s; the lower row of the pair
  // takes the sum, the upper one the difference (lower - upper)
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned int o = __shfl_xor_sync(0xffffffffu, v[i], s);
      v[i] = (r & s) ? o - v[i] : v[i] + o;
    }
  }
  if (t && valid) {
    int* out = t + g * 8;
    if (kVec) {
      reinterpret_cast<int4*>(out)[0] = make_int4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<int4*>(out)[1] = make_int4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = (int)v[i];
    }
  }
  if (satd) {
    // |q| in int32 (wrapping at INT_MIN as numpy's abs does), then summed
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sum += (int)((int)v[i] < 0 ? 0u - v[i] : v[i]);
#pragma unroll
    for (int s = 1; s < 8; s <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, s);
    if (valid && r == 0) satd[b] = sum;
  }
}

template <typename T>
void ko_launch(const void* x, int B, int* t, long long* satd,
               cudaStream_t st) {
  // vector loads need the row's alignment: 8 bytes at 8 bits, 16 above;
  // the transform's int32 rows 16 bytes
  const size_t al = sizeof(T) == 1 ? 8 : 16;
  const bool vec = (uintptr_t)x % al == 0 && (uintptr_t)t % 16 == 0;
  const int grid = (int)(((long long)B * 8 + kThreads - 1) / kThreads);
  if (vec)
    ko_kernel<T, true><<<grid, kThreads, 0, st>>>((const T*)x, B, t, satd);
  else
    ko_kernel<T, false><<<grid, kThreads, 0, st>>>((const T*)x, B, t, satd);
}

template <int OP>
void launch_op(const KNArgs& k, int grid, cudaStream_t st) {
  switch (k.dtype) {
    case kU8:
      kn_kernel<OP, unsigned char><<<grid, kThreads, 0, st>>>(k);
      break;
    case kI8:
      kn_kernel<OP, signed char><<<grid, kThreads, 0, st>>>(k);
      break;
    case kI16:
      kn_kernel<OP, short><<<grid, kThreads, 0, st>>>(k);
      break;
    default:
      kn_kernel<OP, int><<<grid, kThreads, 0, st>>>(k);
      break;
  }
}

}  // namespace

AV1_EXPORT int block_reduce(const KNArgs* args, void* stream) {
  const KNArgs k = *args;
  if (k.B <= 0) return 0;
  if (k.n <= 0 || k.w <= 0 || k.bdiv <= 0 || k.op < kSad ||
      k.op > kProject || k.dtype < kU8 || k.dtype > kI32)
    return (int)cudaErrorInvalidValue;
  const int grid = (k.B + kWarps - 1) / kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k.op) {
    case kSad: launch_op<kSad>(k, grid, st); break;
    case kSse: launch_op<kSse>(k, grid, st); break;
    case kVariance: launch_op<kVariance>(k, grid, st); break;
    case kBlockError: launch_op<kBlockError>(k, grid, st); break;
    case kObmcSad: launch_op<kObmcSad>(k, grid, st); break;
    case kObmcVar: launch_op<kObmcVar>(k, grid, st); break;
    case kMaskedSad: launch_op<kMaskedSad>(k, grid, st); break;
    case kSubpelVar: launch_op<kSubpelVar>(k, grid, st); break;
    default: launch_op<kProject>(k, grid, st); break;
  }
  return (int)cudaGetLastError();
}

AV1_EXPORT int satd8x8(const void* x, int dtype, int B, int* t,
                       long long* satd, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kU8: ko_launch<unsigned char>(x, B, t, satd, st); break;
    case kI8: ko_launch<signed char>(x, B, t, satd, st); break;
    case kI16: ko_launch<short>(x, B, t, satd, st); break;
    case kI32: ko_launch<int>(x, B, t, satd, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
