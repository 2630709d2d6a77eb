// Kernel KQ: palette_indices.
//
// Replaces the jnp branch of the reference's calc_indices
// (aom_av1_psy_tpu/ops/palette.py:20, av1_calc_indices_dim1/dim2_c): the
// (N, K) nearest-centroid argmin of N points of dim 1 or 2, and the total
// distance (dim 1: the sum of the squared best |d|; dim 2: the sum of the
// best squared L2 distance). Ties go to the first centroid, as argmin
// breaks them. The total is exact in int64, as the reference's numpy
// branch sums it (and wraps where it wraps).
//
// What bounds it: a palette block is at most 64x64 = 4096 points and K <=
// 8 in the encoder, so one call reads at most 32 KB and does ~10^5
// operations; the card's share is the launch. What a call costs is the
// work around the kernel, so the design takes all of it into one launch:
// - the data is read in its own integer type (uint8, int16, int32, int64:
//   a template variant each; the centroids' type is an argument), so no
//   cast runs before the kernel;
// - up to kCtaPoints = 4096 points (the 64x64 block) are one CTA of 512
//   threads: a thread loads two 16-byte vectors (kG points each) when the
//   data is aligned and whole vectors, two single points otherwise; the K
//   centroids sit in shared memory as int64 and as int32;
// - where every centroid and every value of a warp's points lies in
//   [-1023, 1023] (checked per CTA and warp, as KJ checks its range), a
//   point's argmin is the min of 32-bit keys d * 256 + k (d < 2^23, so the
//   first centroid of least distance has the least key): a thread takes
//   8 centroids at a time into registers and runs its points' min chains
//   side by side (4 instructions a point and centroid). Otherwise int64
//   distances with a strict `<` over k ascending; the result is the same;
// - the CTA sums its points' terms in int64 (warp shuffles, one shared
//   step) and stores the total; with more CTAs each stores its partial
//   and the last to finish (a counter it resets) adds them, so there is
//   no zero-fill launch and no atomic on the total;
// - the total is stored straight into a mapped pinned host slot: the
//   entry sets the slot to a pending value before the launch and spins on
//   it until the total lands (with a stream wait past kSpin), so the host
//   reads it with no copy and no stream synchronisation.
// One slot and one scratch area per device: a call has its total before
// the next one launches (calc_indices returns it as an int).
#include <chrono>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 256;
constexpr int kCtaPoints = 4096;  // points a CTA takes in one chunk
constexpr int kMaxCtas = 1024;    // partial slots; more chunks loop
constexpr int kRounds = 2;        // groups a thread loads before computing
constexpr int kFast = 1023;       // |value| bound of the 32-bit keys
// how long the host spins on the slot before it waits on the stream, and
// what the slot holds until the kernel stores the total
constexpr std::chrono::microseconds kSpin{1000};
constexpr long long kPending = (long long)0x8000000000000001ull;

struct Scratch {       // device memory, zeroed once
  unsigned int done;   // CTAs finished in this launch; the last resets it
  long long part[kMaxCtas];
};

struct KQArgs {
  const void* data;    // (N, dim) of the variant's type
  const void* cents;   // (K, dim) of type ctype (0 u8, 1 i16, 2 i32, 3 i64)
  int ctype;
  long long N;
  int K;
  unsigned char* idx;  // (N,)
  long long* total;    // the mapped host slot
  Scratch* scratch;
};

__device__ __forceinline__ long long load_cent(const void* p, int t, int j) {
  switch (t) {
    case 0: return ((const unsigned char*)p)[j];
    case 1: return ((const short*)p)[j];
    case 2: return ((const int*)p)[j];
    default: return ((const long long*)p)[j];
  }
}

template <typename T>
__device__ __forceinline__ bool fits(T v) {
  if constexpr (sizeof(T) == 1) return true;  // uint8
  else return v >= (T)-kFast && v <= (T)kFast;
}

// The fast path: the keys d * 256 + k of the kP points of x (kDim values
// each) against the K8 centroids of c (K rounded up to a multiple of 8 with
// copies of centroid 0, whose keys exceed centroid 0's, so they never
// win): 8 centroids at a time in registers, the points' chains side by
// side.
template <int kDim, int kP>
__device__ __forceinline__ void keys_fast(const int (&x)[kP * kDim],
                                          const int* c, int K8,
                                          unsigned (&best)[kP]) {
#pragma unroll
  for (int p = 0; p < kP; ++p) best[p] = 0xffffffffu;
  for (int k0 = 0; k0 < K8; k0 += 8) {
    int cc[8 * kDim];
#pragma unroll
    for (int i = 0; i < 8 * kDim; ++i) cc[i] = c[k0 * kDim + i];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        unsigned d;
        if constexpr (kDim == 1) {
          d = (unsigned)abs(x[p] - cc[k]);
        } else {
          const int d0 = x[2 * p] - cc[2 * k];
          const int d1 = x[2 * p + 1] - cc[2 * k + 1];
          d = (unsigned)(d0 * d0 + d1 * d1);
        }
        best[p] = min(best[p], (d << 8) | (unsigned)(k0 + k));
      }
    }
  }
}

// The int64 path for one point: the first index of least distance by a
// strict `<` over k ascending, and its term of the total, in arithmetic
// that wraps as the reference's numpy int64 does.
template <typename T, int kDim>
__device__ __forceinline__ void nearest_wide(const T* x, const long long* c,
                                             int K, int& arg,
                                             unsigned long long& term) {
  using u64 = unsigned long long;
  long long best = 0;
  arg = 0;
  for (int k = 0; k < K; ++k) {
    long long d;
    if constexpr (kDim == 1) {
      d = (long long)((u64)(long long)x[0] - (u64)c[k]);
      if (d < 0) d = (long long)(0ull - (u64)d);
    } else {
      const u64 d0 = (u64)(long long)x[0] - (u64)c[2 * k];
      const u64 d1 = (u64)(long long)x[1] - (u64)c[2 * k + 1];
      d = (long long)(d0 * d0 + d1 * d1);
    }
    if (k == 0 || d < best) {
      best = d;
      arg = k;
    }
  }
  term = kDim == 1 ? (u64)best * (u64)best : (u64)best;
}

// kG indices (one byte each, packed four to a word) as one store: idx is
// 16-byte aligned and a group starts at a multiple of kG.
template <int kG>
__device__ __forceinline__ void store_indices(
    unsigned char* dst, const unsigned (&ix)[(kG + 3) / 4]) {
  if constexpr (kG == 16) {
    *(uint4*)dst = make_uint4(ix[0], ix[1], ix[2], ix[3]);
  } else if constexpr (kG == 8) {
    *(uint2*)dst = make_uint2(ix[0], ix[1]);
  } else if constexpr (kG == 4) {
    *(unsigned*)dst = ix[0];
  } else if constexpr (kG == 2) {
    *(unsigned short*)dst = (unsigned short)ix[0];
  } else {
    dst[0] = (unsigned char)ix[0];
  }
}

// kG points a group: a 16-byte vector (kVec) or one point; a thread holds
// kRounds groups at a time.
template <typename T, int kDim, bool kVec>
__global__ void __launch_bounds__(kThreads) kq_kernel(KQArgs a) {
  constexpr int kG = kVec ? 16 / (int)(sizeof(T) * kDim) : 1;
  constexpr int kE = kG * kDim;      // values a group
  constexpr int kP = kRounds * kG;   // points a thread holds
  __shared__ long long c64[2 * kMaxK];  // K rounded up to 8: K <= 256
  __shared__ int c32[2 * kMaxK];
  __shared__ long long red[kThreads / 32];
  const int K = a.K, K8 = (K + 7) & ~7, warp = threadIdx.x >> 5;
  bool ok = true;
  for (int j = threadIdx.x; j < K8 * kDim; j += kThreads) {
    const long long v =
        load_cent(a.cents, a.ctype, j < K * kDim ? j : j % kDim);
    c64[j] = v;
    c32[j] = (int)v;
    ok = ok && v >= -kFast && v <= kFast;
  }
  const bool cfast = __syncthreads_and(ok);

  const T* data = (const T*)a.data;
  const long long groups = (a.N + kG - 1) / kG;  // kVec: N % kG == 0
  constexpr long long kCtaGroups = kCtaPoints / kG;
  unsigned long long part = 0;
  for (long long g0 = (long long)blockIdx.x * kCtaGroups; g0 < groups;
       g0 += (long long)gridDim.x * kCtaGroups) {
    const long long gend = min(g0 + kCtaGroups, groups);
    for (long long r0 = g0; r0 < gend; r0 += kThreads * kRounds) {
      T x[kRounds][kE];
      bool valid[kRounds], fit = true;
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        const long long g = r0 + j * kThreads + threadIdx.x;
        valid[j] = g < gend;
#pragma unroll
        for (int e = 0; e < kE; ++e) x[j][e] = 0;
        if (!valid[j]) continue;
        if constexpr (kVec) {
          union {
            int4 q;
            T v[kE];
          } u;
          u.q = ((const int4*)data)[g];
#pragma unroll
          for (int e = 0; e < kE; ++e) x[j][e] = u.v[e];
        } else {
#pragma unroll
          for (int e = 0; e < kDim; ++e) x[j][e] = data[g * kDim + e];
        }
#pragma unroll
        for (int e = 0; e < kE; ++e) fit = fit && fits(x[j][e]);
      }
      // warp-uniform: every lane of a warp takes the same rounds
      if (cfast && __all_sync(0xffffffffu, fit)) {
        int xi[kP * kDim];
#pragma unroll
        for (int j = 0; j < kRounds; ++j)
#pragma unroll
          for (int e = 0; e < kE; ++e) xi[j * kE + e] = (int)x[j][e];
        unsigned best[kP];
        keys_fast<kDim, kP>(xi, c32, K8, best);
#pragma unroll
        for (int j = 0; j < kRounds; ++j) {
          if (!valid[j]) continue;
          unsigned ix[(kG + 3) / 4] = {};
#pragma unroll
          for (int p = 0; p < kG; ++p) {
            const unsigned b = best[j * kG + p], d = b >> 8;
            part += kDim == 1 ? d * d : d;
            ix[p >> 2] |= (b & 255u) << (8 * (p & 3));
          }
          store_indices<kG>(a.idx + (r0 + j * kThreads + threadIdx.x) * kG,
                            ix);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kRounds; ++j) {
          if (!valid[j]) continue;
          unsigned ix[(kG + 3) / 4] = {};
#pragma unroll
          for (int p = 0; p < kG; ++p) {
            int arg;
            unsigned long long t;
            nearest_wide<T, kDim>(&x[j][p * kDim], c64, K, arg, t);
            part += t;
            ix[p >> 2] |= (unsigned)arg << (8 * (p & 3));
          }
          store_indices<kG>(a.idx + (r0 + j * kThreads + threadIdx.x) * kG,
                            ix);
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) red[warp] = (long long)part;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += (unsigned long long)red[w];
  if (gridDim.x == 1) {
    *(volatile long long*)a.total = (long long)total;
    return;
  }
  // the last CTA to finish adds the partials and leaves the counter at 0
  a.scratch->part[blockIdx.x] = (long long)total;
  __threadfence();
  if (atomicAdd(&a.scratch->done, 1u) != gridDim.x - 1) return;
  __threadfence();
  const volatile long long* parts = a.scratch->part;
  unsigned long long sum = 0;
  for (unsigned b = 0; b < gridDim.x; ++b)
    sum += (unsigned long long)parts[b];
  a.scratch->done = 0;
  *(volatile long long*)a.total = (long long)sum;
}

template <typename T>
const void* variant(int dim, bool vec) {
  if (dim == 1)
    return vec ? (const void*)kq_kernel<T, 1, true>
               : (const void*)kq_kernel<T, 1, false>;
  return vec ? (const void*)kq_kernel<T, 2, true>
             : (const void*)kq_kernel<T, 2, false>;
}

}  // namespace

// Once per device: slots[0] the address of an 8-byte mapped pinned slot
// (the host's and the card's: under unified addressing they are one; the
// entry fails otherwise), slots[1] the zeroed scratch area.
AV1_EXPORT int palette_setup(void** slots, void* stream) {
  void* host = nullptr;
  void* dev = nullptr;
  void* scratch = nullptr;
  cudaError_t e = cudaHostAlloc(&host, 64, cudaHostAllocMapped);
  if (e == cudaSuccess) e = cudaHostGetDevicePointer(&dev, host, 0);
  if (e == cudaSuccess && dev != host) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = cudaMalloc(&scratch, sizeof(Scratch));
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, sizeof(Scratch), (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize((cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  slots[0] = host;
  slots[1] = scratch;
  return 0;
}

// data (N, dim) of type dtype (0 uint8, 1 int16, 2 int32, 3 int64), read
// as 16-byte vectors when vec (the caller checks the alignment and that
// N * dim values are whole vectors); cents (K, dim) of type ctype; idx
// (N,) uint8; slot and scratch from palette_setup. The entry sets the slot
// to kPending, launches, spins until the kernel's total replaces it, and
// waits on the stream if that takes longer than kSpin (a total equal to
// kPending, or a stream busy with earlier work, costs a wait, never a wrong
// total): it returns with the total in the slot.
AV1_EXPORT int palette_indices(const void* data, int dtype, int vec,
                               const void* cents, int ctype, long long N,
                               int K, int dim, unsigned char* idx,
                               long long* slot, void* scratch,
                               void* stream) {
  if (N <= 0 || K <= 0 || K > kMaxK || (dim != 1 && dim != 2) || dtype < 0 ||
      dtype > 3 || ctype < 0 || ctype > 3)
    return (int)cudaErrorInvalidValue;
  const void* kern = dtype == 0   ? variant<unsigned char>(dim, vec)
                     : dtype == 1 ? variant<short>(dim, vec)
                     : dtype == 2 ? variant<int>(dim, vec)
                                  : variant<long long>(dim, vec);
  const long long chunks = (N + kCtaPoints - 1) / kCtaPoints;
  const int grid = (int)(chunks < kMaxCtas ? chunks : kMaxCtas);
  KQArgs a{data, cents, ctype, N, K, idx, slot, (Scratch*)scratch};
  volatile long long* t = slot;
  *t = kPending;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3(grid), dim3(kThreads), args, 0,
                                   (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const auto t0 = std::chrono::steady_clock::now();
  for (unsigned i = 1;; ++i) {
    if (*t != kPending) return 0;
    if (!(i & 255) && std::chrono::steady_clock::now() - t0 > kSpin) break;
  }
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}
