// Kernel KA: intra_pred_sse / intra_pred_one.
//
// Replaces the reference's batched intra prediction inside the two-level
// and the uniform-grid (tpu_intra.py:282-411) wavefronts:
// tpu_intra._predict_all_modes (aom_av1_psy_tpu/encoder/
// tpu_intra.py:64), the directional edge pipeline of tpu_intra_dir
// (_filter_edge_b / build_edge_buffer / dir_predict, tpu_intra_dir.py:
// 179-265) and the per-candidate SSE (tpu_intra.py:645, :710, :817, :859).
//
// Candidates: k < 7 are the plain modes in PLAN order (DC V H SMOOTH
// SMOOTH_V SMOOTH_H PAETH); k >= 7 are directional, read from the static
// gather tables IDXa/IDXb/SH (2, nd, bs, bs) of tpu_intra_dir.tables.
//
// Block sizes 4 (the chroma of the 8x8 uniform grid), 8, 16 and 32; the
// directional candidates exist at 16 and 32 only.
//
// What bounds it: tiny per-launch work (one anti-diagonal holds <= 34
// cells of the partition plan, <= 135 of the 8x8 uniform grid at 1080p) —
// launch latency and the serial wavefront, not bytes or FLOPs.
// A 32x32 block's 61 predictions are 62k pixels of integer blends.
// Design: one CTA per (block, group of 8 candidates). The CTA builds the
// block's effective edges and the whole 16-segment filtered edge buffer
// (<= 792 ints at bs 32) in shared memory, keeps its source pixels in
// registers, and reduces each candidate's SSE across the block. The
// second entry point re-predicts one chosen candidate per block (the RD
// pick between the two runs as torch ops on the device).
#include "common.cuh"

namespace {

constexpr int kPlain = 7;
constexpr int kGroup = 8;
__constant__ int kFilter[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0},
                                  {2, 4, 4, 4, 2}};

struct KAArgs {
  const int* above;       // (B, bs) raw recon above row
  const int* left;        // (B, bs) raw recon left column
  const int* tl;          // (B,)
  const bool* have_a;     // (B,)
  const bool* have_l;     // (B,)
  const bool* trreal;     // (B,) real top-right pixels in abext
  const bool* blreal;     // (B,) real bottom-left pixels in lfext
  const int* abext;       // (B, bs)
  const int* lfext;       // (B, bs)
  const bool* ef;         // (B,) edge-filter type (smooth neighbour)
  const int* src;         // (B, bs, bs) or null
  const int* smooth_w;    // (bs,)
  const int* idxa;        // (2, nd, bs, bs) or null when K == 7
  const int* idxb;
  const int* sh;          // (nd, bs, bs)
  const int* cand;        // (B,) chosen candidate (pred mode) or null
  int B, K;
  int* sse_out;           // (K, B)
  int* pred_out;          // (B, bs, bs)
};

template <int BS>
struct Smem {
  static constexpr int kSegA1 = 2 * BS + 1;
  static constexpr int kSegA2 = BS + 2;
  static constexpr int kL = 8 * kSegA1 + 8 * kSegA2;
  int ae[BS], le[BS], sw[BS];
  int a1[kSegA1], l3[kSegA1], a2c[BS + 1], l2c[BS + 1];
  int E[kL];
  int tle, dc, c2;
  int red[32];
};

// av1_filter_intra_edge_c on x[0..sz): position 0 is never modified.
__device__ __forceinline__ int filt(const int* x, int sz, int s, int i) {
  if (s == 0 || i == 0) return x[i];
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k)
    acc += x[clampi(i + k - 2, 0, sz - 1)] * kFilter[s - 1][k];
  return (acc + 8) >> 4;
}

template <int BS>
__device__ void build_edges(const KAArgs& a, int b, bool need_dir,
                            Smem<BS>& s) {
  const int tid = threadIdx.x;
  const bool ha = a.have_a[b], hl = a.have_l[b];
  const int* above = a.above + b * BS;
  const int* left = a.left + b * BS;
  if (tid < BS) {
    s.ae[tid] = ha ? above[tid] : (hl ? left[0] : 127);
    s.le[tid] = hl ? left[tid] : (ha ? above[0] : 129);
    s.sw[tid] = a.smooth_w[tid];
  }
  __syncthreads();
  if (tid == 0) {
    s.tle = (ha && hl) ? a.tl[b] : (ha ? above[0] : (hl ? left[0] : 128));
    int sa = 0, sl = 0;
    for (int i = 0; i < BS; ++i) {
      sa += s.ae[i];
      sl += s.le[i];
    }
    const int lg = 31 - __clz(BS);
    s.dc = (ha && hl) ? (sa + sl + BS) >> (lg + 1)
           : ha       ? (sa + (BS >> 1)) >> lg
           : hl       ? (sl + (BS >> 1)) >> lg
                      : 128;
    // z2 corner smoothing (reconintra.c, w + h >= 24 holds at 16/32)
    s.c2 = (s.le[0] * 5 + s.tle * 6 + s.ae[0] * 5 + 8) >> 4;
  }
  __syncthreads();
  if (!need_dir) return;
  const bool tr = a.trreal[b], bl = a.blreal[b];
  for (int i = tid; i < Smem<BS>::kSegA1; i += blockDim.x) {
    if (i == 0) {
      s.a1[0] = s.tle;
      s.l3[0] = s.tle;
    } else if (i <= BS) {
      s.a1[i] = s.ae[i - 1];
      s.l3[i] = s.le[i - 1];
    } else {
      s.a1[i] = tr ? a.abext[b * BS + i - 1 - BS] : s.ae[BS - 1];
      s.l3[i] = bl ? a.lfext[b * BS + i - 1 - BS] : s.le[BS - 1];
    }
    if (i <= BS) {
      s.a2c[i] = i == 0 ? s.c2 : s.ae[i - 1];
      s.l2c[i] = i == 0 ? s.c2 : s.le[i - 1];
    }
  }
  __syncthreads();
  constexpr int A1 = Smem<BS>::kSegA1, A2 = Smem<BS>::kSegA2;
  for (int e = tid; e < Smem<BS>::kL; e += blockDim.x) {
    int v;
    if (e < 4 * A1) {
      v = filt(s.a1, A1, e / A1, e % A1);
    } else if (e < 4 * A1 + 4 * A2) {
      const int e2 = e - 4 * A1, i = e2 % A2;
      v = i == 0 ? 127 : filt(s.a2c, BS + 1, e2 / A2, i - 1);
    } else if (e < 4 * A1 + 8 * A2) {
      const int e2 = e - 4 * A1 - 4 * A2, i = e2 % A2;
      v = i == 0 ? 129 : filt(s.l2c, BS + 1, e2 / A2, i - 1);
    } else {
      const int e2 = e - 4 * A1 - 8 * A2;
      v = filt(s.l3, A1, e2 / A1, e2 % A1);
    }
    s.E[e] = v;
  }
  __syncthreads();
}

template <int BS>
__device__ __forceinline__ int predict(const KAArgs& a, const Smem<BS>& s,
                                       int k, int nd, int t, int r, int c) {
  const int ae = s.ae[c], le = s.le[r];
  switch (k) {
    case 0: return s.dc;
    case 1: return ae;
    case 2: return le;
    case 3: {
      const int p = s.sw[r] * ae + (256 - s.sw[r]) * s.le[BS - 1] +
                    s.sw[c] * le + (256 - s.sw[c]) * s.ae[BS - 1];
      return (p + 256) >> 9;
    }
    case 4: return (s.sw[r] * ae + (256 - s.sw[r]) * s.le[BS - 1] + 128) >> 8;
    case 5: return (s.sw[c] * le + (256 - s.sw[c]) * s.ae[BS - 1] + 128) >> 8;
    case 6: {
      const int base = le + ae - s.tle;
      const int pl = abs(base - le), pt = abs(base - ae),
                ptl = abs(base - s.tle);
      return (pl <= pt && pl <= ptl) ? le : (pt <= ptl ? ae : s.tle);
    }
    default: {
      const int kd = k - kPlain;
      const int off = ((t * nd + kd) * BS + r) * BS + c;
      const int sh = a.sh[(kd * BS + r) * BS + c];
      return (s.E[a.idxa[off]] * (32 - sh) + s.E[a.idxb[off]] * sh + 16) >>
             5;
    }
  }
}

// Threads per CTA: one per pixel up to 256, and at least one full warp
// (a 4x4 block runs 16 of its 32 threads) for the warp-shuffle reduction.
template <int BS>
__host__ __device__ constexpr int threads() {
  return BS * BS < 32 ? 32 : (BS * BS < 256 ? BS * BS : 256);
}

template <int BS>
__global__ void ka_sse_kernel(KAArgs a) {
  constexpr int NT = threads<BS>();
  constexpr int PPT = (BS * BS + NT - 1) / NT;
  __shared__ Smem<BS> s;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * kGroup;
  const int k1 = min(a.K, k0 + kGroup);
  const int nd = a.K - kPlain;
  build_edges<BS>(a, b, a.K > kPlain, s);
  const int t = a.ef[b] ? 1 : 0;
  int src[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * NT;
    src[j] = p < BS * BS ? a.src[b * BS * BS + p] : 0;
  }
  for (int k = k0; k < k1; ++k) {
    int acc = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = threadIdx.x + j * NT;
      if (p >= BS * BS) break;
      const int d = predict<BS>(a, s, k, nd, t, p / BS, p % BS) - src[j];
      acc += d * d;
    }
    acc = block_sum<int>(acc, s.red);
    if (threadIdx.x == 0) a.sse_out[k * a.B + b] = acc;
  }
}

template <int BS>
__global__ void ka_one_kernel(KAArgs a) {
  constexpr int NT = threads<BS>();
  __shared__ Smem<BS> s;
  const int b = blockIdx.x;
  const int k = a.cand[b];
  build_edges<BS>(a, b, k >= kPlain, s);
  const int t = a.ef[b] ? 1 : 0;
  for (int p = threadIdx.x; p < BS * BS; p += NT)
    a.pred_out[b * BS * BS + p] =
        predict<BS>(a, s, k, a.K - kPlain, t, p / BS, p % BS);
}

template <int BS>
int launch(const KAArgs& a, bool one, cudaStream_t st) {
  constexpr int NT = threads<BS>();
  if (one) {
    ka_one_kernel<BS><<<dim3(a.B), NT, 0, st>>>(a);
  } else {
    ka_sse_kernel<BS><<<dim3(a.B, (a.K + kGroup - 1) / kGroup), NT, 0, st>>>(
        a);
  }
  return (int)cudaGetLastError();
}

int dispatch(const KAArgs& a, int bs, bool one, void* stream) {
  if (a.B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bs) {
    case 4: return launch<4>(a, one, st);
    case 8: return launch<8>(a, one, st);
    case 16: return launch<16>(a, one, st);
    case 32: return launch<32>(a, one, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

AV1_EXPORT int intra_pred_sse(const int* above, const int* left,
                              const int* tl, const bool* have_a,
                              const bool* have_l, const bool* trreal,
                              const bool* blreal, const int* abext,
                              const int* lfext, const bool* ef,
                              const int* src, const int* smooth_w,
                              const int* idxa, const int* idxb,
                              const int* sh, int B, int bs, int K,
                              int* sse_out, void* stream) {
  KAArgs a{above, left,  tl,       have_a, have_l, trreal,  blreal,
           abext, lfext, ef,       src,    smooth_w, idxa, idxb,
           sh,    nullptr, B,      K,      sse_out, nullptr};
  return dispatch(a, bs, false, stream);
}

AV1_EXPORT int intra_pred_one(const int* above, const int* left,
                              const int* tl, const bool* have_a,
                              const bool* have_l, const bool* trreal,
                              const bool* blreal, const int* abext,
                              const int* lfext, const bool* ef,
                              const int* smooth_w, const int* idxa,
                              const int* idxb, const int* sh,
                              const int* cand, int B, int bs, int K,
                              int* pred_out, void* stream) {
  KAArgs a{above, left,  tl,       have_a, have_l, trreal,  blreal,
           abext, lfext, ef,       nullptr, smooth_w, idxa, idxb,
           sh,    cand,  B,        K,      nullptr, pred_out};
  return dispatch(a, bs, true, stream);
}
