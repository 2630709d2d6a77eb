// Kernel KA: intra_pick, and its older entries intra_pred_sse /
// intra_pred_one.
//
// Replaces the reference's batched intra prediction inside the two-level
// and the uniform-grid (tpu_intra.py:282-411) wavefronts:
// tpu_intra._predict_all_modes (aom_av1_psy_tpu/encoder/
// tpu_intra.py:64), the directional edge pipeline of tpu_intra_dir
// (_filter_edge_b / build_edge_buffer / dir_predict, tpu_intra_dir.py:
// 179-265) and the per-candidate SSE (tpu_intra.py:645, :710, :817, :859);
// intra_pick also the RD choice around them: the mode rate (tpu_intra.py:
// 600-609, :793-795, :314-316), allowed_mask (tpu_intra_dir.py:268), _rd
// (tpu_intra.py:273) and the argmin.
//
// Candidates: k < 7 are the plain modes in PLAN order (DC V H SMOOTH
// SMOOTH_V SMOOTH_H PAETH); k >= 7 are directional (tpu_intra_dir.
// candidates). Block sizes 4 (the chroma of the 8x8 uniform grid), 8, 16
// and 32; the directional candidates exist at 16 and 32 only.
//
// What bounds it: tiny per-launch work (one anti-diagonal holds <= 34
// cells of the partition plan, <= 135 of the 8x8 uniform grid at 1080p) —
// launch latency and the serial wavefront, not bytes or FLOPs.
// A 32x32 block's 61 predictions are 62k pixels of integer blends.
//
// intra_pick (the wavefronts' entry, one launch per pick): each block
// reads its edges straight from the wavefront's recon buffer, prices every
// candidate from its neighbours' modes, masks the disallowed classes,
// takes the float32 RD sse*2048 + rate*(rdmult/512) (the first index on
// ties) and writes the winner's index, mode, delta, rate and prediction.
// - K = 61 (luma 32 / 16): a cluster of 4 CTAs of 16 warps per block
//   (__cluster_dims__), 64 warps for the 61 candidates, so each warp owns
//   one candidate and reduces its SSE with shuffles, with no block
//   barrier. The cluster size is fixed at 4 for both block sizes: the
//   largest diagonal of a 1080p frame (34 cells) then puts 136 CTAs on
//   the 132 SMs, about one CTA per SM. The 16-segment filtered edge buffer
//   (<= 792 ints) is built once per block: each CTA builds a quarter and
//   reads the other three from its peers' shared memory (distributed
//   shared memory); the argmin is taken across the cluster in rank 0's
//   shared memory.
// - K = 7 (chroma, the uniform grid): one CTA per block, one warp per
//   candidate; a chroma pair sums its U and V SSEs before pricing.
// The source block sits in shared memory. The directional sample
// positions (base, shift, above or left) are computed in registers from
// per-candidate constants in __constant__ memory (dx, dy, the edge-filter
// strengths of both ef types, the class: tpu_intra_dir.dir_consts), not
// read from the IDXa / IDXb / SH gather tables.
//
// intra_pred_sse / intra_pred_one: one CTA per (block, group of 8
// candidates) builds the block's edges and the whole filtered edge buffer,
// reads the directional positions from the gather tables IDXa / IDXb / SH
// (2, nd, bs, bs) of tpu_intra_dir.tables and reduces each candidate's
// SSE across the CTA; the second entry re-predicts one chosen candidate
// per block.
#include <cooperative_groups.h>

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

// ----------------------------------------------------------------------
// intra_pick
// ----------------------------------------------------------------------

// The argument block of intra_pick (mirrored by ops/intra_pred._PickArgs).
struct PickArgs {
  const int* buf;         // (planes, Hb, Wb) recon with a 1-px guard border
  const long long* tt;    // (B,) cell tile
  const long long* rc;    // (B,) cell row
  const long long* cc;    // (B,) cell column
  const int* src;         // (T, SH, SW) source plane (a pair: U)
  const int* src_v;       // (T, SH, SW) V source plane, or null
  const float* rd;        // (T, MR, MC) lambdas
  const bool* ok1;        // (T, MR, MC) class masks, or null (all allowed)
  const bool* ok2;
  const bool* ok3;
  const bool* trreal;     // (T, MR, MC) real top-right pixels, or null
  const bool* blreal;     // (T, MR, MC) real bottom-left pixels, or null
  const int* cost;        // luma (5, 5, K); chroma (13, K)
  const int* angle;       // luma (K,)
  const int* nbr;         // (T, NR, NC) neighbours' (luma: the luma) modes
  int* mode_out;          // (T, MR, MC) chosen mode, or null
  int* delta_out;         // (T, MR, MC) chosen angle delta, or null
  int* pick;              // (4, B): candidate, mode, delta, rate
  int* pred;              // (P*B, bs, bs)
  int B, K, bs, P, pstride, Hb, Wb;
  int local, qr, qc;      // local: block b reads plane b at the quad
  int SH, SW;
  int T, MR, MC, scale, NR, NC, nscale;
  int nbr_plan, luma;
};

namespace {

constexpr int kK = 61, kND = 54, kDirW = 8;
constexpr int kZ1 = 1, kZ2 = 2, kZ3 = 3;
// kTab (ops/intra_pred.pick_table): MODE, DELTA, CLS of the K = 61
// candidates, the PLAN modes, INTRA_MODE_CONTEXT, the smooth weights at
// bs 4 / 8 / 16 / 32 (offset bs - 4), then per directional candidate at
// bs 16 and at bs 32: dx, dy, sa(ef 0), sa(ef 1), sl(ef 0), sl(ef 1), cls
constexpr int kOffMode = 0, kOffDelta = kK, kOffCls = 2 * kK;
constexpr int kOffPlan = 3 * kK, kOffImc = kOffPlan + kPlain;
constexpr int kOffSw = kOffImc + 13, kOffDir = kOffSw + 60;
constexpr int kTabN = kOffDir + 2 * kND * kDirW;
__constant__ int kTab[kTabN];

constexpr int kCluster = 4, kWarpsPerCta = 16;

struct PickCtx {
  int tt, ha, hl, t, trr, blr;   // t: the edge-filter type
  int plane[2], oy, ox;
  int allow[4];                  // by class: PLAIN, Z1, Z2, Z3
  int rbase;                     // the rate row in cost
  float lam;                     // rdmult / 512
  long long pos;                 // the block's index in the (T, MR, MC) maps
};

template <int BS>
struct PlaneEdges {
  int ae[BS], le[BS];  // effective above row and left column
  int tle, dc;
};

template <int BS>
struct DirEdges {
  static constexpr int A1 = 2 * BS + 1, A2 = BS + 2, L = 8 * A1 + 8 * A2;
  int a1[A1], l3[A1], a2c[BS + 1], l2c[BS + 1];
  int E[L];  // the 16 filtered segments (tpu_intra_dir's layout)
};

__device__ __forceinline__ int mode_of_nbr(const PickArgs& a, int m) {
  return a.nbr_plan ? kTab[kOffPlan + m] : m;
}

__device__ __forceinline__ bool smooth(int m) { return m >= 9 && m <= 11; }

// The block's geometry, masks, lambda and rate row (one thread).
__device__ void setup(const PickArgs& a, int b, PickCtx& x) {
  const int tt = (int)a.tt[b], rc = (int)a.rc[b], cc = (int)a.cc[b];
  x.tt = tt;
  x.ha = rc > 0 || a.qr > 0;
  x.hl = cc > 0 || a.qc > 0;
  x.plane[0] = a.local ? b : tt;
  x.plane[1] = x.plane[0] + a.pstride;
  x.oy = ((a.local ? 0 : rc) + a.qr) * a.bs + 1;
  x.ox = ((a.local ? 0 : cc) + a.qc) * a.bs + 1;
  const int i = rc * a.scale + a.qr, j = cc * a.scale + a.qc;
  const long long pos = ((long long)tt * a.MR + i) * a.MC + j;
  x.pos = pos;
  x.lam = a.rd[pos] / 512.0f;
  x.allow[0] = 1;
  x.allow[1] = a.ok1 ? a.ok1[pos] : 1;
  x.allow[2] = a.ok2 ? a.ok2[pos] : 1;
  x.allow[3] = a.ok3 ? a.ok3[pos] : 1;
  x.trr = a.trreal ? a.trreal[pos] : 0;
  x.blr = a.blreal ? a.blreal[pos] : 0;
  const int ni = rc * a.nscale + a.qr, nj = cc * a.nscale + a.qc;
  const long long nrow = (long long)tt * a.NR;
  if (a.luma) {
    // inside the cell, the quads already chosen (mode_out); else the map
    int am = a.qr > 0   ? a.mode_out[pos - a.MC]
             : rc > 0   ? a.nbr[(nrow + ni - 1) * a.NC + nj]
                        : 0;
    int lm = a.qc > 0   ? a.mode_out[pos - 1]
             : cc > 0   ? a.nbr[(nrow + ni) * a.NC + nj - 1]
                        : 0;
    am = mode_of_nbr(a, am);
    lm = mode_of_nbr(a, lm);
    x.t = (smooth(am) && x.ha) || (smooth(lm) && x.hl);
    x.rbase = (kTab[kOffImc + am] * 5 + kTab[kOffImc + lm]) * a.K;
  } else {
    x.t = 0;
    x.rbase = mode_of_nbr(a, a.nbr[(nrow + ni) * a.NC + nj]) * a.K;
  }
}

__device__ __forceinline__ int rate_of(const PickArgs& a, const PickCtx& x,
                                       int k) {
  return a.cost[x.rbase + k] + (a.luma ? a.angle[k] : 0);
}

// rd_cost's float32 order: (f32(sse) * 2048) + (f32(rate) * (rdmult / 512))
__device__ __forceinline__ float rd_of(int sse, int rate, float lam) {
  return __fadd_rn(__fmul_rn(__int2float_rn(sse), 2048.0f),
                   __fmul_rn(__int2float_rn(rate), lam));
}

// One warp: plane p's effective edges, corner and DC into shared memory.
template <int BS>
__device__ void load_plane(const PickArgs& a, const PickCtx& x, int p,
                           PlaneEdges<BS>& e, int lane) {
  const int* pl = a.buf + (long long)x.plane[p] * a.Hb * a.Wb;
  const int* arow = pl + (long long)(x.oy - 1) * a.Wb + x.ox;
  const int* lcol = pl + (long long)x.oy * a.Wb + x.ox - 1;
  int va = 0, vl = 0;
  if (lane < BS) {
    va = x.ha ? arow[lane] : (x.hl ? lcol[0] : 127);
    vl = x.hl ? lcol[(long long)lane * a.Wb] : (x.ha ? arow[0] : 129);
    e.ae[lane] = va;
    e.le[lane] = vl;
  }
  for (int o = 16; o > 0; o >>= 1) {
    va += __shfl_xor_sync(0xffffffffu, va, o);
    vl += __shfl_xor_sync(0xffffffffu, vl, o);
  }
  if (lane == 0) {
    e.tle = (x.ha && x.hl) ? arow[-1]
            : x.ha         ? arow[0]
            : x.hl         ? lcol[0]
                           : 128;
    const int lg = floor_log2(BS);
    e.dc = (x.ha && x.hl) ? (va + vl + BS) >> (lg + 1)
           : x.ha         ? (va + (BS >> 1)) >> lg
           : x.hl         ? (vl + (BS >> 1)) >> lg
                          : 128;
  }
}

template <int BS>
__device__ __forceinline__ int plain_pix(const PlaneEdges<BS>& e,
                                         const int* sw, int k, int r, int c) {
  const int ae = e.ae[c], le = e.le[r];
  switch (k) {
    case 0: return e.dc;
    case 1: return ae;
    case 2: return le;
    case 3: {
      const int p = sw[r] * ae + (256 - sw[r]) * e.le[BS - 1] +
                    sw[c] * le + (256 - sw[c]) * e.ae[BS - 1];
      return (p + 256) >> 9;
    }
    case 4: return (sw[r] * ae + (256 - sw[r]) * e.le[BS - 1] + 128) >> 8;
    case 5: return (sw[c] * le + (256 - sw[c]) * e.ae[BS - 1] + 128) >> 8;
    default: {
      const int base = le + ae - e.tle;
      const int pl = abs(base - le), pt = abs(base - ae),
                ptl = abs(base - e.tle);
      return (pl <= pt && pl <= ptl) ? le : (pt <= ptl ? ae : e.tle);
    }
  }
}

// A directional candidate's constants for one ef type: its class, step
// and the offsets of the segments it reads in the edge buffer.
struct Dir {
  int cls, dx, dy, offa, offl;
};

template <int BS>
__device__ __forceinline__ Dir dir_of(int kd, int t) {
  constexpr int A1 = DirEdges<BS>::A1, A2 = DirEdges<BS>::A2;
  const int* c = kTab + kOffDir + ((BS == 32 ? kND : 0) + kd) * kDirW;
  const int sa = c[2 + t], sl = c[4 + t];
  Dir d;
  d.dx = c[0];
  d.dy = c[1];
  d.cls = c[6];
  d.offa = d.cls == kZ1 ? sa * A1 + 1 : 4 * A1 + sa * A2;
  d.offl = d.cls == kZ3 ? 4 * A1 + 8 * A2 + sl * A1 + 1
                        : 4 * A1 + 4 * A2 + sl * A2;
  return d;
}

// tpu_intra_dir.dir_positions, one sample: Z1 / Z3 step along one edge and
// read its last sample past the end; Z2 reads the above edge while
// ((c << 6) - (r + 1) * dx) >> 6 >= -1, else the left edge, clipped.
template <int BS>
__device__ __forceinline__ int dir_pix(const Dir& d, const int* E, int r,
                                       int c) {
  if (d.cls != kZ2) {
    const bool z1 = d.cls == kZ1;
    const int pos = z1 ? d.dx * (r + 1) : d.dy * (c + 1);
    const int base = (pos >> 6) + (z1 ? c : r);
    const int off = z1 ? d.offa : d.offl;
    constexpr int mb = 2 * BS - 1;
    if (base >= mb) return E[off + mb];
    const int sh = (pos & 63) >> 1;
    return (E[off + base] * (32 - sh) + E[off + base + 1] * sh + 16) >> 5;
  }
  int pos = (c << 6) - (r + 1) * d.dx;
  int off = d.offa;
  if ((pos >> 6) < -1) {
    pos = (r << 6) - (c + 1) * d.dy;
    off = d.offl;
  }
  const int base = pos >> 6, sh = (pos & 63) >> 1;
  return (E[off + clampi(base, -2, BS - 1) + 2] * (32 - sh) +
          E[off + clampi(base + 1, -2, BS - 1) + 2] * sh + 16) >> 5;
}

// One warp's SSE of candidate k over the P planes' blocks (every lane).
template <int BS>
__device__ int warp_sse(int k, int P, const PlaneEdges<BS>* ed,
                        const int* sw, const int* srcs, const Dir& d,
                        const int* E, int lane) {
  int acc = 0;
  for (int p = 0; p < P; ++p) {
    const int* s = srcs + p * BS * BS;
    for (int px = lane; px < BS * BS; px += 32) {
      const int r = px / BS, c = px % BS;
      const int v = k < kPlain ? plain_pix<BS>(ed[p], sw, k, r, c)
                               : dir_pix<BS>(d, E, r, c);
      const int diff = v - s[px];
      acc += diff * diff;
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// Block b's source, read where it lies: the (i*BS, j*BS) block of plane
// tt[b] of the source planes (U, then V for a pair), (i, j) the block's
// position on the maps.
template <int BS>
__device__ void load_src(const PickArgs& a, int b, int* srcs) {
  const long long i = a.rc[b] * a.scale + a.qr, j = a.cc[b] * a.scale + a.qc;
  const long long o = (a.tt[b] * a.SH + i * BS) * a.SW + j * BS;
  for (int k = threadIdx.x; k < a.P * BS * BS; k += blockDim.x) {
    const int p = k / (BS * BS), px = k % (BS * BS);
    srcs[k] = (p ? a.src_v : a.src)[o + (long long)(px / BS) * a.SW +
                                    px % BS];
  }
}

// The chosen candidate's outputs (one thread).
__device__ void finish(const PickArgs& a, const PickCtx& x, int b, int k) {
  const int mode = kTab[kOffMode + k], delta = kTab[kOffDelta + k];
  a.pick[b] = k;
  a.pick[a.B + b] = mode;
  a.pick[2 * a.B + b] = delta;
  a.pick[3 * a.B + b] = rate_of(a, x, k);
  if (a.mode_out) a.mode_out[x.pos] = a.K == kK ? mode : k;
  if (a.delta_out) a.delta_out[x.pos] = delta;
}

// K = 7: one CTA per block, warp k scores candidate k.
template <int BS>
__global__ void __launch_bounds__(256) pick7_kernel(const PickArgs a) {
  __shared__ PickCtx x;
  __shared__ PlaneEdges<BS> ed[2];
  __shared__ int sw[BS];
  __shared__ int srcs[2 * BS * BS];
  __shared__ float rdk[kPlain];
  __shared__ int best;
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) setup(a, b, x);
  if (threadIdx.x < BS) sw[threadIdx.x] = kTab[kOffSw + BS - 4 + threadIdx.x];
  __syncthreads();
  if (warp < a.P) load_plane<BS>(a, x, warp, ed[warp], lane);
  load_src<BS>(a, b, srcs);
  __syncthreads();
  if (warp < kPlain) {
    const int sse = warp_sse<BS>(warp, a.P, ed, sw, srcs, Dir{}, nullptr,
                                 lane);
    if (lane == 0) rdk[warp] = rd_of(sse, rate_of(a, x, warp), x.lam);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = 0;
    for (int j = 1; j < kPlain; ++j)
      if (rdk[j] < rdk[k]) k = j;
    finish(a, x, b, k);
    best = k;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.P * BS * BS; i += blockDim.x) {
    const int p = i / (BS * BS), px = i % (BS * BS);
    a.pred[(long long)(p * a.B + b) * BS * BS + px] =
        plain_pix<BS>(ed[p], sw, best, px / BS, px % BS);
  }
}

// The edge buffer's element e (the old kernel's build_edges, per element).
template <int BS>
__device__ __forceinline__ int edge_value(const DirEdges<BS>& d, int e) {
  constexpr int A1 = DirEdges<BS>::A1, A2 = DirEdges<BS>::A2;
  if (e < 4 * A1) return filt(d.a1, A1, e / A1, e % A1);
  if (e < 4 * A1 + 4 * A2) {
    const int e2 = e - 4 * A1, i = e2 % A2;
    return i == 0 ? 127 : filt(d.a2c, BS + 1, e2 / A2, i - 1);
  }
  if (e < 4 * A1 + 8 * A2) {
    const int e2 = e - 4 * A1 - 4 * A2, i = e2 % A2;
    return i == 0 ? 129 : filt(d.l2c, BS + 1, e2 / A2, i - 1);
  }
  const int e2 = e - 4 * A1 - 8 * A2;
  return filt(d.l3, A1, e2 / A1, e2 % A1);
}

// The unfiltered segments: [corner, above + top-right], [corner, left +
// bottom-left], and z2's [corner2, above] / [corner2, left].
template <int BS>
__device__ void build_segments(const PickArgs& a, const PickCtx& x,
                               const PlaneEdges<BS>& e, DirEdges<BS>& d) {
  const int* pl = a.buf + (long long)x.plane[0] * a.Hb * a.Wb;
  // z2 corner smoothing (reconintra.c, w + h >= 24 holds at 16/32)
  const int c2 = (e.le[0] * 5 + e.tle * 6 + e.ae[0] * 5 + 8) >> 4;
  for (int i = threadIdx.x; i < DirEdges<BS>::A1; i += blockDim.x) {
    if (i == 0) {
      d.a1[0] = e.tle;
      d.l3[0] = e.tle;
    } else if (i <= BS) {
      d.a1[i] = e.ae[i - 1];
      d.l3[i] = e.le[i - 1];
    } else {
      const int j = i - 1;
      d.a1[i] = x.trr ? pl[(long long)(x.oy - 1) * a.Wb +
                           min(x.ox + j, a.Wb - 1)]
                      : e.ae[BS - 1];
      d.l3[i] = x.blr ? pl[(long long)min(x.oy + j, a.Hb - 1) * a.Wb +
                           x.ox - 1]
                      : e.le[BS - 1];
    }
    if (i <= BS) {
      d.a2c[i] = i == 0 ? c2 : e.ae[i - 1];
      d.l2c[i] = i == 0 ? c2 : e.le[i - 1];
    }
  }
}

// K = 61: a cluster of kCluster CTAs per block, warp w of rank r scores
// candidate r * kWarpsPerCta + w.
template <int BS>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kWarpsPerCta * 32) pick61_kernel(const PickArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  constexpr int L = DirEdges<BS>::L;
  constexpr int Q = (L + kCluster - 1) / kCluster;
  __shared__ PickCtx x;
  __shared__ PlaneEdges<BS> ed;
  __shared__ DirEdges<BS> d;
  __shared__ int sw[BS];
  __shared__ int srcs[BS * BS];
  __shared__ float rdw[kWarpsPerCta], rdc[kCluster];
  __shared__ int kw[kWarpsPerCta], kc[kCluster];
  __shared__ int best;
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / kCluster;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) setup(a, b, x);
  if (threadIdx.x < BS) sw[threadIdx.x] = kTab[kOffSw + BS - 4 + threadIdx.x];
  __syncthreads();
  if (warp == 0) load_plane<BS>(a, x, 0, ed, lane);
  load_src<BS>(a, b, srcs);
  __syncthreads();
  build_segments<BS>(a, x, ed, d);
  __syncthreads();
  // this CTA's quarter of the filtered edge buffer, then the others'
  for (int e = rank * Q + threadIdx.x; e < min(L, (rank + 1) * Q);
       e += blockDim.x)
    d.E[e] = edge_value<BS>(d, e);
  cl.sync();
  for (int e = threadIdx.x; e < L; e += blockDim.x) {
    const int owner = e / Q;
    if (owner != rank) d.E[e] = cl.map_shared_rank(d.E, owner)[e];
  }
  __syncthreads();
  const int k = rank * kWarpsPerCta + warp;
  float v = __int_as_float(0x7f800000);  // +inf: not scored, or masked
  if (k < a.K) {
    const Dir dk = k < kPlain ? Dir{} : dir_of<BS>(k - kPlain, x.t);
    const int sse = warp_sse<BS>(k, 1, &ed, sw, srcs, dk, d.E, lane);
    if (x.allow[kTab[kOffCls + k]]) v = rd_of(sse, rate_of(a, x, k), x.lam);
  }
  if (lane == 0) {
    rdw[warp] = v;
    kw[warp] = k;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // this CTA's best, into rank 0's slot
    int w = 0;
    for (int j = 1; j < kWarpsPerCta; ++j)
      if (rdw[j] < rdw[w]) w = j;
    cl.map_shared_rank(rdc, 0)[rank] = rdw[w];
    cl.map_shared_rank(kc, 0)[rank] = kw[w];
  }
  cl.sync();
  if (rank != 0) return;
  if (threadIdx.x == 0) {  // ranks hold ascending candidates: first on ties
    int r = 0;
    for (int j = 1; j < kCluster; ++j)
      if (rdc[j] < rdc[r]) r = j;
    best = kc[r];
    finish(a, x, b, best);
  }
  __syncthreads();
  const int kb = best;
  const Dir dk = kb < kPlain ? Dir{} : dir_of<BS>(kb - kPlain, x.t);
  for (int px = threadIdx.x; px < BS * BS; px += blockDim.x)
    a.pred[(long long)b * BS * BS + px] =
        kb < kPlain ? plain_pix<BS>(ed, sw, kb, px / BS, px % BS)
                    : dir_pix<BS>(dk, d.E, px / BS, px % BS);
}

}  // namespace

AV1_EXPORT int intra_pick_init(const int* tab, int n, void* stream) {
  (void)stream;
  if (n != kTabN) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(kTab, tab, n * sizeof(int));
}

AV1_EXPORT int intra_pick(const PickArgs* args, void* stream) {
  const PickArgs a = *args;
  if (a.B <= 0) return 0;
  if (a.P < 1 || a.P > 2 || (a.K == kK && a.P != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid61(kCluster * a.B);
  if (a.K == kK && a.bs == 16) {
    pick61_kernel<16><<<grid61, kWarpsPerCta * 32, 0, st>>>(a);
  } else if (a.K == kK && a.bs == 32) {
    pick61_kernel<32><<<grid61, kWarpsPerCta * 32, 0, st>>>(a);
  } else if (a.K != kPlain) {
    return (int)cudaErrorInvalidValue;
  } else {
    switch (a.bs) {
      case 4: pick7_kernel<4><<<a.B, 256, 0, st>>>(a); break;
      case 8: pick7_kernel<8><<<a.B, 256, 0, st>>>(a); break;
      case 16: pick7_kernel<16><<<a.B, 256, 0, st>>>(a); break;
      case 32: pick7_kernel<32><<<a.B, 256, 0, st>>>(a); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
