// Kernel KP: analyze_blocks.
//
// Replaces the batched analysis pipeline of the reference: analyze_plane
// (aom_av1_psy_tpu/ops/analyze.py:119-148, over blockify :38,
// _edges_from_source :53, predict_modes :72, quantize_fp :110 and the jnp
// forward transform ops/txfm.py:227 fwd_txfm2d) and the per-shard step of
// sharded_analyze_step (aom_av1_psy_tpu/parallel/mesh.py:32-75, with its
// psum totals). Per n x n block (n = 4, 8, 16, 32): the 7 broadcast
// predictions (DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH) from the
// source-neighbour edges, their int32 SSEs and the first-index argmin, the
// winner's residual through the forward DCT_DCT 2-D transform (the stage
// programs of txfm.cuh, with the reference's intermediate round shifts),
// the fp-domain quantization and the eob over the default scan.
//
// Two entries of one kernel: from a plane (the edges are read from the
// plane: 127 above the first block row, 129 left of the first column, 128
// in the corner of either), or from blocks and the caller's edges, which
// also adds every block's SSE and eob to two int64 totals (one atomic each
// per CTA: integers, so the totals do not depend on the order of the CTAs;
// the wrapper truncates them to int32 as the reference's psum wraps).
//
// Exactness: quantize_fp is sign(F) * ((|F| << shift) + (dq >> 1)) // dq
// with no dead zone, no 48/128 rounding and no clamp (not KB's quantizer),
// in wrapping int32 with a floor division, as jnp computes it; the DC
// predictor always averages both edges, (sum above + sum left + n) // 2n;
// PAETH prefers left, then top, then the corner (<=); the SSEs wrap in
// int32 as jnp's do (they cannot at 8-bit samples: 1024 * 255^2 < 2^31).
//
// What bounds it: at the 1080p luma plane (n = 16, B = 8160) the kernel
// reads 8.4 MB of int32 samples and writes 8.4 MB of levels, ~5 us at
// 3.35 TB/s, and does ~10^8 integer operations (~5.5 us at 67 T/s). As
// built it is bound by instruction issue: per element, 7 predictions and
// squared errors, and per transform stage an entry load, two shuffles and
// a multiply-add, beside the per-block work (staging, DC, the reductions,
// the barriers) that every thread of a block repeats.
//
// Design: a persistent grid (as many CTAs as fit on the card at once).
// Each CTA copies the stage table, the meta, the inverse scan and the
// smooth weights into shared memory once, then walks the blocks, G at a
// time. A thread holds V elements of a block: lane i of V column vectors
// n / V apart (V = 8 at n >= 8, 2 at n = 4), so the per-block work is
// paid once for V elements and one stage entry serves V vectors; a block
// is n * n / V threads: 8 at n = 4 and 8 (four blocks to a warp), one
// warp at n = 16, four warps at n = 32. Its
// loop-invariant values (smooth weights, scan positions, quantizer steps
// and their reciprocals) stay in registers. Per block:
// - the block and its edges are staged in shared memory, rows padded so
//   that column-order reads hit every bank (barrier 1);
// - every warp sums the 2n edge samples for DC itself, with shuffles;
// - each thread predicts the 7 modes at its pixels and keeps them in
//   registers; the seven SSEs are reduced together: a reduce-scatter over
//   the block's lanes in the warp (9 shuffles for a warp, where seven
//   separate reductions take 35) leaves each mode's sum in a lane, which
//   stores it (or, at n = 32, adds it) into the block's seven sums in
//   shared memory (barrier 2); each thread takes the first-index argmin;
// - the winner's residual goes through the forward DCT_DCT: txfm.cuh's
//   stage walk (KB's) unrolled over the forward DCT's stages, one entry
//   load for the V vectors of a lane, one transpose through shared memory
//   between the column and the row pass (barrier 3);
// - the levels are quantized (the division by the quantizer step as an
//   exact multiply and shift), the eob's max is reduced with shuffles (an
//   atomicMax per warp at n = 32), and the levels are laid out in
//   coefficient order in shared memory so that the store to the output is
//   coalesced (barrier 4).
// Barriers are the warp's where a block lies within one warp (n <= 16),
// the CTA's at n = 32. The blocks entry's totals are summed per thread
// across the blocks and per CTA in shared memory: one int64 atomicAdd per
// total per CTA.
#include "txfm.cuh"

namespace {

struct KPArgs {
  const int* plane;   // (H, W): the plane entry, else null
  int W;
  const int* blocks;  // (B, n, n): the blocks entry
  const int* above;   // (B, n)
  const int* left;    // (B, n)
  const int* corner;  // (B,)
  const int* sw;      // (n,) smooth weights
  int dc_q, ac_q, shift;
  const int* scan;    // (n*n,)
  const int* stages;  // stage table and meta (txfm.cuh)
  const int* meta;
  int* mode;          // (B,)
  int* sse;           // (B,)
  int* levels;        // (B, n*n) coefficient layout c * n + r
  int* eob;           // (B,)
  unsigned long long* totals;  // (2,) sse, eob; null on the plane entry
  // floor(a / dq) = a * mul >> sh for 0 <= a < 2^31 (dc_q, then ac_q)
  unsigned long long mul[2];
  int sh[2];
};

// mul = ceil(2^(31+l) / d) with 2^l >= d: for 0 <= a < 2^31 the error of
// a * mul / 2^(31+l) against a / d is below 1/d, so the floor is exact.
void div_magic(int d, unsigned long long* mul, int* sh) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  *sh = 31 + l;
  *mul = ((1ULL << *sh) + (unsigned long long)d - 1) / (unsigned long long)d;
}

constexpr int kModes = 7;

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The 7 predictions at one pixel (analyze.py:72-107): a = above[c],
// l = left[r], wr = sw[r], wc = sw[c].
__device__ __forceinline__ void predict7(int a, int l, int below, int right,
                                         int cr, int dc, int wr, int wc,
                                         int (&p)[kModes]) {
  const int sv = wr * a + (256 - wr) * below;
  const int sh = wc * l + (256 - wc) * right;
  p[0] = dc;
  p[1] = a;
  p[2] = l;
  p[3] = (sv + sh + 256) >> 9;
  p[4] = (sv + 128) >> 8;
  p[5] = (sh + 128) >> 8;
  const int base = l + a - cr;
  const int pl = abs(base - l), pt = abs(base - a), ptl = abs(base - cr);
  p[6] = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? a : cr);
}

// quantize_fp (analyze.py:110-116) of one coefficient, jnp's int32; the
// division by the magic multiply where the dividend is not negative (it
// is negative only where the int32 arithmetic wrapped).
__device__ __forceinline__ int quantize_fp(int x, int dq, int shift,
                                           unsigned long long mul, int sh) {
  const int ax = x < 0 ? sub32(0, x) : x;
  const int scaled = (int)((unsigned)ax << shift);
  const int num = add32(scaled, dq >> 1);
  const int lv = num >= 0
      ? (int)(((unsigned long long)(unsigned)num * mul) >> sh)
      : floordiv(num, dq);
  return mul32((x > 0) - (x < 0), lv);
}

// The launch shape at block size BS: each thread holds V elements (lane i
// of V column vectors BS / V apart), a block is NT threads, a CTA takes G
// blocks at a time and goes in step (one at n = 32, whose shared memory
// would pass 48 KB with two).
template <int BS>
struct KPShape {
  static constexpr int N = BS * BS, V = BS >= 8 ? 8 : 2, NT = N / V;
  static constexpr int G = BS == 32 || NT >= 256 ? 1 : 256 / NT;
  static constexpr int T = NT * G;
  static constexpr int S = NT < 32 ? NT : 32;  // lanes of a block in a warp
  // stages of the forward DCT's program (ops/analyze.KP_DCT_STAGES)
  static constexpr int kStages = BS == 4 ? 3 : BS == 8 ? 5 : BS == 16 ? 7 : 9;
};

template <int BS>
struct KPSmem {
  static constexpr int N = BS * BS, G = KPShape<BS>::G;
  int4 st[stage_rows<BS>()];
  int meta[kMetaLen];
  int iscan[N];
  int sw[BS];
  unsigned long long tot[2];
  struct Group {  // padded rows: column-order reads hit every bank
    int src[BS][BS + 1];
    int tr[BS][BS + 1];
    int lv[BS][BS + 1];
    int ab[BS], lf[BS];
    int corner;
    unsigned sse[kModes];
    int eob;
  } g[G];
};

// The S-lane segment's sums of a[0..7] (a reduce-scatter: 8 -> 4 -> 2 -> 1
// values a lane, then the rest of the lanes): returns the segment's sum of
// a[kp_mode<S>(lane)], held by S / 8 lanes each.
template <int S>
__device__ __forceinline__ unsigned reduce8(const unsigned (&a)[8],
                                            int lane) {
  const bool h2 = lane & (S / 2), h4 = lane & (S / 4), h8 = lane & (S / 8);
  unsigned b[4], c[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = (h2 ? a[k + 4] : a[k]) +
           __shfl_xor_sync(kFull, h2 ? a[k] : a[k + 4], S / 2);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    c[k] = (h4 ? b[k + 2] : b[k]) +
           __shfl_xor_sync(kFull, h4 ? b[k] : b[k + 2], S / 4);
  unsigned d = (h8 ? c[1] : c[0]) + __shfl_xor_sync(kFull, h8 ? c[0] : c[1],
                                                    S / 8);
#pragma unroll
  for (int o = S / 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
  return d;
}

template <int S>
__device__ __forceinline__ int kp_mode(int lane) {
  return ((lane & (S / 2)) ? 4 : 0) + ((lane & (S / 4)) ? 2 : 0) +
         ((lane & (S / 8)) ? 1 : 0);
}

template <int S, typename T, typename Op>
__device__ __forceinline__ T seg_reduce(T v, Op op) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A barrier of the blocks in flight: the warp where a block lies within
// one (n <= 16), the CTA otherwise.
template <int BS>
__device__ __forceinline__ void kp_sync() {
  if (KPShape<BS>::NT <= 32)
    __syncwarp();
  else
    __syncthreads();
}

// Forward DCT pass ``prog`` (0: columns, 2: rows) over the V vectors of
// this lane: txfm.cuh's stage walk, unrolled over the forward DCT's
// kStages stages (the wrapper checks the table, ops/analyze._kp_programs).
template <int BS, int V>
__device__ __forceinline__ void fdct_pass(int (&x)[V], const int4* st,
                                          const int* meta, int prog) {
  constexpr int kStages = KPShape<BS>::kStages;
  const int* m = meta + 4 * prog;
  tx_stages<BS, V, kStages>(x, st, m[0], kStages, kStages, m[2], m[3]);
}

template <int BS>
__global__ void __launch_bounds__(KPShape<BS>::T) kp_kernel(KPArgs a, int B) {
  using Shape = KPShape<BS>;
  constexpr int N = Shape::N, V = Shape::V, NT = Shape::NT, G = Shape::G;
  constexpr int S = Shape::S, kStep = BS / V;
  __shared__ KPSmem<BS> sm;
  const int gi = threadIdx.x / NT, t = threadIdx.x % NT;
  const int lane = threadIdx.x & 31;
  auto& grp = sm.g[gi];
  load_stages<BS>(sm.st, sm.meta, sm.iscan, a.stages, a.meta, a.scan);
  for (int j = threadIdx.x; j < BS; j += blockDim.x) sm.sw[j] = a.sw[j];
  if (threadIdx.x < 2) sm.tot[threadIdx.x] = 0;
  if (t < kModes) grp.sse[t] = 0u;
  if (t == 0) grp.eob = 0;
  __syncthreads();
  const int* meta = sm.meta;
  const int* fsh = meta + 32;
  // element v of thread t is (i, col[v]) of the column pass: the pixel at
  // row i, column col[v], which the thread also scores; after the row
  // pass, coefficient (col[v], i), flat index i * BS + col[v]
  const int i = t % BS, wr = sm.sw[i];
  int col[V], wc[V], scan_pos[V], dq[V], qsh[V];
  unsigned long long qmul[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    col[v] = t / BS + v * kStep;
    wc[v] = sm.sw[col[v]];
    const int f = i * BS + col[v], q = f == 0 ? 0 : 1;
    scan_pos[v] = sm.iscan[f] + 1;
    dq[v] = q ? a.ac_q : a.dc_q;
    qmul[v] = a.mul[q];
    qsh[v] = a.sh[q];
  }
  long long tot_sse = 0, tot_eob = 0;

  for (long long first = (long long)blockIdx.x * G; first < B;
       first += (long long)gridDim.x * G) {
    const long long b = first + gi;
    const bool valid = b < B;
    if (valid) {  // coalesced: pixel p = t + v * NT at (p / BS, p % BS)
      if (a.plane) {
        const int cols = a.W / BS;
        const long long by = b / cols, bx = b % cols;
        const int* o = a.plane + (by * BS * a.W + bx * BS);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int p = t + v * NT;
          grp.src[p / BS][p % BS] = o[(long long)(p / BS) * a.W + p % BS];
        }
        if (t < BS) {
          grp.ab[t] = by ? o[t - a.W] : 127;
          grp.lf[t] = bx ? o[(long long)t * a.W - 1] : 129;
        }
        if (t == 0) grp.corner = (by && bx) ? o[-a.W - 1] : 128;
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int p = t + v * NT;
          grp.src[p / BS][p % BS] = a.blocks[b * N + p];
        }
        if (t < BS) {
          grp.ab[t] = a.above[b * BS + t];
          grp.lf[t] = a.left[b * BS + t];
        }
        if (t == 0) grp.corner = a.corner[b];
      }
    }
    kp_sync<BS>();  // 1: the block and its edges

    // DC: each warp sums the 2n edge samples itself
    int e = 0;
    for (int k = t % S; k < 2 * BS; k += S)
      e = add32(e, k < BS ? grp.ab[k] : grp.lf[k - BS]);
    e = seg_reduce<S>(e, [](int u, int w) { return add32(u, w); });
    const int dc = floordiv(add32(e, BS), 2 * BS);

    // the 7 predictions and SSEs (wrapping int32, as jnp's), the SSEs
    // reduced together
    const int l = grp.lf[i], below = grp.lf[BS - 1], right = grp.ab[BS - 1];
    const int cr = grp.corner;
    int pred[V][kModes], px[V];
    unsigned part[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) part[m] = 0u;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      predict7(grp.ab[col[v]], l, below, right, cr, dc, wr, wc[v], pred[v]);
      px[v] = grp.src[i][col[v]];
#pragma unroll
      for (int m = 0; m < kModes; ++m) {
        const unsigned d = (unsigned)(pred[v][m] - px[v]);
        part[m] += d * d;
      }
    }
    const unsigned s = reduce8<S>(part, lane);
    const int mode = kp_mode<S>(lane);
    if ((lane & (S / 8 - 1)) == 0 && mode < kModes) {
      if (NT > 32)
        atomicAdd(&grp.sse[mode], s);
      else
        grp.sse[mode] = s;
    }
    kp_sync<BS>();  // 2: the seven sums
    int best = 0, best_sse = (int)grp.sse[0];
#pragma unroll
    for (int m = 1; m < kModes; ++m) {
      const int w = (int)grp.sse[m];
      if (w < best_sse) {
        best = m;
        best_sse = w;
      }
    }

    // residual -> forward DCT_DCT: the column pass, a transpose, the row
    // pass
    int x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int pr = pred[v][0];
#pragma unroll
      for (int m = 1; m < kModes; ++m) pr = best == m ? pred[v][m] : pr;
      x[v] = round_shift_arr(px[v] - pr, -fsh[0]);
    }
    fdct_pass<BS, V>(x, sm.st, meta, 0);
#pragma unroll
    for (int v = 0; v < V; ++v)
      grp.tr[i][col[v]] = round_shift_arr(x[v], -fsh[1]);
    kp_sync<BS>();  // 3: the transpose (every read of the sums is done)
    if (NT > 32 && t < kModes) grp.sse[t] = 0u;
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = grp.tr[col[v]][i];
    fdct_pass<BS, V>(x, sm.st, meta, 2);

    // quantize_fp, the eob over the scan, the levels in coefficient order
    int eob = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int lv = quantize_fp(round_shift_arr(x[v], -fsh[2]), dq[v],
                                 a.shift, qmul[v], qsh[v]);
      grp.lv[i][col[v]] = lv;
      if (lv != 0 && scan_pos[v] > eob) eob = scan_pos[v];
    }
    eob = seg_reduce<S>(eob, [](int u, int w) { return u > w ? u : w; });
    if (NT > 32 && lane == 0) atomicMax(&grp.eob, eob);
    kp_sync<BS>();  // 4: the levels in coefficient order, the eob
    if (valid) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int p = t + v * NT;
        a.levels[b * N + p] = grp.lv[p / BS][p % BS];
      }
    }
    if (t == 0) {
      if (NT > 32) {
        eob = grp.eob;
        grp.eob = 0;  // its next atomicMax follows the next barrier 3
      }
      if (valid) {
        a.mode[b] = best;
        a.sse[b] = best_sse;
        a.eob[b] = eob;
        tot_sse += best_sse;
        tot_eob += eob;
      }
    }
  }
  if (a.totals) {
    if (t == 0) {
      atomicAdd(&sm.tot[0], (unsigned long long)tot_sse);
      atomicAdd(&sm.tot[1], (unsigned long long)tot_eob);
    }
    __syncthreads();
    if (threadIdx.x < 2) atomicAdd(a.totals + threadIdx.x,
                                   sm.tot[threadIdx.x]);
  }
}

// The persistent grid: as many CTAs as fit on the card at once, at most
// one per G blocks (cached per device and block size).
template <int BS>
int kp_launch(const KPArgs& a, int B, cudaStream_t st) {
  static int fit[16] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  if (!fit[dev]) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kp_kernel<BS>, KPShape<BS>::T, 0);
    if (e != cudaSuccess) return (int)e;
    fit[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = ((long long)B + KPShape<BS>::G - 1) /
                         KPShape<BS>::G;
  const int grid = need < fit[dev] ? (int)need : fit[dev];
  kp_kernel<BS><<<grid, KPShape<BS>::T, 0, st>>>(a, B);
  return (int)cudaGetLastError();
}

}  // namespace

// plane (H, W) int32 with blocks == null, or blocks (B, n, n), above,
// left (B, n) and corner (B,) int32 with plane == null (then totals (2,)
// int64, zeroed by the caller, receives the sums of sse and eob).
AV1_EXPORT int analyze_blocks(const int* plane, int W, const int* blocks,
                              const int* above, const int* left,
                              const int* corner, int B, int n, const int* sw,
                              int dc_q, int ac_q, int shift, const int* scan,
                              const int* stages, const int* meta, int* mode,
                              int* sse, int* levels, int* eob,
                              long long* totals, void* stream) {
  if (B <= 0 || (plane == nullptr) == (blocks == nullptr) || dc_q <= 0 ||
      ac_q <= 0)
    return (int)cudaErrorInvalidValue;
  KPArgs a{plane, W,     blocks, above,  left,   corner, sw,
           dc_q,  ac_q,  shift,  scan,   stages, meta,   mode,
           sse,   levels, eob,   (unsigned long long*)totals};
  div_magic(dc_q, &a.mul[0], &a.sh[0]);
  div_magic(ac_q, &a.mul[1], &a.sh[1]);
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 4: return kp_launch<4>(a, B, st);
    case 8: return kp_launch<8>(a, B, st);
    case 16: return kp_launch<16>(a, B, st);
    case 32: return kp_launch<32>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
