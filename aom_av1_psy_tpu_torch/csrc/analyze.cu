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
// 3.35 TB/s, and does ~10^8 integer operations; the transform's chain of
// dependent stages makes a CTA latency-bound. Design: one CTA per block,
// one thread per element (a full warp for 4x4, so the warp-shuffle
// reductions see 32 lanes); the block and its edges live in shared memory;
// each thread scores the 7 modes on its pixel and the 7 SSEs are block
// reductions; the forward transform runs on KB's register pass (txfm.cuh:
// each 1-D vector in BS lanes, a stage is two shuffles, one transpose
// through shared memory between the column and the row pass).
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
};

constexpr int kModes = 7;

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Prediction of BATCH_MODES[m] at (r, c) (analyze.py:72-107).
__device__ __forceinline__ int predict(int m, int r, int c, int n,
                                       const int* ab, const int* lf, int cr,
                                       int dc, const int* sw) {
  const int a = ab[c], l = lf[r];
  const int below = lf[n - 1], right = ab[n - 1];
  switch (m) {
    case 0: return dc;
    case 1: return a;
    case 2: return l;
    case 3:
      return (sw[r] * a + (256 - sw[r]) * below + sw[c] * l +
              (256 - sw[c]) * right + 256) >> 9;
    case 4: return (sw[r] * a + (256 - sw[r]) * below + 128) >> 8;
    case 5: return (sw[c] * l + (256 - sw[c]) * right + 128) >> 8;
    default: {
      const int base = l + a - cr;
      const int pl = abs(base - l), pt = abs(base - a), ptl = abs(base - cr);
      if (pl <= pt && pl <= ptl) return l;
      return pt <= ptl ? a : cr;
    }
  }
}

// quantize_fp (analyze.py:110-116) of one coefficient, jnp's int32.
__device__ __forceinline__ int quantize_fp(int x, int dq, int shift) {
  const int ax = x < 0 ? sub32(0, x) : x;
  const int scaled = (int)((unsigned)ax << shift);
  const int lv = floordiv(add32(scaled, dq >> 1), dq);
  return mul32((x > 0) - (x < 0), lv);
}

template <int BS>
struct KPSmem {
  static constexpr int N = BS * BS;
  static constexpr int NT = N < 32 ? 32 : N;
  int4 st[stage_rows<BS>()];
  int meta[kMetaLen];
  int iscan[N];
  int src[N];
  int tr[BS][BS + 1];
  int ab[BS], lf[BS], sw[BS];
  int corner, dc;
  unsigned int red[32];
  int red_i[32];
};

template <int BS>
__global__ void __launch_bounds__(KPSmem<BS>::NT) kp_kernel(KPArgs a) {
  constexpr int N = BS * BS, NT = KPSmem<BS>::NT;
  __shared__ KPSmem<BS> sm;
  const int b = blockIdx.x, t = threadIdx.x;
  load_stages<BS>(sm.st, sm.meta, sm.iscan, a.stages, a.meta, a.scan);

  if (a.plane) {
    const int cols = a.W / BS, by = b / cols, bx = b % cols;
    const int* o = a.plane + ((size_t)by * BS * a.W + (size_t)bx * BS);
    for (int p = t; p < N; p += NT)
      sm.src[p] = o[(size_t)(p / BS) * a.W + p % BS];
    for (int j = t; j < BS; j += NT) {
      sm.ab[j] = by ? o[j - a.W] : 127;
      sm.lf[j] = bx ? o[(long long)j * a.W - 1] : 129;
    }
    if (t == 0) sm.corner = (by && bx) ? o[-a.W - 1] : 128;
  } else {
    for (int p = t; p < N; p += NT)
      sm.src[p] = a.blocks[(size_t)b * N + p];
    for (int j = t; j < BS; j += NT) {
      sm.ab[j] = a.above[(size_t)b * BS + j];
      sm.lf[j] = a.left[(size_t)b * BS + j];
    }
    if (t == 0) sm.corner = a.corner[b];
  }
  for (int j = t; j < BS; j += NT) sm.sw[j] = a.sw[j];
  __syncthreads();
  if (t == 0) {
    int s = BS;
    for (int j = 0; j < BS; ++j) s = add32(add32(s, sm.ab[j]), sm.lf[j]);
    sm.dc = floordiv(s, 2 * BS);
  }
  __syncthreads();
  const int cr = sm.corner, dc = sm.dc;

  // the 7 SSEs (wrapping int32, as jnp's) and the first-index argmin
  unsigned int part[kModes];
#pragma unroll
  for (int m = 0; m < kModes; ++m) part[m] = 0u;
  for (int p = t; p < N; p += NT) {
    const int r = p / BS, c = p % BS;
#pragma unroll
    for (int m = 0; m < kModes; ++m) {
      const unsigned int d = (unsigned int)(
          predict(m, r, c, BS, sm.ab, sm.lf, cr, dc, sm.sw) - sm.src[p]);
      part[m] += d * d;
    }
  }
  int best = 0, best_sse = 0;
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    const int s = (int)block_sum<unsigned int>(part[m], sm.red);
    if (m == 0 || s < best_sse) { best = m; best_sse = s; }
  }

  // residual -> forward DCT_DCT on the register pass: thread t < N holds
  // element (r, c) = (i, g) for the column pass, (g, i) for the row pass
  // (the threads past N of a 4x4 block's warp run the pass on zeros)
  const bool own = t < N;
  const int g = t / BS, i = t % BS;
  const int* meta = sm.meta;
  const int* fsh = meta + 32;
  int x = 0;
  if (own) {
    const int pr = predict(best, i, g, BS, sm.ab, sm.lf, cr, dc, sm.sw);
    x = round_shift_arr(sm.src[i * BS + g] - pr, -fsh[0]);
  }
  x = tx_pass<BS>(x, sm.st, meta, 0, pass_stages(meta, 0, false));
  if (own) sm.tr[i][g] = round_shift_arr(x, -fsh[1]);
  __syncthreads();
  x = tx_pass<BS>(own ? sm.tr[g][i] : 0, sm.st, meta, 2,
                  pass_stages(meta, 2, false));

  // quantize_fp: coefficient (g, i) has flat index i * BS + g
  const int f = i * BS + g;
  int e_loc = 0;
  if (own) {
    const int lv = quantize_fp(round_shift_arr(x, -fsh[2]),
                               f == 0 ? a.dc_q : a.ac_q, a.shift);
    a.levels[(size_t)b * N + f] = lv;
    if (lv != 0) e_loc = sm.iscan[f] + 1;
  }
  const int eob = block_max<int>(e_loc, sm.red_i);
  if (t == 0) {
    a.mode[b] = best;
    a.sse[b] = best_sse;
    a.eob[b] = eob;
    if (a.totals) {
      atomicAdd(a.totals, (unsigned long long)(long long)best_sse);
      atomicAdd(a.totals + 1, (unsigned long long)(long long)eob);
    }
  }
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 4: kp_kernel<4><<<B, KPSmem<4>::NT, 0, st>>>(a); break;
    case 8: kp_kernel<8><<<B, KPSmem<8>::NT, 0, st>>>(a); break;
    case 16: kp_kernel<16><<<B, KPSmem<16>::NT, 0, st>>>(a); break;
    case 32: kp_kernel<32><<<B, KPSmem<32>::NT, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
