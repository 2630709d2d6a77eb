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
// 3.35 TB/s, and does ~10^8 integer operations; the transform's ~9
// barriers per pass make a CTA latency-bound. Design: one CTA per block
// (KB's thread counts: a full warp for 4x4, so the warp-shuffle reductions
// see 32 lanes); the block, its edges and the transform's two buffers live
// in shared memory; each thread scores the 7 modes on its pixels and the
// 7 SSEs are block reductions.
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
  const int* progs;   // stage programs (txfm.cuh)
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
  const int ax = x < 0 ? wrap32(-(long long)x) : x;
  const int scaled = wrap32((long long)ax * (1LL << shift));
  const int lv = floordiv(wrap32((long long)scaled + (dq >> 1)), dq);
  return wrap32((long long)((x > 0) - (x < 0)) * lv);
}

template <int BS>
__global__ void kp_kernel(KPArgs a) {
  constexpr int NT = threads<BS>();
  constexpr int N = BS * BS;
  __shared__ int src[N], buf0[N], buf1[N];
  __shared__ int ab[BS], lf[BS], sw[BS];
  __shared__ int s_corner, s_dc;
  __shared__ unsigned int red[32];
  __shared__ int red_i[32];
  const int b = blockIdx.x;

  if (a.plane) {
    const int cols = a.W / BS, by = b / cols, bx = b % cols;
    const int* o = a.plane + ((size_t)by * BS * a.W + (size_t)bx * BS);
    for (int p = threadIdx.x; p < N; p += NT)
      src[p] = o[(size_t)(p / BS) * a.W + p % BS];
    for (int j = threadIdx.x; j < BS; j += NT) {
      ab[j] = by ? o[j - a.W] : 127;
      lf[j] = bx ? o[(long long)j * a.W - 1] : 129;
    }
    if (threadIdx.x == 0) s_corner = (by && bx) ? o[-a.W - 1] : 128;
  } else {
    for (int p = threadIdx.x; p < N; p += NT)
      src[p] = a.blocks[(size_t)b * N + p];
    for (int j = threadIdx.x; j < BS; j += NT) {
      ab[j] = a.above[(size_t)b * BS + j];
      lf[j] = a.left[(size_t)b * BS + j];
    }
    if (threadIdx.x == 0) s_corner = a.corner[b];
  }
  for (int j = threadIdx.x; j < BS; j += NT) sw[j] = a.sw[j];
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = BS;
    for (int j = 0; j < BS; ++j) s = wrap32((long long)s + ab[j] + lf[j]);
    s_dc = floordiv(s, 2 * BS);
  }
  __syncthreads();
  const int cr = s_corner, dc = s_dc;

  // the 7 SSEs (wrapping int32, as jnp's) and the first-index argmin
  unsigned int part[kModes];
#pragma unroll
  for (int m = 0; m < kModes; ++m) part[m] = 0u;
  for (int p = threadIdx.x; p < N; p += NT) {
    const int r = p / BS, c = p % BS;
#pragma unroll
    for (int m = 0; m < kModes; ++m) {
      const unsigned int d =
          (unsigned int)(predict(m, r, c, BS, ab, lf, cr, dc, sw) - src[p]);
      part[m] += d * d;
    }
  }
  int best = 0, best_sse = 0;
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    const int s = (int)block_sum<unsigned int>(part[m], red);
    if (m == 0 || s < best_sse) { best = m; best_sse = s; }
  }

  // residual -> forward DCT_DCT: column pass along H, then row pass
  const int* fsh = a.meta + 32;
  for (int p = threadIdx.x; p < N; p += NT) {
    const int pr = predict(best, p / BS, p % BS, BS, ab, lf, cr, dc, sw);
    buf0[p] = round_shift_arr(src[p] - pr, -fsh[0]);
  }
  __syncthreads();
  int* X = pass<BS, NT>(buf0, buf1, a.progs, a.meta, 0);
  int* Y = X == buf0 ? buf1 : buf0;
  for (int p = threadIdx.x; p < N; p += NT)
    X[p] = round_shift_arr(X[p], -fsh[1]);
  __syncthreads();
  X = pass<BS, NT>(X, Y, a.progs, a.meta, 2);
  Y = X == buf0 ? buf1 : buf0;

  // quantize_fp: coefficient (r, c) has flat index c * BS + r
  for (int p = threadIdx.x; p < N; p += NT) {
    const int r = p / BS, c = p % BS, f = c * BS + r;
    const int x = round_shift_arr(X[p], -fsh[2]);
    Y[f] = quantize_fp(x, f == 0 ? a.dc_q : a.ac_q, a.shift);
  }
  __syncthreads();

  int e_loc = 0;
  for (int j = threadIdx.x; j < N; j += NT)
    if (Y[a.scan[j]] != 0) e_loc = j + 1;
  const int eob = block_max<int>(e_loc, red_i);
  for (int p = threadIdx.x; p < N; p += NT)
    a.levels[(size_t)b * N + p] = Y[p];
  if (threadIdx.x == 0) {
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
                              const int* progs, const int* meta, int* mode,
                              int* sse, int* levels, int* eob,
                              long long* totals, void* stream) {
  if (B <= 0 || (plane == nullptr) == (blocks == nullptr) || dc_q <= 0 ||
      ac_q <= 0)
    return (int)cudaErrorInvalidValue;
  KPArgs a{plane, W,     blocks, above,  left,  corner, sw,
           dc_q,  ac_q,  shift,  scan,   progs, meta,   mode,
           sse,   levels, eob,   (unsigned long long*)totals};
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 4: kp_kernel<4><<<B, threads<4>(), 0, st>>>(a); break;
    case 8: kp_kernel<8><<<B, threads<8>(), 0, st>>>(a); break;
    case 16: kp_kernel<16><<<B, threads<16>(), 0, st>>>(a); break;
    case 32: kp_kernel<32><<<B, threads<32>(), 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
