// Kernel KJ: fullpel_sad.
//
// Replaces the jnp branch of the reference's dense full-pel search,
// ops/mvsearch.py full_pel_grid_search / full_pel_hierarchical
// (aom_av1_psy_tpu/ops/mvsearch.py:48-134): the (B, n, n, h, w) candidate
// gather, |cand - src| summed over the block, the optional MV-cost grid,
// and the argmin over the flattened (dy-major) offsets. Ties go to the
// lowest flat index, as jnp.argmin's do: flat blocks tie on every offset.
//
// Two entries share one kernel body. `fullpel_sad` takes the caller's
// windows (B, wh, ww); `fullpel_sad_plane` reads each block's window where
// it lies in a plane, at the block's origin (oy, ox), so no window tensor
// is built (the temporal filter passes its frame padded with 128: nothing
// is clamped to a crop here, unlike KE in csrc/fullpel.cu). The candidate
// at grid point (ky, kx) is the window's (h, w) patch at (ky * stride,
// kx * stride): stride 1 is the dense scan, stride `step` the coarse level
// of full_pel_hierarchical.
//
// What bounds it: at 1080p the temporal filter scores 33 x 33 offsets of
// 1024 pixels for each of 1980 full blocks per reference frame, 2.2 G
// abs-diff-adds. A shared-memory read per operand (two 4-byte loads per
// pixel-SAD) would cap it at 16 pixel-SADs per clock per SM, so the design
// takes the operands from registers instead: one CTA per block, the window
// (zero past its width) and the block staged into shared memory with
// cp.async, and the offsets scored by the strip engine of csrc/strips.cuh
// (shared with KE): strips of 12 offsets in registers, four 8-bit samples
// to a word (one vabsdiff4 with accumulate per four pixel-SADs, about 0.5
// instructions per pixel-SAD) where the CTA finds every staged value in
// 0..255 and the candidate stride is 1, 32-bit strips otherwise; G = 2 row
// groups at 33 x 33 (198 of 224 threads busy, equal work each).
//
// Kernel KM: subpel_refine49.
//
// Replaces the jnp branch of the reference's batched_subpel_refine
// (aom_av1_psy_tpu/ops/mvsearch.py:195-223): the 49-point quarter-pel
// lattice around each block's full-pel winner, r8 = 8 + 2 * dr and
// c8 = 8 + 2 * dc for dr, dc in -3..3 (dr-major), each candidate predicted
// from the window's region at (r8 >> 3, c8 >> 3) with phases
// ((c8 & 7) << 1, (r8 & 7) << 1) through the facade path those phases
// select (the four paths of csrc/convolve.cuh, with KL's roundings), its
// SAD against the block, and the first-index argmin. Blocks of every
// w, h in 2..128 (AV1's, up to 128x128, the 2-wide chroma of 4:2:0, and
// sizes that are not powers of two).
//
// What bounds it: at the 1080p P-frame's 16x16 grid (B = 8160) the least
// work is one x pass per column phase (6 of them, over h + 8 window rows)
// and one 8-tap y pass or rounding per candidate output, with a
// 3-operation SAD: ~2.5 G integer operations (2 a tap and ~4 for the
// rounding and clip of each pass output) against ~30 MB of windows and
// blocks, operation bound (about 0.037 ms at 67 T/s). As built, the 42
// vertical passes' multiply-adds from registers are most of the
// instructions; 83 registers a thread at 16x16 leave 21 warps an SM.
//
// Design. The lattice has seven column positions (fc, sc) = (c8 >> 3,
// (c8 & 7) << 1), and so seven row positions. The x pass of column phase
// dc over window rows 0..h+7 serves all seven candidates of that column:
// the 2-D ones read rows fr..fr+h+6 of it (fr = r8 >> 3 in {0, 1}), and
// the x-only one (dr = 0) reads rows 4..3+h through the identity
// round2(acc, 3) == round2(acc + 2^(bd+6), 3) - 2^(bd+3) (2^(bd+6) is a
// multiple of 8), so its output clip(round2(round2(acc, 3), 4)) is
// clip(round2(im - 2^(bd+3), 4)). Column dc = 0 holds the raw window
// column 4 + c instead: the y-only candidates and the copy.
// A lane-task is (block, column phase, row chunk of R output rows, column
// c), R = h rounded up to a power of two, at most 16; a last chunk of
// fewer rows (h not a multiple of R) reads its window rows clamped to the
// block's and adds nothing for the rows past h. It keeps the R + 8 values
// of its column in registers,
// then scores the 7 candidates of its column phase, each a sliding 8-tap
// vertical pass over those registers (the rounding of the 2-D or the
// y-only path by the column) and the SAD against the block's column c,
// also held in registers. Lanes of consecutive columns sum each
// candidate's SAD with warp shuffles over a segment of min(gw, 32) lanes,
// gw = w rounded up to a power of two up to 32, or to a multiple of 32
// above (lanes of columns past w add zero, so the shuffle tree stays a
// power of two that divides the warp), and
// add it into the block's 49 sums in shared memory at the dr-major index
// (dr + 3) * 7 + (dc + 3); after the one barrier, a warp per block takes
// the first-index argmin. There is no CTA barrier between candidates:
// two per CTA, after staging and before the argmin. A CTA takes
// nb = max(1, 256 / tasks) blocks (2 at 16x16); their windows, blocks and
// both tap tables are staged in shared memory once (141.8 KB at 128x128,
// one block a CTA: dynamic shared memory above 48 KB). A CTA has at most
// 512 threads; its lane-tasks (7168 at 128x128) are taken 512 at a time.
#include <limits.h>

#include "convolve.cuh"
#include "strips.cuh"

namespace {

constexpr int kMaxThreads = 512;    // KJ
constexpr int kKmMaxThreads = 512;  // KM: threads per CTA at most
constexpr int kKmCtaTasks = 256;    // KM: lane-tasks a CTA aims at

struct KJArgs {
  const int* src;      // (B, h, w)
  const int* win;      // (B, wh, ww) windows, or the plane (H, W)
  const int* oy;       // (B,) window origins in the plane, or null
  const int* ox;
  int H, W;            // the plane (origins clamp to it)
  int wh, ww;
  strips::Shape p;     // block (h, w), m, stride; kj_launch fills the rest
  const int* cost;     // (m * m,) or null
  int* best_idx;
  int* best_sad;
};

// Whether this thread's share of the staged values (rows wid, wid + nw, ...
// of warp wid of nw, columns lane, lane + 32, ...) lies in 0..255 (the
// CTA then agrees with __syncthreads_and).
__device__ __forceinline__ int fits(const strips::Shape& p,
                                    const strips::Smem& v, int wh, int ww,
                                    int wid, int nw, int lane) {
  int ok = 1;
  for (int r = wid; r < wh; r += nw)
    for (int c = lane; c < ww; c += 32)
      ok &= (unsigned)v.win[r * p.sw + c] <= 255u;
  for (int r = wid; r < p.h; r += nw)
    for (int c = lane; c < p.w; c += 32)
      ok &= (unsigned)v.blk[r * p.bs + c] <= 255u;
  return ok;
}

// Packs the staged values four 8-bit samples to a word (the CTA found that
// they fit); a barrier must follow before the words are read.
__device__ __forceinline__ void pack(const strips::Shape& p,
                                     const strips::Smem& v, int wh, int ww,
                                     int wid, int nw, int lane) {
  for (int r = wid; r < wh; r += nw)
    for (int k = lane; k < p.swp; k += 32) {
      unsigned x = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * k + e;
        x |= (unsigned)(c < ww ? v.win[r * p.sw + c] : 0) << (8 * e);
      }
      v.pwin[r * p.swp + k] = x;
    }
  for (int r = wid; r < p.h; r += nw)
    for (int k = lane; k < p.w / 4; k += 32) {
      const int* x = v.blk + r * p.bs + 4 * k;
      v.pblk[r * p.bsp + k] = (unsigned)x[0] | (unsigned)x[1] << 8 |
                              (unsigned)x[2] << 16 | (unsigned)x[3] << 24;
    }
}

__global__ void __launch_bounds__(kMaxThreads, 2) kj_kernel(KJArgs a) {
  extern __shared__ int sm[];
  __shared__ int rs[kMaxThreads / 32], ri[kMaxThreads / 32];
  const strips::Shape& p = a.p;
  const strips::Smem v(sm, p, a.wh);
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int* gw;
  long long ld;
  if (a.oy) {
    const int y = clampi(a.oy[b], 0, a.H - a.wh);
    const int x = clampi(a.ox[b], 0, a.W - a.ww);
    gw = a.win + (long long)y * a.W + x;
    ld = a.W;
  } else {
    gw = a.win + b * a.wh * a.ww;
    ld = a.ww;
  }
  const int* gs = a.src + b * p.h * p.w;
  for (int r = warp; r < a.wh; r += nw)
    for (int c = lane; c < p.sw; c += 32) {
      if (c < a.ww)
        cp_async4(v.win + r * p.sw + c, gw + r * ld + c);
      else
        v.win[r * p.sw + c] = 0;
    }
  for (int r = warp; r < p.h; r += nw)
    for (int c = lane; c < p.w; c += 32)
      cp_async4(v.blk + r * p.bs + c, gs + r * p.w + c);
  cp_async_wait_all();
  __syncthreads();

  bool packed = false;
  if (p.swp) {
    packed = __syncthreads_and(fits(p, v, a.wh, a.ww, warp, nw,
                                            lane));
    if (packed) {
      pack(p, v, a.wh, a.ww, warp, nw, lane);
      __syncthreads();
    }
  }
  int best, bi;
  const int* cost = a.cost;
  strips::best_of_strips<strips::Sad>(
      p, v, packed,
      [cost](unsigned sad, int o) {
        return cost ? (int)sad + cost[o] : (int)sad;
      },
      best, bi);
  strips::argmin_cta(best, bi, rs, ri);
  if (threadIdx.x == 0) {
    a.best_idx[b] = bi;
    a.best_sad[b] = best;
  }
}

// Fills the launch shape of `a` (strips, row groups, strides) and launches.
int kj_launch(KJArgs a, int B, void* stream) {
  strips::Shape& p = a.p;
  if (B <= 0) return 0;
  if (p.h <= 0 || p.w <= 0 || p.m <= 0 || p.stride <= 0 ||
      a.wh < p.h + (p.m - 1) * p.stride || a.ww < p.w + (p.m - 1) * p.stride)
    return (int)cudaErrorInvalidValue;
  const int ns = p.m * ((p.m + strips::kR - 1) / strips::kR);
  p.G = ns * 2 <= kMaxThreads ? 2 : 1;
  const int items = ns * p.G;
  const int threads = items >= kMaxThreads ? kMaxThreads
                                           : (items + 31) / 32 * 32;
  const size_t smem = sizeof(int) * (size_t)strips::plan(p, a.wh, a.ww);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kj_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

AV1_EXPORT int fullpel_sad(const int* src, const int* win, int B, int h,
                           int w, int wh, int ww, int m, int stride,
                           const int* cost, int* best_idx, int* best_sad,
                           void* stream) {
  KJArgs a{src, win, nullptr, nullptr, 0, 0, wh, ww,
           {h, w, m, stride}, cost, best_idx, best_sad};
  return kj_launch(a, B, stream);
}

// The windows (h + m - 1, w + m - 1) of plane (H, W) at origins oy/ox
// (B,), read where they lie; origins clamp to the plane.
AV1_EXPORT int fullpel_sad_plane(const int* src, const int* plane, int H,
                                 int W, const int* oy, const int* ox, int B,
                                 int h, int w, int m, const int* cost,
                                 int* best_idx, int* best_sad,
                                 void* stream) {
  if (h + m - 1 > H || w + m - 1 > W) return (int)cudaErrorInvalidValue;
  KJArgs a{src, plane, oy, ox, H, W, h + m - 1, w + m - 1, {h, w, m, 1},
           cost, best_idx, best_sad};
  return kj_launch(a, B, stream);
}

namespace {

struct KMArgs {
  const int* src;   // (B, h, w)
  const int* win;   // (B, h + 9, w + 9)
  long long B;
  int w, h, bd;
  int nb;           // blocks per CTA
  int gw;           // lane columns per (block, phase, chunk): w padded
  int chunks;       // row chunks: ceil(h / R)
  int tasks;        // lane-tasks per block: 7 * chunks * gw
  const int* tabx;  // (16, 8) x taps of width w
  const int* taby;  // (16, 8) y taps of height h
  int* best_idx;
  int* best_sad;
};

// The 7 SADs (one per dr, dr-major) of the lane-task of column phase
// (fc, sc) at column c: `wc` is the window at (r0, c) (row stride ww),
// `sb` the block at (r0, c) (row stride w); rows r0..r0+nr-1 of the
// output (nr == R unless kRagged: then rows past nr are read clamped and
// score nothing).
template <int R, bool kRagged>
__device__ __forceinline__ void km_column(const int* wc, int ww,
                                          const int* sb, int w, int nr,
                                          int fc, int sc, const int* stab,
                                          int bd, int (&sad)[7]) {
  using av1conv::kFilterBits;
  using av1conv::kRound0;
  const int maxv = (1 << bd) - 1;
  int v[R + 8];
  if (sc) {  // the x pass of the 2-D path, over R + 8 window rows
    int kx[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) kx[k] = stab[sc * 8 + k];
    const int off = (1 << (bd + kFilterBits - 1)) + (1 << (kRound0 - 1));
    const int* p = wc + fc;
#pragma unroll
    for (int q = 0; q < R + 8; ++q) {
      const int* pq = p + (kRagged && q > nr + 7 ? nr + 7 : q) * ww;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kx[k] * pq[k];
      v[q] = (acc + off) >> kRound0;
    }
  } else {  // dc = 0: the raw column 4 + c
#pragma unroll
    for (int q = 0; q < R + 8; ++q)
      v[q] = wc[(kRagged && q > nr + 7 ? nr + 7 : q) * ww + 4];
  }
  int s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = sb[(kRagged && r >= nr ? 0 : r) * w];
  // dr != 0: round2(acc + 2^ob, 11) - sub (2-D) or round2(acc, 7) (y only)
  const int round1 = 2 * kFilterBits - kRound0;
  const int ob = bd + 2 * kFilterBits - kRound0;
  const int yadd = sc ? (1 << ob) + (1 << (round1 - 1))
                      : 1 << (kFilterBits - 1);
  const int ysh = sc ? round1 : kFilterBits;
  const int ysub = sc ? (1 << (ob - round1)) + (1 << (ob - round1 - 1)) : 0;
  // dr = 0: round2(im - 2^(bd+3), 4) (x only) or the raw value (copy)
  const int xsh = sc ? kFilterBits - kRound0 : 0;
  const int xadd = sc ? (1 << (xsh - 1)) - (1 << (bd + kFilterBits - 1 -
                                                   kRound0))
                      : 0;
  const int lo = sc ? 0 : INT_MIN, hi = sc ? maxv : INT_MAX;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const int r8 = 2 + 2 * i, fr = r8 >> 3, sr = (r8 & 7) << 1;
    int t = 0;
    if (sr) {
      int ky[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) ky[k] = stab[128 + sr * 8 + k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += ky[k] * v[fr + r + k];
        const int d =
            abs(clampi(((acc + yadd) >> ysh) - ysub, 0, maxv) - s[r]);
        t += kRagged && r >= nr ? 0 : d;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d = abs(clampi((v[4 + r] + xadd) >> xsh, lo, hi) - s[r]);
        t += kRagged && r >= nr ? 0 : d;
      }
    }
    sad[i] = t;
  }
}

template <int R, bool kRagged>
__global__ void __launch_bounds__(kKmMaxThreads) km_kernel(KMArgs a) {
  extern __shared__ int sm[];
  const int w = a.w, h = a.h, ww = w + 9, wsz = (h + 9) * ww, bsz = h * w;
  int* stab = sm;                  // 256: x taps, then y taps
  int* sads = stab + 256;          // (nb, 49), dr-major
  int* swin = sads + a.nb * 49;    // (nb, h + 9, w + 9)
  int* sblk = swin + a.nb * wsz;   // (nb, h, w)
  const long long b0 = (long long)blockIdx.x * a.nb;
  const int nblk = (int)(a.B - b0 < a.nb ? a.B - b0 : a.nb);
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    stab[i] = i < 128 ? a.tabx[i] : a.taby[i - 128];
  for (int i = threadIdx.x; i < nblk * 49; i += blockDim.x) sads[i] = 0;
  const int* gw = a.win + b0 * wsz;
  for (int i = threadIdx.x; i < nblk * wsz; i += blockDim.x) swin[i] = gw[i];
  const int* gs = a.src + b0 * bsz;
  for (int i = threadIdx.x; i < nblk * bsz; i += blockDim.x) sblk[i] = gs[i];
  __syncthreads();

  // lane-tasks, column fastest: (block, column phase j, row chunk, c);
  // a segment of seg lanes shares (block, j, chunk) (tasks and gw are
  // multiples of seg), so its lanes sum the same 7 candidates; lanes of
  // columns c >= w add zero, and a segment's first lane is a column < w
  const int pw = a.gw, seg = pw < 32 ? pw : 32, chunks = a.chunks;
  const int valid_tasks = nblk * a.tasks, all_tasks = a.nb * a.tasks;
  for (int base = 0; base < all_tasks; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const bool valid = t < valid_tasks;
    int sad[7] = {0, 0, 0, 0, 0, 0, 0};
    int blk = 0, j = 0;
    if (valid) {
      blk = t / a.tasks;
      const int u = t - blk * a.tasks, c = u % pw, q = u / pw;
      const int r0 = q % chunks * R;
      j = q / chunks;
      const int c8 = 2 + 2 * j;
      if (c < w)
        km_column<R, kRagged>(swin + blk * wsz + r0 * ww + c, ww,
                              sblk + blk * bsz + r0 * w + c, w,
                              h - r0 < R ? h - r0 : R, c8 >> 3,
                              (c8 & 7) << 1, stab, a.bd, sad);
    }
#pragma unroll
    for (int i = 0; i < 7; ++i)
      for (int o = seg >> 1; o > 0; o >>= 1)
        sad[i] += __shfl_xor_sync(0xffffffffu, sad[i], o);
    if (valid && (threadIdx.x & (seg - 1)) == 0) {
#pragma unroll
      for (int i = 0; i < 7; ++i) atomicAdd(sads + blk * 49 + i * 7 + j,
                                            sad[i]);
    }
  }
  __syncthreads();

  // a warp per block: the first-index argmin of the 49 sums
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < nblk; k += blockDim.x >> 5) {
    const int* s = sads + k * 49;
    int bs = s[lane], bi = lane;
    if (lane + 32 < 49 && s[lane + 32] < bs) {
      bs = s[lane + 32];
      bi = lane + 32;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (os < bs || (os == bs && oi < bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      a.best_idx[b0 + k] = bi;
      a.best_sad[b0 + k] = bs;
    }
  }
}

}  // namespace

AV1_EXPORT int subpel_refine49(const int* src, const int* win, int B, int w,
                               int h, const int* tabx, const int* taby,
                               int bd, int* best_idx, int* best_sad,
                               void* stream) {
  if (B <= 0) return 0;
  if (w < 2 || w > 128 || h < 2 || h > 128 || bd < 8 || bd > 12)
    return (int)cudaErrorInvalidValue;
  int R = 2, gw = 2;  // h and w rounded up to a power of two, R <= 16
  while (R < h && R < 16) R <<= 1;
  while (gw < w && gw < 32) gw <<= 1;
  if (w > 32) gw = (w + 31) / 32 * 32;
  const int chunks = (h + R - 1) / R;
  const bool ragged = chunks * R != h;
  const int tasks = 7 * chunks * gw;
  const int nb = tasks >= kKmCtaTasks ? 1 : kKmCtaTasks / tasks;
  int threads = (nb * tasks + 31) / 32 * 32;
  if (threads > kKmMaxThreads) threads = kKmMaxThreads;
  // 38.9 KB at 64x64, 72.3 KB at 128x64 and 64x128, 141.8 KB at 128x128
  // (one block a CTA)
  const size_t smem = sizeof(int) *
      (256 + (size_t)nb * (49 + (h + 9) * (w + 9) + h * w));
  KMArgs a{src, win, B, w, h, bd, nb, gw, chunks, tasks, tabx, taby,
           best_idx, best_sad};
  const int grid = (B + nb - 1) / nb;
  void (*kern)(KMArgs) =
      R == 2    ? km_kernel<2, false>
      : R == 4  ? (ragged ? km_kernel<4, true> : km_kernel<4, false>)
      : R == 8  ? (ragged ? km_kernel<8, true> : km_kernel<8, false>)
                : (ragged ? km_kernel<16, true> : km_kernel<16, false>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
