// Kernel KL: subpel_predict.
//
// Replaces the jnp branch of the reference's normative subpel prediction,
// predict_subpel and the convolve_2d_sr / convolve_x_sr / convolve_y_sr /
// copy paths it dispatches to (aom_av1_psy_tpu/ops/convolve.py:64-136), for a
// batch of blocks that each carry their own phases: the 9 half- or
// quarter-pel neighbours of a motion search, or the mode candidates of one
// block, go out in one launch. The paths and their roundings are those of
// csrc/convolve.cuh.
//
// What bounds it: per output pixel at most 8 + 8 taps of 2 operations on
// int32 values; at the 1080p P-frame's 16x16 grid (B = 8160) that is ~70 M
// operations against ~17 MB of regions read and 8 MB written: bytes bound
// (about 8 us at 3.35 TB/s). The design moves each region once from device
// memory and keeps everything after a region row in registers:
// - A lane owns one output column of a block and walks the block's rows.
//   An item is nb blocks of width w <= 32 (gw lanes a block: w rounded up
//   to a power of two; nb = 32 / gw, fewer where their rows would pass
//   kSliceBudget) or one strip of up to 32 columns of a wider block, and
//   at most kChunk = 32 output rows of them (a taller block is several
//   items, each with its 7 rows of halo).
// - A warp takes one item. It stages the item's region rows into its own
//   slice of shared memory with 4-byte cp.async copies (nb blocks' rows as
//   one flat run each; a strip's rows with their 7 columns of halo) and
//   waits on __syncwarp: no CTA barrier. In a slice the blocks start ps
//   ints apart, ps = gw (mod 32), so the lanes of a warp read distinct
//   banks. (Two or three items a warp, each staged while the one before
//   is computed, took 0.0114 / 0.0136 ms at 16x16 against this design's
//   0.0101 on an H100 80GB HBM3 at 700 W: the slices cut the warps an SM
//   holds. CTAs of 8 warps gain ~2 % on 4.)
// - The four paths run one code: a block's phases select its taps and
//   roundings (block_path). A pass that a path skips takes the identity
//   (weight 1 at tap 3, no rounding), so the lanes of a warp run the same
//   instructions whatever the phases of its blocks. Region row r gives
//   H(r) = (sum kx[k] s[r][c + k] + hadd) >> hsh; output row o is
//   clip(((sum ky[k] H(o + k) + vadd) >> vsh) - vsub): the reference's
//   roundings in its order, in int32 arithmetic that wraps as jnp's does.
// - The last 8 x-pass outputs stay in a register ring (the row loop is
//   unrolled by 8, so the ring's indices are constants) and the y taps read
//   them from registers: no intermediate in shared memory and no division
//   per pixel. Any w, h in 2..128 runs (AV1's blocks up to 128x128 and the
//   2-wide chroma blocks of 4:2:0).
#include <limits.h>

#include "convolve.cuh"

namespace {

using av1conv::kFilterBits;
using av1conv::kRound0;

constexpr int kWarps = 8;                 // warps of a CTA, an item each
constexpr int kStrip = 32;                // columns of a strip (w > 32)
constexpr int kChunk = 32;                // output rows of an item at most
constexpr int kMaxDim = 128;              // AV1's largest block side
constexpr int kSliceBudget = 16 * 1024;   // bytes of a slice that bound nb

struct KLArgs {
  const int* regions;  // (B, h + 7, w + 7)
  long long B;
  int w, h, bd;
  int gw, lgw;         // lanes a block and their log2 (w <= 32)
  int nb;              // blocks an item (w <= 32)
  int ps;              // ints from one block of a slice to the next
  int strips;          // column strips a block (w > 32), else 0
  int chunks;          // row chunks a block
  int slice;           // ints of a warp's slice
  long long items;
  const int* sx;       // (B,) phases
  const int* sy;
  const int* tabx;     // (16, 8) x taps of width w
  const int* taby;     // (16, 8) y taps of height h
  int* out;            // (B, h, w)
};

// One block's taps and roundings: the path its phases select.
struct Path {
  int kx[8], ky[8];
  int hadd, hsh, vadd, vsh, vsub, lo, hi;
};

__device__ __forceinline__ void block_path(const KLArgs& a, long long b,
                                           Path& p) {
  const int px = a.sx[b] & 15, py = a.sy[b] & 15, bd = a.bd;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    p.kx[k] = px ? a.tabx[px * 8 + k] : k == 3;
    p.ky[k] = py ? a.taby[py * 8 + k] : k == 3;
  }
  const int round1 = 2 * kFilterBits - kRound0;
  const int ob = bd + 2 * kFilterBits - kRound0;
  // x pass: 2-D round2(acc + 2^(bd+6), 3); x only round2(acc, 3)
  p.hadd = px ? (py ? 1 << (bd + kFilterBits - 1) : 0) + (1 << (kRound0 - 1))
              : 0;
  p.hsh = px ? kRound0 : 0;
  if (py) {  // 2-D round2(acc + 2^ob, 11) - sub; y only round2(acc, 7)
    p.vadd = px ? (1 << ob) + (1 << (round1 - 1)) : 1 << (kFilterBits - 1);
    p.vsh = px ? round1 : kFilterBits;
    p.vsub = px ? (1 << (ob - round1)) + (1 << (ob - round1 - 1)) : 0;
  } else {   // x only round2(H, 4); copy H
    p.vadd = px ? 1 << (kFilterBits - kRound0 - 1) : 0;
    p.vsh = px ? kFilterBits - kRound0 : 0;
    p.vsub = 0;
  }
  p.lo = px || py ? 0 : INT_MIN;
  p.hi = px || py ? (1 << bd) - 1 : INT_MAX;
}

// An item: blocks b .. b + nblk - 1 (w <= 32) or the strip of block b at
// columns col0 .. col0 + cw - 1, output rows r0 .. r0 + rows - 1.
struct Item {
  long long b;
  int nblk, col0, cw, r0, rows;
};

template <bool kStrips>
__device__ __forceinline__ Item decode(const KLArgs& a, long long it) {
  Item t;
  const int per = kStrips ? a.strips * a.chunks : a.chunks;
  const long long u = it / per;
  const int rest = (int)(it - u * per), ch = rest % a.chunks;
  t.r0 = ch * kChunk;
  t.rows = min(kChunk, a.h - t.r0);
  if constexpr (kStrips) {
    t.b = u;
    t.nblk = 1;
    t.col0 = rest / a.chunks * kStrip;
    t.cw = min(kStrip, a.w - t.col0);
  } else {
    t.b = u * a.nb;
    t.nblk = (int)min((long long)a.nb, a.B - t.b);
    t.col0 = 0;
    t.cw = a.w;
  }
  return t;
}

// The item's region rows r0 .. r0 + rows + 6 into slice s (cp.async: they
// land at cp_async_wait_all).
template <bool kStrips>
__device__ __forceinline__ void stage(const KLArgs& a, const Item& t, int* s,
                                      int lane) {
  const int rw = a.w + 7, rsz = (a.h + 7) * rw;
  const int* src = a.regions + t.b * rsz + t.r0 * rw + t.col0;
  if constexpr (kStrips) {
    const int rs = t.cw + 7;
    for (int r = 0; r < t.rows + 7; ++r)
      for (int j = lane; j < rs; j += 32)
        cp_async4(s + r * rs + j, src + r * rw + j);
  } else {
    // nblk runs of L values, rsz apart in the regions and ps apart in the
    // slice; L >= 8 * 9 > 32, so a lane's step crosses one run end at most
    const int L = (t.rows + 7) * rw, n = t.nblk * L;
    const int* sp = src + lane;
    int* dp = s + lane;
    for (int e = lane, rem = lane; e < n; e += 32) {
      cp_async4(dp, sp);
      sp += 32;
      dp += 32;
      rem += 32;
      if (rem >= L) {
        rem -= L;
        sp += rsz - L;
        dp += a.ps - L;
      }
    }
  }
}

// The lane's column of the item: its block, slice offset and row stride.
struct Lane {
  long long b;
  int c, base, rs;
  bool live;  // the lane writes an output column
};

template <bool kStrips>
__device__ __forceinline__ Lane lane_of(const KLArgs& a, const Item& t,
                                        int lane) {
  Lane l;
  if constexpr (kStrips) {
    l.c = lane;
    l.live = lane < t.cw;
    l.b = t.b;
    l.base = 0;
    l.rs = t.cw + 7;
  } else {
    const int grp = lane >> a.lgw, g = grp < t.nblk ? grp : 0;
    l.c = lane & (a.gw - 1);
    l.live = grp < t.nblk && l.c < a.w;
    l.b = t.b + g;
    l.base = g * a.ps;
    l.rs = a.w + 7;
  }
  return l;
}

__device__ __forceinline__ void predict(const KLArgs& a, const Item& t,
                                        const Lane& l, const Path& p,
                                        const int* s) {
  const int w = a.w, rh = t.rows + 7, rs = l.rs;
  const int* q = s + l.base + min(l.c, t.cw - 1);
  int* o = a.out + (l.b * a.h + t.r0) * w + t.col0 + l.c;
  int ring[8];
  for (int r0 = 0; r0 < rh; r0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = r0 + j;
      if (r < rh) {
        unsigned acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc += (unsigned)p.kx[k] * (unsigned)q[r * rs + k];
        ring[j] = (int)(acc + (unsigned)p.hadd) >> p.hsh;
        if (r >= 7) {  // output row r - 7 from region rows r - 7 .. r
          unsigned v = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v += (unsigned)p.ky[k] * (unsigned)ring[(j + 1 + k) & 7];
          const int y = (int)((unsigned)((int)(v + (unsigned)p.vadd) >>
                                         p.vsh) - (unsigned)p.vsub);
          if (l.live) o[(r - 7) * w] = clampi(y, p.lo, p.hi);
        }
      }
    }
  }
}

template <bool kStrips>
__global__ void __launch_bounds__(kWarps * 32) kl_kernel(KLArgs a) {
  extern __shared__ int sm[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long it = (long long)blockIdx.x * kWarps + wid;
  if (it >= a.items) return;
  int* s = sm + wid * a.slice;
  const Item t = decode<kStrips>(a, it);
  stage<kStrips>(a, t, s, lane);
  const Lane l = lane_of<kStrips>(a, t, lane);
  Path p;
  block_path(a, l.b, p);  // its loads overlap the copies
  cp_async_wait_all();
  __syncwarp();
  predict(a, t, l, p, s);
}

}  // namespace

AV1_EXPORT int subpel_predict(const int* regions, int B, int w, int h,
                              const int* sx, const int* sy, const int* tabx,
                              const int* taby, int bd, int* out,
                              void* stream) {
  if (B <= 0) return 0;
  if (w < 2 || h < 2 || w > kMaxDim || h > kMaxDim || bd < 8 || bd > 12)
    return (int)cudaErrorInvalidValue;
  KLArgs a{regions, B, w, h, bd, 32, 5, 1, 0, 0, 0, 0, 0,
           sx, sy, tabx, taby, out};
  a.chunks = (h + kChunk - 1) / kChunk;
  const int rows = h < kChunk ? h : kChunk;
  if (w <= 32) {
    while (a.gw >> 1 >= w) {
      a.gw >>= 1;
      --a.lgw;
    }
    const int L = (rows + 7) * (w + 7);
    a.nb = 32 / a.gw;
    // the least ps >= L with ps = gw (mod 32); one block needs no pad
    a.ps = a.nb > 1 ? L + (((a.gw - L) % 32) + 32) % 32 : L;
    const int fit = kSliceBudget / (int)sizeof(int) / a.ps;
    if (a.nb > fit) a.nb = fit > 1 ? fit : 1;
    a.slice = a.nb * a.ps;
    a.items = ((long long)B + a.nb - 1) / a.nb * a.chunks;
  } else {
    a.strips = (w + kStrip - 1) / kStrip;
    a.slice = (rows + 7) * (kStrip + 7);
    a.items = (long long)B * a.strips * a.chunks;
  }
  void (*kern)(KLArgs) =
      a.strips ? kl_kernel<true> : kl_kernel<false>;
  const size_t smem = sizeof(int) * (size_t)kWarps * a.slice;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (a.items + kWarps - 1) / kWarps;
  kern<<<(unsigned)grid, kWarps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
