// The strip engine of the exhaustive full-pel searches: KJ (csrc/mvsearch.cu,
// SAD) and KE (csrc/fullpel.cu, SSD) score every offset of an m x m grid for
// a block staged in shared memory beside its window, and keep the first
// (dy-major) offset of least score.
//
// - A thread owns a strip of kR = 12 horizontally adjacent offsets of one
//   offset row and a row group g of G: block rows g, g + G, ...; for each
//   block row it reads each block value once (the same address across the
//   strips of a warp) and updates kR running sums in registers. A row of m
//   offsets is S = ceil(m / kR) strips; the last strip's phantom offsets are
//   computed and never compared.
// - 8-bit samples go four to a word where every staged value lies in 0..255
//   (the kernel checks what its CTA staged, with __syncthreads_and): the
//   window words of the 12 offsets of 4 columns come from 4 words by byte
//   permutes, and one word scores four pixels of one offset. SAD: vabsdiff4
//   with accumulate. SSD: __vabsdiffu4, then __dp4a(d, d, acc), exact since
//   a square is at most 255^2 and a 16x16 SSD below 2^24. Otherwise (a value
//   past 255, a width not a multiple of 4, a candidate stride above 1) the
//   same strips run on 32-bit values; the result is the same either way.
// - The G row groups of a strip sit in adjacent lanes and add their partial
//   sums with xor shuffles before any compare.
// - Ties: a thread scores its strips in increasing flat index and keeps the
//   first strict `<`; better() takes the lowest index across lanes and
//   warps.
// - Row strides: the window's 1 mod 32 (values) and 9 mod 32 (words), the
//   block's odd, so that the lanes of a warp (G row groups of 32 / G strips)
//   read distinct banks or the same word.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace strips {

constexpr int kR = 12;  // offsets per strip, a multiple of 4

__device__ __forceinline__ bool better(int s, int i, int bs, int bi) {
  return s < bs || (s == bs && i < bi);
}

// d = c + |a0 - b0| + |a1 - b1| + |a2 - b2| + |a3 - b3| over the bytes
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

// The metrics: `word` adds four 8-bit pixels of one offset, `value` one
// 32-bit pixel. Sums are unsigned and wrap; callers compare them as int.
struct Sad {
  static __device__ __forceinline__ unsigned word(unsigned w, unsigned q,
                                                  unsigned acc) {
    return sad4(w, q, acc);
  }
  static __device__ __forceinline__ unsigned value(int w, int q,
                                                   unsigned acc) {
    return __sad(w, q, acc);
  }
};

struct Ssd {
  static __device__ __forceinline__ unsigned word(unsigned w, unsigned q,
                                                  unsigned acc) {
    const unsigned d = __vabsdiffu4(w, q);
    return __dp4a(d, d, acc);
  }
  static __device__ __forceinline__ unsigned value(int w, int q,
                                                   unsigned acc) {
    const unsigned d = (unsigned)w - (unsigned)q;
    return acc + d * d;
  }
};

// The launch shape of a search: block (h, w), m x m offsets `stride` apart,
// S strips per offset row, G row groups, and the shared-memory row strides
// (sw, bs values; swp, bsp words, 0 where the search runs on 32-bit values
// only).
struct Shape {
  int h, w, m, stride, G;
  int S, sw, bs, swp, bsp;
};

// Fills S and the strides of `p` for a (wh, ww) window; returns the int32
// words of shared memory one block's operands take.
inline int plan(Shape& p, int wh, int ww) {
  p.S = (p.m + kR - 1) / kR;
  // every strip's reads stay in the row: the last strip's last offset is
  // S * kR - 1, read up to w - 1 values past it
  const int need = ww > p.S * kR * p.stride + p.w ? ww
                                                  : p.S * kR * p.stride + p.w;
  p.sw = need + (33 - need % 32) % 32;  // 1 mod 32
  p.bs = p.w | 1;                       // odd
  p.swp = p.bsp = 0;
  if (p.stride == 1 && p.w % 4 == 0) {
    // the last strip reads 3 words past the block's width; 9 mod 32
    const int words = (p.S * kR + p.w) / 4 + 1;
    p.swp = words + (41 - words % 32) % 32;
    p.bsp = (p.w / 4) | 1;
  }
  return wh * p.sw + p.h * p.bs + wh * p.swp + p.h * p.bsp;
}

// One block's operands in shared memory, laid out as `plan` counts them.
struct Smem {
  int* win;        // (wh, sw), zero past ww where a strip reads
  int* blk;        // (h, bs)
  unsigned* pwin;  // (wh, swp)
  unsigned* pblk;  // (h, bsp)
  __device__ Smem(int* base, const Shape& p, int wh)
      : win(base),
        blk(base + wh * p.sw),
        pwin((unsigned*)(blk + p.h * p.bs)),
        pblk(pwin + wh * p.swp) {}
};

// kR running sums of one block row on 8-bit samples four to a word: wr is
// the window row at the strip's first offset (a multiple of 4), q the block
// row, nq = w / 4 words. W[] holds the 16 window bytes that the 12 offsets
// of 4 columns read.
template <class M>
__device__ __forceinline__ void strip_row_packed(const unsigned* wr,
                                                 const unsigned* q, int nq,
                                                 unsigned (&s)[kR]) {
  unsigned W[4];
  W[0] = wr[0];
  W[1] = wr[1];
  W[2] = wr[2];
  for (int k = 0; k < nq; ++k) {
    W[3] = wr[k + 3];
    const unsigned qv = q[k];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = r >> 2, sh = r & 3;
      const unsigned x =
          sh ? __byte_perm(W[i], W[i + 1], 0x3210 + sh * 0x1111) : W[i];
      s[r] = M::word(x, qv, s[r]);
    }
    W[0] = W[1];
    W[1] = W[2];
    W[2] = W[3];
  }
}

// kR running sums of one block row on 32-bit values: wr is the window row
// at the strip's first offset, q the block row; the strip's offsets are
// `stride` apart.
template <class M>
__device__ __forceinline__ void strip_row_strided(const int* wr, const int* q,
                                                  int w, int stride,
                                                  unsigned (&s)[kR]) {
  for (int j = 0; j < w; ++j) {
    const int qv = q[j];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = M::value(wr[r * stride + j], qv, s[r]);
  }
}

// This thread's best (score, flat offset index) over its items of the
// m * S * G (strip, row group) items, the row groups' partial sums added
// first; score(sum, o) gives offset o's score from its sum. Every thread of
// the CTA calls it, and all run the same trip count (blockDim.x is a
// multiple of 32 and of G), so the shuffles see full warps.
template <class M, class Score>
__device__ __forceinline__ void best_of_strips(const Shape& p, const Smem& v,
                                               bool packed, Score score,
                                               int& best, int& bi) {
  const int ns = p.m * p.S, items = ns * p.G;
  best = INT_MAX;
  bi = INT_MAX;
  for (int base = 0; base < items; base += blockDim.x) {
    const int it = base + threadIdx.x;
    const int strip = it / p.G, g = it - strip * p.G;
    const int ky = strip / p.S, ox0 = (strip - ky * p.S) * kR;
    unsigned s[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = 0;
    if (strip < ns && packed) {
      const unsigned* w0 = v.pwin + ky * p.swp + ox0 / 4;
      for (int i = g; i < p.h; i += p.G)
        strip_row_packed<M>(w0 + i * p.swp, v.pblk + i * p.bsp, p.w / 4, s);
    } else if (strip < ns) {
      const int* w0 = v.win + ky * p.stride * p.sw + ox0 * p.stride;
      for (int i = g; i < p.h; i += p.G)
        strip_row_strided<M>(w0 + i * p.sw, v.blk + i * p.bs, p.w, p.stride,
                             s);
    }
    for (int off = 1; off < p.G; off <<= 1) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    }
    if (strip < ns && g == 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (ox0 + r < p.m) {
          const int o = ky * p.m + ox0 + r;
          const int t = score(s[r], o);
          if (t < best) {  // offsets rise within a thread: keep the first
            best = t;
            bi = o;
          }
        }
      }
    }
  }
}

// The CTA's argmin under better() of (best, bi), in thread 0. Every thread
// calls it (a barrier); rs / ri hold one slot per warp.
__device__ __forceinline__ void argmin_cta(int& best, int& bi, int* rs,
                                           int* ri) {
  for (int off = 16; off > 0; off >>= 1) {
    const int s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(s, i, best, bi)) {
      best = s;
      bi = i;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    rs[warp] = best;
    ri[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k)
      if (better(rs[k], ri[k], best, bi)) {
        best = rs[k];
        bi = ri[k];
      }
}

}  // namespace strips
