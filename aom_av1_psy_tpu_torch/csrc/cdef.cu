// Kernel KF: cdef_filter, one pass per frame.
//
// Replaces the reference's device CDEF apply, cdef_jax._filter_plane /
// cdef_apply_fused (aom_av1_psy_tpu/ops/cdef_jax.py:73-192, with
// _adjust_strength and _constrain at :35-60): frame-level strengths
// (cdef_bits = 0), 8-bit 4:2:0, 8x8 luma / 4x4 chroma blocks, skip-gated;
// and the host direction search the reference runs before it
// (aom_av1_psy_tpu/ops/cdef.py:34-67 find_dir_blocks, libaom's
// cdef_find_dir_c), which the reference keeps on the host only because its
// backend has no 64-bit integers.
//
// One CTA per tile of 8 x 8 blocks (luma 64 x 64 px, chroma 32 x 32 px;
// ops/cdef_torch.kf_tiles states the same layout for the CPU test). The
// CTA stages each plane's tile with its 2-px halo in shared memory
// (CDEF_VERY_LARGE outside the mi area, the reference's padding), then
// - with `search`, finds each block's direction and variance from the
//   staged luma once (every direction's 15 line sums, integer costs, the
//   first largest cost as numpy's argmax takes it) and writes them out;
//   otherwise reads them;
// - works out each block's primary strength once per plane (luma: adjusted
//   by the variance);
// - filters every plane from shared memory: the two primary and four
//   secondary taps of both rings, constrain, the min/max clip;
// - with a source, sums (before - src)^2 and (after - src)^2 over the mi
//   area per plane in int64: a CTA sum and one integer atomicAdd each, so
//   the result does not depend on the order.
// Every tap reads pre-CDEF pixels into new planes: the tiles have no order
// and no hazard between them. Pixels outside the mi area are copied.
//
// Costs are int64 built from int32 line sums and int32 products p * div:
// exact while |px - 128| * 8 * 840 < 2^31 (any sample below 2^18). The
// largest cost 8-bit samples give is 64 * 128^2 * 840 = 880,803,840 (a
// constant-0 block, where all eight directions tie), held by the extreme
// blocks of tests/cdef_cases.py.
//
// What bounds it: at 1080p the three int32 planes read and written (25 MB)
// and the sources (12.5 MB), ~0.011 ms at 3.35 TB/s; the 12 taps cost ~11
// integer operations each per filtered pixel, and the search ~2 operations
// per pixel and direction. Design: one launch for the frame (the direction
// search fused), 256 threads and at most 64 registers a thread, so 4 CTAs
// an SM hold a 1080p frame's 510 tiles in one wave. Planes are staged in
// 16-byte words, all of a thread's loads before its stores, and the
// source's lines are asked of the L2 while they are (the filter reads them
// last). The search spreads a tile's 64 blocks x 8 directions over the 8
// warps (a warp-uniform pair of directions, one block per lane, the line
// sums in registers at compile-time indices). The luma filter gives a warp
// whole blocks, so a block's direction, strength and skip are one value
// per warp (no divergence, no bank conflicts between its lanes' taps);
// a chroma thread takes one column of one block. floor(log2) is
// the integer bit length (the reference's float32 log2 mis-floors only at
// 8192 and 32768, hidden by the clip at 12; thresholds are below 64).
#include "common.cuh"

namespace {

constexpr int kVeryLarge = 0x4000;
constexpr int kThreads = 256;
// (dy, dx) tap offsets per direction, two rings (cdef_block.c:25-47,
// aom_av1_psy_tpu/ops/cdef.py DIRS)
__constant__ int kDirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};

}  // namespace

// ops/cdef_torch._KFPlane / _KFArgs mirror these, field for field.
struct KFPlane {
  const int* in;        // (H, W) pre-CDEF plane
  int* out;             // (H, W) new plane
  const int* src;       // (>= ph rows, src_stride) source, or null
  int H, W, src_stride;
  int ph, pw;           // the filtered (mi) area
  int bs;               // 8 (luma) | 4 (chroma)
  int pri, sec, damping;
  int adjust;           // luma: primary strength adjusted by the variance
};

struct KFArgs {
  KFPlane p[3];
  const bool* skip;     // (>= nb_r, skip_stride) per 8x8 block: all-skip
  int* dirs;            // (nb_r * nb_c,) raster: written with search
  int* var;             // (nb_r * nb_c,) the same; or null where no plane
                        // adjusts its strength
  unsigned long long* sums;  // (2, np) before / after, or null
  int np;               // planes
  int skip_stride;
  int nb_r, nb_c;       // blocks of the mi area
  int search;           // find dirs/var from p[0] (bs 8)
};

namespace {

template <int BS>
struct Tile {
  static constexpr int T = 8 * BS;      // pixels per side
  static constexpr int ROWS = T + 4;    // 2-px halo above and below
  static constexpr int PITCH = T + 8;   // column c holds x0 - 4 + c
  static constexpr int SIZE = ROWS * PITCH;
};
constexpr int kSmemInts = Tile<8>::SIZE + 2 * Tile<4>::SIZE;

__device__ __forceinline__ int adjust_strength(int strength, int var) {
  const int v6 = var >> 6;
  const int i = v6 >= 1 ? min(floor_log2(v6), 12) : 0;
  return var != 0 ? (strength * (4 + i) + 8) >> 4 : 0;
}

__device__ __forceinline__ int shift_of(int t, int damping) {
  return t > 0 ? max(damping - floor_log2(t), 0) : 0;
}

// sign(diff) * min(|diff|, c) with c = max(0, t - (|diff| >> shift)),
// written as the clamp of diff to [-c, c]
__device__ __forceinline__ int constrain(int diff, int t, int shift) {
  const int c = max(0, t - (abs(diff) >> shift));
  return min(max(diff, -c), c);
}

// Stage rows y0-2 .. y0+T+1 and columns x0-4 .. x0+T+3 of the plane (the
// mi area; kVeryLarge elsewhere): 16-byte words where the rows allow
// (W % 4 == 0 and an aligned plane: a word is then wholly inside or wholly
// outside the mi area, whose width is a multiple of 4), every load of a
// thread issued before its stores.
template <int BS>
__device__ void stage(const KFPlane& p, int ty, int tx, int* sm) {
  using TL = Tile<BS>;
  constexpr int Q = TL::PITCH / 4;                    // words per row
  constexpr int N = TL::ROWS * Q;
  constexpr int K = (N + kThreads - 1) / kThreads;
  const int y0 = ty * TL::T - 2, x0 = tx * TL::T - 4;
  if ((p.W & 3) == 0 && ((unsigned long long)p.in & 15) == 0) {
    int4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / Q, y = y0 + r, x = x0 + 4 * (i - r * Q);
      v[k] = make_int4(kVeryLarge, kVeryLarge, kVeryLarge, kVeryLarge);
      if (i < N && y >= 0 && y < p.ph && x >= 0 && x < p.pw)
        v[k] = __ldg(reinterpret_cast<const int4*>(
            p.in + (long long)y * p.W + x));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / Q;
      if (i < N)
        *reinterpret_cast<int4*>(sm + r * TL::PITCH + 4 * (i - r * Q)) = v[k];
    }
    return;
  }
  for (int i = threadIdx.x; i < TL::ROWS * TL::PITCH; i += kThreads) {
    const int r = i / TL::PITCH, c = i - r * TL::PITCH;
    const int y = y0 + r, x = x0 + c;
    sm[i] = (y >= 0 && y < p.ph && x >= 0 && x < p.pw)
                ? p.in[(long long)y * p.W + x] : kVeryLarge;
  }
}

// Ask the L2 for the tile's rows of the source (128-byte lines, inside
// the mi area) while the planes are staged: the filter reads them last.
template <int BS>
__device__ void prefetch_source(const KFPlane& p, int ty, int tx) {
  constexpr int T = Tile<BS>::T, LINES = T * 4 / 128;  // lines per row
  const int x0 = tx * T;
  for (int i = threadIdx.x; i < T * LINES; i += kThreads) {
    const int y = ty * T + i / LINES, x = x0 + (i % LINES) * 32;
    if (y < p.ph && x < p.pw)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          p.src + (long long)y * p.src_stride + x));
  }
}

// line index of pixel (i, j) on direction D (cdef_find_dir_c's partial[])
template <int D>
__device__ __forceinline__ constexpr int line(int i, int j) {
  return D == 0 ? i + j : D == 1 ? i + j / 2 : D == 2 ? i
       : D == 3 ? 3 + i - j / 2 : D == 4 ? 7 + i - j
       : D == 5 ? 3 - i / 2 + j : D == 6 ? j : i / 2 + j;
}

__device__ __forceinline__ constexpr int div_table(int n) {
  return n == 1 ? 840 : n == 2 ? 420 : n == 3 ? 280 : n == 4 ? 210
       : n == 5 ? 168 : n == 6 ? 140 : n == 7 ? 120 : 105;
}

template <int D>
__device__ __forceinline__ long long cost_of(const int (&p)[15]) {
  long long c = 0;
  auto add = [&c](int v, int div) { c += (long long)(v * div) * v; };
  if (D == 2 || D == 6) {
#pragma unroll
    for (int l = 0; l < 8; ++l) add(p[l], 105);
  } else if (D == 0 || D == 4) {
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      add(p[i], div_table(i + 1));
      add(p[14 - i], div_table(i + 1));
    }
    add(p[7], 105);
  } else {
#pragma unroll
    for (int l = 3; l < 8; ++l) add(p[l], 105);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      add(p[j], div_table(2 * j + 2));
      add(p[10 - j], div_table(2 * j + 2));
    }
  }
  return c;
}

// The costs of directions D0 and D0 + 1 of the block whose top-left pixel
// is at `blk` (a staged luma tile, rows PITCH apart, 16-byte aligned).
template <int D0>
__device__ void pair_costs(const int* blk, long long& c0, long long& c1) {
  int p0[15], p1[15];
#pragma unroll
  for (int l = 0; l < 15; ++l) p0[l] = p1[l] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int4 a = *reinterpret_cast<const int4*>(blk + i * Tile<8>::PITCH);
    const int4 b =
        *reinterpret_cast<const int4*>(blk + i * Tile<8>::PITCH + 4);
    const int x[8] = {a.x - 128, a.y - 128, a.z - 128, a.w - 128,
                      b.x - 128, b.y - 128, b.z - 128, b.w - 128};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p0[line<D0>(i, j)] += x[j];
      p1[line<D0 + 1>(i, j)] += x[j];
    }
  }
  c0 = cost_of<D0>(p0);
  c1 = cost_of<D0 + 1>(p1);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Filter this thread's pixels of one plane's tile, write them, and add
// their squared errors (before / after) against the source to s_sum[0..1].
// Luma: a warp takes whole blocks (8 of the tile's 64), a lane one column
// and the rows r and r + 4 of each, so a block's direction, strength and
// skip are one value per warp (no divergence, no bank conflict between the
// lanes' taps). Chroma: a thread takes one column of one block (4 rows).
template <int BS>
__device__ void filter_tile(const KFPlane& p, int ty, int tx, const int* sm,
                            const int* s_dir, const int* s_pri,
                            const bool* s_on, unsigned long long* s_sum) {
  using TL = Tile<BS>;
  constexpr int NB = BS == 8 ? 8 : 1;     // blocks per thread
  constexpr int RB = BS == 8 ? 2 : 4;     // rows per block and thread
  constexpr int RSTEP = BS == 8 ? 4 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long e0 = 0, e1 = 0;
  const int sec_shift = shift_of(p.sec, p.damping);
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    int b, c, r0;
    if (BS == 8) {
      b = warp + 8 * i;
      c = (b & 7) * 8 + (lane & 7);
      r0 = (b >> 3) * 8 + (lane >> 3);
    } else {
      c = lane;
      b = warp * 8 + c / 4;
      r0 = warp * 4;
    }
    const int x = tx * TL::T + c;
    const int pri = s_pri[b];
    const bool on = s_on[b] && (pri != 0 || p.sec != 0);
    const int d = p.pri != 0 ? s_dir[b] : 0;
    const int d2 = (d + 2) & 7, d6 = (d - 2) & 7;
    int op[2], os2[2], os6[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      op[k] = kDirs[d][k][0] * TL::PITCH + kDirs[d][k][1];
      os2[k] = kDirs[d2][k][0] * TL::PITCH + kDirs[d2][k][1];
      os6[k] = kDirs[d6][k][0] * TL::PITCH + kDirs[d6][k][1];
    }
    const int pri_shift = shift_of(pri, p.damping);
    const int tap0 = (pri & 1) ? 3 : 4, tap1 = (pri & 1) ? 3 : 2;
    int v[RB], x0[RB];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      const int r = r0 + rr * RSTEP, y = ty * TL::T + r;
      const bool inside = y < p.ph && x < p.pw;
      const int* px = sm + (r + 2) * TL::PITCH + c + 4;
      x0[rr] = inside ? *px
               : (y < p.H && x < p.W) ? __ldg(p.in + (long long)y * p.W + x)
                                      : 0;
      v[rr] = x0[rr];
      if (!on || !inside) continue;
      // the taps: primary (ring k, +/-), secondary (d+2 / d-2, +/-)
      int pt[2][2], st[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        pt[k][0] = px[op[k]];
        pt[k][1] = px[-op[k]];
        st[k][0] = px[os2[k]];
        st[k][1] = px[os6[k]];
        st[k][2] = px[-os2[k]];
        st[k][3] = px[-os6[k]];
      }
      int total = 0;
      if (pri != 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            total += (k ? tap1 : tap0) *
                     constrain(pt[k][s] - x0[rr], pri, pri_shift);
      }
      if (p.sec != 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            total += (k ? 1 : 2) * constrain(st[k][s] - x0[rr], p.sec,
                                             sec_shift);
      }
      v[rr] = x0[rr] + ((8 + total - (total < 0)) >> 4);
      if (pri != 0 && p.sec != 0) {
        int mx = x0[rr], mn = x0[rr];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (pt[k][s] != kVeryLarge) mx = max(pt[k][s], mx);
            mn = min(pt[k][s], mn);
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            if (st[k][s] != kVeryLarge) mx = max(st[k][s], mx);
            mn = min(st[k][s], mn);
          }
        }
        v[rr] = clampi(v[rr], mn, mx);
      }
    }
    if (x >= p.W) continue;
    const int y0 = ty * TL::T + r0;
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      const int y = y0 + rr * RSTEP;
      if (y < p.H) p.out[(long long)y * p.W + x] = v[rr];
    }
    if (p.src && x < p.pw) {
      int sv[RB];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int y = y0 + rr * RSTEP;
        sv[rr] = y < p.ph ? __ldg(p.src + (long long)y * p.src_stride + x)
                          : 0;
      }
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        if (y0 + rr * RSTEP >= p.ph) continue;
        e0 += (long long)(x0[rr] - sv[rr]) * (x0[rr] - sv[rr]);
        e1 += (long long)(v[rr] - sv[rr]) * (v[rr] - sv[rr]);
      }
    }
  }
  if (p.src) {
    e0 = warp_sum(e0);
    e1 = warp_sum(e1);
    if (lane == 0) {
      atomicAdd(s_sum, (unsigned long long)e0);
      atomicAdd(s_sum + 1, (unsigned long long)e1);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4) kf_tile_kernel(KFArgs a) {
  __shared__ __align__(16) int sm[kSmemInts];
  __shared__ long long s_cost[8][64];
  __shared__ int s_dir[64], s_pri[3][64];
  __shared__ bool s_on[64];
  __shared__ unsigned long long s_sum[3][2];
  const int ty = blockIdx.y, tx = blockIdx.x, t = threadIdx.x;
  if (t < 6) s_sum[t >> 1][t & 1] = 0;
  int base[3];
#pragma unroll
  for (int j = 0, off = 0; j < 3; ++j) {
    base[j] = off;
    if (j < a.np) off += a.p[j].bs == 8 ? Tile<8>::SIZE : Tile<4>::SIZE;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j >= a.np) break;
    if (a.p[j].bs == 8)
      stage<8>(a.p[j], ty, tx, sm + base[j]);
    else
      stage<4>(a.p[j], ty, tx, sm + base[j]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j >= a.np || !a.p[j].src) continue;
    if (a.p[j].bs == 8)
      prefetch_source<8>(a.p[j], ty, tx);
    else
      prefetch_source<4>(a.p[j], ty, tx);
  }
  // the tile's blocks: b = 8 * row + column
  const int gbr0 = ty * 8, gbc0 = tx * 8;
  if (a.search) {
    __syncthreads();
    const int w = t >> 5, b = (w & 1) * 32 + (t & 31);
    const int br = b >> 3, bc = b & 7;
    if (gbr0 + br < a.nb_r && gbc0 + bc < a.nb_c) {
      const int* blk = sm + base[0] + (br * 8 + 2) * Tile<8>::PITCH + bc * 8
                       + 4;
      long long c0, c1;
      switch (w >> 1) {
        case 0: pair_costs<0>(blk, c0, c1); break;
        case 1: pair_costs<2>(blk, c0, c1); break;
        case 2: pair_costs<4>(blk, c0, c1); break;
        default: pair_costs<6>(blk, c0, c1); break;
      }
      s_cost[2 * (w >> 1)][b] = c0;
      s_cost[2 * (w >> 1) + 1][b] = c1;
    }
  }
  __syncthreads();
  if (t < 64) {
    const int gr = gbr0 + (t >> 3), gc = gbc0 + (t & 7);
    int d = 0, v = 0;
    bool on = false;
    if (gr < a.nb_r && gc < a.nb_c) {
      const long long gb = (long long)gr * a.nb_c + gc;
      if (a.search) {
        long long best = s_cost[0][t];
        for (int k = 1; k < 8; ++k) {
          if (s_cost[k][t] > best) {
            best = s_cost[k][t];
            d = k;
          }
        }
        v = (int)((best - s_cost[(d + 4) & 7][t]) >> 10);
        a.dirs[gb] = d;
        if (a.var) a.var[gb] = v;
      } else {
        d = a.dirs[gb];
        v = a.var ? a.var[gb] : 0;
      }
      on = !a.skip[(long long)gr * a.skip_stride + gc];
    }
    s_dir[t] = d;
    s_on[t] = on;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < a.np)
        s_pri[j][t] = a.p[j].adjust ? adjust_strength(a.p[j].pri, v)
                                  : a.p[j].pri;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j >= a.np) break;
    if (a.p[j].bs == 8)
      filter_tile<8>(a.p[j], ty, tx, sm + base[j], s_dir, s_pri[j], s_on,
                     s_sum[j]);
    else
      filter_tile<4>(a.p[j], ty, tx, sm + base[j], s_dir, s_pri[j], s_on,
                     s_sum[j]);
  }
  if (!a.sums) return;
  __syncthreads();
  if (t < 2 * a.np) {
    const int j = t >> 1, k = t & 1;
    if (a.p[j].src && s_sum[j][k])
      atomicAdd(a.sums + k * a.np + j, s_sum[j][k]);
  }
}

__host__ int tiles_of(const KFPlane& p, bool rows) {
  const int T = 8 * p.bs, n = rows ? p.H : p.W;
  return (n + T - 1) / T;
}

}  // namespace

AV1_EXPORT int cdef_launch(const KFArgs* args, void* stream) {
  const KFArgs& a = *args;
  if (a.np < 1 || a.np > 3) return (int)cudaErrorInvalidValue;
  int gy = 0, gx = 0, smem = 0, luma = 0;
  for (int j = 0; j < a.np; ++j) {
    const KFPlane& p = a.p[j];
    if ((p.bs != 4 && p.bs != 8) || p.ph > p.H || p.pw > p.W ||
        p.ph > a.nb_r * p.bs || p.pw > a.nb_c * p.bs)
      return (int)cudaErrorInvalidValue;
    smem += p.bs == 8 ? Tile<8>::SIZE : Tile<4>::SIZE;
    luma += p.bs == 8;
    gy = max(gy, tiles_of(p, true));
    gx = max(gx, tiles_of(p, false));
  }
  if (smem > kSmemInts || luma > 1 || (a.search && a.p[0].bs != 8))
    return (int)cudaErrorInvalidValue;
  if (gy == 0 || gx == 0) return 0;
  kf_tile_kernel<<<dim3(gx, gy), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
