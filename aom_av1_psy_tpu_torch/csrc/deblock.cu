// Kernel KC: lpf_ladder.
//
// Replaces the reference's device loop-filter ladder,
// deblock_jax.deblock_plane_fused vmapped over the candidate levels inside
// lpf_pick_and_filter / lpf_apply (aom_av1_psy_tpu/ops/deblock_jax.py:
// 183-290), with the edge filters _filter_seg14 / _filter_seg6 (:59-167).
//
// For one plane and L candidate levels: the plane filtered at each level
// (every vertical edge, then every horizontal edge) and, where a source is
// given, each level's exact squared error against it over the cropped
// area, in int64. The pick and the chroma zeroing stay in torch.
//
// What bounds it: memory traffic. At 1080p luma the ladder writes 6 x 1088
// x 1920 int32 (50 MB) and reads the plane and the source (17 MB); the
// filters are a few dozen integer operations per segment. Design: one
// launch per plane, one CTA per tile, looping over the levels. Tile origins
// sit half a cell before an edge (luma 16m - 8, chroma 8m - 4), so an edge
// at e reads and writes only inside [e - cell/2, e + cell/2) (luma
// e-7..e+6, chroma e-3..e+2), which lies in one tile in both directions: a
// tile depends on nothing outside it, after the vertical pass and after the
// horizontal pass, and needs no halo. Tiles are 4 x 4 cells (luma 64 px,
// chroma 32 px; ops/deblock_torch.kc_tile states the same layout for the
// CPU test of this claim), clipped to the plane at its border.
// A thread holds a fixed set of the tile's pixels (rows a warp apart,
// columns 32 apart): it reads them, and the source at the same positions,
// from DRAM once, into registers. For each level the CTA writes the tile
// into shared memory (row stride odd, so a warp's lanes on 32 rows of one
// column hit distinct banks), runs one thread per (row, vertical edge)
// segment with its 14 (or 6) taps in registers, a barrier, one thread per
// (column, horizontal edge) segment, a barrier, then writes every pixel of
// the tile to the level's plane once, coalesced, summing (out - src)^2 in
// int64: a block sum and one atomicAdd per CTA and level (integer sums: the
// order does not matter).
#include "common.cuh"

namespace {

__device__ __forceinline__ int c127(int v) { return clampi(v, -128, 127); }
__device__ __forceinline__ int r3(int v) { return (v + 4) >> 3; }
__device__ __forceinline__ int r4(int v) { return (v + 8) >> 4; }

struct Limits {
  int lim, blimit, thresh;
  __device__ explicit Limits(int level)
      : lim(max(level, 1)), blimit(2 * (level + 2) + max(level, 1)),
        thresh(level >> 4) {}
};

// filter4 on (p1, p0, q0, q1) with mask = 1 (callers gate on it).
__device__ void filter4(int hev, int& p1, int& p0, int& q0, int& q1) {
  const int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
  int f = c127(ps1 - qs1) * hev;
  f = c127(f + 3 * (qs0 - ps0));
  const int f1 = c127(f + 4) >> 3;
  const int f2 = c127(f + 3) >> 3;
  q0 = c127(qs0 - f1) + 128;
  p0 = c127(ps0 + f2) + 128;
  f = ((f1 + 1) >> 1) * (1 - hev);
  q1 = c127(qs1 - f) + 128;
  p1 = c127(ps1 + f) + 128;
}

// 14-tap luma edge on px[0..14) = p6..p0, q0..q6; rewrites px[1..13).
__device__ void filter14(int* px, int level) {
  const Limits L(level);
  int p[7], q[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    p[i] = px[6 - i];
    q[i] = px[7 + i];
  }
  auto ab = [](int a, int b) { return abs(a - b); };
  const bool fm2 = !(ab(p[1], p[0]) > L.lim || ab(q[1], q[0]) > L.lim ||
                     ab(p[0], q[0]) * 2 + ab(p[1], q[1]) / 2 > L.blimit);
  const bool fm3 = fm2 && !(ab(p[2], p[1]) > L.lim || ab(q[2], q[1]) > L.lim);
  const bool mask = fm3 && !(ab(p[3], p[2]) > L.lim || ab(q[3], q[2]) > L.lim);
  if (!mask) return;
  const bool flat3 = !(ab(p[1], p[0]) > 1 || ab(q[1], q[0]) > 1 ||
                       ab(p[2], p[0]) > 1 || ab(q[2], q[0]) > 1);
  const bool flat4 = flat3 && !(ab(p[3], p[0]) > 1 || ab(q[3], q[0]) > 1);
  const bool flat2 = !(ab(p[1], p[0]) > 1 || ab(q[1], q[0]) > 1 ||
                       ab(p[4], p[0]) > 1 || ab(q[4], q[0]) > 1 ||
                       ab(p[5], p[0]) > 1 || ab(q[5], q[0]) > 1 ||
                       ab(p[6], p[0]) > 1 || ab(q[6], q[0]) > 1);
  if (flat4 && flat2) {
    px[1] = r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0] +
               q[0]);
    px[2] = r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] +
               p[0] + q[0] + q[1]);
    px[3] = r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] +
               p[0] + q[0] + q[1] + q[2]);
    px[4] = r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 +
               p[0] + q[0] + q[1] + q[2] + q[3]);
    px[5] = r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 +
               p[0] * 2 + q[0] + q[1] + q[2] + q[3] + q[4]);
    px[6] = r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2 +
               q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5]);
    px[7] = r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2 +
               q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6]);
    px[8] = r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2 +
               q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2);
    px[9] = r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2 +
               q[3] * 2 + q[4] + q[5] + q[6] * 3);
    px[10] = r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2 +
                q[4] * 2 + q[5] + q[6] * 4);
    px[11] = r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2 +
                q[5] * 2 + q[6] * 5);
    px[12] = r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2 +
                q[6] * 7);
  } else if (flat4) {
    px[4] = r3(p[3] * 3 + 2 * p[2] + p[1] + p[0] + q[0]);
    px[5] = r3(p[3] * 2 + p[2] + 2 * p[1] + p[0] + q[0] + q[1]);
    px[6] = r3(p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2]);
    px[7] = r3(p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3]);
    px[8] = r3(p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] * 2);
    px[9] = r3(p[0] + q[0] + q[1] + 2 * q[2] + q[3] * 3);
  } else {
    const int hev = (ab(p[1], p[0]) > L.thresh || ab(q[1], q[0]) > L.thresh);
    int a = p[1], b = p[0], c = q[0], d = q[1];
    filter4(hev, a, b, c, d);
    px[5] = a;
    px[6] = b;
    px[7] = c;
    px[8] = d;
  }
}

// 6-tap chroma edge on px[0..6) = p2, p1, p0, q0, q1, q2; rewrites px[1..5).
__device__ void filter6(int* px, int level) {
  const Limits L(level);
  const int p2 = px[0], p1 = px[1], p0 = px[2], q0 = px[3], q1 = px[4],
            q2 = px[5];
  auto ab = [](int a, int b) { return abs(a - b); };
  const bool fm2 = !(ab(p1, p0) > L.lim || ab(q1, q0) > L.lim ||
                     ab(p0, q0) * 2 + ab(p1, q1) / 2 > L.blimit);
  const bool mask = fm2 && !(ab(p2, p1) > L.lim || ab(q2, q1) > L.lim);
  if (!mask) return;
  const bool flat3 = !(ab(p1, p0) > 1 || ab(q1, q0) > 1 || ab(p2, p0) > 1 ||
                       ab(q2, q0) > 1);
  if (flat3) {
    px[1] = r3(p2 * 3 + p1 * 2 + p0 * 2 + q0);
    px[2] = r3(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1);
    px[3] = r3(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2);
    px[4] = r3(p0 + q0 * 2 + q1 * 2 + q2 * 3);
  } else {
    const int hev = (ab(p1, p0) > L.thresh || ab(q1, q0) > L.thresh);
    int a = p1, b = p0, c = q0, d = q1;
    filter4(hev, a, b, c, d);
    px[1] = a;
    px[2] = b;
    px[3] = c;
    px[4] = d;
  }
}

struct KCArgs {
  const int* buf;        // (Hb, Wb)
  int Hb, Wb;
  const bool* split16;   // (R2, C2)
  int C2;
  const int* cands;      // (L,)
  int nl_v, kv, nl_h, kh;
  const int* src;        // (>= ph, src_stride) or null
  int src_stride, pw, ph;
  int* outs;             // (L, Hb, Wb)
  unsigned long long* sse;  // (L,)
  int L, ntx;            // levels, tiles per row
};

// Filters a segment of TAPS values `step` apart at p0 in place (14: luma,
// 6: chroma), the taps in registers.
template <int TAPS>
__device__ __forceinline__ void segment(int* p0, int step, int level) {
  int px[TAPS];
#pragma unroll
  for (int i = 0; i < TAPS; ++i) px[i] = p0[i * step];
  if constexpr (TAPS == 14)
    filter14(px, level);
  else
    filter6(px, level);
#pragma unroll
  for (int i = 1; i < TAPS - 1; ++i) p0[i * step] = px[i];
}

// A tile of 4 x 4 cells (TAPS 14: luma, 16 px cells; 6: chroma, 8 px): its
// side, threads (one per vertical segment: side rows x 4 edges) and the
// pixels each thread holds (PR rows, a warp apart, of PC columns, 32
// apart).
template <int TAPS>
struct Tile {
  static constexpr int kCells = 4;
  static constexpr int kCell = TAPS == 14 ? 16 : 8;
  static constexpr int kSide = kCells * kCell;
  static constexpr int kThreads = kSide * kCells;
  static constexpr int kPR = kSide / (kThreads / 32), kPC = kSide / 32;
  static constexpr int kStride = kSide | 1;   // shared row stride, odd
};

// One CTA per tile (blockIdx.x, row-major), looping over the levels. Tile
// (ty, tx) spans rows ty * side - cell / 2 ... and columns tx * side -
// cell / 2 ..., clipped to the plane; its edges lie at tile-local cell / 2
// + j * cell, edge index k = (ty or tx) * 4 + j.
template <int TAPS>
__global__ void __launch_bounds__(Tile<TAPS>::kThreads)
    kc_tile_kernel(KCArgs a) {
  using T = Tile<TAPS>;
  constexpr int cell = T::kCell, side = T::kSide, ts = T::kStride;
  constexpr int cells = T::kCells, half = TAPS / 2, nw = T::kThreads / 32;
  __shared__ int t[side * ts];   // tile-local coordinates
  __shared__ long long red[32];
  const int ty = blockIdx.x / a.ntx, tx = blockIdx.x - ty * a.ntx;
  const int Y0 = ty * side - cell / 2, X0 = tx * side - cell / 2;
  const int y0 = max(Y0, 0), y1 = min(Y0 + side, a.Hb);
  const int x0 = max(X0, 0), x1 = min(X0 + side, a.Wb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this thread's pixels of the plane (ov) and of the source (sv); zero
  // where they fall outside the plane or the source's cropped area
  int ov[T::kPR][T::kPC], sv[T::kPR][T::kPC];
#pragma unroll
  for (int i = 0; i < T::kPR; ++i) {
    const int y = Y0 + warp + i * nw;
#pragma unroll
    for (int j = 0; j < T::kPC; ++j) {
      const int x = X0 + lane + 32 * j;
      ov[i][j] = sv[i][j] = 0;
      if (y >= y0 && y < y1 && x >= x0 && x < x1) {
        ov[i][j] = a.buf[(long long)y * a.Wb + x];
        if (a.src && y < a.ph && x < a.pw)
          sv[i][j] = a.src[(long long)y * a.src_stride + x];
      }
    }
  }

  for (int l = 0; l < a.L; ++l) {
    // the tile, unfiltered (the barrier orders the last level's reads)
    __syncthreads();
#pragma unroll
    for (int i = 0; i < T::kPR; ++i)
#pragma unroll
      for (int j = 0; j < T::kPC; ++j)
        t[(warp + i * nw) * ts + lane + 32 * j] = ov[i][j];
    __syncthreads();

    const int level = a.cands[l];
    if (level > 0) {
      // vertical edges: one thread per (row, edge), rows fastest
      const int nr = min(y1, a.nl_v) - y0;
      for (int s = threadIdx.x; s < nr * cells; s += T::kThreads) {
        const int y = y0 + s % nr, j = s / nr;
        const int k = tx * cells + j;
        if (k < 1 || k > a.kv) continue;
        if (k % 2 != 0 && !a.split16[(y / cell) * a.C2 + k]) continue;
        segment<TAPS>(t + (y - Y0) * ts + (cell / 2 + j * cell - half), 1,
                      level);
      }
      __syncthreads();
      // horizontal edges: one thread per (column, edge), columns fastest
      const int nc = min(x1, a.nl_h) - x0;
      for (int s = threadIdx.x; s < nc * cells; s += T::kThreads) {
        const int x = x0 + s % nc, j = s / nc;
        const int k = ty * cells + j;
        if (k < 1 || k > a.kh) continue;
        if (k % 2 != 0 && !a.split16[k * a.C2 + x / cell]) continue;
        segment<TAPS>(t + (cell / 2 + j * cell - half) * ts + (x - X0), ts,
                      level);
      }
      __syncthreads();
    }

    int* out = a.outs + (long long)l * a.Hb * a.Wb;
    long long acc = 0;
#pragma unroll
    for (int i = 0; i < T::kPR; ++i) {
      const int y = Y0 + warp + i * nw;
#pragma unroll
      for (int j = 0; j < T::kPC; ++j) {
        const int x = X0 + lane + 32 * j;
        if (y >= y0 && y < y1 && x >= x0 && x < x1) {
          const int v = t[(y - Y0) * ts + x - X0];
          out[(long long)y * a.Wb + x] = v;
          const long long d = v - sv[i][j];
          if (a.src && y < a.ph && x < a.pw) acc += d * d;
        }
      }
    }
    if (a.src) {
      acc = block_sum<long long>(acc, red);
      if (threadIdx.x == 0) atomicAdd(a.sse + l, (unsigned long long)acc);
    }
  }
}

}  // namespace

// One launch, beside the memset of the sums.
AV1_EXPORT int lpf_ladder(const int* buf, int Hb, int Wb,
                          const bool* split16, int R2, int C2,
                          const int* cands, int L, int cell, int luma,
                          int nl_v, int kv, int nl_h, int kh,
                          const int* src, int src_stride, int pw, int ph,
                          int* outs, long long* sse, void* stream) {
  if (L <= 0) return 0;
  if (cell != (luma ? 16 : 8) || R2 <= 0 || C2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (src) {
    cudaError_t e = cudaMemsetAsync(sse, 0, sizeof(long long) * L, st);
    if (e != cudaSuccess) return (int)e;
  }
  // tiles of side `tile` from -cell / 2
  const int tile = luma ? Tile<14>::kSide : Tile<6>::kSide;
  const int nty = (Hb + cell / 2 + tile - 1) / tile;
  const int ntx = (Wb + cell / 2 + tile - 1) / tile;
  const KCArgs a{buf, Hb, Wb, split16, C2, cands, nl_v, kv, nl_h, kh, src,
                 src_stride, pw, ph, outs, (unsigned long long*)sse, L, ntx};
  if (luma)
    kc_tile_kernel<14><<<nty * ntx, Tile<14>::kThreads, 0, st>>>(a);
  else
    kc_tile_kernel<6><<<nty * ntx, Tile<6>::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
