// Kernel KK: tf_span_filter, one pass per span.
//
// Replaces the reference's host weighting of the temporal filter,
// apply_temporal_filter (aom_av1_psy_tpu/encoder/temporal_filter.py:33-94),
// with the per-block prediction origins, subblock MSEs and the final
// rounding of temporal_filter_frames (:97-181) around it: for every pixel
// of the centre frame and every other frame of the span, the 5x5 windowed
// squared error between the centre frame and that frame's prediction
// (chroma adds the co-located luma 2x2 sums), the non-local-means weight in
// float64, and weight * pred and weight summed; at the end
// (accum + count / 2) / max(count, 1), clamped, written as uint8.
//
// Inputs per span: each frame's three int32 planes, each non-centre frame's
// full-pel MV per 32x32 luma block (KJ's search), the host's d_factor table
// by MV (np.hypot) and weight thresholds (np.exp), and the host constants
// wf, inv and decay per plane (np.log).
//
// Exactness:
// - the prediction's origin is (block origin + MV) >> ss, clamped to keep
//   the block inside the plane (an arithmetic >> on negative positions);
// - the four subblock MSEs are integer sums of the luma squared errors over
//   the reference's windows (hh = max(h / 2, 1) rows, hw = max(w / 2, 1)
//   columns, cut to the block: an odd last row or column is left out), each
//   divided by its pixel count (at least 1), floored;
// - the window clamps at the block's border (the reference pads the
//   block's own squared errors with mode="edge"), never at the frame's;
// - chroma divides by 25 + (1 << (ss_x + ss_y)); the weight's subblock
//   index uses each plane's own ph / 2 and pw / 2;
// - window_error = total / n, combined = wf * we + be * inv,
//   scaled = min((combined * d) * decay, 7): each operation rounded once
//   (__dmul_rn / __dadd_rn, and the library builds with --fmad=false);
//   total is an exact integer in [0, 29 * 255^2], and total / n is the
//   product by RN(1 / n) corrected by its exact residual (div_total), which
//   equals the IEEE quotient at every such total and every n the pass uses
//   (25, 26, 27, 29): tf_div_sweep lets the tests check all of them;
// - the weight (int64)(exp(-scaled) * 1000) is NOT computed with CUDA's
//   exp: on an H100 it truncated to another integer than np.exp at 276 of
//   the 101002 values within 50 ulp of the 1000 truncation boundaries. It
//   is the count of the host's thresholds (weight_thresholds in
//   encoder/temporal_filter.py: for each k, the largest `scaled` whose
//   np.exp weight is >= k, ascending) at or above `scaled`. A float __expf
//   only guesses the position; comparisons with the thresholds on either
//   side settle it, so the result is the count whatever the guess.
//   tf_weight() is the one place the weight is made; the second entry,
//   tf_weight_sweep, applies it to an array of `scaled` values, so that a
//   test can hold it against numpy's at every truncation boundary
//   (tests/test_torch_tf_gpu.py, chip_smoke.py phase 3e);
// - the centre frame's prediction is itself with MV 0: every squared error
//   and MSE is 0, so scaled is +0.0 for finite d and decay, and each pixel
//   takes weight(0) * ref and weight(0) without the window;
// - int32 sums are exact: a pixel's accum is at most n * 1000 * 255, which
//   the wrapper keeps below 2^31; a quadrant's squared errors at most
//   16 * 16 * 255^2.
//
// What bounds it: at 1080p with 3 frames, reading each frame's int32
// planes once (37 MB) and writing the uint8 result (3 MB), ~0.012 ms at
// 3.35 TB/s; per pixel and non-centre frame ~20 integer and ~11 float64
// operations are a few microseconds. Design: a persistent grid (as many
// CTAs of 256 threads as the SMs hold at once) whose CTAs stage the 8 KB
// of thresholds in shared memory once and then walk the 32x32 luma blocks,
// looping over the span's frames for each. A thread owns a 2x2 luma quad
// and the chroma pixels it covers (one each at 4:2:0), so the luma 2x2
// sums that chroma adds are its own registers; its centre pixels,
// accumulators and counts stay in registers across the frames, and the
// next frame's pixels are loaded while the current one is weighted. Per
// frame the squared errors go to shared memory once; the 5x5 window is two
// separable passes over them (the luma's as column pairs in tiles whose
// 2-px border replicates the block's edge: each thread sums 6 values a row
// for its 2 columns, then 6 a column for its 2 rows); the quadrant sums
// are one warp reduction each; two barriers a frame. A weight reads two
// staged thresholds next to its __expf guess. Nothing but the uint8 planes
// goes back to device memory. On an H100 the 1080p KEY span takes ~4x the
// bound; builds without any one part (the threshold reads, the windows,
// the frame loads, the writes, the float64 arithmetic) left most of the
// time in place: it is the latency of 24 warps an SM, not one resource.
#include "common.cuh"

constexpr int kKKMaxFrames = 16;

// The wrapper's argument block (ops: encoder/temporal_filter._KKArgs).
struct KKArgs {
  const int* planes[kKKMaxFrames][3];  // frame f's y, u, v (int32)
  unsigned char* out[3];               // the filtered y, u, v
  const int* mvs;                      // (n, B, 2) full-pel (dy, dx)
  const double* dtab;                  // (2 rad + 1)^2 d_factor by MV
  const double* thresholds;            // (kScale,) ascending
  double decay[3];
  double wf, inv;
  int n, center, H, W, Hc, Wc, nbx, mb, rad, ss_x, ss_y;
};

namespace {

constexpr int kThreads = 256, kMaxMb = 32, kScale = 1000;
constexpr int kWarps = kThreads / 32;

// The non-local-means weight of one pixel, (int64)(np.exp(-scaled) * 1000):
// the count of the kScale ascending thresholds `t` at or above `scaled`,
// i.e. kScale minus the first index lo with t[lo] >= scaled. A guess of lo
// from __expf (off by a position or two at most), both neighbours read at
// once, then lo moved until t[lo - 1] < scaled <= t[lo] (t[-1] = -inf,
// t[kScale] = +inf): the loops rarely turn, and the count does not depend
// on the guess.
__device__ __forceinline__ int tf_weight(double scaled, const double* t) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const float g = __expf(-(float)scaled) * (float)kScale;
  int lo = clampi(kScale - (int)g, 0, kScale);
  double above = lo < kScale ? t[lo] : inf;
  double below = lo > 0 ? t[lo - 1] : -inf;
  while (above < scaled) {
    ++lo;
    below = above;
    above = lo < kScale ? t[lo] : inf;
  }
  while (below >= scaled) {
    --lo;
    above = below;
    below = lo > 0 ? t[lo - 1] : -inf;
  }
  return kScale - lo;
}

// total / n rounded once, for an integer total in [0, kMaxTotal] and n in
// {25, 26, 27, 29}: the product by inv = RN(1 / n), corrected by its exact
// residual (two explicit FMAs). Equal to the IEEE quotient (__ddiv_rn,
// numpy's /) at every such total and n: tf_div_sweep lets the tests check
// all of them on the card (tests/test_torch_tf_gpu.py, chip_smoke.py 3e).
constexpr int kMaxTotal = 29 * 255 * 255;
__device__ __forceinline__ double div_total(int total, double n,
                                            double inv) {
  const double t = (double)total;
  const double q = __dmul_rn(t, inv);
  return __fma_rn(__fma_rn(-q, n, t), inv, q);
}

// One pixel's `scaled` from its window total; `be_inv` is the subblock's
// MSE * inv. The reference's order of float64 operations, each rounded once.
__device__ __forceinline__ double scaled_of(int total, double nref,
                                            double inv_nref, double be_inv,
                                            double d, double decay,
                                            double wf) {
  const double we = div_total(total, nref, inv_nref);
  const double combined = __dadd_rn(__dmul_rn(wf, we), be_inv);
  const double scaled = __dmul_rn(__dmul_rn(combined, d), decay);
  return scaled < 7.0 ? scaled : 7.0;
}

// Horizontal 5-sums of an R x C patch at (i0, j0) of a ph x pw tile (the
// window clamped at the tile's edge): rows past ph and columns past pw are
// not written.
template <int R, int C, int S>
__device__ __forceinline__ void hsum(int (*sq)[S], int (*hs)[S],
                                     int i0, int j0, int ph, int pw) {
  if (i0 >= ph || j0 >= pw) return;
  int col[C + 4];
#pragma unroll
  for (int k = 0; k < C + 4; ++k) col[k] = clampi(j0 - 2 + k, 0, pw - 1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i >= ph) break;
    int x[C + 4];
#pragma unroll
    for (int k = 0; k < C + 4; ++k) x[k] = sq[i][col[k]];
    int s = x[0] + x[1] + x[2] + x[3] + x[4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (j0 + c < pw) hs[i][j0 + c] = s;
      if (c + 1 < C) s += x[c + 5] - x[c];
    }
  }
}

// Vertical 5-sums of the horizontal sums: the window sum of each pixel of
// the patch (0 outside the tile).
template <int R, int C, int S>
__device__ __forceinline__ void vsum(int (*hs)[S], int i0, int j0,
                                     int ph, int pw, int (&out)[R][C]) {
  int row[R + 4];
#pragma unroll
  for (int k = 0; k < R + 4; ++k) row[k] = clampi(i0 - 2 + k, 0, ph - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    if (i0 >= ph || j >= pw) {
#pragma unroll
      for (int r = 0; r < R; ++r) out[r][c] = 0;
      continue;
    }
    int x[R + 4];
#pragma unroll
    for (int k = 0; k < R + 4; ++k) x[k] = hs[row[k]][j];
    int s = x[0] + x[1] + x[2] + x[3] + x[4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      out[r][c] = s;
      if (r + 1 < R) s += x[r + 5] - x[r];
    }
  }
}

// One frame's prediction of a thread's pixels, and the block's d_factor.
template <int CY, int CX>
struct Pred {
  int y[2][2], u[CY][CX], v[CY][CX];
  double d;
};

template <int SX, int SY>
struct Smem {
  static constexpr int TH = kMaxMb >> SY, TW = kMaxMb >> SX;  // chroma tile
  double thr[kScale];  // the weight thresholds, staged once per CTA
  // luma: squared errors with 2 columns of the block's edge replicated on
  // either side, and their horizontal sums with 2 rows replicated above
  // and below, read as column pairs
  int2 sq_y[kMaxMb][(kMaxMb + 4) / 2], hs_y[kMaxMb + 4][kMaxMb / 2];
  int sq_c[2][TH][TW + 1], hs_c[2][TH][TW + 1];
  int red[kWarps][4];
  double be_inv[4];  // each subblock's MSE * inv
};

// Block b of the span: every frame's weighting into registers, then the
// rounded uint8 pixels.
template <int SX, int SY>
__device__ __forceinline__ void filter_block(const KKArgs& a, int b, int B,
                                             int w0, Smem<SX, SY>& sm) {
  constexpr int CY = 2 >> SY, CX = 2 >> SX;  // chroma per thread
  auto& sq_y = sm.sq_y;
  auto& hs_y = sm.hs_y;
  auto& sq_c = sm.sq_c;
  auto& hs_c = sm.hs_c;
  auto& red = sm.red;
  auto& be_inv = sm.be_inv;
  const double* thr = sm.thr;
  const int by = (b / a.nbx) * a.mb, bx = (b % a.nbx) * a.mb;
  const int h = min(a.mb, a.H - by), w = min(a.mb, a.W - bx);
  const int ch = h >> SY, cw = w >> SX;
  const int i0 = (threadIdx.x >> 4) * 2, j0 = (threadIdx.x & 15) * 2;
  const int ci0 = i0 >> SY, cj0 = j0 >> SX;
  const int cby = by >> SY, cbx = bx >> SX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  bool lv[2][2], cv[CY][CX];  // the thread's pixels inside the block
  int qm[4][2][2];  // 1 where a pixel counts in MSE quadrant q, else 0
  const int hh = max(h / 2, 1), hw = max(w / 2, 1);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = i0 + u, j = j0 + v;
      lv[u][v] = i < h && j < w;
      const int qy = i < hh ? 0 : (i < 2 * hh ? 1 : -1);
      const int qx = j < hw ? 0 : (j < 2 * hw ? 1 : -1);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        qm[q][u][v] = lv[u][v] && qy == (q >> 1) && qx == (q & 1);
    }
#pragma unroll
  for (int u = 0; u < CY; ++u)
#pragma unroll
    for (int v = 0; v < CX; ++v) cv[u][v] = ci0 + u < ch && cj0 + v < cw;

  // frame f's MV of this block (then load() reads its prediction of the
  // thread's pixels); the first frame's MV, then the centre frame, read
  // once: the reference and its own prediction
  auto mv_of = [&](int f) {
    return __ldg(reinterpret_cast<const int2*>(a.mvs) + (long long)f * B + b);
  };
  const int2 first_mv = a.n > 1 ? mv_of(a.center == 0 ? 1 : 0)
                                : make_int2(0, 0);
  const int* const* cp = a.planes[a.center];
  int ry[2][2], ru[CY][CX], rv[CY][CX];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v)
      ry[u][v] = lv[u][v] ? __ldg(cp[0] + (by + i0 + u) * a.W + bx + j0 + v)
                          : 0;
#pragma unroll
  for (int u = 0; u < CY; ++u)
#pragma unroll
    for (int v = 0; v < CX; ++v) {
      const int o = (cby + ci0 + u) * a.Wc + cbx + cj0 + v;
      ru[u][v] = cv[u][v] ? __ldg(cp[1] + o) : 0;
      rv[u][v] = cv[u][v] ? __ldg(cp[2] + o) : 0;
    }
  auto load = [&](int f, int2 mv, Pred<CY, CX>& p) {
    const int dy = mv.x, dx = mv.y;
    p.d = __ldg(a.dtab + (dy + a.rad) * (2 * a.rad + 1) + dx + a.rad);
    const int oy = min(max(by + dy, 0), a.H - h);
    const int ox = min(max(bx + dx, 0), a.W - w);
    const int coy = min(max((by + dy) >> SY, 0), a.Hc - ch);
    const int cox = min(max((bx + dx) >> SX, 0), a.Wc - cw);
    const int* const* fp = a.planes[f];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        p.y[u][v] = lv[u][v] ? __ldg(fp[0] + (oy + i0 + u) * a.W + ox + j0 + v)
                             : 0;
#pragma unroll
    for (int u = 0; u < CY; ++u)
#pragma unroll
      for (int v = 0; v < CX; ++v) {
        const int o = (coy + ci0 + u) * a.Wc + cox + cj0 + v;
        p.u[u][v] = cv[u][v] ? __ldg(fp[1] + o) : 0;
        p.v[u][v] = cv[u][v] ? __ldg(fp[2] + o) : 0;
      }
  };

  const double nref_c = (double)(25 + (1 << (SX + SY)));
  const double inv_y = __drcp_rn(25.0), inv_c = __drcp_rn(nref_c);
  Pred<CY, CX> cur, nxt;
  int f = a.center == 0 ? 1 : 0;
  if (f < a.n) load(f, first_mv, nxt);
  int ay[2][2], cy[2][2], au[CY][CX], cu[CY][CX], av[CY][CX], cvn[CY][CX];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      ay[u][v] = w0 * ry[u][v];
      cy[u][v] = w0;
    }
#pragma unroll
  for (int u = 0; u < CY; ++u)
#pragma unroll
    for (int v = 0; v < CX; ++v) {
      au[u][v] = w0 * ru[u][v];
      av[u][v] = w0 * rv[u][v];
      cu[u][v] = cvn[u][v] = w0;
    }

  while (f < a.n) {
    cur = nxt;
    int fn = f + 1;
    if (fn == a.center) ++fn;
    if (fn < a.n) load(fn, mv_of(fn), nxt);  // in flight meanwhile

    // squared errors to shared memory; the quadrants' sums
    int ey[2][2], part[4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int d = ry[u][v] - cur.y[u][v];
        ey[u][v] = d * d;
      }
    const int b2 = j0 >> 1;  // the quad's column pair
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (lv[u][0]) {  // the edge column replicated past it
        const int e0 = ey[u][0], e1 = lv[u][1] ? ey[u][1] : e0;
        sq_y[i0 + u][b2 + 1] = make_int2(e0, e1);
        if (j0 == 0) sq_y[i0 + u][0] = make_int2(e0, e0);
        if (j0 + 2 >= w) sq_y[i0 + u][b2 + 2] = make_int2(e1, e1);
      }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      part[q] = ey[0][0] * qm[q][0][0] + ey[0][1] * qm[q][0][1] +
                ey[1][0] * qm[q][1][0] + ey[1][1] * qm[q][1][1];
#pragma unroll
    for (int u = 0; u < CY; ++u)
#pragma unroll
      for (int v = 0; v < CX; ++v)
        if (cv[u][v]) {
          const int du = ru[u][v] - cur.u[u][v], dv = rv[u][v] - cur.v[u][v];
          sq_c[0][ci0 + u][cj0 + v] = du * du;
          sq_c[1][ci0 + u][cj0 + v] = dv * dv;
        }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = __reduce_add_sync(0xffffffffu, part[q]);
      if (lane == 0) red[warp][q] = s;
    }
    __syncthreads();

    if (j0 < w) {  // the luma's horizontal sums, the edge rows replicated
      int2 hr[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int2 x01 = sq_y[i0 + u][b2], x23 = sq_y[i0 + u][b2 + 1],
                   x45 = sq_y[i0 + u][b2 + 2];
        const int s0 = x01.x + x01.y + x23.x + x23.y + x45.x;
        hr[u] = make_int2(s0, s0 - x01.x + x45.y);
      }
      if (i0 < h) {
        hs_y[i0 + 2][b2] = hr[0];
        if (i0 + 1 < h) hs_y[i0 + 3][b2] = hr[1];
        if (i0 == 0) hs_y[0][b2] = hs_y[1][b2] = hr[0];
        if (i0 + 2 >= h) {
          const int2 r = i0 + 1 < h ? hr[1] : hr[0];
          hs_y[h + 2][b2] = hs_y[h + 3][b2] = r;
        }
      }
    }
    hsum<CY, CX>(sq_c[0], hs_c[0], ci0, cj0, ch, cw);
    hsum<CY, CX>(sq_c[1], hs_c[1], ci0, cj0, ch, cw);
    if (threadIdx.x < 4) {  // quadrant q's sum over its pixel count
      const int q = threadIdx.x, r0 = (q >> 1) * hh, c0 = (q & 1) * hw;
      const int n = max(min(r0 + hh, h) - r0, 0) * max(min(c0 + hw, w) - c0,
                                                       0);
      int s = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += red[k][q];
      be_inv[q] = __dmul_rn((double)(s / max(n, 1)), a.inv);
    }
    __syncthreads();

    int win[2][2], wu[CY][CX], wv[CY][CX];
    if (j0 < w) {
      int2 x[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = hs_y[i0 + k][b2];
      const int s0 = x[0].x + x[1].x + x[2].x + x[3].x + x[4].x;
      const int s1 = x[0].y + x[1].y + x[2].y + x[3].y + x[4].y;
      win[0][0] = s0;
      win[0][1] = s1;
      win[1][0] = s0 - x[0].x + x[5].x;
      win[1][1] = s1 - x[0].y + x[5].y;
    }
    vsum<CY, CX>(hs_c[0], ci0, cj0, ch, cw, wu);
    vsum<CY, CX>(hs_c[1], ci0, cj0, ch, cw, wv);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        if (lv[u][v]) {
          const int sub = (i0 + u >= h / 2) * 2 + (j0 + v >= w / 2);
          const int wt = tf_weight(
              scaled_of(win[u][v], 25.0, inv_y, be_inv[sub], cur.d,
                        a.decay[0], a.wf),
              thr);
          ay[u][v] += wt * cur.y[u][v];
          cy[u][v] += wt;
        }
#pragma unroll
    for (int u = 0; u < CY; ++u)
#pragma unroll
      for (int v = 0; v < CX; ++v)
        if (cv[u][v]) {
          // the co-located luma squared errors: this thread's own quad
          int lum = 0;
#pragma unroll
          for (int lu = 0; lu < 2; ++lu)
#pragma unroll
            for (int lw = 0; lw < 2; ++lw)
              if ((lu >> SY) == u && (lw >> SX) == v) lum += ey[lu][lw];
          const int sub = (ci0 + u >= ch / 2) * 2 + (cj0 + v >= cw / 2);
          const int tu = tf_weight(
              scaled_of(wu[u][v] + lum, nref_c, inv_c, be_inv[sub], cur.d,
                        a.decay[1], a.wf),
              thr);
          const int tv = tf_weight(
              scaled_of(wv[u][v] + lum, nref_c, inv_c, be_inv[sub], cur.d,
                        a.decay[2], a.wf),
              thr);
          au[u][v] += tu * cur.u[u][v];
          cu[u][v] += tu;
          av[u][v] += tv * cur.v[u][v];
          cvn[u][v] += tv;
        }
    f = fn;
  }

  // (accum + count / 2) / max(count, 1), clamped: the only writes
  auto round8 = [](int acc, int cnt) {
    const int c = max(cnt, 1);
    return (unsigned char)clampi((acc + (c >> 1)) / c, 0, 255);
  };
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v)
      if (lv[u][v])
        a.out[0][(long long)(by + i0 + u) * a.W + bx + j0 + v] =
            round8(ay[u][v], cy[u][v]);
#pragma unroll
  for (int u = 0; u < CY; ++u)
#pragma unroll
    for (int v = 0; v < CX; ++v)
      if (cv[u][v]) {
        const long long o = (long long)(cby + ci0 + u) * a.Wc + cbx + cj0 + v;
        a.out[1][o] = round8(au[u][v], cu[u][v]);
        a.out[2][o] = round8(av[u][v], cvn[u][v]);
      }
}

// A persistent grid: each CTA stages the thresholds once and walks the
// blocks b = blockIdx.x, blockIdx.x + gridDim.x, ...
template <int SX, int SY>
__global__ void __launch_bounds__(kThreads, 3) kk_span_kernel(const KKArgs a) {
  __shared__ Smem<SX, SY> sm;
  for (int i = threadIdx.x; i < kScale; i += kThreads)
    sm.thr[i] = __ldg(a.thresholds + i);
  __syncthreads();
  const int w0 = tf_weight(0.0, sm.thr);  // the centre frame's weight
  const int B = (a.H + a.mb - 1) / a.mb * a.nbx;
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    filter_block<SX, SY>(a, b, B, w0, sm);
}

__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const double* __restrict__ scaled, int n,
                 const double* __restrict__ thresholds,
                 long long* __restrict__ weight) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) weight[i] = tf_weight(scaled[i], thresholds);
}

// As many CTAs as the SMs hold at once, at most one per block.
void launch(void (*kernel)(KKArgs), const KKArgs& a, int B, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  kernel<<<min(B, max(sms * per_sm, 1)), kThreads, 0, s>>>(a);
}

__global__ void __launch_bounds__(kThreads)
    div_sweep_kernel(int n, double* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t <= kMaxTotal) out[t] = div_total(t, (double)n, __drcp_rn((double)n));
}

}  // namespace

// out[t] = t / n as the span pass divides, for every total t in
// [0, 29 * 255^2] (out holds kMaxTotal + 1 values).
AV1_EXPORT int tf_div_sweep(int n, double* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  div_sweep_kernel<<<(kMaxTotal + kThreads) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(n, out);
  return (int)cudaGetLastError();
}

AV1_EXPORT int tf_weight_sweep(const double* scaled, int n,
                               const double* thresholds, long long* weight,
                               void* stream) {
  if (n <= 0) return 0;
  sweep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(scaled, n, thresholds, weight);
  return (int)cudaGetLastError();
}

AV1_EXPORT int tf_span_filter(const KKArgs* args, void* stream) {
  const KKArgs& a = *args;
  if (a.n < 1 || a.n > kKKMaxFrames || a.center < 0 || a.center >= a.n ||
      a.mb <= 0 || a.mb > kMaxMb || a.ss_x < 0 || a.ss_x > 1 ||
      a.ss_y < 0 || a.ss_y > 1 || a.nbx <= 0 || a.rad < 0 ||
      (long long)a.n * kScale * 255 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (a.H <= 0 || a.W <= 0) return 0;
  if (a.nbx != (a.W + a.mb - 1) / a.mb) return (int)cudaErrorInvalidValue;
  const int B = (a.H + a.mb - 1) / a.mb * a.nbx;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.ss_x && a.ss_y)
    launch(kk_span_kernel<1, 1>, a, B, s);
  else if (a.ss_x)
    launch(kk_span_kernel<1, 0>, a, B, s);
  else if (a.ss_y)
    launch(kk_span_kernel<0, 1>, a, B, s);
  else
    launch(kk_span_kernel<0, 0>, a, B, s);
  return (int)cudaGetLastError();
}
