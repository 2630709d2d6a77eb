// Kernel KK: tf_weight_accum.
//
// Replaces the reference's host weighting of the temporal filter,
// apply_temporal_filter (aom_av1_psy_tpu/encoder/temporal_filter.py:33-94),
// run there block by block from temporal_filter_frames (:97-176): for every
// pixel of a block, the 5x5 windowed squared error between the centre
// frame and this frame's prediction (chroma adds the co-located luma 2x2
// sums), the non-local-means weight in float64, and weight * pred and
// weight added into the int64 accumulators.
//
// Exactness:
// - the window clamps at the block's border (the reference pads the
//   block's own squared errors with mode="edge"), never at the frame's;
// - chroma divides by 25 + (1 << (ss_x + ss_y)); the subblock index uses
//   each plane's own ph / 2 and pw / 2;
// - window_error = total / n, combined = wf * we + be * inv,
//   scaled = min((combined * d) * decay, 7): each operation rounded once
//   (__dmul_rn / __dadd_rn / __ddiv_rn, and the library builds with
//   --fmad=false); wf, inv, decay and d come from the host (np.log,
//   np.hypot);
// - the weight (int64)(exp(-scaled) * 1000) is NOT computed with CUDA's
//   exp: on an H100 it truncated to another integer than np.exp at 276 of
//   the 101002 values within 50 ulp of the 1000 truncation boundaries. It
//   is the count of the host's thresholds (weight_thresholds in
//   encoder/temporal_filter.py: for each k, the largest `scaled` whose
//   np.exp weight is >= k, ascending) at or above `scaled`, by binary
//   search. tf_weight() is the one place the weight is made; the second
//   entry, tf_weight_sweep, applies it to an array of `scaled` values, so
//   that a test can hold it against numpy's at every truncation boundary
//   (tests/test_torch_tf_gpu.py, chip_smoke.py phase 3e).
//
// What bounds it: at 1080p it reads ~3.1 M pixels of each of the two
// frames and read-modify-writes two int64 values per pixel: memory bound
// (about 0.04 ms at the H100 SXM data sheet's 3.35 TB/s); ~20 float64
// operations per pixel (with the 10 compares of the threshold search) are
// a few microseconds at its 34 TFLOP/s FP64 vector rate. Design: one CTA per 32x32 luma block, all three planes in
// turn; the block's squared errors in shared memory (luma kept for the
// chroma passes), one thread per pixel (strided) for the window, the
// weight and the accumulation. Each pixel belongs to one block, so no
// atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256, kMaxMb = 32, kScale = 1000;

// The non-local-means weight of one pixel, (int64)(np.exp(-scaled) * 1000):
// the count of the kScale ascending thresholds `t` at or above `scaled`.
__device__ __forceinline__ long long tf_weight(double scaled,
                                               const double* t) {
  int lo = 0, hi = kScale;  // first index whose threshold is >= scaled
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < scaled)
      lo = mid + 1;
    else
      hi = mid;
  }
  return kScale - lo;
}

struct KKArgs {
  const int* ref[3];   // centre frame planes
  const int* pred[3];  // this frame's planes
  long long* accum[3];
  long long* count[3];
  int H, W, Hc, Wc, nbx, mb, ss_x, ss_y;
  const int* org;           // (B, 3, 2) prediction origin per plane
  const long long* mses;    // (B, 4)
  const double* dfac;       // (B, 4)
  double decay[3], wf, inv;
  const double* thresholds;  // (kScale,) ascending
};

__global__ void __launch_bounds__(kThreads) kk_kernel(KKArgs a) {
  __shared__ int sql[kMaxMb * kMaxMb];  // luma squared errors
  __shared__ int sqc[kMaxMb * kMaxMb];  // the current chroma plane's
  __shared__ double thr[kScale];
  for (int i = threadIdx.x; i < kScale; i += kThreads)
    thr[i] = a.thresholds[i];
  const int b = blockIdx.x;
  const int by = (b / a.nbx) * a.mb, bx = (b % a.nbx) * a.mb;
  const int h = min(a.mb, a.H - by), w = min(a.mb, a.W - bx);
  for (int p = 0; p < 3; ++p) {
    const int sy = p ? a.ss_y : 0, sx = p ? a.ss_x : 0;
    const int ph = h >> sy, pw = w >> sx;
    const int stride = p ? a.Wc : a.W;
    const int r0 = by >> sy, c0 = bx >> sx;
    const int pr0 = a.org[(b * 3 + p) * 2], pc0 = a.org[(b * 3 + p) * 2 + 1];
    const int* ref = a.ref[p];
    const int* pred = a.pred[p];
    int* sq = p ? sqc : sql;
    for (int k = threadIdx.x; k < ph * pw; k += kThreads) {
      const int i = k / pw, j = k % pw;
      const int d = ref[(long long)(r0 + i) * stride + c0 + j] -
                    pred[(long long)(pr0 + i) * stride + pc0 + j];
      sq[k] = d * d;
    }
    __syncthreads();
    const double nref = (double)(25 + (p ? (1 << (sx + sy)) : 0));
    const double decay = a.decay[p];
    for (int k = threadIdx.x; k < ph * pw; k += kThreads) {
      const int i = k / pw, j = k % pw;
      int win = 0;
      for (int di = -2; di <= 2; ++di) {
        const int ii = clampi(i + di, 0, ph - 1);
        for (int dj = -2; dj <= 2; ++dj)
          win += sq[ii * pw + clampi(j + dj, 0, pw - 1)];
      }
      double total = (double)win;
      if (p) {
        int lum = 0;
        for (int u = 0; u < (1 << sy); ++u)
          for (int v = 0; v < (1 << sx); ++v)
            lum += sql[((i << sy) + u) * w + (j << sx) + v];
        total = __dadd_rn(total, (double)lum);
      }
      const double we = __ddiv_rn(total, nref);
      const int sub = (i >= ph / 2) * 2 + (j >= pw / 2);
      const double be = (double)a.mses[b * 4 + sub];
      const double combined = __dadd_rn(__dmul_rn(a.wf, we),
                                        __dmul_rn(be, a.inv));
      double scaled = __dmul_rn(__dmul_rn(combined, a.dfac[b * 4 + sub]),
                                decay);
      scaled = scaled < 7.0 ? scaled : 7.0;
      const long long weight = tf_weight(scaled, thr);
      const long long pv = pred[(long long)(pr0 + i) * stride + pc0 + j];
      const long long o = (long long)(r0 + i) * stride + c0 + j;
      a.accum[p][o] += weight * pv;
      a.count[p][o] += weight;
    }
    __syncthreads();  // sqc is rewritten by the next plane
  }
}

__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const double* __restrict__ scaled, int n,
                 const double* __restrict__ thresholds,
                 long long* __restrict__ weight) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) weight[i] = tf_weight(scaled[i], thresholds);
}

}  // namespace

AV1_EXPORT int tf_weight_sweep(const double* scaled, int n,
                               const double* thresholds, long long* weight,
                               void* stream) {
  if (n <= 0) return 0;
  sweep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(scaled, n, thresholds, weight);
  return (int)cudaGetLastError();
}

AV1_EXPORT int tf_weight_accum(
    const int* ref0, const int* ref1, const int* ref2, const int* pred0,
    const int* pred1, const int* pred2, long long* acc0, long long* acc1,
    long long* acc2, long long* cnt0, long long* cnt1, long long* cnt2, int H,
    int W, int Hc, int Wc, int B, int nbx, int mb, int ss_x, int ss_y,
    const int* org, const long long* mses, const double* dfac, double decay0,
    double decay1, double decay2, double wf, double inv,
    const double* thresholds, void* stream) {
  if (B <= 0) return 0;
  if (mb <= 0 || mb > kMaxMb || ss_x < 0 || ss_x > 1 || ss_y < 0 ||
      ss_y > 1 || nbx <= 0)
    return (int)cudaErrorInvalidValue;
  KKArgs a{{ref0, ref1, ref2},
           {pred0, pred1, pred2},
           {acc0, acc1, acc2},
           {cnt0, cnt1, cnt2},
           H, W, Hc, Wc, nbx, mb, ss_x, ss_y, org, mses, dfac,
           {decay0, decay1, decay2}, wf, inv, thresholds};
  kk_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
