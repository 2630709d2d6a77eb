// Kernel KD: mc_8tap.
//
// Replaces the reference's batched motion compensation and the reductions
// that follow each call: tpu_inter._gather_region / _conv2d_batched /
// _mc_blocks (aom_av1_psy_tpu/encoder/tpu_inter.py:47-93) and the per-block
// SAD / SSE at :174, :251, :255-256, :275-276, :301 and :335.
//
// Per (candidate k, block b): the block's clamped 1/16-pel MV gives an
// integer position (arithmetic shift) and a phase (two's-complement mask);
// the (bw+7)^2 source region, clamped to the TRUE crop, is gathered into
// shared memory; a horizontal 8-tap pass and a vertical 8-tap pass follow
// with av1_convolve_2d_sr's rounding (:62-70); the prediction is written
// and, with src blocks given, its SAD and SSE are reduced in the block.
//
// What bounds it: at 1080p the search stages run K = 9 candidates over
// B = 8160 16x16 blocks (73,440 CTAs), each reading a 23x23 region and
// 2 x 8 x 368 multiply-adds: a gather from L2-resident planes plus a few
// thousand integer ops per CTA, so launch-and-latency bound, not bandwidth
// bound. Design: one CTA per (candidate, block), 256 threads; integer
// arithmetic only, so it equals the plain version exactly.
#include "common.cuh"

namespace {

constexpr int kBd = 8, kFilterBits = 7, kRound0 = 3;
constexpr int kRound1 = 2 * kFilterBits - kRound0;
constexpr int kOffsetBits = kBd + 2 * kFilterBits - kRound0;
constexpr int kThreads = 256;

struct KDArgs {
  const int* ref;      // (H, W)
  int H, W, crop_h, crop_w;
  const int* by;       // (B,) block origins, plane px
  const int* bx;
  const int* qr;       // (K, B) clamped 1/16-pel MVs
  const int* qc;
  int K, B;
  const int* kern;     // (K, 16, 8) filter taps per phase
  const int* src;      // (B, bw, bw) or null
  int* pred;           // (K, B, bw, bw) or null
  int* sad;            // (K, B) or null
  int* sse;            // (K, B) or null
};

template <int BW>
__global__ void __launch_bounds__(kThreads) kd_kernel(KDArgs a) {
  constexpr int RW = BW + 7;
  __shared__ int reg[RW * RW];
  __shared__ int im[RW * BW];
  __shared__ int red[32];
  const int b = blockIdx.x, k = blockIdx.y;
  const int kb = k * a.B + b;
  const int pos_y = (a.by[b] << 4) + a.qr[kb];
  const int pos_x = (a.bx[b] << 4) + a.qc[kb];
  const int y0 = (pos_y >> 4) - 3, x0 = (pos_x >> 4) - 3;
  const int* kx = a.kern + k * 128 + (pos_x & 15) * 8;
  const int* ky = a.kern + k * 128 + (pos_y & 15) * 8;

  for (int p = threadIdx.x; p < RW * RW; p += kThreads) {
    const int y = clampi(y0 + p / RW, 0, a.crop_h - 1);
    const int x = clampi(x0 + p % RW, 0, a.crop_w - 1);
    reg[p] = a.ref[(long long)y * a.W + x];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < RW * BW; p += kThreads) {
    const int r = p / BW, c = p % BW;
    int s = 0;
    for (int t = 0; t < 8; ++t) s += kx[t] * reg[r * RW + c + t];
    im[p] = (s + (1 << (kBd + kFilterBits - 1)) + (1 << (kRound0 - 1))) >>
            kRound0;
  }
  __syncthreads();

  const int* src = a.src ? a.src + (long long)b * BW * BW : nullptr;
  int* pred = a.pred ? a.pred + (long long)kb * BW * BW : nullptr;
  int sad = 0, sse = 0;
  for (int p = threadIdx.x; p < BW * BW; p += kThreads) {
    const int r = p / BW, c = p % BW;
    int s = 0;
    for (int t = 0; t < 8; ++t) s += ky[t] * im[(r + t) * BW + c];
    int o = (s + (1 << kOffsetBits) + (1 << (kRound1 - 1))) >> kRound1;
    o -= (1 << (kOffsetBits - kRound1)) + (1 << (kOffsetBits - kRound1 - 1));
    o = clampi(o, 0, (1 << kBd) - 1);
    if (pred) pred[p] = o;
    if (src) {
      const int d = o - src[p];
      sad += abs(d);
      sse += d * d;
    }
  }
  if (src) {
    sad = block_sum<int>(sad, red);
    sse = block_sum<int>(sse, red);
    if (threadIdx.x == 0) {
      a.sad[kb] = sad;
      a.sse[kb] = sse;
    }
  }
}

}  // namespace

AV1_EXPORT int mc_8tap(const int* ref, int H, int W, int crop_h, int crop_w,
                       const int* by, const int* bx, const int* qr,
                       const int* qc, int K, int B, int bw, const int* kern,
                       const int* src, int* pred, int* sad, int* sse,
                       void* stream) {
  if (K <= 0 || B <= 0) return 0;
  if (K > 65535 || crop_h <= 0 || crop_w <= 0 || crop_h > H || crop_w > W)
    return (int)cudaErrorInvalidValue;
  KDArgs a{ref, H, W, crop_h, crop_w, by, bx, qr, qc, K, B, kern, src, pred,
           sad, sse};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B, K);
  switch (bw) {
    case 8: kd_kernel<8><<<grid, kThreads, 0, st>>>(a); break;
    case 16: kd_kernel<16><<<grid, kThreads, 0, st>>>(a); break;
    case 32: kd_kernel<32><<<grid, kThreads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
