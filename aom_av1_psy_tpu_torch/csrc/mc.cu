// Kernel KD: mc_8tap.
//
// Replaces the reference's batched motion compensation and the reductions
// that follow each call: tpu_inter._gather_region / _conv2d_batched /
// _mc_blocks (aom_av1_psy_tpu/encoder/tpu_inter.py:47-93) and the per-block
// SAD / SSE at :174, :251, :255-256, :275-276, :301 and :335.
//
// Per (candidate k, block b): the block's clamped 1/16-pel MV gives an
// integer position (arithmetic shift) and a phase (two's-complement mask);
// the (bw+7)^2 source region, clamped to the TRUE crop, is read; a
// horizontal 8-tap pass and a vertical 8-tap pass follow with
// av1_convolve_2d_sr's rounding; the prediction is written when asked for
// and, with src blocks given, its SAD and SSE are reduced.
//
// What bounds it: at 1080p the subpel steps run K = 9 candidates over
// B = 8160 16x16 blocks, ~35 integer operations per output pixel (0.66 G,
// about 0.01 ms at 67 T/s) against the plane and the blocks read once
// (~17 MB, 0.005 ms): operation bound. A CTA of 256 threads per (k, b)
// spent its time on the region gather's division and modulo per element,
// four block barriers and the launch of 73,440 CTAs. Design:
// - one warp per (candidate, block) at bw 16 and 32, four per warp at
//   bw 8; four warps per CTA, pairs ordered block-major (q = b * K + k),
//   so the candidates of one block share a CTA and their overlapping
//   regions hit L1;
// - the region is read row by row into the warp's slice of shared memory
//   (a lane per column: the row clamps once per row, the lane's columns
//   once, no division or modulo per element); the horizontal pass gives a
//   lane a region row, along which it slides an 8-value register window
//   (one shared load per output in place of eight); the vertical pass
//   runs down a lane's column (half of it at bw 16, where a warp has two
//   lanes per column); the taps sit in registers;
// - SAD and SSE are xor-shuffle sums over the pair's lanes; only
//   __syncwarp, no block barrier;
// - integer arithmetic only, so it equals the plain version exactly.
#include "common.cuh"

namespace {

constexpr int kBd = 8, kFilterBits = 7, kRound0 = 3;
constexpr int kRound1 = 2 * kFilterBits - kRound0;
constexpr int kOffsetBits = kBd + 2 * kFilterBits - kRound0;
constexpr int kWarps = 4;

struct KDArgs {
  const int* ref;      // (H, W)
  int H, W, crop_h, crop_w;
  const int* by;       // (B,) block origins, plane px
  const int* bx;
  const int* qr;       // (K, B) clamped 1/16-pel MVs
  const int* qc;
  int K, B;
  const int* kern;     // (K, 16, 8) filter taps per phase, 16-byte aligned
  const int* src;      // (B, bw, bw) or null
  int* pred;           // (K, B, bw, bw) or null
  int* sad;            // (K, B) or null
  int* sse;            // (K, B) or null
};

// Lanes per (k, b) pair (LP = bw x HS: HS lanes share a column in the
// vertical pass), and the shared-memory row strides of the region (odd:
// the lanes of the horizontal pass read rows RWS apart) and of the
// intermediate (at bw 16 the two half-warps of the vertical pass read
// rows 8 apart: 8 x 18 = 16 mod 32).
template <int BW> struct KDShape;
template <> struct KDShape<8> {
  static constexpr int HS = 1, LP = 8, RWS = 15, IMS = 9;
};
template <> struct KDShape<16> {
  static constexpr int HS = 2, LP = 32, RWS = 23, IMS = 18;
};
template <> struct KDShape<32> {
  static constexpr int HS = 1, LP = 32, RWS = 39, IMS = 33;
};

// ints per pair, rounded up to 8 mod 32: the four pairs of a bw-8 warp
// start on banks 0, 8, 16 and 24
__host__ __device__ constexpr int pair_ints(int n) {
  return n + (40 - n % 32) % 32;
}

template <int BW>
__global__ void __launch_bounds__(kWarps * 32) kd_kernel(KDArgs a) {
  using T = KDShape<BW>;
  constexpr int RW = BW + 7, P = 32 / T::LP;
  constexpr int PAIR = pair_ints(RW * T::RWS + RW * T::IMS);
  constexpr int NC = (RW + T::LP - 1) / T::LP;   // region columns per lane
  constexpr int OH = BW / T::HS;                 // output rows per lane
  __shared__ int sm[kWarps * P * PAIR];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / T::LP, lp = lane % T::LP;
  const int c = lp % BW, hs = lp / BW;
  int* reg = sm + (warp * P + slot) * PAIR;     // (RW, RWS)
  int* im = reg + RW * T::RWS;                  // (RW, IMS)

  // the pair: block-major, so a block's candidates share the CTA; a warp
  // past the last pair repeats it and stores nothing
  const int n = a.K * a.B;
  const int q0 = (blockIdx.x * kWarps + warp) * P + slot;
  const bool live = q0 < n;
  const int q = live ? q0 : n - 1;
  const int b = q / a.K, k = q - b * a.K;
  const long long kb = (long long)k * a.B + b;
  const int pos_y = (a.by[b] << 4) + a.qr[kb];
  const int pos_x = (a.bx[b] << 4) + a.qc[kb];
  const int y0 = (pos_y >> 4) - 3, x0 = (pos_x >> 4) - 3;
  // the taps, two 16-byte loads each (the wrapper aligns the table)
  const int4* tx = (const int4*)(a.kern + k * 128 + (pos_x & 15) * 8);
  const int4* ty = (const int4*)(a.kern + k * 128 + (pos_y & 15) * 8);
  const int4 x_lo = tx[0], x_hi = tx[1], y_lo = ty[0], y_hi = ty[1];
  const int kx[8] = {x_lo.x, x_lo.y, x_lo.z, x_lo.w,
                     x_hi.x, x_hi.y, x_hi.z, x_hi.w};
  const int ky[8] = {y_lo.x, y_lo.y, y_lo.z, y_lo.w,
                     y_hi.x, y_hi.y, y_hi.z, y_hi.w};

  // the region, row by row: the lane's columns clamp once (a lane past the
  // region's width reads a clamped column and stores nothing), the row
  // once per row
  const int* col[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
    col[j] = a.ref + clampi(x0 + lp + j * T::LP, 0, a.crop_w - 1);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int off = clampi(y0 + r, 0, a.crop_h - 1) * a.W;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int v = col[j][off];
      if (lp + j * T::LP < RW) reg[r * T::RWS + lp + j * T::LP] = v;
    }
  }
  __syncwarp();

  // horizontal pass: a lane owns region rows lp, lp + LP, ... and slides
  // an 8-value register window along each
  constexpr int NR = (RW + T::LP - 1) / T::LP;
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    const int r = lp + n * T::LP;
    if (r < RW) {
      const int* x = reg + r * T::RWS;
      int t[8];
#pragma unroll
      for (int j = 0; j < 7; ++j) t[j] = x[j];
#pragma unroll
      for (int cc = 0; cc < BW; ++cc) {
        t[7] = x[cc + 7];
        int s = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) s += kx[j] * t[j];
        im[r * T::IMS + cc] =
            (s + (1 << (kBd + kFilterBits - 1)) + (1 << (kRound0 - 1))) >>
            kRound0;
#pragma unroll
        for (int j = 0; j < 7; ++j) t[j] = t[j + 1];
      }
    }
  }
  __syncwarp();

  // vertical pass down the lane's column: output rows r0 .. r0 + OH - 1
  const int r0 = hs * OH;
  const int* src = a.src ? a.src + (long long)b * BW * BW : nullptr;
  int* pred = (a.pred && live) ? a.pred + kb * BW * BW : nullptr;
  int v[8];
#pragma unroll
  for (int t = 0; t < 7; ++t) v[t] = im[(r0 + t) * T::IMS + c];
  int sad = 0, sse = 0;
#pragma unroll
  for (int i = 0; i < OH; ++i) {
    v[7] = im[(r0 + i + 7) * T::IMS + c];
    int s = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) s += ky[t] * v[t];
    int o = (s + (1 << kOffsetBits) + (1 << (kRound1 - 1))) >> kRound1;
    o -= (1 << (kOffsetBits - kRound1)) + (1 << (kOffsetBits - kRound1 - 1));
    o = clampi(o, 0, (1 << kBd) - 1);
    const int p = (r0 + i) * BW + c;
    if (pred) pred[p] = o;
    if (src) {
      const int d = o - src[p];
      sad += abs(d);
      sse += d * d;
    }
#pragma unroll
    for (int t = 0; t < 7; ++t) v[t] = v[t + 1];
  }
  if (a.src) {
#pragma unroll
    for (int off = T::LP / 2; off > 0; off >>= 1) {
      sad += __shfl_xor_sync(0xffffffffu, sad, off);
      sse += __shfl_xor_sync(0xffffffffu, sse, off);
    }
    if (lp == 0 && live) {
      a.sad[kb] = sad;
      a.sse[kb] = sse;
    }
  }
}

template <int BW>
void kd_launch(const KDArgs& a, cudaStream_t st) {
  constexpr int per_cta = kWarps * (32 / KDShape<BW>::LP);
  const long long n = (long long)a.K * a.B;
  kd_kernel<BW><<<(unsigned)((n + per_cta - 1) / per_cta), kWarps * 32, 0,
                  st>>>(a);
}

}  // namespace

AV1_EXPORT int mc_8tap(const int* ref, int H, int W, int crop_h, int crop_w,
                       const int* by, const int* bx, const int* qr,
                       const int* qc, int K, int B, int bw, const int* kern,
                       const int* src, int* pred, int* sad, int* sse,
                       void* stream) {
  if (K <= 0 || B <= 0) return 0;
  if ((long long)K * B > (1LL << 30) || crop_h <= 0 || crop_w <= 0 ||
      crop_h > H || crop_w > W)
    return (int)cudaErrorInvalidValue;
  KDArgs a{ref, H, W, crop_h, crop_w, by, bx, qr, qc, K, B, kern, src, pred,
           sad, sse};
  cudaStream_t st = (cudaStream_t)stream;
  switch (bw) {
    case 8: kd_launch<8>(a, st); break;
    case 16: kd_launch<16>(a, st); break;
    case 32: kd_launch<32>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
