// Kernel KB: txq_recon_skip.
//
// Replaces the reference's transform / quantize / recon / skip-RD chain
// inside the two-level wavefronts: tpu_intra._quantize, _dequantize,
// _tq_recon, _tq_recon_uv (aom_av1_psy_tpu/encoder/tpu_intra.py:129-250,
// over the jnp stage interpreter ops/txfm._run_stages) and
// _coeff_rate_est / _skip_rd (tpu_intra.py:525-567).
//
// Per block: residual -> forward 2-D transform (column then row pass) ->
// zbin-dead-zone quantize -> eob over the scan -> dequantize -> inverse
// 2-D transform (row then column pass) + add + clip -> exact coefficient
// rate estimate -> skip decision (zero the residual when 2048 * sse gain
// is below the lambda-scaled rate).
//
// What bounds it: one anti-diagonal gives <= 34 blocks (68 for chroma U+V)
// per launch, so the kernel is latency-bound: ~9 butterfly stages per
// pass, each a barrier. Design: one CTA per block; the block lives in
// shared memory (two 4 KB buffers at 32x32) and every stage is one
// gather + multiply-add + round-shift per element, reading the normative
// stage programs (ops/txfm._compiled_stages, uploaded as a table), not
// hard-coded butterflies. Products are int64 truncated to int32 so the
// wraparound equals jnp's; the float32 skip-RD runs with --fmad=false in
// the reference's order of operations; the per-level rate sum is exact in
// half units; floor(log2) is the integer bit length, except on the golomb
// tail, where golomb_floor_log2 repeats the reference's float32 mis-floors.
#include "common.cuh"

namespace {

struct KBArgs {
  const int* src;       // (B, bs, bs)
  const int* pred;      // (B, bs, bs)
  const bool* vadst;    // (B,) or null (DCT)
  const bool* hadst;    // (B,) or null
  int dc_q, ac_q, shift;
  const int* scan;      // (bs*bs,)
  const float* lvl_tbl; // (16,) half-integer costs
  const float* eob_tbl; // (neob,)
  int neob;
  const float* rdm;     // (B,)
  const int* progs;     // (rows, 5): ia, ib, wa, wb, is_btf | clamp << 1
  const int* meta;      // 8 x (offset, n_stages, cos_bit, clamp_bit),
                        // fwd shifts (3), inv shifts (2)
  int* levels;          // (B, bs*bs)
  int* eob;             // (B,)
  int* recon;           // (B, bs, bs)
  float* sse;           // (B,)
  float* rate;          // (B,)
};

// The reference floors log2(big) of the golomb tail in float32
// (tpu_intra.py:538-541); XLA's log2 of 8192.0 and 32768.0 lands just below
// 13 and 15, so it charges one bit length less there (ops/txq.py
// GOLOMB_MISFLOORS).
__device__ __forceinline__ int golomb_floor_log2(int big) {  // big >= 1
  return floor_log2(big) - (big == 8192 || big == 32768 ? 1 : 0);
}

// av1_round_shift_array: bit > 0 round-shifts down, bit < 0 scales up.
__device__ __forceinline__ int round_shift_arr(int x, int bit) {
  if (bit > 0) return wrap32((long long)x + (1 << (bit - 1))) >> bit;
  if (bit < 0) return wrap32((long long)x * (1LL << -bit));
  return x;
}

// One 1-D pass over all BS vectors of the block held in X (row-major
// r * BS + c). rows: vectors are rows (elements along c), else columns.
// Returns the buffer that holds the result.
template <int BS, int NT>
__device__ int* pass(int* X, int* Y, const KBArgs& a, int prog) {
  const int off = a.meta[4 * prog], nst = a.meta[4 * prog + 1];
  const int cos_bit = a.meta[4 * prog + 2], clamp_bit = a.meta[4 * prog + 3];
  const bool rows = (prog == 2 || prog == 3 || prog == 4 || prog == 5);
  const int rnd = 1 << (cos_bit - 1);
  const int lo = clamp_bit ? -(1 << (clamp_bit - 1)) : 0;
  const int hi = clamp_bit ? (1 << (clamp_bit - 1)) - 1 : 0;
  for (int st = 0; st < nst; ++st) {
    for (int e = threadIdx.x; e < BS * BS; e += NT) {
      const int v = e / BS, i = e % BS;
      const int* ent = a.progs + 5 * (off + st * BS + i);
      const int ia = ent[0], ib = ent[1], fl = ent[4];
      const int xa = rows ? X[v * BS + ia] : X[ia * BS + v];
      const int xb = rows ? X[v * BS + ib] : X[ib * BS + v];
      int y = wrap32((long long)xa * ent[2] + (long long)xb * ent[3]);
      if (fl & 1) y = wrap32((long long)y + rnd) >> cos_bit;
      if ((fl & 2) && clamp_bit) y = clampi(y, lo, hi);
      if (rows) Y[v * BS + i] = y; else Y[i * BS + v] = y;
    }
    __syncthreads();
    int* t = X; X = Y; Y = t;
  }
  return X;
}

template <int BS>
__global__ void kb_kernel(KBArgs a) {
  constexpr int NT = BS * BS < 256 ? BS * BS : 256;
  constexpr int N = BS * BS;
  __shared__ int buf0[N], buf1[N], lev[N];
  __shared__ long long red64[32];
  __shared__ int red[32];
  __shared__ int s_skip;
  const int b = blockIdx.x;
  const int* src = a.src + b * N;
  const int* pred = a.pred + b * N;
  const int va = a.vadst && a.vadst[b] ? 1 : 0;
  const int ha = a.hadst && a.hadst[b] ? 1 : 0;
  const int* fsh = a.meta + 32;
  const int* ish = a.meta + 35;

  // forward: column pass along H, then row pass along W
  for (int p = threadIdx.x; p < N; p += NT)
    buf0[p] = round_shift_arr(src[p] - pred[p], -fsh[0]);
  __syncthreads();
  int* X = pass<BS, NT>(buf0, buf1, a, 0 + va);
  int* Y = X == buf0 ? buf1 : buf0;
  for (int p = threadIdx.x; p < N; p += NT)
    X[p] = round_shift_arr(X[p], -fsh[1]);
  __syncthreads();
  X = pass<BS, NT>(X, Y, a, 2 + ha);
  Y = X == buf0 ? buf1 : buf0;

  // quantize: coefficient (r, c) has flat index c * BS + r
  const int zf = a.dc_q < 148 ? 84 : 80;
  for (int p = threadIdx.x; p < N; p += NT) {
    const int r = p / BS, c = p % BS, f = c * BS + r;
    const int x = round_shift_arr(X[p], -fsh[2]);
    const int dq = f == 0 ? a.dc_q : a.ac_q;
    const int rnd = (48 * dq) >> 7, zbin = (zf * dq + 64) >> 7;
    const int scaled = wrap32((long long)abs(x) << a.shift);
    int lv = (x > 0) - (x < 0);
    lv *= wrap32((long long)scaled + rnd) / dq;
    if (scaled < zbin) lv = 0;
    lev[f] = clampi(lv, -(1 << 15), (1 << 15) - 1);
  }
  __syncthreads();

  // eob over the scan, and the rate sums (exact: half units, integers)
  int e_loc = 0, nnz = 0, gol = 0;
  long long s2 = 0;
  for (int j = threadIdx.x; j < N; j += NT) {
    if (lev[a.scan[j]] != 0) e_loc = j + 1;
    const int al = abs(lev[j]);
    if (al > 0) {
      ++nnz;
      s2 += (long long)(a.lvl_tbl[al < 15 ? al : 15] * 2.0f);
    }
    if (al >= 15) gol += (2 * golomb_floor_log2(max(al - 14, 1)) + 1) * 512;
  }
  const int eob = block_max<int>(e_loc, red);
  nnz = block_sum<int>(nnz, red);
  gol = block_sum<int>(gol, red);
  s2 = block_sum<long long>(s2, red64);

  // dequantize into the inverse's layout: X[r * BS + c] = coeff(c * BS + r)
  for (int p = threadIdx.x; p < N; p += NT) {
    const int r = p / BS, c = p % BS, f = c * BS + r;
    const int l = lev[f];
    const int dq = f == 0 ? a.dc_q : a.ac_q;
    const int mag = ((abs(l) * dq) & 0xFFFFFF) >> a.shift;
    X[p] = clampi(l < 0 ? -mag : mag, -(1 << 15), (1 << 15) - 1);
  }
  __syncthreads();
  // inverse: row pass, then column pass (bd 8: 16-bit input clamps)
  X = pass<BS, NT>(X, Y, a, 4 + ha);
  Y = X == buf0 ? buf1 : buf0;
  for (int p = threadIdx.x; p < N; p += NT)
    X[p] = clampi(round_shift_arr(X[p], -ish[0]), -(1 << 15), (1 << 15) - 1);
  __syncthreads();
  X = pass<BS, NT>(X, Y, a, 6 + va);

  int ssep = 0, ssec = 0;
  for (int p = threadIdx.x; p < N; p += NT) {
    const int res = round_shift_arr(X[p], -ish[1]);
    const int rec = clampi(pred[p] + res, 0, 255);
    X[p] = rec;
    const int dp = pred[p] - src[p], dc = rec - src[p];
    ssep += dp * dp;
    ssec += dc * dc;
  }
  ssep = block_sum<int>(ssep, red);
  ssec = block_sum<int>(ssec, red);

  if (threadIdx.x == 0) {
    const float fp = (float)ssep, fc = (float)ssec;
    float rate = 0.0f;
    if (eob > 0) {
      rate = (float)((double)s2 * 0.5);
      rate = rate + (float)(eob - nnz) * a.lvl_tbl[0];
      rate = rate + (float)gol;
      int pt = eob <= 2 ? eob : 2 + floor_log2(max(eob - 1, 1));
      pt = clampi(pt, 1, a.neob);
      rate = rate + a.eob_tbl[pt - 1];
    }
    const bool keep = eob > 0;
    const bool skip = keep && (2048.0f * (fp - fc) < (a.rdm[b] / 512.0f) * rate);
    s_skip = skip;
    a.eob[b] = skip ? 0 : eob;
    a.sse[b] = (skip || !keep) ? fp : fc;
    a.rate[b] = (skip || !keep) ? 0.0f : rate;
  }
  __syncthreads();
  const bool skip = s_skip;
  for (int p = threadIdx.x; p < N; p += NT) {
    a.levels[b * N + p] = skip ? 0 : lev[p];
    a.recon[b * N + p] = skip ? pred[p] : X[p];
  }
}

}  // namespace

AV1_EXPORT int txq_recon_skip(const int* src, const int* pred,
                              const bool* vadst, const bool* hadst, int B,
                              int bs, int dc_q, int ac_q, int shift,
                              const int* scan, const float* lvl_tbl,
                              const float* eob_tbl, int neob,
                              const float* rdm, const int* progs,
                              const int* meta, int* levels, int* eob,
                              int* recon, float* sse, float* rate,
                              void* stream) {
  if (B <= 0) return 0;
  KBArgs a{src,     pred,    vadst, hadst, dc_q,  ac_q,   shift, scan,
           lvl_tbl, eob_tbl, neob,  rdm,   progs, meta,   levels, eob,
           recon,   sse,     rate};
  cudaStream_t st = (cudaStream_t)stream;
  switch (bs) {
    case 8: kb_kernel<8><<<B, 64, 0, st>>>(a); break;
    case 16: kb_kernel<16><<<B, 256, 0, st>>>(a); break;
    case 32: kb_kernel<32><<<B, 256, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
