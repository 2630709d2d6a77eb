// The stage-program interpreter of the square AV1 transforms, shared by
// kernels KB (txq.cu) and KP (analyze.cu): the counterpart of the
// reference's jnp _run_stages (aom_av1_psy_tpu/ops/txfm.py:105) and the
// sinpi-based _fadst4 / _iadst4 (:129-182). The stage programs are the
// normative tables of ops/txfm._compiled_stages, uploaded by
// ops/txq._programs as one int32 table:
//   progs: per stage entry (ia, ib, wa, wb, is_btf | clamp << 1);
//   meta:  8 x (offset, n_stages, cos_bit, clamp_bit) in the pass order of
//          ops/txq._PROG_ORDER (fwd dct col, fwd adst col, fwd dct row, fwd
//          adst row, inv dct row, inv adst row, inv dct col, inv adst col),
//          then the forward shifts (3) at 32, the inverse shifts (2) at 35
//          and 8 x 5 sinpi constants at 37.
// Products are int64 truncated to int32 (wrap32), so the wraparound equals
// jnp's int32.
#pragma once

#include "common.cuh"

// av1_round_shift_array: bit > 0 round-shifts down, bit < 0 scales up.
__device__ __forceinline__ int round_shift_arr(int x, int bit) {
  if (bit > 0) return wrap32((long long)x + (1 << (bit - 1))) >> bit;
  if (bit < 0) return wrap32((long long)x * (1LL << -bit));
  return x;
}

__device__ __forceinline__ int mul32(int a, int b) {
  return wrap32((long long)a * b);
}

// av1_fadst4 / av1_iadst4 (ops/txfm.py:129-182) on one 4-vector, int32
// wraparound throughout, no stage clamp (the reference applies none).
__device__ inline void adst4(const int* x, int* o, const int* s, int cos_bit,
                      bool inverse) {
  const int rnd = 1 << (cos_bit - 1);
  int t0, t1, t2, t3;
  if (!inverse) {
    t0 = wrap32((long long)mul32(s[1], x[0]) + mul32(s[2], x[1]));
    t1 = mul32(s[3], wrap32((long long)x[0] + x[1] - x[3]));
    t2 = wrap32((long long)mul32(s[4], x[0]) - mul32(s[1], x[1]));
    t3 = mul32(s[3], x[2]);
    t0 = wrap32((long long)t0 + mul32(s[4], x[3]));
    t2 = wrap32((long long)t2 + mul32(s[2], x[3]));
    o[0] = wrap32((long long)t0 + t3);
    o[1] = t1;
    o[2] = wrap32((long long)t2 - t3);
    o[3] = wrap32((long long)t2 - t0 + t3);
  } else {
    t0 = wrap32((long long)mul32(s[1], x[0]) + mul32(s[4], x[2]));
    t1 = wrap32((long long)mul32(s[2], x[0]) - mul32(s[1], x[2]));
    t3 = mul32(s[3], x[1]);
    t2 = mul32(s[3], wrap32((long long)x[0] - x[2] + x[3]));
    t0 = wrap32((long long)t0 + mul32(s[2], x[3]));
    t1 = wrap32((long long)t1 - mul32(s[4], x[3]));
    o[0] = wrap32((long long)t0 + t3);
    o[1] = wrap32((long long)t1 + t3);
    o[2] = t2;
    o[3] = wrap32((long long)t0 + t1 - t3);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = wrap32((long long)o[i] + rnd) >> cos_bit;
}

// One 1-D pass over all BS vectors of the block held in X (row-major
// r * BS + c). rows: vectors are rows (elements along c), else columns.
// Returns the buffer that holds the result.
template <int BS, int NT>
__device__ int* pass(int* X, int* Y, const int* progs, const int* meta,
                     int prog) {
  const int off = meta[4 * prog], nst = meta[4 * prog + 1];
  const int cos_bit = meta[4 * prog + 2], clamp_bit = meta[4 * prog + 3];
  const bool rows = (prog == 2 || prog == 3 || prog == 4 || prog == 5);
  if (BS == 4 && nst < 0) {  // ADST4: one thread per vector
    const int v = threadIdx.x;
    if (v < 4) {
      int x[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = rows ? X[v * 4 + i] : X[i * 4 + v];
      adst4(x, o, meta + 37 + 5 * prog, cos_bit, prog >= 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (rows) Y[v * 4 + i] = o[i]; else Y[i * 4 + v] = o[i];
      }
    }
    __syncthreads();
    return Y;
  }
  const int rnd = 1 << (cos_bit - 1);
  const int lo = clamp_bit ? -(1 << (clamp_bit - 1)) : 0;
  const int hi = clamp_bit ? (1 << (clamp_bit - 1)) - 1 : 0;
  for (int st = 0; st < nst; ++st) {
    for (int e = threadIdx.x; e < BS * BS; e += NT) {
      const int v = e / BS, i = e % BS;
      const int* ent = progs + 5 * (off + st * BS + i);
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
__host__ __device__ constexpr int threads() {
  return BS * BS < 32 ? 32 : (BS * BS < 256 ? BS * BS : 256);
}
