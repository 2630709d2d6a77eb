// The 1-D pass of the square AV1 transforms, shared by kernels KB (txq.cu)
// and KP (analyze.cu, through tx_stages on several vectors a lane): the counterpart of the reference's jnp _run_stages
// (aom_av1_psy_tpu/ops/txfm.py:105) and the sinpi-based _fadst4 / _iadst4
// (:129-182).
//
// Layout: every 1-D vector of a block belongs to a group of BS consecutive
// lanes of one warp (a whole warp at BS = 32, a 16-, 8- or 4-lane segment
// below), and lane i holds element i in a register. A butterfly stage is
// y_i = x[ia]·wa + x[ib]·wb, read with two __shfl_sync of width BS: no
// shared memory and no block barrier inside a pass. Between the column and
// the row passes the caller transposes through shared memory padded to
// BS + 1 (one barrier).
//
// The stage programs are the normative tables of ops/txfm_host.
// _compiled_stages, uploaded by ops/txq._programs as one int32 table:
//   stages: per stage entry, one int4 (ia | ib << 8 | is_btf << 16 |
//           clamp << 17, wa, wb, 0), stage s of a pass at off + s·BS;
//   meta:   8 x (offset, n_stages, cos_bit, clamp_bit) in the pass order of
//           ops/txq._PROG_ORDER (fwd dct col, fwd adst col, fwd dct row,
//           fwd adst row, inv dct row, inv adst row, inv dct col, inv adst
//           col), then the forward shifts (3) at 32, the inverse shifts (2)
//           at 35 and 8 x 5 sinpi constants at 37 (kMetaLen ints).
// A kernel copies both into shared memory once per CTA (load_stages):
// lanes read different entries, which constant memory would serialise.
//
// int32 wraparound as jnp's: every product and sum is taken in 32-bit
// unsigned arithmetic and cast back (signed overflow is undefined in C++);
// the truncation always precedes a shift, so the bits equal an int64
// product truncated to int32.
#pragma once

#include "common.cuh"

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMetaLen = 77;

// stage entries of all 8 passes at a block size (ops/txq._programs)
template <int BS>
__host__ __device__ constexpr int stage_rows() {
  return BS == 4 ? 48 : BS == 8 ? 384 : BS == 16 ? 1024 : 1152;
}

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// av1_round_shift_array: bit > 0 round-shifts down, bit < 0 scales up.
__device__ __forceinline__ int round_shift_arr(int x, int bit) {
  if (bit > 0) return add32(x, 1 << (bit - 1)) >> bit;
  if (bit < 0) return (int)((unsigned)x << -bit);
  return x;
}

// Copy the stage table and meta of one block size into shared memory, and
// invert the scan (iscan[scan[j]] = j: each coefficient's scan position)
// (all threads of the CTA; the caller synchronises before the first pass).
// The whole table: copying only a launch's own programs (half of it for
// a DCT-only launch at bs 16) moved no device time; its reads hit L2.
template <int BS>
__device__ __forceinline__ void load_stages(int4* st, int* meta, int* iscan,
                                            const int* g_st,
                                            const int* g_meta,
                                            const int* scan) {
  const int4* src = reinterpret_cast<const int4*>(g_st);
  for (int k = threadIdx.x; k < stage_rows<BS>(); k += blockDim.x)
    st[k] = src[k];
  for (int k = threadIdx.x; k < kMetaLen; k += blockDim.x)
    meta[k] = g_meta[k];
  for (int k = threadIdx.x; k < BS * BS; k += blockDim.x) iscan[scan[k]] = k;
}

// av1_fadst4 / av1_iadst4 (ops/txfm.py:129-182): output i of one 4-vector,
// int32 wraparound throughout, no stage clamp (the reference applies none).
__device__ __forceinline__ int adst4_lane(int x0, int x1, int x2, int x3,
                                          const int* s, int cos_bit,
                                          bool inverse, int i) {
  int o0, o1, o2, o3;
  if (!inverse) {
    int t0 = add32(mul32(s[1], x0), mul32(s[2], x1));
    const int t1 = mul32(s[3], sub32(add32(x0, x1), x3));
    int t2 = sub32(mul32(s[4], x0), mul32(s[1], x1));
    const int t3 = mul32(s[3], x2);
    t0 = add32(t0, mul32(s[4], x3));
    t2 = add32(t2, mul32(s[2], x3));
    o0 = add32(t0, t3);
    o1 = t1;
    o2 = sub32(t2, t3);
    o3 = add32(sub32(t2, t0), t3);
  } else {
    int t0 = add32(mul32(s[1], x0), mul32(s[4], x2));
    int t1 = sub32(mul32(s[2], x0), mul32(s[1], x2));
    const int t3 = mul32(s[3], x1);
    const int t2 = mul32(s[3], add32(sub32(x0, x2), x3));
    t0 = add32(t0, mul32(s[2], x3));
    t1 = sub32(t1, mul32(s[4], x3));
    o0 = add32(t0, t3);
    o1 = add32(t1, t3);
    o2 = t2;
    o3 = sub32(add32(t0, t1), t3);
  }
  const int o = i == 0 ? o0 : i == 1 ? o1 : i == 2 ? o2 : o3;
  return add32(o, 1 << (cos_bit - 1)) >> cos_bit;
}

// Number of stages a pass of either type runs in a warp (a warp may hold
// blocks of both types): the DCT program's count, or the larger of the two
// when ``adst`` blocks can occur.
__device__ __forceinline__ int pass_stages(const int* meta, int dct_prog,
                                           bool adst) {
  const int nd = meta[4 * dct_prog + 1], na = meta[4 * dct_prog + 5];
  return adst && na > nd ? na : nd;
}

// Stages 0 .. nmax - 1 of the pass at table offset ``off`` with ``nst``
// stages, on the V vectors whose element i this lane holds (lane i of
// each group): one entry load serves all V. A stage s >= nst leaves the
// values as they are (see tx_pass). NST > 0 compiles the walk for a pass
// of exactly NST stages (nst and nmax are then NST), unrolled; the caller
// checks the table against it.
template <int BS, int V, int NST = 0>
__device__ __forceinline__ void tx_stages(int (&x)[V], const int4* st,
                                          int off, int nst, int nmax,
                                          int cos_bit, int clamp_bit) {
  const int i = threadIdx.x & (BS - 1);
  const int rnd = 1 << (cos_bit - 1);
  const int lo = clamp_bit ? -(1 << (clamp_bit - 1)) : 0;
  const int hi = clamp_bit ? (1 << (clamp_bit - 1)) - 1 : 0;
  auto stage = [&](int s, bool live) {
    const int4 e = st[off + (live ? s : 0) * BS + i];
    const int ia = e.x & 0xff, ib = (e.x >> 8) & 0xff;
    const bool btf = e.x & (1 << 16), clp = (e.x & (1 << 17)) && clamp_bit;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int xa = __shfl_sync(kFull, x[v], ia, BS);
      const int xb = __shfl_sync(kFull, x[v], ib, BS);
      int y = add32(mul32(xa, e.y), mul32(xb, e.z));
      if (btf) y = add32(y, rnd) >> cos_bit;
      if (clp) y = clampi(y, lo, hi);
      if (live) x[v] = y;
    }
  };
  if (NST > 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) stage(s, true);
  } else {
    for (int s = 0; s < nmax; ++s) stage(s, s < nst);
  }
}

// One 1-D pass of program ``prog`` over the vector this lane's group holds;
// returns this lane's output element. Every lane of the warp must call it
// with the same ``nmax`` (pass_stages): the shuffles run with the full
// mask, and a lane whose program is shorter keeps its value over the
// remaining stages. ADST4 (n_stages < 0) is written out from its sinpi
// constants; at BS = 4 every lane computes it, so the shuffles stay
// converged in warps that mix DCT4 and ADST4 blocks.
template <int BS>
__device__ __forceinline__ int tx_pass(int x, const int4* st,
                                       const int* meta, int prog, int nmax) {
  const int i = threadIdx.x & (BS - 1);
  const int off = meta[4 * prog], nst = meta[4 * prog + 1];
  const int cos_bit = meta[4 * prog + 2], clamp_bit = meta[4 * prog + 3];
  int a4 = 0;
  if (BS == 4) {
    const int x0 = __shfl_sync(kFull, x, 0, 4);
    const int x1 = __shfl_sync(kFull, x, 1, 4);
    const int x2 = __shfl_sync(kFull, x, 2, 4);
    const int x3 = __shfl_sync(kFull, x, 3, 4);
    a4 = adst4_lane(x0, x1, x2, x3, meta + 37 + 5 * prog, cos_bit, prog >= 4,
                    i);
  }
  int v[1] = {x};
  tx_stages<BS, 1>(v, st, off, nst, nmax, cos_bit, clamp_bit);
  return (BS == 4 && nst < 0) ? a4 : v[0];
}
