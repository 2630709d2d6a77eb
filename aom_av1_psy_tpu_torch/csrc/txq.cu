// Kernel KB: txq_recon_skip (the batched entry) and txq_step (the
// wavefronts' in-place entry), one body.
//
// Replaces the reference's transform / quantize / recon / skip-RD chain
// inside the wavefronts: tpu_intra._quantize, _dequantize, _tq_recon,
// _tq_recon_uv (aom_av1_psy_tpu/encoder/tpu_intra.py:129-250, over the jnp
// stage interpreter ops/txfm._run_stages and the sinpi-based
// _fadst4/_iadst4, ops/txfm.py:129-182) and _coeff_rate_est / _skip_rd
// (tpu_intra.py:525-567), and the step glue around them in the wavefronts
// (tpu_intra.py:317-368, :409-452, :282-411): the source and window
// gathers, the float32 costs of the two partition paths, the split choice
// and the scatters of levels, eobs, recon, split and the mode context map.
// With skip = 0 (the uniform-grid wavefronts, which never call _skip_rd) it
// stops after the recon and returns _tq_recon's levels, eob and recon.
//
// Per block: residual -> forward 2-D transform (column then row pass) ->
// zbin-dead-zone quantize -> eob over the scan -> dequantize -> inverse
// 2-D transform (row then column pass) + add + clip -> exact coefficient
// rate estimate -> skip decision (zero the residual when 2048 * sse gain
// is below the lambda-scaled rate).
//
// What bounds it: a diagonal step gives <= 34 blocks (68 for chroma U+V)
// per launch: ~4 MB/s worth of bytes and ~10^6 integer operations, well
// under a microsecond of the card (bs 32, B = 34: 0.00017 ms), so the
// kernel is latency-bound: the chain of dependent stages of the four 1-D
// passes (9 at DCT32) and the barriers between them. Design: one thread
// per element (1024 threads at bs 32; at bs 8 and 4 two and eight blocks
// per CTA, so a CTA has 4 warps). Each 1-D vector sits in the registers of
// BS lanes and every butterfly stage is two warp shuffles and a multiply-
// add (txfm.cuh): no barrier inside a pass, one at each of the two
// transposes (shared memory padded to BS + 1), one per reduction phase.
// The normative stage programs (not hard-coded butterflies) are read from
// a shared-memory table loaded once per CTA, one 16-byte entry per lane
// and stage. Reductions (eob max, nnz, half-unit level sum, golomb bits,
// the two SSEs) go warp shuffle first, then one shared step. Products wrap
// as jnp's int32; the float32 skip-RD and costs run op by op
// (__fmul_rn / __fadd_rn, --fmad=false) in the reference's order; the
// per-level rate sum is exact in half units; floor(log2) is the integer
// bit length, except on the golomb tail, where golomb_floor_log2 repeats
// the reference's float32 mis-floors.
//
// txq_step reads each block where it lies (the source plane by strides,
// KA's prediction and pick, the lambda map by index) and writes its
// results into the plan's maps; the cell launch of a partition step fills
// each cell's local window from the recon buffer, and quad (1, 1)'s launch
// chooses the split and writes the chosen recon and mode context back.
#include "txfm.cuh"

namespace {

// Inputs that every block of a launch shares.
struct KBConst {
  const int* stages;     // (stage_rows, 4): txfm.cuh's int4 entries
  const int* meta;       // (kMetaLen,)
  const int* scan;       // (bs*bs,) the coefficients in scan order
  const float* lvl_tbl;  // (16,) half-integer costs; null without skip
  const float* eob_tbl;  // (neob,)
  int neob, dc_q, ac_q, shift;
  int skip;              // 0: no skip decision (lvl_tbl .. rdm unused)
};

// One block's operands.
struct Blk {
  const int* src;        // bs x bs at row stride src_rs
  const int* pred;       // bs x bs contiguous
  int* levels;           // bs*bs
  int* rec;              // bs x bs at row stride rec_rs
  long long src_rs, rec_rs;
  int va, ha;            // ADST flags of the vertical / horizontal pass
  float rdm;
};

struct Res {
  int eob;
  float sse, rate;
};

template <int BS>
struct Smem {
  static constexpr int N = BS * BS;
  static constexpr int NB = N >= 128 ? 1 : 128 / N;  // blocks per CTA
  static constexpr int NT = NB * N;
  int4 st[stage_rows<BS>()];
  int meta[kMetaLen];
  int iscan[N];
  int tr[NB][BS][BS + 1];
  int tr2[NB][BS][BS + 1];
  int r_eob[32], r_nnz[32], r_gol[32], r_sp[32], r_sc[32];
  long long r_s2[32];
  int split[NB];         // the epilogue's split, per block
};

// Sum (or max) over the lanes of one block within a warp: all 32 lanes at
// bs >= 8, the block's 16 at bs 4 (xor offsets below 16 stay in a half).
template <int BS, typename T>
__device__ __forceinline__ T seg_sum(T v) {
  constexpr int SEG = BS * BS < 32 ? BS * BS : 32;
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
template <int BS>
__device__ __forceinline__ int seg_max(int v) {
  constexpr int SEG = BS * BS < 32 ? BS * BS : 32;
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The reference floors log2(big) of the golomb tail in float32
// (tpu_intra.py:538-541); XLA's log2 of 8192.0 and 32768.0 lands just below
// 13 and 15, so it charges one bit length less there (ops/txq.py
// GOLOMB_MISFLOORS).
__device__ __forceinline__ int golomb_floor_log2(int big) {  // big >= 1
  return floor_log2(big) - (big == 8192 || big == 32768 ? 1 : 0);
}

// av1_quantize_b-domain level of coefficient x (zbin dead zone, 48/128
// rounding, clamp to int16), int32 wraparound as jnp's.
__device__ __forceinline__ int quantize(int x, int dq, int zf, int shift) {
  const int rnd = (48 * dq) >> 7, zbin = (zf * dq + 64) >> 7;
  const unsigned ax = x < 0 ? 0u - (unsigned)x : (unsigned)x;
  const int scaled = (int)(ax << shift);
  int lv = ((x > 0) - (x < 0)) * (add32(scaled, rnd) / dq);
  if (scaled < zbin) lv = 0;
  return clampi(lv, -(1 << 15), (1 << 15) - 1);
}

// One block through the whole chain; the block's threads are the BS*BS
// consecutive threads lb * BS*BS .. of the CTA. Writes the levels and the
// recon (after the skip decision) and returns eob, sse and rate to every
// thread of the block. All threads of the CTA call it (valid or not): it
// holds barriers and full-warp shuffles.
template <int BS>
__device__ __forceinline__ Res kb_block(const KBConst& k, const Blk& q,
                                        bool valid, bool adst, Smem<BS>& sm) {
  constexpr int N = BS * BS, W = N / 32;  // warps per block (0 at bs 4)
  const int t = threadIdx.x, lb = t / N, e = t % N;
  const int g = e / BS, i = e % BS;
  const int* meta = sm.meta;
  const int* fsh = meta + 32;
  const int* ish = meta + 35;

  // column layout: this lane holds element (r, c) = (i, g)
  const int s = valid ? q.src[i * q.src_rs + g] : 0;
  const int p = valid ? q.pred[i * BS + g] : 0;
  int x = round_shift_arr(s - p, -fsh[0]);
  x = tx_pass<BS>(x, sm.st, meta, 0 + q.va, pass_stages(meta, 0, adst));
  sm.tr[lb][i][g] = round_shift_arr(x, -fsh[1]);
  __syncthreads();
  // row layout: element (r, c) = (g, i); coefficient (g, i) has flat
  // index f = i * BS + g
  x = tx_pass<BS>(sm.tr[lb][g][i], sm.st, meta, 2 + q.ha,
                  pass_stages(meta, 2, adst));
  const int f = i * BS + g;
  const int dq = f == 0 ? k.dc_q : k.ac_q;
  const int lv = quantize(round_shift_arr(x, -fsh[2]), dq,
                          k.dc_q < 148 ? 84 : 80, k.shift);

  // eob over the scan, and the rate sums (exact: half units, integers)
  int eob = valid && lv != 0 ? sm.iscan[f] + 1 : 0;
  int nnz = 0, gol = 0;
  long long s2 = 0;
  if (k.skip && valid) {
    const int al = abs(lv);
    if (al > 0) {
      nnz = 1;
      s2 = (long long)(k.lvl_tbl[al < 15 ? al : 15] * 2.0f);
    }
    if (al >= 15) gol = (2 * golomb_floor_log2(max(al - 14, 1)) + 1) * 512;
  }
  eob = seg_max<BS>(eob);
  nnz = seg_sum<BS>(nnz);
  gol = seg_sum<BS>(gol);
  s2 = seg_sum<BS>(s2);
  if constexpr (W > 0) {
    const int lane = t & 31, warp = t >> 5;
    if (lane == 0) {
      sm.r_eob[warp] = eob;
      sm.r_nnz[warp] = nnz;
      sm.r_gol[warp] = gol;
      sm.r_s2[warp] = s2;
    }
    __syncthreads();
    eob = nnz = gol = 0;
    s2 = 0;
#pragma unroll
    for (int w = lb * W; w < lb * W + W; ++w) {
      eob = max(eob, sm.r_eob[w]);
      nnz += sm.r_nnz[w];
      gol += sm.r_gol[w];
      s2 += sm.r_s2[w];
    }
  }

  // dequantize in place: the inverse's input (r, c) = coefficient f
  const int mag = ((abs(lv) * dq) & 0xFFFFFF) >> k.shift;
  x = clampi(lv < 0 ? -mag : mag, -(1 << 15), (1 << 15) - 1);
  // inverse: row pass, then column pass (bd 8: 16-bit input clamps)
  x = tx_pass<BS>(x, sm.st, meta, 4 + q.ha, pass_stages(meta, 4, adst));
  sm.tr2[lb][g][i] =
      clampi(round_shift_arr(x, -ish[0]), -(1 << 15), (1 << 15) - 1);
  __syncthreads();
  x = tx_pass<BS>(sm.tr2[lb][i][g], sm.st, meta, 6 + q.va,
                  pass_stages(meta, 6, adst));
  const int rec = clampi(p + round_shift_arr(x, -ish[1]), 0, 255);

  Res r{eob, 0.0f, 0.0f};
  bool skip = false;
  if (k.skip) {
    int ssep = valid ? (p - s) * (p - s) : 0;
    int ssec = valid ? (rec - s) * (rec - s) : 0;
    ssep = seg_sum<BS>(ssep);
    ssec = seg_sum<BS>(ssec);
    if constexpr (W > 0) {
      const int lane = t & 31, warp = t >> 5;
      if (lane == 0) {
        sm.r_sp[warp] = ssep;
        sm.r_sc[warp] = ssec;
      }
      __syncthreads();
      ssep = ssec = 0;
#pragma unroll
      for (int w = lb * W; w < lb * W + W; ++w) {
        ssep += sm.r_sp[w];
        ssec += sm.r_sc[w];
      }
    }
    // every thread of the block takes the same decision from the same sums
    const float fp = (float)ssep, fc = (float)ssec;
    float rate = 0.0f;
    if (eob > 0) {
      rate = (float)((double)s2 * 0.5);
      rate = __fadd_rn(rate, __fmul_rn((float)(eob - nnz), k.lvl_tbl[0]));
      rate = __fadd_rn(rate, (float)gol);
      int pt = eob <= 2 ? eob : 2 + floor_log2(max(eob - 1, 1));
      pt = clampi(pt, 1, k.neob);
      rate = __fadd_rn(rate, k.eob_tbl[pt - 1]);
    }
    const bool keep = eob > 0;
    skip = keep && __fmul_rn(2048.0f, __fsub_rn(fp, fc)) <
                       __fmul_rn(__fdiv_rn(q.rdm, 512.0f), rate);
    r.eob = skip ? 0 : eob;
    r.sse = (skip || !keep) ? fp : fc;
    r.rate = (skip || !keep) ? 0.0f : rate;
  }
  if (valid) {
    q.levels[f] = skip ? 0 : lv;
    q.rec[i * q.rec_rs + g] = skip ? p : rec;
  }
  return r;
}

// ---------------------------------------------------------------------
// (a) the batched entry: (B, bs, bs) blocks in, (B, ...) outputs
// ---------------------------------------------------------------------
struct KBBatch {
  KBConst k;
  const int* src;       // (B, bs, bs)
  const int* pred;      // (B, bs, bs)
  const bool* vadst;    // (B,) or null (DCT)
  const bool* hadst;    // (B,) or null
  const float* rdm;     // (B,) or null without skip
  int* levels;          // (B, bs*bs)
  int* eob;             // (B,)
  int* recon;           // (B, bs, bs)
  float* sse;           // (B,) or null without skip
  float* rate;          // (B,) or null without skip
  int B;
};

template <int BS>
__global__ void __launch_bounds__(Smem<BS>::NT) kb_batch_kernel(KBBatch a) {
  constexpr int N = BS * BS;
  __shared__ Smem<BS> sm;
  load_stages<BS>(sm.st, sm.meta, sm.iscan, a.k.stages, a.k.meta,
                  a.k.scan);
  __syncthreads();
  const int b = blockIdx.x * Smem<BS>::NB + threadIdx.x / N;
  const bool valid = b < a.B;
  const long long o = valid ? (long long)b * N : 0;
  Blk q{a.src + o, a.pred + o, a.levels + o, a.recon + o, BS, BS,
        valid && a.vadst && a.vadst[b] ? 1 : 0,
        valid && a.hadst && a.hadst[b] ? 1 : 0,
        valid && a.k.skip ? a.rdm[b] : 0.0f};
  const Res r = kb_block<BS>(a.k, q, valid, a.vadst != nullptr, sm);
  if (valid && threadIdx.x % N == 0) {
    a.eob[b] = r.eob;
    if (a.k.skip) {
      a.sse[b] = r.sse;
      a.rate[b] = r.rate;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------
// (b) the in-place step entry (ops/txq.TxqStep; _StepArgs mirrors it)
// ---------------------------------------------------------------------
struct StepArgs {
  const long long* tt;    // (B,) the diagonal's cells: tile, row, column
  const long long* rc;
  const long long* cc;
  const int* src;         // (T, SH, SW) source plane (chroma: U)
  const int* src_v;       // (T, SH, SW) V source plane, or null
  const int* pick;        // (4, B) KA's pick: candidate, mode, delta, rate
  const int* pred;        // (P*B, bs, bs) KA's prediction
  const int* tx_type;     // (13,) INTRA_MODE_TO_TX_TYPE (chroma), or null
  const float* rd;        // (T, MR, MC) lambdas, or null without skip
  const float* rd_cell;   // (T, R, C) the 32 lambdas (luma quad epilogue)
  const float* lvl_tbl;   // (16,)
  const float* eob_tbl;   // (neob,)
  const int* stages;      // txfm.cuh's stage table and meta
  const int* meta;
  const int* scan;        // (bs*bs,)
  int* levels;            // (T, P, MR, MC, bs*bs)
  int* eob;               // (T, P, MR, MC)
  int* buf;               // (P*T, Hb, Wb) recon with a 1-px guard border
  int* loc;               // (P*B, L, L) the cells' local windows, or null
  int* stage;             // (P*B, cs, cs) the cell launch's recon, or null
  float* cost;            // (2, bmax) luma cost32, cost16; or null
  const bool* forced;     // (T, R, C) luma epilogue
  const bool* no_split;   // (T, R, C)
  int* split;             // (T, R, C): luma epilogue writes, chroma reads
  const int* m32;         // (T, R, C) chosen 32 modes (luma)
  const int* m16;         // (T, 2R, 2C) chosen 16 modes
  int* mode16;            // (T, 2R, 2C) the mode context map
  float pr_none, pr_split;
  int B, bmax, bs, P, T, SH, SW, Hb, Wb, MR, MC, R, C;
  int role;               // 0 uniform, 1 partition cell, 2 partition quad
  int qr, qc, dc_q, ac_q, shift, skip, neob;
  int luma;               // 1: the luma plane (P = 1); 0: a U/V pair
};

namespace {

template <int BS>
__global__ void __launch_bounds__(Smem<BS>::NT) kb_step_kernel(StepArgs a) {
  constexpr int N = BS * BS;
  __shared__ Smem<BS> sm;
  load_stages<BS>(sm.st, sm.meta, sm.iscan, a.stages, a.meta, a.scan);
  const int b = blockIdx.x * Smem<BS>::NB + threadIdx.x / N;
  const int e = threadIdx.x % N;
  const bool valid = b < a.P * a.B;
  const int j = valid ? b % a.B : 0, p = valid ? b / a.B : 0;
  const long long tt = valid ? a.tt[j] : 0, rc = valid ? a.rc[j] : 0,
                  cc = valid ? a.cc[j] : 0;
  const bool quad = a.role == 2;
  const int cs = quad ? 2 * BS : BS;           // cell size
  const int L = cs + 2;                        // local window side
  const long long mi = quad ? 2 * rc + a.qr : rc;
  const long long mj = quad ? 2 * cc + a.qc : cc;
  int* bplane = a.buf + (p * a.T + tt) * (long long)a.Hb * a.Wb;
  int* loc = a.loc ? a.loc + (long long)b * L * L : nullptr;

  // the cell launch fills the cell's local window from the recon buffer
  if (a.role == 1 && loc && valid) {
    const int* w = bplane + rc * BS * a.Wb + cc * BS;
    for (int k = e; k < L * L; k += N) loc[k] = w[(k / L) * a.Wb + k % L];
  }

  KBConst k{a.stages, a.meta, a.scan, a.lvl_tbl, a.eob_tbl, a.neob,
            a.dc_q,   a.ac_q, a.shift, a.skip};
  int va = 0, ha = 0;
  if (a.tx_type && valid) {
    const int ty = a.tx_type[a.pick[a.B + j]];
    va = ty == 1 || ty == 3;
    ha = ty == 2 || ty == 3;
  }
  const long long cell = (tt * a.R + rc) * a.C + cc;
  const long long m = (tt * a.MR + mi) * a.MC + mj;
  const long long lm = (tt * a.P + p) * a.MR * a.MC + mi * a.MC + mj;
  Blk q;
  q.src = (p ? a.src_v : a.src) + tt * a.SH * (long long)a.SW +
          (rc * cs + a.qr * BS) * a.SW + cc * cs + a.qc * BS;
  q.src_rs = a.SW;
  q.pred = a.pred + (long long)b * N;
  q.levels = a.levels + lm * N;
  if (a.role == 0) {
    q.rec = bplane + (1 + rc * BS) * a.Wb + 1 + cc * BS;
    q.rec_rs = a.Wb;
  } else if (a.role == 1) {
    q.rec = a.stage + (long long)b * N;
    q.rec_rs = BS;
  } else {
    q.rec = loc + (1 + a.qr * BS) * L + 1 + a.qc * BS;
    q.rec_rs = L;
  }
  q.va = va;
  q.ha = ha;
  q.rdm = a.skip && valid ? a.rd[m] : 0.0f;
  if (!valid) {
    q.src = q.pred = a.pred;
    q.levels = q.rec = nullptr;
  }
  // the 16 path's cost so far (quads (0, 1) .. (1, 1)), read before the
  // barriers of kb_block: its write below comes after them
  const bool acc16 = quad && a.luma && valid && (a.qr | a.qc);
  const float prev16 = acc16 ? a.cost[a.bmax + j] : 0.0f;
  __syncthreads();  // the stage table
  const Res r = kb_block<BS>(k, q, valid, a.tx_type != nullptr, sm);
  const int lb = threadIdx.x / N;
  if (valid && e == 0) a.eob[lm] = r.eob;

  // the float32 RD costs of the partition's luma sites, in the order of
  // tpu_intra.py:329-330 / :350-351; thread 0 of the block writes them and
  // takes the split (the uniform grid prices nothing here)
  float c16 = 0.0f;
  if (a.luma && a.role != 0 && valid && e == 0) {
    const float mrate = (float)a.pick[3 * a.B + j];
    const float lam = __fdiv_rn(q.rdm, 512.0f);
    if (!quad) {
      a.cost[j] = __fadd_rn(
          __fmul_rn(2048.0f, r.sse),
          __fmul_rn(lam, __fadd_rn(__fadd_rn(mrate, r.rate), a.pr_none)));
    } else {
      c16 = __fadd_rn(prev16, __fmul_rn(2048.0f, r.sse));
      c16 = __fadd_rn(c16, __fmul_rn(lam, __fadd_rn(mrate, r.rate)));
      a.cost[a.bmax + j] = c16;
    }
  }
  if (!quad || !a.qr || !a.qc) return;

  // quad (1, 1) finishes the cell (:354-368, :440-452): the split, the
  // chosen recon into the recon buffer, the mode context entries. Thread 0
  // takes the split and shares it with the block through shared memory.
  if (e == 0) {
    bool split = false;
    if (valid) {
      if (a.luma) {
        c16 = __fadd_rn(c16, __fmul_rn(__fdiv_rn(a.rd_cell[cell], 512.0f),
                                       a.pr_split));
        split = a.forced[cell] || (c16 < a.cost[j] && !a.no_split[cell]);
        a.split[cell] = split;
      } else {
        split = a.split[cell] != 0;
      }
    }
    sm.split[lb] = split;
  }
  __syncthreads();  // the split; this block's quads are in its local window
  if (!valid) return;
  const bool split = sm.split[lb] != 0;
  if (a.luma && e < 4) {
    const long long m16 = (tt * 2 * a.R + 2 * rc + (e >> 1)) * 2 * a.C +
                          2 * cc + (e & 1);
    a.mode16[m16] = split ? a.m16[m16] : a.m32[cell];
  }
  const int* stage = a.stage + (long long)b * cs * cs;
  int* out = bplane + (1 + rc * cs) * a.Wb + 1 + cc * cs;
  for (int k2 = e; k2 < cs * cs; k2 += N) {
    const int y = k2 / cs, xx = k2 % cs;
    out[y * a.Wb + xx] = split ? loc[(1 + y) * L + 1 + xx] : stage[k2];
  }
}

template <int BS>
int launch_step(const StepArgs& a, cudaStream_t st) {
  const int nblk = a.P * a.B, nb = Smem<BS>::NB;
  kb_step_kernel<BS><<<(nblk + nb - 1) / nb, Smem<BS>::NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BS>
int launch_batch(const KBBatch& a, cudaStream_t st) {
  const int nb = Smem<BS>::NB;
  kb_batch_kernel<BS><<<(a.B + nb - 1) / nb, Smem<BS>::NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

AV1_EXPORT int txq_recon_skip(const int* src, const int* pred,
                              const bool* vadst, const bool* hadst, int B,
                              int bs, int dc_q, int ac_q, int shift,
                              const int* scan, int skip,
                              const float* lvl_tbl, const float* eob_tbl,
                              int neob, const float* rdm, const int* stages,
                              const int* meta, int* levels, int* eob,
                              int* recon, float* sse, float* rate,
                              void* stream) {
  if (B <= 0) return 0;
  KBBatch a{{stages, meta, scan, lvl_tbl, eob_tbl, neob, dc_q, ac_q, shift,
             skip},
            src, pred, vadst, hadst, rdm, levels, eob, recon, sse, rate, B};
  cudaStream_t st = (cudaStream_t)stream;
  switch (bs) {
    case 4: return launch_batch<4>(a, st);
    case 8: return launch_batch<8>(a, st);
    case 16: return launch_batch<16>(a, st);
    case 32: return launch_batch<32>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

AV1_EXPORT int txq_step(const StepArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  if (a->role < 0 || a->role > 2 || a->P < 1 || a->P > 2 ||
      (a->role == 2 && !a->loc) || (a->role == 1 && !a->stage))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a->bs) {
    case 4: return launch_step<4>(*a, st);
    case 8: return launch_step<8>(*a, st);
    case 16: return launch_step<16>(*a, st);
    case 32: return launch_step<32>(*a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
