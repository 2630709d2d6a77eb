// Kernel KR: the AV1 2-D transforms of any tx size and type, forward and
// inverse + add at bd 8 / 10 / 12, and the lossless 4x4 Walsh-Hadamard
// pair, over a batch of blocks of one (tx size, tx type) per launch.
//
// Replaces the reference's eager jnp transforms on device arrays
// (aom_av1_psy_tpu/ops/txfm.py: _run_stages :105, _fadst4 / _iadst4
// :129-182, _identity :185, _txfm_1d / _flips :197-216, fwd_txfm2d :227,
// inv_txfm2d_add :266, fwht4x4 :314, iwht4x4_add :343). The plain version
// is ops/txfm.py's *_plain functions.
//
// Bound: bytes. A launch reads each input once and writes each output
// once (4 bytes a coefficient, the inverse's prediction and recon; the
// inverse needs only the coded min(W, 32) x min(H, 32) corner of its
// coefficients), and its integer work (~2 n log2 n operations a 1-D
// vector) is a few percent of the card's rate: at a 1080p luma's blocks
// 4.99 us forward, 7.48 us inverse (5.61 us at 64x64, 6.24 us at 16x64;
// chip_smoke.bound). On an NVIDIA H100 80GB HBM3 at 700 W the first
// design (a thread a vector, its values in a local array indexed from a
// stage table read at run time) took 5-80x that, in local memory; this
// one's device time, with the L2 flushed before each call, is 1.2-2.0x
// it, and 2.8x at the 64x64 inverse, the shape with the fewest warps an
// SM (chip_smoke.py phase 3h).
//
// Design:
// - each 1-D program is straight-line register code generated from the
//   normative stage data (kr_programs.cuh, tools/gen_kr_programs.py):
//   compile-time indices and weights, no memory access in a transform;
//   ADST4 is txfm.cuh's sinpi code, IDTX its scale;
// - a kernel instantiation per tx size and direction (KrPlan<TS, INV>):
//   shifts, cos bits, the rescale and every stride are constants, and the
//   index math is shifts and masks; each pass switches on its 1-D kind
//   (DCT / ADST / IDTX, FLIPADST being ADST with the flips) in
//   warp-uniform code;
// - a CTA of T threads stages G blocks in shared memory (tile A [r][c],
//   tile B [c][r], rows padded so that int4 row accesses and scalar
//   column accesses are free of bank conflicts). Each pass spreads the
//   G x (vectors a block) vectors over all T = G x min(W, H) threads
//   (1, 2 or 4 each), so no thread idles in either pass, save in the
//   64x64 inverse's row pass (32 coded rows a block for 64 threads: a
//   thread a column keeps twice the warps in its longer column pass);
// - blocks move between global and shared memory as int4, neighbouring
//   threads on neighbouring addresses, up to 8 loads of a thread in flight
//   together (copy_quads); the inverse reads only the coded
//   32 x 32 corner of a 64-point size and takes the rest as zero (the
//   reference zeroes it), so its row pass skips rows 32-63;
// - 4x4 and the WHT pair: a thread a block, its 16 values read and written
//   as four int4, no shared memory.
//
// int32 wraparound as jnp's: every product and sum is taken in 32-bit
// unsigned arithmetic (txfm.cuh's add32 / mul32), so the bits equal an
// int64 product truncated to int32, before each shift and clamp.
#include "kr_programs.cuh"

namespace {

enum { kDct = 0, kAdst = 1, kIdtx = 2 };   // ops/txfm.KR_DCT / _ADST / _IDTX
constexpr int kNewSqrt2 = 5793, kNewInvSqrt2 = 2896, kSqrt2Bits = 12;
constexpr int kTpb = 128;   // threads a CTA of the thread-a-block kernels

__device__ __forceinline__ int rshift_round(int x, int bit) {
  return add32(x, 1 << (bit - 1)) >> bit;
}

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void st4(int* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}

// The 1-D transform of ``kind`` over x[0..N) at cos bit CB; the inverse
// programs clamp their flagged stage outputs to [lo, hi].
template <int N, int CB, bool INV>
__device__ __forceinline__ void tx1d(int (&x)[N], int kind, int lo, int hi) {
  if (kind == kIdtx) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int v = x[i];
      x[i] = N == 4    ? rshift_round(mul32(v, kNewSqrt2), kSqrt2Bits)
             : N == 8  ? mul32(v, 2)
             : N == 16 ? rshift_round(mul32(v, 2 * kNewSqrt2), kSqrt2Bits)
                       : mul32(v, 4);
    }
    return;
  }
  if (kind == kAdst) {
    if constexpr (N == 4) {
      const int s[5] = {0, kr_sinpi(CB, 1), kr_sinpi(CB, 2), kr_sinpi(CB, 3),
                        kr_sinpi(CB, 4)};
      const int x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = adst4_lane(x0, x1, x2, x3, s, CB, INV, i);
    } else if constexpr (N == 8) {
      if constexpr (INV) kr_iadst8<CB, true>(x, lo, hi);
      else kr_fadst8<CB, false>(x, lo, hi);
    } else if constexpr (N == 16) {
      if constexpr (INV) kr_iadst16<CB, true>(x, lo, hi);
      else kr_fadst16<CB, false>(x, lo, hi);
    }
    return;
  }
  if constexpr (N == 4) {
    if constexpr (INV) kr_idct4<CB, true>(x, lo, hi);
    else kr_fdct4<CB, false>(x, lo, hi);
  } else if constexpr (N == 8) {
    if constexpr (INV) kr_idct8<CB, true>(x, lo, hi);
    else kr_fdct8<CB, false>(x, lo, hi);
  } else if constexpr (N == 16) {
    if constexpr (INV) kr_idct16<CB, true>(x, lo, hi);
    else kr_fdct16<CB, false>(x, lo, hi);
  } else if constexpr (N == 32) {
    if constexpr (INV) kr_idct32<CB, true>(x, lo, hi);
    else kr_fdct32<CB, false>(x, lo, hi);
  } else {
    if constexpr (INV) kr_idct64<CB, true>(x, lo, hi);
    else kr_fdct64<CB, false>(x, lo, hi);
  }
}

// The CTA's copy of n quads, k = tid + j T (j < NJ): load(k) for up to 8
// quads at once, so that their loads are in flight together, then use(k,
// the quad) for each.
template <int NJ, int T, typename Load, typename Use>
__device__ __forceinline__ void copy_quads(unsigned tid, unsigned n, Load load,
                                           Use use) {
  constexpr int C = NJ < 8 ? NJ : 8;
#pragma unroll
  for (int j0 = 0; j0 < NJ; j0 += C) {
    int4 v[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (tid + (j0 + j) * T < n) v[j] = load(tid + (j0 + j) * T);
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (tid + (j0 + j) * T < n) use(tid + (j0 + j) * T, v[j]);
  }
}

template <int N>
__device__ __forceinline__ void reverse(int (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int t = x[i];
    x[i] = x[N - 1 - i];
    x[N - 1 - i] = t;
  }
}

// The forward transform of B (H, W) residual blocks into (W, H)
// coefficients (flat c*H + r), G blocks a CTA.
template <int TS>
__global__ void __launch_bounds__(KrPlan<TS, false>::T)
    kr_fwd_kernel(const int* __restrict__ res, int* __restrict__ out, int B,
                  int vkind, int hkind, int ud_flip, int lr_flip) {
  using P = KrPlan<TS, false>;
  constexpr int W = P::W, H = P::H, G = P::G, T = P::T, Q = W * H / 4;
  __shared__ __align__(16) int smem[G * (P::BA + P::BB)];
  int* const ta = smem;               // [g][r][c]
  int* const tb = smem + G * P::BA;   // [g][c][r]
  const int b0 = blockIdx.x * G, nb = min(G, B - b0);
  const unsigned tid = threadIdx.x;
  const int4* src = reinterpret_cast<const int4*>(res) + (long long)b0 * Q;
  // stage: residual row r (ud-flipped) into tile A
  copy_quads<G * Q / T, T>(
      tid, nb * Q, [&](unsigned k) { return __ldg(src + k); },
      [&](unsigned k, int4 v) {
        const unsigned g = k / Q, r = k % Q / (W / 4), q = k % (W / 4);
        const unsigned rr = ud_flip ? H - 1 - r : r;
        st4(ta + g * P::BA + rr * P::RA + 4 * q, v);
      });
  __syncthreads();
  // column pass: W vectors of H a block
#pragma unroll 1
  for (unsigned i = tid; i < nb * W; i += T) {
    int* col = ta + i / W * P::BA + i % W;
    int x[H];
#pragma unroll
    for (int r = 0; r < H; ++r) x[r] = round_shift_arr(col[r * P::RA], -P::SH0);
    tx1d<H, P::CB1, false>(x, vkind, 0, 0);
#pragma unroll
    for (int r = 0; r < H; ++r) col[r * P::RA] = round_shift_arr(x[r], -P::SH1);
  }
  __syncthreads();
  // row pass: H vectors of W a block (lr-flipped), into tile B
#pragma unroll 1
  for (unsigned i = tid; i < nb * H; i += T) {
    const unsigned g = i / H, r = i % H;
    const int* row = ta + g * P::BA + r * P::RA;
    int x[W];
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const int4 v = ld4(row + 4 * q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
    if (lr_flip) reverse(x);
    tx1d<W, P::CB2, false>(x, hkind, 0, 0);
    int* dst = tb + g * P::BB + r;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      int v = round_shift_arr(x[c], -P::SH2);
      if (P::RECT) v = rshift_round(mul32(v, kNewSqrt2), kSqrt2Bits);
      dst[c * P::RB] = v;
    }
  }
  __syncthreads();
  // store: tile B's rows are the coefficient layout
  int4* dst = reinterpret_cast<int4*>(out) + (long long)b0 * Q;
  copy_quads<G * Q / T, T>(
      tid, nb * Q,
      [&](unsigned k) {
        const unsigned g = k / Q, c = k % Q / (H / 4), q = k % (H / 4);
        return ld4(tb + g * P::BB + c * P::RB + 4 * q);
      },
      [&](unsigned k, int4 v) { dst[k] = v; });
}

// The inverse transform of B (W, H) coefficient blocks, added to the
// (H, W) predictions and clipped to bd bits, G blocks a CTA. Input clamps
// at bd + 8 (rows) and max(bd + 6, 16) (columns), the stage clamp at
// ``stage_bits``.
template <int TS>
__global__ void __launch_bounds__(KrPlan<TS, true>::T)
    kr_inv_kernel(const int* __restrict__ coeff, const int* __restrict__ pred,
                  int* __restrict__ out, int B, int vkind, int hkind,
                  int ud_flip, int lr_flip, int bd, int stage_bits) {
  using P = KrPlan<TS, true>;
  constexpr int W = P::W, H = P::H, HR = P::HR, CW = P::CW, G = P::G;
  constexpr int T = P::T, Q = W * H / 4, QB = CW * HR / 4;
  __shared__ __align__(16) int smem[G * (P::BA + P::BB)];
  int* const ta = smem;               // [g][r][c]
  int* const tb = smem + G * P::BA;   // [g][c][r], c < CW, r < HR
  const int b0 = blockIdx.x * G, nb = min(G, B - b0);
  const unsigned tid = threadIdx.x;
  const int ha = 1 << (bd + 7), hb = 1 << (max(bd + 6, 16) - 1);
  const int hs = 1 << (stage_bits - 1);
  // stage: the coded corner (c < CW, r < HR) of each block into tile B
  const int4* src = reinterpret_cast<const int4*>(coeff) + (long long)b0 * Q;
  copy_quads<G * QB / T, T>(
      tid, nb * QB,
      [&](unsigned k) {
        const unsigned g = k / QB, c = k % QB / (HR / 4), q = k % (HR / 4);
        return __ldg(src + g * Q + c * (H / 4) + q);
      },
      [&](unsigned k, int4 v) {
        const unsigned g = k / QB, c = k % QB / (HR / 4), q = k % (HR / 4);
        st4(tb + g * P::BB + c * P::RB + 4 * q, v);
      });
  __syncthreads();
  // row pass: HR vectors of W a block (columns c >= CW are 0), into tile
  // A lr-flipped
#pragma unroll 1
  for (unsigned i = tid; i < nb * HR; i += T) {
    const unsigned g = i / HR, r = i % HR;
    const int* s = tb + g * P::BB + r;
    int x[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      int v = c < CW ? s[c * P::RB] : 0;
      if (P::RECT) v = rshift_round(mul32(v, kNewInvSqrt2), kSqrt2Bits);
      x[c] = clampi(v, -ha, ha - 1);
    }
    tx1d<W, P::CB1, true>(x, hkind, -hs, hs - 1);
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = round_shift_arr(x[c], -P::SH0);
    if (lr_flip) reverse(x);
    int* row = ta + g * P::BA + r * P::RA;
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      st4(row + 4 * q,
          make_int4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
  }
  __syncthreads();
  // column pass: W vectors of H a block (rows r >= HR are 0), in place
#pragma unroll 1
  for (unsigned i = tid; i < nb * W; i += T) {
    int* col = ta + i / W * P::BA + i % W;
    int x[H];
#pragma unroll
    for (int r = 0; r < H; ++r)
      x[r] = r < HR ? clampi(col[r * P::RA], -hb, hb - 1) : 0;
    tx1d<H, P::CB2, true>(x, vkind, -hs, hs - 1);
#pragma unroll
    for (int r = 0; r < H; ++r) col[r * P::RA] = round_shift_arr(x[r], -P::SH1);
  }
  __syncthreads();
  // recon: prediction row r + residual row r (ud-flipped), clipped
  const int pmax = (1 << bd) - 1;
  const int4* p4 = reinterpret_cast<const int4*>(pred) + (long long)b0 * Q;
  int4* o4 = reinterpret_cast<int4*>(out) + (long long)b0 * Q;
  copy_quads<G * Q / T, T>(
      tid, nb * Q, [&](unsigned k) { return __ldg(p4 + k); },
      [&](unsigned k, int4 p) {
        const unsigned g = k / Q, r = k % Q / (W / 4), q = k % (W / 4);
        const unsigned rr = ud_flip ? H - 1 - r : r;
        const int4 d = ld4(ta + g * P::BA + rr * P::RA + 4 * q);
        o4[k] = make_int4(clampi(add32(p.x, d.x), 0, pmax),
                          clampi(add32(p.y, d.y), 0, pmax),
                          clampi(add32(p.z, d.z), 0, pmax),
                          clampi(add32(p.w, d.w), 0, pmax));
      });
}

// TX_4X4, a thread a block: res (B, 4, 4) -> coefficients (B, 4, 4) in
// the (W, H) layout.
__global__ void __launch_bounds__(kTpb)
    kr_fwd_kernel_4x4(const int* __restrict__ res, int* __restrict__ out,
                      int B, int vkind, int hkind, int ud_flip, int lr_flip) {
  using P = KrPlan<0, false>;
  const long long b = (long long)blockIdx.x * kTpb + threadIdx.x;
  if (b >= B) return;
  const int4* src = reinterpret_cast<const int4*>(res) + b * 4;
  int m[4][4];   // m[r][c]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int4 v = __ldg(src + (ud_flip ? 3 - r : r));
    m[r][0] = v.x;
    m[r][1] = v.y;
    m[r][2] = v.z;
    m[r][3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = round_shift_arr(m[r][c], -P::SH0);
    tx1d<4, P::CB1, false>(x, vkind, 0, 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) m[r][c] = round_shift_arr(x[r], -P::SH1);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int x[4] = {m[r][0], m[r][1], m[r][2], m[r][3]};
    if (lr_flip) reverse(x);
    tx1d<4, P::CB2, false>(x, hkind, 0, 0);
#pragma unroll
    for (int c = 0; c < 4; ++c) m[r][c] = round_shift_arr(x[c], -P::SH2);
  }
  int4* dst = reinterpret_cast<int4*>(out) + b * 4;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    dst[c] = make_int4(m[0][c], m[1][c], m[2][c], m[3][c]);
}

// TX_4X4 inverse, a thread a block.
__global__ void __launch_bounds__(kTpb)
    kr_inv_kernel_4x4(const int* __restrict__ coeff,
                      const int* __restrict__ pred, int* __restrict__ out,
                      int B, int vkind, int hkind, int ud_flip, int lr_flip,
                      int bd, int stage_bits) {
  using P = KrPlan<0, true>;
  const long long b = (long long)blockIdx.x * kTpb + threadIdx.x;
  if (b >= B) return;
  const int ha = 1 << (bd + 7), hb = 1 << (max(bd + 6, 16) - 1);
  const int hs = 1 << (stage_bits - 1);
  const int4* src = reinterpret_cast<const int4*>(coeff) + b * 4;
  int m[4][4];   // m[c][r]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int4 v = __ldg(src + c);
    m[c][0] = v.x;
    m[c][1] = v.y;
    m[c][2] = v.z;
    m[c][3] = v.w;
  }
  int d[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = clampi(m[c][r], -ha, ha - 1);
    tx1d<4, P::CB1, true>(x, hkind, -hs, hs - 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = round_shift_arr(x[c], -P::SH0);
    if (lr_flip) reverse(x);
#pragma unroll
    for (int c = 0; c < 4; ++c) d[r][c] = x[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = clampi(d[r][c], -hb, hb - 1);
    tx1d<4, P::CB2, true>(x, vkind, -hs, hs - 1);
    if (ud_flip) reverse(x);
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r][c] = round_shift_arr(x[r], -P::SH1);
  }
  const int pmax = (1 << bd) - 1;
  const int4* p4 = reinterpret_cast<const int4*>(pred) + b * 4;
  int4* o4 = reinterpret_cast<int4*>(out) + b * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int4 p = __ldg(p4 + r);
    o4[r] = make_int4(clampi(add32(p.x, d[r][0]), 0, pmax),
                      clampi(add32(p.y, d[r][1]), 0, pmax),
                      clampi(add32(p.z, d[r][2]), 0, pmax),
                      clampi(add32(p.w, d[r][3]), 0, pmax));
  }
}

// av1_fwht4x4_c's butterfly: outputs (a, c, d, b).
__device__ __forceinline__ void fwht_pass(int x0, int x1, int x2, int x3,
                                          int* o) {
  const int a1 = add32(x0, x1), d1 = sub32(x3, x2);
  const int e1 = sub32(a1, d1) >> 1;
  const int b1 = sub32(e1, x1), c1 = sub32(e1, x2);
  o[0] = sub32(a1, c1);
  o[1] = c1;
  o[2] = add32(d1, b1);
  o[3] = b1;
}

// av1_highbd_iwht4x4_16_add_c's butterfly: outputs (a, b, c, d).
__device__ __forceinline__ void iwht_pass(int x0, int x1, int x2, int x3,
                                          int* o) {
  const int a1 = add32(x0, x1), d1 = sub32(x2, x3);
  const int e1 = sub32(a1, d1) >> 1;
  const int b1 = sub32(e1, x3), c1 = sub32(e1, x1);
  o[0] = sub32(a1, b1);
  o[1] = b1;
  o[2] = c1;
  o[3] = add32(d1, c1);
}

__device__ __forceinline__ void load16(int (&x)[16], const int4* p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = __ldg(p + q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

// res (B, 4, 4) natural -> (B, 4, 4) coefficients: pass 1 down each
// column c gives inter[c][k]; pass 2 over inter[j][i] for each i gives
// out[j][i], times 4.
__global__ void __launch_bounds__(kTpb)
    kr_fwht_kernel(const int* __restrict__ res, int* __restrict__ out,
                   int B) {
  const long long b = (long long)blockIdx.x * kTpb + threadIdx.x;
  if (b >= B) return;
  int x[16], inter[16], y[16], o[4];
  load16(x, reinterpret_cast<const int4*>(res) + b * 4);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    fwht_pass(x[c], x[4 + c], x[8 + c], x[12 + c], o);
#pragma unroll
    for (int k = 0; k < 4; ++k) inter[c * 4 + k] = o[k];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fwht_pass(inter[i], inter[4 + i], inter[8 + i], inter[12 + i], o);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j * 4 + i] = mul32(o[j], 4);
  }
  int4* dst = reinterpret_cast<int4*>(out) + b * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[q] = make_int4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
}

// coeff (B, 4, 4) in the C layout -> recon: x = coeff >> 2; pass 1 over
// x[0..3][k] for each k gives inter[j][k]; pass 2 over inter[i][0..3]
// for each i gives the residual at row j, column i.
__global__ void __launch_bounds__(kTpb)
    kr_iwht_kernel(const int* __restrict__ coeff, const int* __restrict__ pred,
                   int* __restrict__ out, int B, int bd) {
  const long long b = (long long)blockIdx.x * kTpb + threadIdx.x;
  if (b >= B) return;
  int x[16], inter[16], p[16], o[4];
  load16(x, reinterpret_cast<const int4*>(coeff) + b * 4);
  load16(p, reinterpret_cast<const int4*>(pred) + b * 4);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] >>= 2;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    iwht_pass(x[k], x[4 + k], x[8 + k], x[12 + k], o);
#pragma unroll
    for (int j = 0; j < 4; ++j) inter[j * 4 + k] = o[j];
  }
  const int pmax = (1 << bd) - 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    iwht_pass(inter[i * 4], inter[i * 4 + 1], inter[i * 4 + 2],
              inter[i * 4 + 3], o);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[j * 4 + i] = clampi(add32(p[j * 4 + i], o[j]), 0, pmax);
  }
  int4* dst = reinterpret_cast<int4*>(out) + b * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[q] = make_int4(p[4 * q], p[4 * q + 1], p[4 * q + 2], p[4 * q + 3]);
}

// Launch tx size ``ts``'s instantiation (TS = ts, searched from 1 up; 0
// is the thread-a-block kernel).
template <int TS>
void fwd_at(int ts, const int* res, int* out, int B, int vk, int hk, int ud,
            int lr, cudaStream_t s) {
  using P = KrPlan<TS, false>;
  if (ts == TS) {
    kr_fwd_kernel<TS><<<(B + P::G - 1) / P::G, P::T, 0, s>>>(res, out, B, vk,
                                                          hk, ud, lr);
  } else if constexpr (TS + 1 < 19) {
    fwd_at<TS + 1>(ts, res, out, B, vk, hk, ud, lr, s);
  }
}

template <int TS>
void inv_at(int ts, const int* coeff, const int* pred, int* out, int B,
            int vk, int hk, int ud, int lr, int bd, int sb, cudaStream_t s) {
  using P = KrPlan<TS, true>;
  if (ts == TS) {
    kr_inv_kernel<TS><<<(B + P::G - 1) / P::G, P::T, 0, s>>>(
        coeff, pred, out, B, vk, hk, ud, lr, bd, sb);
  } else if constexpr (TS + 1 < 19) {
    inv_at<TS + 1>(ts, coeff, pred, out, B, vk, hk, ud, lr, bd, sb, s);
  }
}

}  // namespace

// Every entry launches on ``stream``, does not synchronise and returns
// cudaGetLastError() (cudaErrorInvalidValue for a tx size outside 0..18).
// Pointers are 16-byte aligned (the wrapper copies a tensor that is not);
// vkind / hkind are the column and row 1-D kinds (0 DCT, 1 ADST or
// FLIPADST, 2 IDTX), the flips those of FLIPADST.
AV1_EXPORT int kr_fwd(const int* res, int* out, int B, int ts, int vkind,
                      int hkind, int ud_flip, int lr_flip,
                      cudaStream_t stream) {
  if (ts < 0 || ts > 18) return (int)cudaErrorInvalidValue;
  if (ts == 0)
    kr_fwd_kernel_4x4<<<(B + kTpb - 1) / kTpb, kTpb, 0, stream>>>(
        res, out, B, vkind, hkind, ud_flip, lr_flip);
  else
    fwd_at<1>(ts, res, out, B, vkind, hkind, ud_flip, lr_flip, stream);
  return (int)cudaGetLastError();
}

AV1_EXPORT int kr_inv(const int* coeff, const int* pred, int* out, int B,
                      int ts, int vkind, int hkind, int ud_flip, int lr_flip,
                      int bd, int stage_bits, cudaStream_t stream) {
  if (ts < 0 || ts > 18) return (int)cudaErrorInvalidValue;
  if (ts == 0)
    kr_inv_kernel_4x4<<<(B + kTpb - 1) / kTpb, kTpb, 0, stream>>>(
        coeff, pred, out, B, vkind, hkind, ud_flip, lr_flip, bd, stage_bits);
  else
    inv_at<1>(ts, coeff, pred, out, B, vkind, hkind, ud_flip, lr_flip, bd,
              stage_bits, stream);
  return (int)cudaGetLastError();
}

AV1_EXPORT int kr_fwht(const int* res, int* out, int B,
                       cudaStream_t stream) {
  kr_fwht_kernel<<<(B + kTpb - 1) / kTpb, kTpb, 0, stream>>>(res, out, B);
  return (int)cudaGetLastError();
}

AV1_EXPORT int kr_iwht(const int* coeff, const int* pred, int* out, int B,
                       int bd, cudaStream_t stream) {
  kr_iwht_kernel<<<(B + kTpb - 1) / kTpb, kTpb, 0, stream>>>(coeff, pred,
                                                             out, B, bd);
  return (int)cudaGetLastError();
}
