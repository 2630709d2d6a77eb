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
// Design (a simple one that is right; making it fast is later work):
// - a CTA of 128 threads holds G = 128 / V blocks, V = max(w, h) threads
//   a block; each block is staged in shared memory (h rows of w + 1
//   ints: the row pass reads a row a thread without bank conflicts);
// - the first 1-D pass gives each of a block's vectors a thread (forward:
//   the w columns; inverse: the h rows), a barrier, then the second pass
//   gives each vector of the other axis a thread; a thread keeps its
//   vector in a local array and walks the stage program over it;
// - the two programs come from the table ops/txfm.kr_program builds once
//   per (tx size, tx type, direction, bd): stage entries (ia | ib << 8 |
//   is_btf << 16 | clamp << 17, wa, wb, 0), read through the read-only
//   cache (every thread of a pass reads the same entry at once), and 32
//   ints (ops/txfm.META_LEN) of sizes, flips, shifts, clamps and two
//   pass descriptors (kind, n, n_stages, offset, cos_bit, clamp_bit,
//   sinpi 1..4). ADST4 is txfm.cuh's sinpi code, IDTX its scale;
// - the WHT pair: a thread a 4x4 block.
//
// int32 wraparound as jnp's: every product and sum is taken in 32-bit
// unsigned arithmetic (txfm.cuh's add32 / mul32), so the bits equal an
// int64 product truncated to int32, before each shift and clamp.
//
// Bound: bytes (4 bytes a coefficient in and out, and the prediction and
// recon of the inverse) against ~2 n log2 n operations a 1-D vector.
// Local arrays with indices read from the table live in local memory
// (L1): the stage walk, not the memory, sets this design's time.
#include "txfm.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPassLen = 10;   // ops/txfm.PASS_LEN; 12 + 2 x 10 ints
constexpr int kMaxN = 64;
enum { kStages = 0, kAdst4 = 1, kIdtx = 2 };
constexpr int kNewSqrt2 = 5793, kNewInvSqrt2 = 2896, kSqrt2Bits = 12;

struct Meta {
  int w, h, ud_flip, lr_flip, rect, bd, sh[3], clamp_a, clamp_b;
  int pa[kPassLen], pb[kPassLen];
};

__device__ __forceinline__ Meta load_meta(const int* g) {
  Meta m;
  m.w = __ldg(g + 0);
  m.h = __ldg(g + 1);
  m.ud_flip = __ldg(g + 2);
  m.lr_flip = __ldg(g + 3);
  m.rect = __ldg(g + 4);
  m.bd = __ldg(g + 5);
  for (int i = 0; i < 3; ++i) m.sh[i] = __ldg(g + 6 + i);
  m.clamp_a = __ldg(g + 9);
  m.clamp_b = __ldg(g + 10);
  for (int i = 0; i < kPassLen; ++i) {
    m.pa[i] = __ldg(g + 12 + i);
    m.pb[i] = __ldg(g + 12 + kPassLen + i);
  }
  return m;
}

__device__ __forceinline__ int rshift_round(int x, int bit) {
  return add32(x, 1 << (bit - 1)) >> bit;
}

__device__ __forceinline__ int clamp_bits(int x, int bits) {
  return clampi(x, -(1 << (bits - 1)), (1 << (bits - 1)) - 1);
}

// One 1-D program (descriptor p) over x[0..n): the stage walk, ADST4 or
// IDTX; y is scratch. The reference's order of int32 operations.
__device__ void tx1d(int* x, int* y, const int* p, const int4* st,
                     bool inverse) {
  const int kind = p[0], n = p[1];
  if (kind == kIdtx) {
    for (int i = 0; i < n; ++i) {
      const int v = x[i];
      x[i] = n == 4    ? rshift_round(mul32(v, kNewSqrt2), kSqrt2Bits)
             : n == 8  ? mul32(v, 2)
             : n == 16 ? rshift_round(mul32(v, 2 * kNewSqrt2), kSqrt2Bits)
                       : mul32(v, 4);
    }
    return;
  }
  const int cos_bit = p[4];
  if (kind == kAdst4) {
    const int s[5] = {0, p[6], p[7], p[8], p[9]};
    const int x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    for (int i = 0; i < 4; ++i)
      x[i] = adst4_lane(x0, x1, x2, x3, s, cos_bit, inverse, i);
    return;
  }
  const int nst = p[2], off = p[3], clamp_bit = p[5];
  const int rnd = 1 << (cos_bit - 1);
  for (int s = 0; s < nst; ++s) {
    const int4* row = st + off + s * n;
    for (int i = 0; i < n; ++i) {
      const int4 e = __ldg(row + i);
      int v = add32(mul32(x[e.x & 0xff], e.y), mul32(x[(e.x >> 8) & 0xff],
                                                     e.z));
      if (e.x & (1 << 16)) v = add32(v, rnd) >> cos_bit;
      if ((e.x & (1 << 17)) && clamp_bit) v = clamp_bits(v, clamp_bit);
      y[i] = v;
    }
    for (int i = 0; i < n; ++i) x[i] = y[i];
  }
}

// The forward transform of B (H, W) residual blocks into (W, H)
// coefficients (flat c*H + r).
__global__ void __launch_bounds__(kThreads)
    kr_fwd_kernel(const int* __restrict__ res, int* __restrict__ out, int B,
                  const int4* __restrict__ st, const int* __restrict__ gm) {
  extern __shared__ int tile[];
  const Meta m = load_meta(gm);
  const int w = m.w, h = m.h, ws = w + 1, n_px = w * h;
  const int V = w > h ? w : h, G = kThreads / V;
  const int g = threadIdx.x / V, t = threadIdx.x % V;
  const long long b0 = (long long)blockIdx.x * G;
  // stage: T[r][c] = res[ud_flip ? h-1-r : r][c]
  for (int k = threadIdx.x; k < G * n_px; k += kThreads) {
    const int gg = k / n_px, rem = k - gg * n_px;
    if (b0 + gg >= B) continue;
    const int r = rem / w, c = rem - r * w;
    const int rr = m.ud_flip ? h - 1 - r : r;
    tile[gg * h * ws + rr * ws + c] = res[(b0 + gg) * n_px + rem];
  }
  __syncthreads();
  int* T = tile + g * h * ws;
  const bool live = b0 + g < B;
  int x[kMaxN], y[kMaxN];
  if (live && t < w) {  // column pass: vector t of length h
    for (int r = 0; r < h; ++r)
      x[r] = round_shift_arr(T[r * ws + t], -m.sh[0]);
    tx1d(x, y, m.pa, st, false);
    for (int r = 0; r < h; ++r)
      T[r * ws + t] = round_shift_arr(x[r], -m.sh[1]);
  }
  __syncthreads();
  if (live && t < h) {  // row pass: vector t of length w, lr-flipped
    int* R = T + t * ws;
    for (int c = 0; c < w; ++c) x[c] = R[m.lr_flip ? w - 1 - c : c];
    tx1d(x, y, m.pb, st, false);
    for (int c = 0; c < w; ++c) {
      int v = round_shift_arr(x[c], -m.sh[2]);
      if (m.rect) v = rshift_round(mul32(v, kNewSqrt2), kSqrt2Bits);
      R[c] = v;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < G * n_px; k += kThreads) {
    const int gg = k / n_px, rem = k - gg * n_px;
    if (b0 + gg >= B) continue;
    const int c = rem / h, r = rem - c * h;
    out[(b0 + gg) * n_px + rem] = tile[gg * h * ws + r * ws + c];
  }
}

// The inverse transform of B (W, H) coefficient blocks, added to the
// (H, W) predictions and clipped to bd bits.
__global__ void __launch_bounds__(kThreads)
    kr_inv_kernel(const int* __restrict__ coeff, const int* __restrict__ pred,
                  int* __restrict__ out, int B, const int4* __restrict__ st,
                  const int* __restrict__ gm) {
  extern __shared__ int tile[];
  const Meta m = load_meta(gm);
  const int w = m.w, h = m.h, ws = w + 1, n_px = w * h;
  const int V = w > h ? w : h, G = kThreads / V;
  const int g = threadIdx.x / V, t = threadIdx.x % V;
  const long long b0 = (long long)blockIdx.x * G;
  // stage: T[r][c] = coeff[c][r], zero beyond index 31 (64-point sizes)
  for (int k = threadIdx.x; k < G * n_px; k += kThreads) {
    const int gg = k / n_px, rem = k - gg * n_px;
    if (b0 + gg >= B) continue;
    const int c = rem / h, r = rem - c * h;
    const int v = coeff[(b0 + gg) * n_px + rem];
    tile[gg * h * ws + r * ws + c] = (c < 32 && r < 32) ? v : 0;
  }
  __syncthreads();
  int* T = tile + g * h * ws;
  const bool live = b0 + g < B;
  int x[kMaxN], y[kMaxN];
  if (live && t < h) {  // row pass: vector t of length w
    int* R = T + t * ws;
    for (int c = 0; c < w; ++c) {
      int v = R[c];
      if (m.rect) v = rshift_round(mul32(v, kNewInvSqrt2), kSqrt2Bits);
      x[c] = clamp_bits(v, m.clamp_a);
    }
    tx1d(x, y, m.pa, st, true);
    for (int c = 0; c < w; ++c)
      R[m.lr_flip ? w - 1 - c : c] = round_shift_arr(x[c], -m.sh[0]);
  }
  __syncthreads();
  if (live && t < w) {  // column pass: vector t of length h, ud-flipped
    for (int r = 0; r < h; ++r) x[r] = clamp_bits(T[r * ws + t], m.clamp_b);
    tx1d(x, y, m.pb, st, true);
    for (int r = 0; r < h; ++r)
      T[(m.ud_flip ? h - 1 - r : r) * ws + t] =
          round_shift_arr(x[r], -m.sh[1]);
  }
  __syncthreads();
  const int pmax = (1 << m.bd) - 1;
  for (int k = threadIdx.x; k < G * n_px; k += kThreads) {
    const int gg = k / n_px, rem = k - gg * n_px;
    if (b0 + gg >= B) continue;
    const int r = rem / w, c = rem - r * w;
    const long long at = (b0 + gg) * n_px + rem;
    out[at] = clampi(add32(pred[at], tile[gg * h * ws + r * ws + c]), 0,
                     pmax);
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

// res (B, 4, 4) natural -> (B, 4, 4) coefficients: pass 1 down each
// column c gives inter[c][k]; pass 2 over inter[j][i] for each i gives
// out[j][i], times 4.
__global__ void __launch_bounds__(kThreads)
    kr_fwht_kernel(const int* __restrict__ res, int* __restrict__ out,
                   int B) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  int x[16], inter[16], o[4];
  for (int i = 0; i < 16; ++i) x[i] = res[b * 16 + i];
  for (int c = 0; c < 4; ++c) {
    fwht_pass(x[c], x[4 + c], x[8 + c], x[12 + c], o);
    for (int k = 0; k < 4; ++k) inter[c * 4 + k] = o[k];
  }
  for (int i = 0; i < 4; ++i) {
    fwht_pass(inter[i], inter[4 + i], inter[8 + i], inter[12 + i], o);
    for (int j = 0; j < 4; ++j) out[b * 16 + j * 4 + i] = mul32(o[j], 4);
  }
}

// coeff (B, 4, 4) in the C layout -> recon: x = coeff >> 2; pass 1 over
// x[0..3][k] for each k gives inter[j][k]; pass 2 over inter[i][0..3]
// for each i gives the residual at row j, column i.
__global__ void __launch_bounds__(kThreads)
    kr_iwht_kernel(const int* __restrict__ coeff, const int* __restrict__ pred,
                   int* __restrict__ out, int B, int bd) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  int x[16], inter[16], o[4];
  for (int i = 0; i < 16; ++i) x[i] = coeff[b * 16 + i] >> 2;
  for (int k = 0; k < 4; ++k) {
    iwht_pass(x[k], x[4 + k], x[8 + k], x[12 + k], o);
    for (int j = 0; j < 4; ++j) inter[j * 4 + k] = o[j];
  }
  const int pmax = (1 << bd) - 1;
  for (int i = 0; i < 4; ++i) {
    iwht_pass(inter[i * 4], inter[i * 4 + 1], inter[i * 4 + 2],
              inter[i * 4 + 3], o);
    for (int j = 0; j < 4; ++j) {
      const long long at = b * 16 + j * 4 + i;
      out[at] = clampi(add32(pred[at], o[j]), 0, pmax);
    }
  }
}

// CTAs and shared bytes of a launch of B (w, h) blocks (G a CTA)
void kr_grid(int w, int h, int B, int* grid, size_t* smem) {
  const int V = w > h ? w : h, G = kThreads / V;
  *grid = (B + G - 1) / G;
  *smem = (size_t)G * h * (w + 1) * sizeof(int);
}

}  // namespace

// Every entry launches on ``stream``, does not synchronise and returns
// cudaGetLastError(); w and h are the table's own (meta[0], meta[1]),
// passed by the wrapper so that the grid needs no read of the table.
AV1_EXPORT int kr_fwd(const int* res, int* out, int B, int w, int h,
                      const int* stages, const int* meta,
                      cudaStream_t stream) {
  int grid;
  size_t smem;
  kr_grid(w, h, B, &grid, &smem);
  kr_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      res, out, B, reinterpret_cast<const int4*>(stages), meta);
  return (int)cudaGetLastError();
}

AV1_EXPORT int kr_inv(const int* coeff, const int* pred, int* out, int B,
                      int w, int h, const int* stages, const int* meta,
                      cudaStream_t stream) {
  int grid;
  size_t smem;
  kr_grid(w, h, B, &grid, &smem);
  kr_inv_kernel<<<grid, kThreads, smem, stream>>>(
      coeff, pred, out, B, reinterpret_cast<const int4*>(stages), meta);
  return (int)cudaGetLastError();
}

AV1_EXPORT int kr_fwht(const int* res, int* out, int B,
                       cudaStream_t stream) {
  kr_fwht_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      res, out, B);
  return (int)cudaGetLastError();
}

AV1_EXPORT int kr_iwht(const int* coeff, const int* pred, int* out, int B,
                       int bd, cudaStream_t stream) {
  kr_iwht_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      coeff, pred, out, B, bd);
  return (int)cudaGetLastError();
}
