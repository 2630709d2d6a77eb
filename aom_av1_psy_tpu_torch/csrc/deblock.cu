// Kernel KC: lpf_ladder.
//
// Replaces the reference's device loop-filter ladder,
// deblock_jax.deblock_plane_fused vmapped over the candidate levels inside
// lpf_pick_and_filter / lpf_apply (aom_av1_psy_tpu/ops/deblock_jax.py:
// 183-290), with the edge filters _filter_seg14 / _filter_seg6 (:59-167).
//
// For one plane and L candidate levels: copy the plane into L slices,
// filter every vertical edge (one launch), then every horizontal edge (a
// second launch), then reduce each slice's squared error against the
// source exactly in int64 (a third launch). The pick and the chroma
// zeroing stay in torch.
//
// What bounds it: memory traffic. At 1080p luma the ladder's working set
// is 6 x 1088 x 1920 int32 (50 MB, about the L2 size); the filters are a
// few dozen integer ops per segment. Design: one thread per (level, line,
// edge) segment holding its 14 (or 6) taps in registers; edges of one
// direction are independent (writes +-6 around edges >= 16 px apart, reads
// +-7), so the in-place update needs no synchronisation.
#include <algorithm>

#include "common.cuh"

namespace {

__device__ __forceinline__ int c127(int v) { return clampi(v, -128, 127); }
__device__ __forceinline__ int r3(int v) { return (v + 4) >> 3; }
__device__ __forceinline__ int r4(int v) { return (v + 8) >> 4; }

struct Limits {
  int lim, blimit, thresh;
  __device__ explicit Limits(int level)
      : lim(max(level, 1)), blimit(2 * (level + 2) + max(level, 1)),
        thresh(level >> 4) {}
};

// filter4 on (p1, p0, q0, q1) with mask = 1 (callers gate on it).
__device__ void filter4(int hev, int& p1, int& p0, int& q0, int& q1) {
  const int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
  int f = c127(ps1 - qs1) * hev;
  f = c127(f + 3 * (qs0 - ps0));
  const int f1 = c127(f + 4) >> 3;
  const int f2 = c127(f + 3) >> 3;
  q0 = c127(qs0 - f1) + 128;
  p0 = c127(ps0 + f2) + 128;
  f = ((f1 + 1) >> 1) * (1 - hev);
  q1 = c127(qs1 - f) + 128;
  p1 = c127(ps1 + f) + 128;
}

// 14-tap luma edge on px[0..14) = p6..p0, q0..q6; rewrites px[1..13).
__device__ void filter14(int* px, int level) {
  const Limits L(level);
  int p[7], q[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    p[i] = px[6 - i];
    q[i] = px[7 + i];
  }
  auto ab = [](int a, int b) { return abs(a - b); };
  const bool fm2 = !(ab(p[1], p[0]) > L.lim || ab(q[1], q[0]) > L.lim ||
                     ab(p[0], q[0]) * 2 + ab(p[1], q[1]) / 2 > L.blimit);
  const bool fm3 = fm2 && !(ab(p[2], p[1]) > L.lim || ab(q[2], q[1]) > L.lim);
  const bool mask = fm3 && !(ab(p[3], p[2]) > L.lim || ab(q[3], q[2]) > L.lim);
  if (!mask) return;
  const bool flat3 = !(ab(p[1], p[0]) > 1 || ab(q[1], q[0]) > 1 ||
                       ab(p[2], p[0]) > 1 || ab(q[2], q[0]) > 1);
  const bool flat4 = flat3 && !(ab(p[3], p[0]) > 1 || ab(q[3], q[0]) > 1);
  const bool flat2 = !(ab(p[1], p[0]) > 1 || ab(q[1], q[0]) > 1 ||
                       ab(p[4], p[0]) > 1 || ab(q[4], q[0]) > 1 ||
                       ab(p[5], p[0]) > 1 || ab(q[5], q[0]) > 1 ||
                       ab(p[6], p[0]) > 1 || ab(q[6], q[0]) > 1);
  if (flat4 && flat2) {
    px[1] = r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0] +
               q[0]);
    px[2] = r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] +
               p[0] + q[0] + q[1]);
    px[3] = r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] +
               p[0] + q[0] + q[1] + q[2]);
    px[4] = r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 +
               p[0] + q[0] + q[1] + q[2] + q[3]);
    px[5] = r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 +
               p[0] * 2 + q[0] + q[1] + q[2] + q[3] + q[4]);
    px[6] = r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2 +
               q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5]);
    px[7] = r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2 +
               q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6]);
    px[8] = r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2 +
               q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2);
    px[9] = r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2 +
               q[3] * 2 + q[4] + q[5] + q[6] * 3);
    px[10] = r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2 +
                q[4] * 2 + q[5] + q[6] * 4);
    px[11] = r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2 +
                q[5] * 2 + q[6] * 5);
    px[12] = r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2 +
                q[6] * 7);
  } else if (flat4) {
    px[4] = r3(p[3] * 3 + 2 * p[2] + p[1] + p[0] + q[0]);
    px[5] = r3(p[3] * 2 + p[2] + 2 * p[1] + p[0] + q[0] + q[1]);
    px[6] = r3(p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2]);
    px[7] = r3(p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3]);
    px[8] = r3(p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] * 2);
    px[9] = r3(p[0] + q[0] + q[1] + 2 * q[2] + q[3] * 3);
  } else {
    const int hev = (ab(p[1], p[0]) > L.thresh || ab(q[1], q[0]) > L.thresh);
    int a = p[1], b = p[0], c = q[0], d = q[1];
    filter4(hev, a, b, c, d);
    px[5] = a;
    px[6] = b;
    px[7] = c;
    px[8] = d;
  }
}

// 6-tap chroma edge on px[0..6) = p2, p1, p0, q0, q1, q2; rewrites px[1..5).
__device__ void filter6(int* px, int level) {
  const Limits L(level);
  const int p2 = px[0], p1 = px[1], p0 = px[2], q0 = px[3], q1 = px[4],
            q2 = px[5];
  auto ab = [](int a, int b) { return abs(a - b); };
  const bool fm2 = !(ab(p1, p0) > L.lim || ab(q1, q0) > L.lim ||
                     ab(p0, q0) * 2 + ab(p1, q1) / 2 > L.blimit);
  const bool mask = fm2 && !(ab(p2, p1) > L.lim || ab(q2, q1) > L.lim);
  if (!mask) return;
  const bool flat3 = !(ab(p1, p0) > 1 || ab(q1, q0) > 1 || ab(p2, p0) > 1 ||
                       ab(q2, q0) > 1);
  if (flat3) {
    px[1] = r3(p2 * 3 + p1 * 2 + p0 * 2 + q0);
    px[2] = r3(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1);
    px[3] = r3(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2);
    px[4] = r3(p0 + q0 * 2 + q1 * 2 + q2 * 3);
  } else {
    const int hev = (ab(p1, p0) > L.thresh || ab(q1, q0) > L.thresh);
    int a = p1, b = p0, c = q0, d = q1;
    filter4(hev, a, b, c, d);
    px[1] = a;
    px[2] = b;
    px[3] = c;
    px[4] = d;
  }
}

struct KCArgs {
  int* outs;             // (L, Hb, Wb)
  int Hb, Wb;
  const bool* split16;   // (R2, C2)
  int R2, C2;
  const int* cands;      // (L,)
  int L, cell, luma;
};

__global__ void copy_kernel(const int* __restrict__ buf, long long n, int L,
                            int* __restrict__ outs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n * L; i += (long long)gridDim.x * blockDim.x)
    outs[i] = buf[i % n];
}

// One thread per (level, line, edge). vertical: line = row y, edge at
// column k * cell; horizontal: line = column x, edge at row k * cell.
template <bool VERT>
__global__ void edge_kernel(KCArgs a, int nl, int nk) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)a.L * nl * nk) return;
  const int k = (int)(idx % nk) + 1;
  const int line = (int)((idx / nk) % nl);
  const int l = (int)(idx / ((long long)nk * nl));
  const int level = a.cands[l];
  const int e = k * a.cell;
  const bool tu = (k % 2 == 0) ||
                  (VERT ? a.split16[(line / a.cell) * a.C2 + k]
                        : a.split16[k * a.C2 + line / a.cell]);
  if (!tu || level <= 0) return;
  const int taps = a.luma ? 14 : 6, half = taps / 2;
  int* base = a.outs + (long long)l * a.Hb * a.Wb;
  const long long step = VERT ? 1 : a.Wb;
  int* p0 = VERT ? base + (long long)line * a.Wb + (e - half)
                 : base + (long long)(e - half) * a.Wb + line;
  int px[14];
  for (int i = 0; i < taps; ++i) px[i] = p0[i * step];
  if (a.luma) {
    filter14(px, level);
    for (int i = 1; i < 13; ++i) p0[i * step] = px[i];
  } else {
    filter6(px, level);
    for (int i = 1; i < 5; ++i) p0[i * step] = px[i];
  }
}

__global__ void sse_kernel(const int* __restrict__ outs, int Hb, int Wb,
                           const int* __restrict__ src, int src_stride,
                           int pw, int ph, unsigned long long* sse) {
  __shared__ long long red[32];
  const int l = blockIdx.y;
  const int* o = outs + (long long)l * Hb * Wb;
  long long acc = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < (long long)pw * ph; i += (long long)gridDim.x * blockDim.x) {
    const int y = (int)(i / pw), x = (int)(i % pw);
    const long long d = o[(long long)y * Wb + x] - src[(long long)y * src_stride + x];
    acc += d * d;
  }
  acc = block_sum<long long>(acc, red);
  if (threadIdx.x == 0) atomicAdd(sse + l, (unsigned long long)acc);
}

int blocks_for(long long n, int nt) {
  return (int)((n + nt - 1) / nt);
}

}  // namespace

AV1_EXPORT int lpf_ladder(const int* buf, int Hb, int Wb,
                          const bool* split16, int R2, int C2,
                          const int* cands, int L, int cell, int luma,
                          int nl_v, int kv, int nl_h, int kh,
                          const int* src, int src_stride, int pw, int ph,
                          int* outs, long long* sse, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = 256;
  const long long n = (long long)Hb * Wb;
  copy_kernel<<<std::min(blocks_for(n * L, nt), 4096), nt, 0, st>>>(buf, n, L,
                                                              outs);
  KCArgs a{outs, Hb, Wb, split16, R2, C2, cands, L, cell, luma};
  if (kv > 0)
    edge_kernel<true><<<blocks_for((long long)L * nl_v * kv, nt), nt, 0, st>>>(
        a, nl_v, kv);
  if (kh > 0)
    edge_kernel<false><<<blocks_for((long long)L * nl_h * kh, nt), nt, 0,
                         st>>>(a, nl_h, kh);
  if (src) {
    cudaError_t e = cudaMemsetAsync(sse, 0, sizeof(long long) * L, st);
    if (e != cudaSuccess) return (int)e;
    sse_kernel<<<dim3(std::min(blocks_for((long long)pw * ph, nt), 512), L), nt, 0,
                 st>>>(outs, Hb, Wb, src, src_stride, pw, ph,
                       (unsigned long long*)sse);
  }
  return (int)cudaGetLastError();
}
