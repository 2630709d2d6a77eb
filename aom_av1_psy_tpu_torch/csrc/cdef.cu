// Kernel KF: cdef_filter.
//
// Replaces the reference's device CDEF apply, cdef_jax._filter_plane /
// cdef_apply_fused (aom_av1_psy_tpu/ops/cdef_jax.py:73-192, with
// _adjust_strength and _constrain at :35-60): frame-level strengths
// (cdef_bits = 0), 8-bit 4:2:0, 8x8 luma / 4x4 chroma blocks, skip-gated.
//
// Each thread owns one pixel of the plane. Inside the mi area it finds its
// block's direction (only when the frame's primary strength is non-zero:
// cdef.c use_dirs), the block's primary strength (luma: adjusted by the
// block variance), reads the two primary and four secondary taps of both
// rings from the pre-CDEF plane (CDEF_VERY_LARGE outside the mi area, the
// reference's 2-pixel padding), applies constrain and the min/max clip, and
// writes the result; outside the mi area, and for skipped or zero-strength
// blocks, it copies the pixel. The output is a new plane of the input's
// shape.
//
// What bounds it: 12 tap reads and one write per pixel over 1088 x 1920
// luma and two 544 x 960 chroma planes, all neighbours of the thread's own
// pixel: memory bound on L1/L2-cached reads, ~0.1 ms at 1080p. Design: a 2-D
// grid of 32 x 8 thread tiles; integer arithmetic only; floor(log2) is the
// integer bit length (the reference's float32 log2 mis-floors only at 8192
// and 32768, hidden by the clip at 12; thresholds are below 64).
#include "common.cuh"

namespace {

constexpr int kVeryLarge = 0x4000;
// (dy, dx) tap offsets per direction, two rings (cdef_block.c:25-47,
// aom_av1_psy_tpu/ops/cdef.py DIRS)
__constant__ int kDirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
__constant__ int kPriTaps[2][2] = {{4, 2}, {3, 3}};
__constant__ int kSecTaps[2] = {2, 1};

struct KFArgs {
  const int* in;        // (Hs, Ws)
  int Hs, Ws, ph, pw;   // plane shape, filtered (mi) area
  int bs, nb_c;         // block size (8 | 4), blocks per row
  const bool* touched;  // (nb_r, skip_stride): false where all-skip
  int skip_stride;
  const int* dirs;      // (nb_r * nb_c,)
  const int* var;       // (nb_r * nb_c,) or null (chroma)
  int pri, sec, damping, use_dirs;
  int* out;             // (Hs, Ws)
};

__device__ __forceinline__ int adjust_strength(int strength, int var) {
  const int v6 = var >> 6;
  const int i = v6 >= 1 ? min(floor_log2(v6), 12) : 0;
  return var != 0 ? (strength * (4 + i) + 8) >> 4 : 0;
}

__device__ __forceinline__ int constrain(int diff, int t, int damping) {
  if (t == 0) return 0;
  const int shift = max(damping - floor_log2(t), 0);
  const int a = abs(diff);
  const int v = min(a, max(0, t - (a >> shift)));
  return diff < 0 ? -v : v;
}

__device__ __forceinline__ int px(const KFArgs& a, int y, int x) {
  return (y >= 0 && y < a.ph && x >= 0 && x < a.pw)
             ? a.in[(long long)y * a.Ws + x]
             : kVeryLarge;
}

__global__ void kf_kernel(KFArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.Ws || y >= a.Hs) return;
  const long long at = (long long)y * a.Ws + x;
  const int x0 = a.in[at];
  if (y >= a.ph || x >= a.pw) {
    a.out[at] = x0;
    return;
  }
  const int br = y / a.bs, bc = x / a.bs, b = br * a.nb_c + bc;
  const int pri = a.var ? adjust_strength(a.pri, a.var[b]) : a.pri;
  if (!a.touched[br * a.skip_stride + bc] || (pri == 0 && a.sec == 0)) {
    a.out[at] = x0;
    return;
  }
  const int d = a.use_dirs ? a.dirs[b] : 0;
  const int d2 = (d + 2) & 7, d6 = (d - 2) & 7;
  int total = 0, mx = x0, mn = x0;
  for (int k = 0; k < 2; ++k) {
    const int tap = kPriTaps[pri & 1][k];
    for (int s = 1; s >= -1; s -= 2) {
      const int pv = px(a, y + s * kDirs[d][k][0], x + s * kDirs[d][k][1]);
      if (pv != kVeryLarge) mx = max(pv, mx);
      mn = min(pv, mn);
      if (pri != 0) total += tap * constrain(pv - x0, pri, a.damping);
    }
    for (int s = 1; s >= -1; s -= 2) {
      for (int dd = 0; dd < 2; ++dd) {
        const int e = dd ? d6 : d2;
        const int sv = px(a, y + s * kDirs[e][k][0], x + s * kDirs[e][k][1]);
        if (sv != kVeryLarge) mx = max(sv, mx);
        mn = min(sv, mn);
        if (a.sec != 0)
          total += kSecTaps[k] * constrain(sv - x0, a.sec, a.damping);
      }
    }
  }
  int v = x0 + ((8 + total - (total < 0)) >> 4);
  if (pri != 0 && a.sec != 0) v = clampi(v, mn, mx);
  a.out[at] = v;
}

}  // namespace

AV1_EXPORT int cdef_filter(const int* in, int Hs, int Ws, int ph, int pw,
                           int bs, int nb_c, const bool* touched,
                           int skip_stride, const int* dirs, const int* var,
                           int pri, int sec, int damping, int use_dirs,
                           int* out, void* stream) {
  if (Hs <= 0 || Ws <= 0) return 0;
  if ((bs != 4 && bs != 8) || ph > Hs || pw > Ws)
    return (int)cudaErrorInvalidValue;
  KFArgs a{in,  Hs,  Ws,  ph,      pw,       bs,  nb_c, touched, skip_stride,
           dirs, var, pri, sec, damping, use_dirs, out};
  const dim3 block(32, 8);
  const dim3 grid((Ws + 31) / 32, (Hs + 7) / 8);
  kf_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
