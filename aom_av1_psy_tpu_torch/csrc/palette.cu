// Kernel KQ: palette_indices.
//
// Replaces the jnp branch of the reference's calc_indices
// (aom_av1_psy_tpu/ops/palette.py:20, av1_calc_indices_dim1/dim2_c): the
// (N, K) nearest-centroid argmin of N points of dim 1 or 2, and the total
// distance (dim 1: the sum of the squared best |d|; dim 2: the sum of the
// best squared L2 distance). Ties go to the first centroid (strict <), as
// argmin breaks them. The total is exact in int64, as the reference's numpy
// branch sums it.
//
// What bounds it: a palette block is at most 64x64 = 4096 points and K <=
// 8 in the encoder, so one call reads ~32 KB and does ~10^5 operations:
// the launch and the one copy of the total back to the host bound it, not
// the card. Design: one thread per point; the K centroids (K <= 256) sit
// in shared memory; each CTA sums its points' distances with a block
// reduction and adds them to the total with one int64 atomic (integers, so
// the total does not depend on the order of the CTAs).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 256;

__global__ void kq_kernel(const long long* data, const long long* cents,
                          int N, int K, int dim, unsigned char* idx,
                          unsigned long long* total) {
  __shared__ long long c[2 * kMaxK];
  __shared__ long long red[32];
  for (int j = threadIdx.x; j < K * dim; j += blockDim.x) c[j] = cents[j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  long long part = 0;
  if (i < N) {
    long long best = 0;
    int arg = 0;
    if (dim == 1) {
      const long long x = data[i];
      for (int k = 0; k < K; ++k) {
        const long long d = x > c[k] ? x - c[k] : c[k] - x;
        if (k == 0 || d < best) { best = d; arg = k; }
      }
      part = best * best;
    } else {
      const long long x0 = data[2 * i], x1 = data[2 * i + 1];
      for (int k = 0; k < K; ++k) {
        const long long d0 = x0 - c[2 * k], d1 = x1 - c[2 * k + 1];
        const long long d = d0 * d0 + d1 * d1;
        if (k == 0 || d < best) { best = d; arg = k; }
      }
      part = best;
    }
    idx[i] = (unsigned char)arg;
  }
  part = block_sum<long long>(part, red);
  if (threadIdx.x == 0) atomicAdd(total, (unsigned long long)part);
}

}  // namespace

// data (N, dim) int64, cents (K, dim) int64, idx (N,) uint8, total (1,)
// int64 zeroed by the caller.
AV1_EXPORT int palette_indices(const long long* data, const long long* cents,
                               int N, int K, int dim, unsigned char* idx,
                               long long* total, void* stream) {
  if (N <= 0 || K <= 0 || K > kMaxK || (dim != 1 && dim != 2))
    return (int)cudaErrorInvalidValue;
  const int grid = (N + kThreads - 1) / kThreads;
  kq_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      data, cents, N, K, dim, idx, (unsigned long long*)total);
  return (int)cudaGetLastError();
}
