// Shared helpers of the hand-written kernels (plain C interface, no
// PyTorch headers: each .cu builds with nvcc alone in a few seconds).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AV1_EXPORT extern "C" __attribute__((visibility("default")))

// Two's-complement wraparound to int32, as jnp's int32 arithmetic wraps
// (signed overflow is undefined in C++, so products are taken in int64).
__device__ __forceinline__ int wrap32(long long v) {
  return (int)(unsigned int)(unsigned long long)v;
}

__device__ __forceinline__ int floor_log2(int x) {  // x >= 1
  return 31 - __clz(x);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A 4-byte copy from device to shared memory that does not wait (the
// thread's copies land at cp_async_wait_all).
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Block-wide reductions; every thread gets the result. `scratch` holds
// one slot per warp (<= 32) and is reused after a barrier.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T t = 0;
  for (int w = 0; w < nwarps; ++w) t += scratch[w];
  return t;
}

template <typename T>
__device__ T block_max(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    T u = __shfl_down_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T t = scratch[0];
  for (int w = 1; w < nwarps; ++w) t = scratch[w] > t ? scratch[w] : t;
  return t;
}
