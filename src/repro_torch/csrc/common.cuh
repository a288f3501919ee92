// Shared device helpers for the repro_torch kernels (bitpack, bitunpack,
// frame_compact). Header-only; every kernel source includes it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Low-`n` mask for n in 0..32 and beyond; n >= 32 gives all ones, so no
// shift by 32 (undefined in C++) is ever issued. Mirrors bits.mask_bits.
__device__ __forceinline__ uint32_t mask_bits(int n) {
  return n >= 32 ? 0xFFFFFFFFu : (n <= 0 ? 0u : ((1u << n) - 1u));
}

// Logical shifts that give 0 for a shift of 32 or more (bits._safe_*).
__device__ __forceinline__ uint32_t shr(uint32_t x, int s) {
  return s >= 32 ? 0u : (x >> s);
}
__device__ __forceinline__ uint32_t shl(uint32_t x, int s) {
  return s >= 32 ? 0u : (x << s);
}

// Block-wide exclusive prefix sum of one int per thread. `warp_sums` is
// shared scratch of THREADS/32 ints. Every thread of the block must call it
// (it synchronises); `total` receives the sum over the whole block.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xFFFFFFFFu, ws, d);
      if (lane >= d) ws += y;
    }
    if (lane < kWarps) warp_sums[lane] = ws;  // inclusive warp prefixes
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// K consecutive ints from p[first] (0 past `count`). kVec: count % 4 == 0
// and p 16-byte aligned, so a group of 4 is in range whole or not at all and
// comes in one 16-byte load.
template <bool kVec, int K>
__device__ __forceinline__ void load_ints(const int* __restrict__ p, int first, int count,
                                          int (&v)[K]) {
  static_assert(K % 4 == 0, "K must be a multiple of 4");
  if (kVec) {
#pragma unroll
    for (int g = 0; g < K; g += 4) {
      const int4 q = first + g < count ? *reinterpret_cast<const int4*>(p + first + g)
                                       : make_int4(0, 0, 0, 0);
      v[g] = q.x, v[g + 1] = q.y, v[g + 2] = q.z, v[g + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = first + k < count ? p[first + k] : 0;
  }
}

// Whether `dynamic` bytes of shared memory beside the kernel's static ones
// fit one block on the current device (its opt-in limit: 227 KB on Hopper).
template <typename Kernel>
inline bool fits_smem(Kernel kernel, size_t dynamic) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return false;
  return dynamic + attr.sharedSizeBytes <= static_cast<size_t>(optin);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
