// Shared device helpers for the store's kernels.
#pragma once
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

// murmur3-style 32-bit finalizer of (x ^ seed): the bit contract of
// core/eve.py::mix32, which every filter kernel must match exactly.
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// First index in [lo, hi) whose element is >= q (searchsorted left).
__device__ __forceinline__ int lower_bound(const uint32_t* __restrict__ a,
                                           int lo, int hi, uint32_t q) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index in [lo, hi) whose element is > q (searchsorted right).
__device__ __forceinline__ int upper_bound(const uint32_t* __restrict__ a,
                                           int lo, int hi, uint32_t q) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

constexpr int kThreads = 256;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// Streaming multiprocessors of the current device (132 on an H100 SXM).
inline int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (!cached[dev])
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 132;
}

// The fewest threads a block (a multiple of 32, at most 256) that still
// spread `total` threads over every SM: a gather-bound launch of ~1024
// threads in blocks of 256 would put all its scattered loads on 4 SMs.
inline int spread_block(long long total) {
  const long long per_sm = (total + sm_count() - 1) / sm_count();
  return (int)std::min(256LL, std::max(32LL, (per_sm + 31) / 32 * 32));
}
