// Shared device helpers for the store's kernels.
#pragma once
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
