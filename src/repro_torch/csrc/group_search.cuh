// Lane-group searches for the store's Hopper kernels.
//
// A binary search is a chain of dependent loads, each an L2 (or HBM)
// round trip.  Here a group of W lanes (8, 16 or 32, a compile-time
// constant) answers one search together: each round every lane loads
// one of W evenly spaced pivots of the current range, a ballot over
// the group counts the pivots that lie before the answer, and the
// range shrinks to the gap between two neighbouring pivots.  A range
// of length len takes about log_{W+1}(len) rounds instead of log2(len):
// 4 rounds instead of 19 over 450 K keys at W = 32.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

template <int W>
struct LaneGroup {
  static_assert(W == 8 || W == 16 || W == 32, "lane groups of 8, 16, 32");
  unsigned mask;  // the group's lanes within the warp
  int lane;       // this thread's lane within the group, 0..W-1

  __device__ __forceinline__ LaneGroup() {
    const int l = threadIdx.x & 31;
    lane = l & (W - 1);
    mask = W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (l & ~(W - 1));
  }
  // How many of the group's lanes hold p.
  __device__ __forceinline__ int count(bool p) const {
    return __popc(__ballot_sync(mask, p) & mask);
  }
  __device__ __forceinline__ bool all(bool p) const {
    return __all_sync(mask, p);
  }
  // v of the group's lane src.
  __device__ __forceinline__ uint32_t from(uint32_t v, int src) const {
    return __shfl_sync(mask, v, src, W);
  }
};

// Pivot i (0..W-1) of [lo, lo + len): W points that cut the range into
// W + 1 near-equal gaps; each lies in [lo, lo + len) when len >= 1.
template <int W>
__device__ __forceinline__ int pivot(int lo, int len, int i) {
  return lo + (int)(((long long)(i + 1) * len) / (W + 1));
}

// The first index in [lo, hi) at which `before(i, x)` is false, for a
// predicate that is true up to some index and false from there on (hi
// if it is true everywhere).  `before` loads what it compares and
// leaves one 32-bit word of it in x; *at receives the x of the index
// returned, and is left as it was when that index is hi.  Every lane
// of the group must call with the same lo, hi and predicate.
template <int W, class Before>
__device__ __forceinline__ int group_search(const LaneGroup<W>& g, int lo,
                                            int hi, Before before,
                                            uint32_t* at) {
  while (lo < hi) {
    const int len = hi - lo;
    uint32_t x = 0;
    const bool b = before(pivot<W>(lo, len, g.lane), x);
    const int k = g.count(b);  // pivots 0..k-1 lie before the answer
    const uint32_t xk = g.from(x, k < W ? k : W - 1);
    const int first = lo;
    if (k > 0) lo = pivot<W>(first, len, k - 1) + 1;
    if (k < W) {
      hi = pivot<W>(first, len, k);
      *at = xk;
    }
  }
  return lo;
}

// First index in [lo, hi) of a sorted u32 array whose element is >= q
// (kUpper false, searchsorted left) or > q (kUpper true, right); *at
// receives that element when the index is below hi.
template <int W, bool kUpper>
__device__ __forceinline__ int group_bound(const LaneGroup<W>& g,
                                           const uint32_t* __restrict__ a,
                                           int lo, int hi, uint32_t q,
                                           uint32_t* at) {
  return group_search<W>(
      g, lo, hi,
      [&](int p, uint32_t& x) {
        x = __ldg(a + p);
        return kUpper ? x <= q : x < q;
      },
      at);
}
