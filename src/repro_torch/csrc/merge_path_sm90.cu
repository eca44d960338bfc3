// Merge path for Hopper: one launch places both sorted runs of a
// two-way merge round.
//
// Replaces src/repro/kernels/merge/ops.py::merge_ranks over
// src/repro/kernels/merge/kernel.py::merge_rank_pallas (TPU), which
// ranks each run in the other with one searchsorted per element, one
// call per side.  out[i] = i + #{b < a[i]} for a's elements and
// out[na + j] = j + #{a <= b[j]} for b's: the merged slot of every
// input element, ties going a-first (a <= b takes a), as
// kernels/merge/ref.py::merge_positions_ref computes.  Both runs sorted;
// duplicates within and across them allowed.
//
// Bound: bytes (both runs read once, one int32 a slot written once).
// csrc/merge_rank.cu spends ~19 dependent global loads per element and
// two launches; here
//   - each block owns kTile consecutive slots of the merged output (a
//     tile of diagonals) and finds the runs' split at its two ends by
//     a warp-cooperative 32-ary search on the diagonal (~4 rounds);
//   - it copies the two input windows, contiguous, into shared memory
//     with cp.async (16-byte copies where aligned, 4-byte at the edges);
//   - each thread finds its own split of kItems slots by a short search
//     in shared memory and merges them serially;
//   - the slots are staged in shared memory in input order, so the
//     stores to global memory coalesce.
#include "common.cuh"
#include "group_search.cuh"

constexpr int kMergeThreads = 256;
constexpr int kItems = 8;  // merged slots a thread
constexpr int kTile = kMergeThreads * kItems;

// Merged order: a goes before b (kBFirst is the planted fault: ties
// b-first).
template <bool kBFirst>
__device__ __forceinline__ bool a_first(uint32_t a, uint32_t b) {
  return kBFirst ? a < b : a <= b;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Start copying x[lo, hi) into s; returns where x[lo] lands in s.  The
// copy starts at lo rounded down to 4 elements, so 16-byte chunks stay
// aligned (when x is), and never reads past x[n - 1].
__device__ __forceinline__ int stage(uint32_t* s, const uint32_t* x, int n,
                                     int lo, int hi) {
  const int base = lo & ~3;
  const int chunks = (hi - base + 3) >> 2;
  const bool aligned = ((uintptr_t)x & 15) == 0;
  for (int c = threadIdx.x; c < chunks; c += kMergeThreads) {
    const int e = base + 4 * c;
    if (aligned && e + 4 <= n) {
      cp_async16(s + 4 * c, x + e);
    } else {
      for (int k = 0; k < 4 && e + k < n; ++k)
        cp_async4(s + 4 * c + k, x + e + k);
    }
  }
  return lo - base;
}

template <bool kBFirst>
__global__ void __launch_bounds__(kMergeThreads) merge_path_sm90_kernel(
    const uint32_t* __restrict__ a, int na, const uint32_t* __restrict__ b,
    int nb, int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t sa[kTile + 8];
  __shared__ __align__(16) uint32_t sb[kTile + 8];
  __shared__ int32_t slot[kTile];
  __shared__ int s_split[2];

  const int d0 = blockIdx.x * kTile;
  const int d1 = min(d0 + kTile, na + nb);
  // Warps 0 and 1 split the runs at diagonals d0 and d1: the count i of
  // a's elements among the first d merged slots is the first index at
  // which a[i] no longer goes before b[d - 1 - i].
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const LaneGroup<32> grp;
    const int d = warp ? d1 : d0;
    uint32_t unused = 0;
    const int i = group_search<32>(
        grp, max(0, d - nb), min(d, na),
        [&](int p, uint32_t&) {
          return a_first<kBFirst>(__ldg(a + p), __ldg(b + d - 1 - p));
        },
        &unused);
    if (grp.lane == 0) s_split[warp] = i;
  }
  __syncthreads();
  const int i0 = s_split[0], i1 = s_split[1];
  const int j0 = d0 - i0, j1 = d1 - i1;
  const int la = i1 - i0, lb = j1 - j0;
  const uint32_t* wa = sa + stage(sa, a, na, i0, i1);
  const uint32_t* wb = sb + stage(sb, b, nb, j0, j1);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // This thread's kItems slots of the tile: split the windows at its
  // first slot t0 by a binary search in shared memory, then merge.
  const int t0 = min((int)threadIdx.x * kItems, la + lb);
  const int t1 = min(t0 + kItems, la + lb);
  int lo = max(0, t0 - lb), hi = min(t0, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a_first<kBFirst>(wa[mid], wb[t0 - 1 - mid])) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = t0 - lo;
  for (int t = t0; t < t1; ++t) {
    if (ib >= lb || (ia < la && a_first<kBFirst>(wa[ia], wb[ib])))
      slot[ia++] = d0 + t;
    else
      slot[la + ib++] = d0 + t;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < la; x += kMergeThreads) out[i0 + x] = slot[x];
  for (int x = threadIdx.x; x < lb; x += kMergeThreads)
    out[na + j0 + x] = slot[la + x];
}

// planted_fault != 0 breaks ties b-first (a wrong kernel for the checks).
extern "C" int merge_path_sm90_launch(const uint32_t* a, int na,
                                      const uint32_t* b, int nb, int32_t* out,
                                      int planted_fault, void* stream) {
  const int total = na + nb;
  if (na < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaGetLastError();
  const int blocks = (total + kTile - 1) / kTile;
  if (planted_fault)
    merge_path_sm90_kernel<true><<<blocks, kMergeThreads, 0,
                                   (cudaStream_t)stream>>>(a, na, b, nb, out);
  else
    merge_path_sm90_kernel<false><<<blocks, kMergeThreads, 0,
                                    (cudaStream_t)stream>>>(a, na, b, nb,
                                                            out);
  return (int)cudaGetLastError();
}

// An empty kernel on merge_path_sm90's grid: its device time is the
// launch floor beneath the merge's time (a reading, not a bound).
__global__ void __launch_bounds__(kMergeThreads) merge_path_sm90_floor_kernel() {}

extern "C" int merge_path_sm90_floor_launch(int na, int nb, void* stream) {
  const int total = na + nb;
  if (na < 0 || nb < 0 || total == 0) return (int)cudaErrorInvalidValue;
  merge_path_sm90_floor_kernel<<<(total + kTile - 1) / kTile, kMergeThreads,
                                 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
