// Point stab of one disjoint DR-tree level for Hopper: idx =
// upper_bound(lo, key) - 1, and (key, seq) is covered iff idx >= 0,
// key < hi[idx] and smin[idx] <= seq < smax[idx].
//
// Replaces src/repro/kernels/interval/kernel.py::interval_query_pallas
// (TPU), and computes exactly what kernels/interval/ref.py::
// interval_query_ref computes.  The columns are the
// registry's pow2-padded u32 views (padding lo = hi = 0xFFFFFFFF, smin =
// smax = 0 covers nothing), the layout the cascade's pack shares.
//
// Bound: the bytes bound (keys and seqs read, verdicts written, the
// search's distinct sectors and three tail loads) lies far below the
// launch floor at the path's sizes; what is left is the dependent-load
// chain.  A thread-a-query binary search in global memory takes 13
// dependent loads at 8192 areas (20 at 2^20), then hi, smin and smax
// one after another behind the && short-circuit.  Here one thread a query
// searches a shared-memory directory of every 2^s-th entry of lo (at
// most kDirEntries, the whole column when it fits), staged once by each
// block of kDirThreads queries; the last s steps run in global memory
// over one 2^s-entry segment.  At 8192 areas the segment is 32 entries,
// one 128-byte line, so the search costs one global round trip.  The
// three tail loads are then issued together, without the short-circuit.
// Staging the whole column (32 KB a block at 8192 areas) and a 32-lane
// group search (group_search.cuh) were timed beside it (PERF.md section
// 6): the first lost at every shape; the second won by 1-2 us only on a
// level of 2^20 areas, larger than any the store's levels reach, and
// lost at n = 8192.  Both were removed.
#include "common.cuh"

constexpr int kDirEntries = 256;  // the directory's largest size (1 KB)
constexpr int kDirThreads = 256;  // queries a block

// Does x lie before the answer?  upper_bound (kLower false) counts the
// elements <= q; kLower is the planted fault: lower_bound counts < q and
// misses keys equal to an area's start.
template <bool kLower>
__device__ __forceinline__ bool before(uint32_t x, uint32_t q) {
  return kLower ? x < q : x <= q;
}

// dir[t] = lo[t << shift] for t < T = ceil(m / 2^shift) <= kDirEntries.
template <bool kLower>
__global__ void __launch_bounds__(kDirThreads) interval_sm90_kernel(
    int n, const uint32_t* __restrict__ keys,
    const uint32_t* __restrict__ seqs, int m, int shift, int T,
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ smin, const uint32_t* __restrict__ smax,
    int32_t* __restrict__ out) {
  __shared__ uint32_t dir[kDirEntries];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t k = 0, s = 0;
  if (i < n) {  // in flight while the directory copies
    k = __ldg(keys + i);
    s = __ldg(seqs + i);
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    dir[t] = __ldg(lo + ((size_t)t << shift));
  __syncthreads();
  if (i >= n) return;
  // a = the directory entries before the answer.
  int a = 0, b = T;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (before<kLower>(dir[mid], k)) a = mid + 1; else b = mid;
  }
  int ans = a;
  if (shift > 0 && a > 0) {
    // lo[(a - 1) << shift] lies before the answer and lo[a << shift]
    // (where it exists) does not: finish in that segment.
    int l = ((a - 1) << shift) + 1;
    int h = (int)min((long long)a << shift, (long long)m);
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (before<kLower>(__ldg(lo + mid), k)) l = mid + 1; else h = mid;
    }
    ans = l;
  }
  const int j = ans - 1;
  int covered = 0;
  if (j >= 0) {
    const uint32_t h = __ldg(hi + j);
    const uint32_t a0 = __ldg(smin + j);
    const uint32_t a1 = __ldg(smax + j);
    covered = (k < h) & (a0 <= s) & (s < a1);
  }
  out[i] = covered;
}

// planted_fault != 0 searches lower_bound (a wrong kernel for the card's
// checks).  An empty level (m = 0) runs the same kernel, which finds no
// area.
extern "C" int interval_sm90_launch(int n, const uint32_t* keys,
                                    const uint32_t* seqs, int m,
                                    const uint32_t* lo, const uint32_t* hi,
                                    const uint32_t* smin,
                                    const uint32_t* smax, int32_t* out,
                                    int planted_fault, void* stream) {
  if (n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  // The least shift with ceil(m / 2^shift) <= kDirEntries.
  int shift = 0;
  while ((((long long)m + (1LL << shift) - 1) >> shift) > kDirEntries)
    ++shift;
  const int T = (int)(((long long)m + (1LL << shift) - 1) >> shift);
  const int blocks = (n + kDirThreads - 1) / kDirThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (planted_fault)
    interval_sm90_kernel<true><<<blocks, kDirThreads, 0, st>>>(
        n, keys, seqs, m, shift, T, lo, hi, smin, smax, out);
  else
    interval_sm90_kernel<false><<<blocks, kDirThreads, 0, st>>>(
        n, keys, seqs, m, shift, T, lo, hi, smin, smax, out);
  return (int)cudaGetLastError();
}

// An empty kernel on the grid interval_sm90_launch would run: its device
// time is the launch floor beneath the stab's (a reading, not a bound).
__global__ void interval_sm90_floor_kernel() {}

extern "C" int interval_sm90_floor_launch(int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  interval_sm90_floor_kernel<<<(n + kDirThreads - 1) / kDirThreads,
                               kDirThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
