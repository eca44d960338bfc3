// Point stab of one disjoint DR-tree level: idx = #(lo <= key) - 1, and
// (key, seq) is covered iff idx >= 0, key < hi[idx] and
// smin[idx] <= seq < smax[idx].
//
// Replaces src/repro/kernels/interval/kernel.py::interval_query_pallas
// (TPU), whose VMEM chunking of levels past 1 << 20 areas becomes one
// launch over the whole level.
//
// Bound: memory latency of log2(A) + 3 dependent reads per query; the
// floor is the keys and seqs read plus the verdicts written over HBM
// bandwidth.
#include "common.cuh"

__global__ void interval_kernel(int n, const uint32_t* __restrict__ keys,
                                const uint32_t* __restrict__ seqs, int m,
                                const uint32_t* __restrict__ lo,
                                const uint32_t* __restrict__ hi,
                                const uint32_t* __restrict__ smin,
                                const uint32_t* __restrict__ smax,
                                int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t k = keys[i];
  const uint32_t s = seqs[i];
  const int j = upper_bound(lo, 0, m, k) - 1;
  out[i] = (j >= 0 && k < __ldg(hi + j) && __ldg(smin + j) <= s &&
            s < __ldg(smax + j)) ? 1 : 0;
}

extern "C" int interval_launch(int n, const uint32_t* keys,
                               const uint32_t* seqs, int m,
                               const uint32_t* lo, const uint32_t* hi,
                               const uint32_t* smin, const uint32_t* smax,
                               int32_t* out, void* stream) {
  if (n > 0)
    interval_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        n, keys, seqs, m, lo, hi, smin, smax, out);
  return (int)cudaGetLastError();
}
