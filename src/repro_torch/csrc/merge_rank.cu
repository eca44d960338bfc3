// Merge rank: per query, the count of elements of a sorted run below it
// (leq = 0, searchsorted left) or at-or-below it (leq = 1, searchsorted
// right).  Two launches, one per side, give a two-way merge round its
// output positions (kernels/merge/ops.py::merge_ranks).
//
// Replaces src/repro/kernels/merge/kernel.py::merge_rank_pallas (TPU),
// whose fixed-depth padded search over VMEM-sized chunks of the run
// becomes one plain binary search per thread over the whole run.
//
// Bound: memory latency.  A query reads log2(m) + 1 dependent elements;
// the top levels of the search are shared by all threads and stay in
// L1/L2, so the floor is the queries read plus the ranks written over
// HBM bandwidth.
#include "common.cuh"

__global__ void merge_rank_kernel(int n, const uint32_t* __restrict__ q,
                                  int m, const uint32_t* __restrict__ run,
                                  int leq, int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t k = q[i];
  out[i] = leq ? upper_bound(run, 0, m, k) : lower_bound(run, 0, m, k);
}

extern "C" int merge_rank_launch(int n, const uint32_t* q, int m,
                                 const uint32_t* run, int leq, int32_t* out,
                                 void* stream) {
  if (n > 0)
    merge_rank_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        n, q, m, run, leq, out);
  return (int)cudaGetLastError();
}
