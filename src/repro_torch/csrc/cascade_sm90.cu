// Fused point-lookup cascade for Hopper: a warp per (query, level)
// pair, every level of a query in flight at once.
//
// Replaces src/repro/kernels/cascade/kernel.py::cascade_pallas (TPU),
// and computes exactly what kernels/cascade/ref.py::cascade_ref
// computes: per packed SSTable level the fence position
// min(lower_bound, cnt - 1) over the level's true count (-1 for an
// empty level), the H-probe Bloom verdict and the exact hit, the first
// hit in level order resolving the entry's seq; per GLORAN DR-tree
// level the point stab of (key, resolved seq) at upper_bound - 1, no
// coverage on an empty level or left of the level's first area.
//
// Bound: the latency of dependent loads, not bytes.  One thread a query
// would run ~19 binary-search steps, H Bloom loads, the hit and the seq
// per level, and ~13 steps + 3 loads per GLORAN level, one level after
// another: ~70 L2 round trips in a row at L = 2, G = 1.  Here:
//   - each (query, SSTable level) and (query, GLORAN level) pair is one
//     work item of a lane group, so a query's levels run concurrently;
//   - searches are 32-ary (group_search.cuh): ~4 rounds over 450 K keys;
//   - the Bloom probes load in one round (lane h probes hash h) before
//     the search; without the early exit the AND is the same (moving
//     the group's vote after the search, so the two overlap, measured
//     no better on the card: PERF.md section 6);
//   - the search's last round already holds the element at the fence,
//     so the exact-hit test needs no further load;
//   - the GLORAN search and its area's hi/smin/smax loads do not wait
//     for the seq; only the final compare does, in shared memory after
//     the block's resolution step, which takes the first hit in level
//     order as the plain version does.
// A block holds kThreads / 32 warps and as many queries as give each
// warp one item.  Groups of 8 and 16 lanes were timed beside 32 and
// lost; a kernel of one thread a query won only from ~8192 queries a
// launch, past what a shard's sub-batch holds (PERF.md section 6).
#include <algorithm>

#include "common.cuh"
#include "group_search.cuh"

constexpr int kMaxLevels = 30;
constexpr int kLanes = 32;                      // lanes a work item
constexpr int kMaxQueries = kThreads / kLanes;  // queries a block

// Instantiated at W = kLanes only; the profiler names the kernel
// cascade_sm90_kernel<32, ...>.
template <int W, bool kLowerStab>
__global__ void __launch_bounds__(kThreads) cascade_sm90_kernel(
    int n, int qpb, const uint32_t* __restrict__ qkey,
    const uint32_t* __restrict__ qhash, const uint32_t* __restrict__ qseq,
    const int32_t* __restrict__ qres, const uint32_t* __restrict__ lkeys,
    const uint32_t* __restrict__ lseqs, const int32_t* __restrict__ key_off,
    const int32_t* __restrict__ key_cnt, const uint32_t* __restrict__ words,
    const int32_t* __restrict__ word_off, const uint32_t* __restrict__ mbits,
    const uint32_t* __restrict__ seeds, int L, int H,
    const uint32_t* __restrict__ glo_lo, const uint32_t* __restrict__ glo_hi,
    const uint32_t* __restrict__ glo_smin,
    const uint32_t* __restrict__ glo_smax,
    const int32_t* __restrict__ gl_off, const int32_t* __restrict__ gl_cnt,
    int G, int32_t* __restrict__ bloom_out, int32_t* __restrict__ hit_out,
    int32_t* __restrict__ gl_out, int32_t* __restrict__ pos_out) {
  __shared__ int s_bloom[kMaxQueries], s_hit[kMaxQueries];
  __shared__ uint32_t s_seq[kMaxQueries][kMaxLevels];  // seq of a hit
  // Per (query, GLORAN level): the stabbed area's smin and smax, and
  // whether the key lies in an area at all.
  __shared__ uint32_t s_smin[kMaxQueries][kMaxLevels];
  __shared__ uint32_t s_smax[kMaxQueries][kMaxLevels];
  __shared__ bool s_in[kMaxQueries][kMaxLevels];

  const LaneGroup<W> grp;
  const int q0 = blockIdx.x * qpb;
  const int nq = min(qpb, n - q0);
  // Thread t < nq resolves query t at the end; its seq and flag load
  // now, off the chain.
  uint32_t my_seq = 0;
  int32_t my_res = 0;
  if (threadIdx.x < nq) {
    my_seq = __ldg(qseq + q0 + threadIdx.x);
    my_res = __ldg(qres + q0 + threadIdx.x);
    s_bloom[threadIdx.x] = 0;
    s_hit[threadIdx.x] = 0;
  }
  __syncthreads();

  const int per_q = L + G;
  const int items = nq * per_q;
  for (int it = threadIdx.x / W; it < items; it += kThreads / W) {
    const int qi = it / per_q;
    const int l = it - qi * per_q;
    const int i = q0 + qi;
    const uint32_t q = __ldg(qkey + i);
    if (l < L) {
      // Bloom: lane h probes hash h; loads issued before the search.
      const uint32_t qh = __ldg(qhash + i);
      const uint32_t mb = __ldg(mbits + l);
      const uint32_t* w = words + __ldg(word_off + l);
      bool maybe = true;
      for (int h0 = 0; h0 < H; h0 += W) {
        const int h = h0 + grp.lane;
        bool set = true;
        if (h < H) {
          const uint32_t p = mix32(qh, __ldg(seeds + l * H + h)) % mb;
          set = (__ldg(w + (p >> 5)) >> (p & 31u)) & 1u;
        }
        const bool every = grp.all(set);
        maybe = maybe && every;
      }
      const int off = __ldg(key_off + l);
      const int cnt = __ldg(key_cnt + l);
      uint32_t at = 0;
      const int lb = group_bound<W, false>(grp, lkeys, off, off + cnt, q,
                                           &at) - off;
      if (grp.lane == 0) {
        pos_out[(size_t)l * n + i] = min(lb, cnt - 1);
        if (maybe) {
          atomicOr(&s_bloom[qi], 1 << l);
          if (lb < cnt && at == q) {  // lkeys[off + lb] == q
            atomicOr(&s_hit[qi], 1 << l);
            s_seq[qi][l] = __ldg(lseqs + off + lb);
          }
        }
      }
    } else {
      const int g = l - L;
      const int off = __ldg(gl_off + g);
      const int cnt = __ldg(gl_cnt + g);
      bool in = false;
      uint32_t smin = 0, smax = 0, at = 0;
      if (cnt > 0) {
        // kLowerStab is the planted fault: lower_bound in place of
        // upper_bound misses keys equal to an area's start.
        const int j = group_bound<W, !kLowerStab>(grp, glo_lo, off,
                                                  off + cnt, q, &at) - 1;
        if (j >= off && grp.lane == 0) {
          in = q < __ldg(glo_hi + j);
          smin = __ldg(glo_smin + j);
          smax = __ldg(glo_smax + j);
        }
      }
      if (grp.lane == 0) {
        s_in[qi][g] = in;
        s_smin[qi][g] = smin;
        s_smax[qi][g] = smax;
      }
    }
  }
  __syncthreads();

  // Resolution in level order, then the seq windows of the stabs.
  if (threadIdx.x < nq) {
    const int qi = threadIdx.x;
    const int hit = s_hit[qi];
    const uint32_t res_seq =
        my_res == 0 && hit ? s_seq[qi][__ffs(hit) - 1] : my_seq;
    int gl = 0;
    for (int g = 0; g < G; ++g)
      if (s_in[qi][g] && s_smin[qi][g] <= res_seq && res_seq < s_smax[qi][g])
        gl |= 1 << g;
    bloom_out[q0 + qi] = s_bloom[qi];
    hit_out[q0 + qi] = hit;
    gl_out[q0 + qi] = gl;
  }
}

// Queries a block: one work item per warp where L + G allows it.
static int queries_per_block(int L, int G) {
  return std::max(1, kMaxQueries / (L + G));
}

// planted_fault != 0 stabs the GLORAN levels at lower_bound - 1 (a
// wrong kernel for the checks).
extern "C" int cascade_sm90_launch(
    int n, const uint32_t* qkey, const uint32_t* qhash, const uint32_t* qseq,
    const int32_t* qres, const uint32_t* lkeys, const uint32_t* lseqs,
    const int32_t* key_off, const int32_t* key_cnt, const uint32_t* words,
    const int32_t* word_off, const uint32_t* mbits, const uint32_t* seeds,
    int L, int H, const uint32_t* glo_lo, const uint32_t* glo_hi,
    const uint32_t* glo_smin, const uint32_t* glo_smax, const int32_t* gl_off,
    const int32_t* gl_cnt, int G, int32_t* bloom_out, int32_t* hit_out,
    int32_t* gl_out, int32_t* pos_out, int planted_fault, void* stream) {
  if (L < 1 || L > kMaxLevels || G < 0 || G > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int qpb = queries_per_block(L, G);
  auto kernel = planted_fault ? cascade_sm90_kernel<kLanes, true>
                              : cascade_sm90_kernel<kLanes, false>;
  kernel<<<(n + qpb - 1) / qpb, kThreads, 0, (cudaStream_t)stream>>>(
      n, qpb, qkey, qhash, qseq, qres, lkeys, lseqs, key_off, key_cnt, words,
      word_off, mbits, seeds, L, H, glo_lo, glo_hi, glo_smin, glo_smax,
      gl_off, gl_cnt, G, bloom_out, hit_out, gl_out, pos_out);
  return (int)cudaGetLastError();
}

// An empty kernel on the cascade's grid: its device time is the launch
// floor beneath the cascade's time (a reading, not a bound).
__global__ void __launch_bounds__(kThreads) cascade_sm90_floor_kernel() {}

extern "C" int cascade_sm90_floor_launch(int n, int L, int G, void* stream) {
  if (n <= 0 || L + G < 1) return (int)cudaErrorInvalidValue;
  const int qpb = queries_per_block(L, G);
  cascade_sm90_floor_kernel<<<(n + qpb - 1) / qpb, kThreads, 0,
                              (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
