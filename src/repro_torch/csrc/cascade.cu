// Fused point-lookup cascade: one thread per query answers every packed
// SSTable level's fence position, Bloom verdict and exact hit (first
// hit resolves the entry's seq), then every GLORAN DR-tree level's
// point stab of (key, resolved seq).
//
// Replaces src/repro/kernels/cascade/kernel.py::cascade_pallas (TPU).
// The TPU kernel ran a fixed-depth padded binary search over VMEM tiles
// of 1024 queries; here each thread runs a plain lower/upper bound over
// the level's true count and loops over the runtime L, H and G.
//
// Bound: memory latency, not bandwidth.  Each query touches about
// log2(cnt) + H + 1 scattered 32-byte sectors per level and log2(A) + 3
// per GLORAN level, so the floor is those sectors over HBM bandwidth;
// the eight shards' packs (~48 MB) mostly sit in the 50 MB L2, which
// is what keeps the dependent search loads short.
#include "common.cuh"

__global__ void cascade_kernel(
    int n, const uint32_t* __restrict__ qkey,
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
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t q = qkey[i];
  const uint32_t qh = qhash[i];
  uint32_t res_seq = qseq[i];
  bool resolved = qres[i] != 0;
  int32_t bloom = 0, hit = 0, gl = 0;
  for (int l = 0; l < L; ++l) {
    const int off = key_off[l];
    const int cnt = key_cnt[l];
    const int idxc = min(lower_bound(lkeys, off, off + cnt, q) - off,
                         cnt - 1);
    pos_out[(size_t)l * n + i] = idxc;
    const uint32_t mb = mbits[l];
    const uint32_t* w = words + word_off[l];
    bool maybe = true;
    for (int h = 0; h < H && maybe; ++h) {
      const uint32_t p = mix32(qh, seeds[l * H + h]) % mb;
      maybe = (__ldg(w + (p >> 5)) >> (p & 31u)) & 1u;
    }
    if (!maybe) continue;
    bloom |= 1 << l;
    if (cnt > 0 && __ldg(lkeys + off + idxc) == q) {
      hit |= 1 << l;
      if (!resolved) {
        res_seq = __ldg(lseqs + off + idxc);
        resolved = true;
      }
    }
  }
  for (int g = 0; g < G; ++g) {
    const int off = gl_off[g];
    const int cnt = gl_cnt[g];
    if (cnt <= 0) continue;
    const int j = upper_bound(glo_lo, off, off + cnt, q) - 1;
    if (j >= off && q < __ldg(glo_hi + j) && __ldg(glo_smin + j) <= res_seq &&
        res_seq < __ldg(glo_smax + j))
      gl |= 1 << g;
  }
  bloom_out[i] = bloom;
  hit_out[i] = hit;
  gl_out[i] = gl;
}

extern "C" int cascade_launch(
    int n, const uint32_t* qkey, const uint32_t* qhash, const uint32_t* qseq,
    const int32_t* qres, const uint32_t* lkeys, const uint32_t* lseqs,
    const int32_t* key_off, const int32_t* key_cnt, const uint32_t* words,
    const int32_t* word_off, const uint32_t* mbits, const uint32_t* seeds,
    int L, int H, const uint32_t* glo_lo, const uint32_t* glo_hi,
    const uint32_t* glo_smin, const uint32_t* glo_smax, const int32_t* gl_off,
    const int32_t* gl_cnt, int G, int32_t* bloom_out, int32_t* hit_out,
    int32_t* gl_out, int32_t* pos_out, void* stream) {
  if (n > 0)
    cascade_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        n, qkey, qhash, qseq, qres, lkeys, lseqs, key_off, key_cnt, words,
        word_off, mbits, seeds, L, H, glo_lo, glo_hi, glo_smin, glo_smax,
        gl_off, gl_cnt, G, bloom_out, hit_out, gl_out, pos_out);
  return (int)cudaGetLastError();
}
