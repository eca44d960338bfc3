// Batched Bloom probe: per folded u32 key, the AND over the seeds of the
// bit at mix32(key, seed) % m_bits of one filter.
//
// Replaces src/repro/kernels/bloom/kernel.py::bloom_probe_pallas (TPU).
// The TPU path split filters above 1 << 20 words into chunks with an
// always-set guard word to fit VMEM; here one launch reads the whole
// filter from device memory.
//
// Bound: memory latency of H scattered word reads per key (one 32-byte
// sector each); the floor is those sectors plus the keys read and the
// verdicts written over HBM bandwidth.
#include "common.cuh"

constexpr int kMaxSeeds = 32;

struct Seeds {
  uint32_t v[kMaxSeeds];
};

__global__ void bloom_kernel(int n, const uint32_t* __restrict__ keys,
                             const uint32_t* __restrict__ words,
                             uint32_t m_bits, Seeds seeds, int H,
                             int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t k = keys[i];
  bool maybe = true;
  for (int h = 0; h < H && maybe; ++h) {
    const uint32_t p = mix32(k, seeds.v[h]) % m_bits;
    maybe = (__ldg(words + (p >> 5)) >> (p & 31u)) & 1u;
  }
  out[i] = maybe ? 1 : 0;
}

extern "C" int bloom_launch(int n, const uint32_t* keys,
                            const uint32_t* words, uint32_t m_bits,
                            const uint32_t* seeds_host, int H, int32_t* out,
                            void* stream) {
  if (H < 0 || H > kMaxSeeds) return (int)cudaErrorInvalidValue;
  Seeds seeds = {};
  for (int h = 0; h < H; ++h) seeds.v[h] = seeds_host[h];
  if (n > 0)
    bloom_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        n, keys, words, m_bits, seeds, H, out);
  return (int)cudaGetLastError();
}
