// Batched Bloom probe for Hopper: per folded u32 key, the AND over the
// seeds of the bit at mix32(key, seed) % m_bits of one filter.
//
// Replaces src/repro/kernels/bloom/kernel.py::bloom_probe_pallas (TPU),
// and computes exactly what kernels/bloom/ref.py::bloom_probe_ref
// computes.
//
// Bound: the bytes bound (keys read, verdicts written, one 32-byte
// sector a probe) lies far below the launch floor at the path's sizes;
// what is left is the latency of the probe chain and how the probes
// spread over the SMs.  A probe that stops at a key's first unset bit
// makes each word load wait for the verdict of the one before it: a key
// in the filter (or a false positive) pays H serial L2 round trips, and
// a `%` on a runtime divisor (~20 instructions) sits in front of each.
// Here:
//   - every position of a key is computed first and all H word loads
//     are issued before any bit is tested (no early exit: the AND is
//     the same), so the chain is one key load, one round of H
//     independent loads and a store;
//   - the modulo is taken by a host-computed reciprocal (mod_by below),
//     exact for every u32 key and every m_bits in [1, 2^32);
//   - blocks are sized so that a launch spreads over every SM (blocks of
//     256 put ~1024 keys on 4 SMs, whose L1s then take all their
//     scattered probes);
//   - H is a compile-time count for H <= 8 (the paper's filters use 6),
//     so the seeds stay in the constant bank and the loads unroll.
// An 8-lane group a key (the cascade's Bloom round) and 4 keys a thread
// with 16-byte key loads both lost to this kernel at n = 1024 and 8192
// (PERF.md section 6) and were removed.
#include "common.cuh"

constexpr int kMaxSeeds = 32;

struct Seeds {
  uint32_t v[kMaxSeeds];
};

// x mod d with magic = floor((2^32 - 1) / d), computed on the host.
// magic >= 2^32 / d - 1, so umulhi(x, magic) >= x / d - x / 2^32 >
// x / d - 1: the quotient is floor(x / d) or one less, and one
// correction step makes the remainder exact for every x in [0, 2^32)
// and d in [1, 2^32) (d = 1 included: magic = 2^32 - 1).
struct Mod {
  uint32_t d, magic;
};

__device__ __forceinline__ uint32_t mod_by(uint32_t x, Mod m) {
  const uint32_t r = x - __umulhi(x, m.magic) * m.d;
  return r >= m.d ? r - m.d : r;
}

// Bit (1 or 0) of k in the filter: all kH positions first, then all kH
// loads, then the AND.  kExact: H == kH; else only seeds j < H probe.
template <int kH, bool kExact>
__device__ __forceinline__ uint32_t probe(uint32_t k,
                                          const uint32_t* __restrict__ words,
                                          Mod mod, const Seeds& s, int H) {
  uint32_t p[kH], w[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j)
    if (kExact || j < H) p[j] = mod_by(mix32(k, s.v[j]), mod);
#pragma unroll
  for (int j = 0; j < kH; ++j)
    if (kExact || j < H) w[j] = __ldg(words + (p[j] >> 5));
  uint32_t all = 1u;
#pragma unroll
  for (int j = 0; j < kH; ++j)
    if (kExact || j < H) all &= w[j] >> (p[j] & 31u);
  return all & 1u;
}

// One thread a key.
template <int kH, bool kExact>
__global__ void bloom_sm90_kernel(int n, const uint32_t* __restrict__ keys,
                                  const uint32_t* __restrict__ words,
                                  Mod mod, Seeds seeds, int H,
                                  int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int32_t)probe<kH, kExact>(__ldg(keys + i), words, mod, seeds, H);
}

// planted_fault != 0 probes only the first H - 1 seeds (a wrong kernel
// for the card's checks).
extern "C" int bloom_sm90_launch(int n, const uint32_t* keys,
                                 const uint32_t* words, uint32_t m_bits,
                                 const uint32_t* seeds_host, int H,
                                 int32_t* out, int planted_fault,
                                 void* stream) {
  if (H < 0 || H > kMaxSeeds || m_bits == 0)
    return (int)cudaErrorInvalidValue;
  Seeds seeds = {};
  for (int h = 0; h < H; ++h) seeds.v[h] = seeds_host[h];
  if (planted_fault && H > 0) --H;
  const Mod mod = {m_bits, 0xFFFFFFFFu / m_bits};
  if (n <= 0) return (int)cudaGetLastError();
  const int block = spread_block(n);
  const int blocks = (n + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  switch (H) {
#define BLOOM_CASE(h)                                                    \
  case h:                                                                \
    bloom_sm90_kernel<h, true><<<blocks, block, 0, st>>>(n, keys, words, \
                                                         mod, seeds, H,  \
                                                         out);           \
    break;
    BLOOM_CASE(1) BLOOM_CASE(2) BLOOM_CASE(3) BLOOM_CASE(4)
    BLOOM_CASE(5) BLOOM_CASE(6) BLOOM_CASE(7) BLOOM_CASE(8)
#undef BLOOM_CASE
    case 0:  // no seed: every key may be present
      bloom_sm90_kernel<1, false><<<blocks, block, 0, st>>>(n, keys, words,
                                                           mod, seeds, 0,
                                                           out);
      break;
    default:
      bloom_sm90_kernel<kMaxSeeds, false><<<blocks, block, 0, st>>>(
          n, keys, words, mod, seeds, H, out);
  }
  return (int)cudaGetLastError();
}

// An empty kernel on the grid bloom_sm90_launch would run: its device
// time is the launch floor beneath the probe's (a reading, not a bound).
__global__ void bloom_sm90_floor_kernel() {}

extern "C" int bloom_sm90_floor_launch(int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int block = spread_block(n);
  bloom_sm90_floor_kernel<<<(n + block - 1) / block, block, 0,
                            (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
