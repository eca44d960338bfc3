// Blocked online-softmax attention in bf16 on Hopper's tensor cores:
// GQA, a causal mask aligned to the end of the kv stream (query i sits
// at kv position i + kv_len - q_len), an optional sliding window
// (k_pos > q_pos - window), NEG = -1e30 semantics (a row with no valid
// key gives 0), f32 m, l and accumulator, bf16 output.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (TPU) for bf16 operands with D % 8 == 0 and
// D <= 256; f32 and other head dims stay on csrc/flash_attention.cu.
//
// Bound: at zamba2-7b's prefill (4 x 2048 tokens, 32 heads of 112,
// causal) the function is 1.203e11 FLOP (the causal half of Q K^T and
// P V) against 0.235 GB of q, k, v and o, so the bf16 tensor-core
// peak, 989 TFLOP/s, bounds it at 0.122 ms.  The design puts both
// products on wgmma:
//
// - A block owns a 128-row query tile of one (batch, q head): two
//   consumer warpgroups of 64 rows each, plus a producer warpgroup
//   that gives its registers to them (setmaxnreg: 240 a consumer
//   thread, 24 a producer thread), so the accumulators do not spill.
//   The grid runs the longest causal tiles first.
// - One producer thread issues TMA loads (cp.async.bulk.tensor,
//   completion on an mbarrier): Q once, then K and V tiles (128 keys
//   for D <= 64, 64 above, which keeps D = 112 and 128 free of spills)
//   into a two-stage ring of 128-byte-swizzled shared memory, each
//   stage freed by the consumers' arrival on its empty barrier.  The
//   tensor maps read the (B, S, H, D) layout where it lies, in boxes
//   of 64 columns: D = 112 takes two
//   boxes and TMA fills columns 112..127 (and rows past the end) with
//   zeros, so the Q K^T depth is D rounded up to 64 at no cost to the
//   result.  The softmax scale stays the caller's (D ** -0.5).
// - S = Q K^T is wgmma.m64n64k16 with both operands in shared memory
//   and f32 accumulators in registers.  The online softmax runs in
//   registers (quad shuffles for the row max, exp2 with the scale
//   folded into log2 e); only the diagonal, window-edge and ragged kv
//   tiles pay for the mask, and kv tiles that the mask empties for
//   every row of the block are never loaded.
// - O += P V takes P from registers as the A operand of wgmma, with V
//   read from shared memory through the transpose bit.  A bf16 P alone
//   misses the element-wise tolerance the kernel is held to (one bf16
//   ulp of the output), so P is split into hi = bf16(p) and lo =
//   bf16(p - hi) and both are multiplied: 1.5x the products of a plain
//   bf16 P, for an error of about 2^-16 of p.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                       // query rows per block
constexpr int kConsumerThreads = 256;          // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kStages = 2;
constexpr int kBox = 64;                       // bf16 columns a box
constexpr int kRowBytes = kBox * 2;            // one swizzled line
constexpr float kLog2e = 1.4426950408889634f;

struct Barriers {
  uint64_t q;
  uint64_t k[kStages];
  uint64_t v[kStages];
  uint64_t empty[kStages];
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Spin until the phase of `bar` with this parity has completed.  A
// wait past 10 s means a lost arrival: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 0xfff) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// One box of a 4-d tensor map (d, head, position, batch) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(h), "r"(s), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator
// across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) B (16 x 64,
// shared, K-major); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64,
// shared, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- kernel
// DP: D rounded up to 64 (the width of the tiles in shared memory);
// BN: keys a kv tile.
template <int DP, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                  int Hkv, int D, float scale_log2, int causal,
                  int has_window, int window) {
  constexpr int kBlocks = DP / kBox;            // 64-column boxes
  constexpr int kQBytes = kBlocks * kBM * kRowBytes;
  constexpr int kKVBytes = kBlocks * BN * kRowBytes;
  constexpr int kSN = BN / 64;                  // S wgmmas per k-step
  constexpr int kPK = BN / 16;                  // P V k-steps

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ks = qs + kQBytes;
  uint8_t* vs = ks + kStages * kKVBytes;
  Barriers* bars = reinterpret_cast<Barriers*>(vs + kStages * kKVBytes);

  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh - b * Hq;
  const int hk = hq / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest first
  const int off = Skv - Sq;  // suffix alignment

  // The kv tiles any row of this block may see.
  const int last_row = min(q0 + kBM, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, last_row + off + 1);
  if (has_window) kv_lo = max(0, q0 + off - window + 1);
  const int kv_start = (kv_lo / BN) * BN;
  const int ntiles = kv_hi > kv_start ? (kv_hi - kv_start + BN - 1) / BN : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bars->q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars->k[s], 1);
      mbar_init(&bars->v[s], 1);
      mbar_init(&bars->empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer warpgroup: it hands its registers to the consumers,
    // and one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumerThreads) {
      mbar_expect_tx(&bars->q, kQBytes);
      for (int c = 0; c < kBlocks; ++c)
        tma_load(qs + c * kBM * kRowBytes, &tq, &bars->q, c * kBox, hq, q0,
                 b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&bars->empty[st], ((j / kStages) - 1) & 1);
        const int k0 = kv_start + j * BN;
        mbar_expect_tx(&bars->k[st], kKVBytes);
        for (int c = 0; c < kBlocks; ++c)
          tma_load(ks + st * kKVBytes + c * BN * kRowBytes, &tk, &bars->k[st],
                   c * kBox, hk, k0, b);
        mbar_expect_tx(&bars->v[st], kKVBytes);
        for (int c = 0; c < kBlocks; ++c)
          tma_load(vs + st * kKVBytes + c * BN * kRowBytes, &tv, &bars->v[st],
                   c * kBox, hk, k0, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; a thread
  // holds rows r0 and r0 + 8 of its warp's 16.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;
  const int rw0 = q0 + wg * 64;  // first row of the warpgroup
  const int r0 = rw0 + warp * 16 + g;
  const int qpos[2] = {r0 + off, r0 + 8 + off};

  float acc[kBlocks][32];
#pragma unroll
  for (int n = 0; n < kBlocks; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_u32(qs) + wg * 64 * kRowBytes;
  mbar_wait(&bars->q, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const int k0 = kv_start + j * BN;
    const uint32_t k_addr = smem_u32(ks + st * kKVBytes);
    const uint32_t v_addr = smem_u32(vs + st * kKVBytes);

    // S = Q K^T over the padded depth.
    float s[kSN][32];
    mbar_wait(&bars->k[st], ph);
#pragma unroll
    for (int n = 0; n < kSN; ++n) fence_regs(s[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = make_desc(
          q_addr + (kk / 4) * kBM * kRowBytes + (kk % 4) * 32, 16, 1024);
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
        const uint64_t db = make_desc(k_addr + (kk / 4) * BN * kRowBytes +
                                          n * 64 * kRowBytes + (kk % 4) * 32,
                                      16, 1024);
        wgmma_ss(s[n], da, db, kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < kSN; ++n) fence_regs(s[n]);

    // Scale into log2 units and mask where some row of the warpgroup
    // may see a key the mask removes.
    const bool whole = k0 + BN <= Skv &&
                       (!causal || k0 + BN - 1 <= rw0 + off) &&
                       (!has_window || k0 > rw0 + 63 + off - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i % 4) / 2;
        float v = s[n][i] * scale_log2;
        if (!whole) {
          const int kpos = k0 + n * 64 + (i / 4) * 8 + 2 * cq + (i % 2);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos[r];
          if (has_window) ok = ok && kpos > qpos[r] - window;
          if (!ok) v = -INFINITY;
        }
        s[n][i] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }

    // P = exp2(S - m) as hi + lo bf16 A fragments: k-step kk covers
    // keys 16 kk .. 16 kk + 15, i.e. registers 8 (kk % 4) .. + 7 of
    // the S block kk / 4.
    uint32_t phi[kPK][4], plo[kPK][4];
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * (kk % 4) + 2 * e;
        const int r = e % 2;  // a0, a2: row r0; a1, a3: row r0 + 8
        const float p0 = exp2f(s[kk / 4][i] - mu[r]);
        const float p1 = exp2f(s[kk / 4][i + 1] - mu[r]);
        l[r] += p0 + p1;
        const float h0 = __bfloat162float(__float2bfloat16_rn(p0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(p1));
        phi[kk][e] = pack_bf16(h0, h1);
        plo[kk][e] = pack_bf16(p0 - h0, p1 - h1);
      }
#pragma unroll
    for (int n = 0; n < kBlocks; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i % 4) / 2];

    // O += P V.
    mbar_wait(&bars->v[st], ph);
#pragma unroll
    for (int n = 0; n < kBlocks; ++n) fence_regs(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk)
#pragma unroll
      for (int n = 0; n < kBlocks; ++n) {
        const uint64_t db = make_desc(
            v_addr + n * BN * kRowBytes + kk * 16 * kRowBytes, 1024, 1024);
        wgmma_rs(acc[n], phi[kk], db);
        wgmma_rs(acc[n], plo[kk], db);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < kBlocks; ++n) fence_regs(acc[n]);
    if (tid % 128 == 0) mbar_arrive(&bars->empty[st]);
  }

  // Normalize (l == 0: a row with no valid key gives 0) and store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + ((static_cast<long>(b) * Sq + row) * Hq + hq) * D;
#pragma unroll
    for (int n = 0; n < kBlocks; ++n)
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int d = n * 64 + c8 * 8 + 2 * cq;
        if (d < D) {
          const int i = 4 * c8 + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(acc[n][i] * l[r], acc[n][i + 1] * l[r]);
        }
      }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, which the process has
// loaded already (the runtime needs it); nothing is linked.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (B, S, H, D) bf16 tensor in boxes of 64 columns x `rows` positions
// of one head, 128-byte swizzle, zeros outside.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
             int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP, int BN>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, B, Sq, Hq, D, kBM);
  if (!err) err = make_map(&mk, k, B, Skv, Hkv, D, BN);
  if (!err) err = make_map(&mv, v, B, Skv, Hkv, D, BN);
  if (err) return err;
  const int bytes = 1024 + (DP / kBox) * (kBM + 2 * kStages * BN) * kRowBytes +
                    (int)sizeof(Barriers);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)flash_sm90_kernel<DP, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hq, (Sq + kBM - 1) / kBM);
  flash_sm90_kernel<DP, BN><<<grid, kThreads, bytes, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, Sq, Skv, Hq, Hkv, D, scale * kLog2e,
      causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), o (B, Sq, Hq, D), all bf16
// and 16-byte aligned; D % 8 == 0, D <= 256, Hq % Hkv == 0.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Sq, int Skv, int Hq, int Hkv,
                                           int D, float scale, int causal,
                                           int has_window, int window,
                                           void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (D % 8 || D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64)
    return launch<64, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                           has_window, window, s);
  if (D <= 128)
    return launch<128, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale,
                           causal, has_window, window, s);
  if (D <= 192)
    return launch<192, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                           has_window, window, s);
  return launch<256, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                         has_window, window, s);
}

// An empty kernel on the grid, block and shared memory flash_sm90_kernel
// would run for these shapes: its device time is the launch floor
// beneath the attention's (a reading, not a bound).
__global__ void __launch_bounds__(kThreads, 1) flash_sm90_floor_kernel() {}

extern "C" int flash_attention_sm90_floor_launch(int B, int Sq, int Hq, int D,
                                                 void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  const int dp = D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256;
  const int bn = D <= 64 ? 128 : 64;
  const int bytes = 1024 + (dp / kBox) * (kBM + 2 * kStages * bn) * kRowBytes +
                    (int)sizeof(Barriers);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)flash_sm90_floor_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hq, (Sq + kBM - 1) / kBM);
  flash_sm90_floor_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
