// Blocked online-softmax attention with GQA, a causal mask aligned to
// the end of the kv stream (query i sits at kv position
// i + kv_len - q_len) and an optional sliding window, in f32 (m, l and
// the accumulator), with q, k and v in f32 or bf16 and the output in
// q's type.  A row with no valid key gives 0 (the l == 0 guard).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (TPU).  The TPU kernel walked a (b*hq,
// q-blocks, kv-blocks) grid in order, carrying m, l and acc in VMEM
// scratch across the kv axis, on inputs padded and transposed to
// (b, h, s, d).  Here one block per (b*hq, q-tile) walks the kv tiles
// in a loop of its own, reads the (b, s, h, d) layout where it lies
// with D a runtime value up to 256, and skips the kv tiles that the
// causal mask or the window leaves empty for every row of its tile
// (they would add nothing: m stays, alpha is 1, p is 0).
//
// 256 threads per block: 32 query rows, 8 threads a row, each thread
// holding D/8 dims of its row's q and accumulator in registers (dims
// g, g + 8, ...), so a warp's reads of a key row fall on 8 consecutive
// words shared by its 4 rows.  A row's score is the 8 threads' partial
// dot summed by three xor shuffles.  Per kv tile of 64 keys, K and V
// sit in shared memory as f32; the first pass writes the tile's scores
// and takes their max, the second rescales once and accumulates p V.
//
// Bound: at zamba2's prefill (s = 2048, 32 heads of 112, bf16) the
// causal products are ~1.2e11 FLOP against ~0.24 GB of q, k, v and o,
// so the tensor-core rate bounds it.  This kernel runs on the CUDA
// cores and is limited by its shared-memory reads (one per FMA).  It
// takes f32 and the head dims outside the tensor-core kernel's domain;
// bf16 with D % 8 == 0 goes to flash_attention_sm90.cu (TMA + wgmma),
// as kernels/flash_attention/ops.py::kernel_for decides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                  // query rows per block
constexpr int kGroup = 8;                  // threads per query row
constexpr int kThreads = kRows * kGroup;   // 256
constexpr int kKeys = 64;                  // keys per kv tile
constexpr float kNeg = -1e30f;             // the TPU kernel's NEG

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int Hq, int Hkv, int D, float scale, int causal,
             int has_window, int window) {
  extern __shared__ float smem[];
  float* ks = smem;                // (kKeys, D)
  float* vs = ks + kKeys * D;      // (kKeys, D)
  float* ss = vs + kKeys * D;      // (kRows, kKeys) scores of the tile

  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh - b * Hq;
  const int hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int r = tid / kGroup, g = tid - r * kGroup;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int off = Skv - Sq;  // suffix alignment
  const int qpos = qi + off;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = g + kGroup * i;
    qr[i] = (row_ok && d < D)
                ? to_f32(q[(((long)b * Sq + qi) * Hq + hq) * D + d])
                : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  // The kv positions any row of this tile may see.
  const int last_row = min(q0 + kRows, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, last_row + off + 1);
  if (has_window) kv_lo = max(0, q0 + off - window + 1);
  for (int k0 = (kv_lo / kKeys) * kKeys; k0 < kv_hi; k0 += kKeys) {
    const int nk = min(kKeys, Skv - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int u = i / D, d = i - u * D;
      float kv = 0.f, vv = 0.f;
      if (u < nk) {
        const long gi = (((long)b * Skv + k0 + u) * Hkv + hk) * D + d;
        kv = to_f32(k[gi]);
        vv = to_f32(v[gi]);
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    // Pass 1: the tile's scores and their max.
    float mt = kNeg;
    for (int u = 0; u < nk; ++u) {
      const float* krow = ks + u * D;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = g + kGroup * i;
        if (d < D) part = fmaf(qr[i], krow[d], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int kpos = k0 + u;
      bool ok = row_ok;
      if (causal) ok = ok && kpos <= qpos;
      if (has_window) ok = ok && kpos > qpos - window;
      const float s = ok ? part * scale : kNeg;
      if (g == 0) ss[r * kKeys + u] = s;
      mt = fmaxf(mt, s);
    }
    __syncwarp();

    // Pass 2: rescale once, then accumulate p V.
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int u = 0; u < nk; ++u) {
      const float s = ss[r * kKeys + u];
      const float p = (s == kNeg) ? 0.f : expf(s - m_new);
      l += p;
      const float* vrow = vs + u * D;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = g + kGroup * i;
        if (d < D) acc[i] = fmaf(p, vrow[d], acc[i]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float denom = (l == 0.f) ? 1.f : l;
  T* orow = o + (((long)b * Sq + qi) * Hq + hq) * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = g + kGroup * i;
    if (d < D) store(orow + d, acc[i] / denom);
  }
}

template <typename T, int DPT>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int Hq, int Hkv, int D, float scale,
             int causal, int has_window, int window, cudaStream_t stream) {
  const int bytes = (2 * kKeys * D + kRows * kKeys) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_kernel<T, DPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (Sq + kRows - 1) / kRows);
  flash_kernel<T, DPT><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, Hq, Hkv, D,
      scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  if (D <= 4 * kGroup)
    return launch_d<T, 4>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale,
                          causal, has_window, window, stream);
  if (D <= 8 * kGroup)
    return launch_d<T, 8>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale,
                          causal, has_window, window, stream);
  if (D <= 16 * kGroup)
    return launch_d<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale,
                           causal, has_window, window, stream);
  if (D <= 32 * kGroup)
    return launch_d<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale,
                           causal, has_window, window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), all f32 (bf16 = 0) or all
// bf16 (bf16 = 1); o (B, Sq, Hq, D) in the same type.  D <= 256 and
// Hq % Hkv == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int D,
                                      float scale, int causal,
                                      int has_window, int window, int bf16,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale,
                                 causal, has_window, window, s);
  return launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                       has_window, window, s);
}
