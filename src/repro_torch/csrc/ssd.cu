// Mamba2 SSD intra-chunk step: for one (batch, head, chunk) cell of q
// positions,
//   y_intra[t] = sum_{u <= t} (C_t . B_u) exp(dac_t - dac_u) dt_u x_u
//   state      = sum_u B_u^T exp(dac_last - dac_u) dt_u x_u     (n x p)
// all in f32, with x, B and C in f32 or bf16.  The inter-chunk
// recurrence and the y_inter product stay in the wrapper
// (kernels/ssd/ops.py), as they did beside the TPU kernel.
//
// Replaces src/repro/kernels/ssd/kernel.py::ssd_chunks_pallas (TPU).
// The TPU kernel took operands packed to (b*h, nc, q, .) with B and C
// broadcast over heads; this one reads x (b, s, h, p), dt and dac
// (b, s, h) and B, C (b, s, n) where they lie, B and C by batch index,
// and writes y_intra in the (b, s, h, p) layout of the output.
//
// One block of 256 threads per cell.  The cell's x, B, C, dac and dt
// sit in dynamic shared memory as f32 (104 KB at q = 128, p = n = 64);
// the (q, q) matrix M = (C B^T) * L * dt is never held whole: each
// warp builds one row of it at a time (lanes over u <= t, so the
// masked half is never computed and exp(dac_t - dac_u) for u > t, which
// can overflow, is never taken) and then sums that row against x
// (lanes over p).  B's rows are padded to n + 1 floats so the lanes'
// reads of B_u fall in distinct banks.
//
// Bound: at zamba2's prefill shapes (q = 128, p = n = 64, bf16 x) a
// cell does ~3.2 MFLOP (the causal half of C B^T and of M x, plus the
// state) against ~100 KB moved, ~32 FLOP a byte, below the H100's
// ridge of ~295: HBM bandwidth bounds it, and the f32 y_intra and
// state outputs are two thirds of the bytes.  This kernel runs its
// products on the CUDA cores from shared memory, far from either
// bound.  It takes f32 and the shapes outside the tensor-core kernel's
// domain; bf16 with p, n and q multiples of 16 goes to ssd_sm90.cu
// (mma.sync), as kernels/ssd/ops.py::kernel_for decides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dac,
                 const float* __restrict__ dt, const T* __restrict__ bm,
                 const T* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ states, int S, int H, int P, int N,
                 int Q) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.x;
  const int NB = N + 1;        // padded row stride of B
  float* xs = smem;            // (Q, P)
  float* bs = xs + Q * P;      // (Q, N + 1)
  float* cs = bs + Q * NB;     // (Q, N)
  float* dacs = cs + Q * N;    // (Q)
  float* dts = dacs + Q;       // (Q)
  float* ws = dts + Q;         // (Q): exp(dac_last - dac_u) * dt_u
  float* mrow = ws + Q;        // (kWarps, Q): one row of M per warp

  const int tid = threadIdx.x;
  const long row0 = (long)b * S + (long)c * Q;  // first position's row
  for (int i = tid; i < Q * P; i += kThreads) {
    const int t = i / P, j = i - t * P;
    xs[i] = to_f32(x[((row0 + t) * H + h) * P + j]);
  }
  for (int i = tid; i < Q * N; i += kThreads) {
    const int t = i / N, k = i - t * N;
    const long g = (row0 + t) * N + k;
    bs[t * NB + k] = to_f32(bm[g]);
    cs[i] = to_f32(cm[g]);
  }
  for (int t = tid; t < Q; t += kThreads) {
    const long g = (row0 + t) * H + h;
    dacs[t] = dac[g];
    dts[t] = dt[g];
  }
  __syncthreads();
  const float dac_last = dacs[Q - 1];
  for (int t = tid; t < Q; t += kThreads)
    ws[t] = expf(dac_last - dacs[t]) * dts[t];

  // y_intra, one row t per warp at a time.
  const int warp = tid >> 5, lane = tid & 31;
  float* m = mrow + warp * Q;
  for (int t = warp; t < Q; t += kWarps) {
    const float* crow = cs + t * N;
    const float dac_t = dacs[t];
    for (int u = lane; u <= t; u += 32) {
      const float* brow = bs + u * NB;
      float dot = 0.f;
      for (int k = 0; k < N; ++k) dot = fmaf(crow[k], brow[k], dot);
      m[u] = dot * expf(dac_t - dacs[u]) * dts[u];
    }
    __syncwarp();
    float* yrow = y + ((row0 + t) * H + h) * P;
    for (int j = lane; j < P; j += 32) {
      float acc = 0.f;
      for (int u = 0; u <= t; ++u) acc = fmaf(m[u], xs[u * P + j], acc);
      yrow[j] = acc;
    }
    __syncwarp();
  }
  __syncthreads();  // ws complete

  // End-of-chunk state (n x p).
  float* st = states + (((long)b * NC + c) * H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) {
    const int k = i / P, j = i - k * P;
    float acc = 0.f;
    for (int u = 0; u < Q; ++u)
      acc = fmaf(bs[u * NB + k] * ws[u], xs[u * P + j], acc);
    st[i] = acc;
  }
}

template <typename T>
int launch(const void* x, const float* dac, const float* dt, const void* bm,
           const void* cm, float* y, float* states, int batch, int S, int H,
           int P, int N, int Q, cudaStream_t stream) {
  if (batch <= 0 || S <= 0 || H <= 0) return 0;
  const size_t floats = (size_t)Q * P + (size_t)Q * (N + 1) +
                        (size_t)Q * N + 3 * (size_t)Q + kWarps * (size_t)Q;
  const int bytes = (int)(floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)ssd_chunk_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / Q, H, batch);
  ssd_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, dac, dt, (const T*)bm, (const T*)cm, y, states, S, H, P,
      N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// x (batch, S, H, P), B and C (batch, S, N) in f32 (bf16 = 0) or bf16
// (bf16 = 1); dac, dt (batch, S, H) f32.  Writes y_intra (batch, S, H,
// P) and states (batch, S / Q, H, N, P), both f32.  S % Q == 0.
extern "C" int ssd_chunks_launch(const void* x, const float* dac,
                                 const float* dt, const void* bm,
                                 const void* cm, float* y, float* states,
                                 int batch, int S, int H, int P, int N,
                                 int Q, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, dac, dt, bm, cm, y, states, batch, S,
                                 H, P, N, Q, s);
  return launch<float>(x, dac, dt, bm, cm, y, states, batch, S, H, P, N, Q,
                       s);
}
