// Mamba2 SSD intra-chunk step in bf16 on the tensor cores: for one
// (batch, chunk) and a group of heads, each (batch, head, chunk) cell of
// q positions gives
//   y_intra[t] = sum_{u <= t} (C_t . B_u) exp(dac_t - dac_u) dt_u x_u
//   state      = sum_u B_u^T exp(dac_last - dac_u) dt_u x_u     (n x p)
// in f32, from x, B and C in bf16 and dac, dt in f32; p, n and q are
// multiples of 16.  The inter-chunk recurrence stays in the wrapper.
//
// Replaces src/repro/kernels/ssd/kernel.py::ssd_chunks_pallas (TPU) for
// bf16 operands; f32 and other shapes stay on csrc/ssd.cu.
//
// Bound: at zamba2-7b's prefill (4 x 2048 tokens, 112 heads, q = 128,
// p = n = 64) the function moves 479,199,232 bytes (x, B, C, dac and dt
// read once, the f32 y_intra and states written once, two thirds of
// it), about 32 FLOP a byte, far below the ridge: 3.35 TB/s bounds it
// at 0.143 ms.  The design keeps the products off that path:
//
// - A block takes one (batch, chunk) and two heads.  B and C, shared
//   by every head, come in once for both; x of the second head streams
//   in by cp.async (16-byte copies of whole rows) while the block
//   computes the first.  That is 75 KB of shared memory at zamba2's
//   shape, so three blocks (12 warps) share an SM and hide each
//   other's loads; with four or eight heads a block (80-86 KB, two
//   blocks an SM) the kernel ran slower on an H100.  Rows in shared
//   memory are padded by 16 bytes, so the ldmatrix reads of eight rows
//   fall in eight distinct bank groups.
// - Each 16 x 16 tile of C B^T is an mma.sync.m16n8k16 product (bf16 in,
//   f32 out).  M = C B^T * exp(dac_t - dac_u) * dt_u is formed from the
//   accumulator fragments in registers, tile by tile, and is never held
//   whole; upper-triangular tiles are skipped, and on the diagonal the
//   mask applies before the exponent (u > t can overflow).
// - M x and (B w)^T x (w_u = exp(dac_last - dac_u) dt_u) run on the
//   tensor cores with the f32 factor split into hi = bf16(m) and lo =
//   bf16(m - hi), two products each, so the error stays near 2^-16 of
//   each term and the kernel meets the f32 plain version's tolerance.
//   A warp takes the 16-row strips i and q/16 - 1 - i of y, so the
//   causal work is even across the warps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;          // output columns a warp's item
constexpr int kTiles = kCols / 8;  // n8 tiles of an item
constexpr int kHeads = 2;          // heads a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two f32 values (a at the lower column) as hi and lo bf16 pairs.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat16 ha = __float2bfloat16_rn(a);
  const __nv_bfloat16 hb = __float2bfloat16_rn(b);
  hi = pack(ha, hb);
  lo = pack(__float2bfloat16_rn(a - __bfloat162float(ha)),
            __float2bfloat16_rn(b - __bfloat162float(hb)));
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// acc (16 x kCols of the output, columns pc ..) += A (16 x 16, as hi +
// lo) times x rows u0 .. u0 + 15, columns pc ...
__device__ __forceinline__ void times_x(float (&acc)[kTiles][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        uint32_t xrow, int pc, int P,
                                        int lane) {
#pragma unroll
  for (int ng = 0; ng < kTiles / 2; ++ng) {
    if (pc + 16 * ng >= P) break;
    uint32_t xb[4];
    ldsm_t(xb, xrow + (pc + 16 * ng + 8 * (lane / 16)) * 2);
    mma(acc[2 * ng], ah, xb[0], xb[1]);
    mma(acc[2 * ng], al, xb[0], xb[1]);
    mma(acc[2 * ng + 1], ah, xb[2], xb[3]);
    mma(acc[2 * ng + 1], al, xb[2], xb[3]);
  }
}

// kStrict drops the diagonal u == t from the mask: a planted fault that
// the checks on the card must reject, never launched by the wrapper.
template <bool kStrict>
__global__ void __launch_bounds__(kThreads)
ssd_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dac, const float* __restrict__ dt,
                const __nv_bfloat16* __restrict__ bm,
                const __nv_bfloat16* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ states, int S, int H, int P, int N,
                int Q) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int NC = gridDim.x;
  const int nh = min(kHeads, H - h0);
  const int RB = N * 2 + 16, RX = P * 2 + 16;  // padded row bytes
  uint8_t* cs = smem;                 // (Q, N) bf16
  uint8_t* bs = cs + Q * RB;          // (Q, N) bf16
  uint8_t* xs = bs + Q * RB;          // two (Q, P) bf16 buffers
  float* dacs = reinterpret_cast<float*>(xs + 2 * Q * RX);  // (kHeads, Q)
  float* dts = dacs + kHeads * Q;
  float* ws = dts + kHeads * Q;       // exp(dac_last - dac_u) dt_u

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;
  const long row0 = static_cast<long>(b) * S + static_cast<long>(c) * Q;

  const int nb = N / 8;
  for (int i = tid; i < Q * nb; i += kThreads) {
    const int t = i / nb, k = i - t * nb;
    cp_async16(cs + t * RB + k * 16, cm + (row0 + t) * N + k * 8);
    cp_async16(bs + t * RB + k * 16, bm + (row0 + t) * N + k * 8);
  }
  const int nx = P / 8;
  auto load_x = [&](int hh) {
    uint8_t* dst = xs + (hh & 1) * Q * RX;
    for (int i = tid; i < Q * nx; i += kThreads) {
      const int t = i / nx, k = i - t * nx;
      cp_async16(dst + t * RX + k * 16,
                 x + ((row0 + t) * H + h0 + hh) * P + k * 8);
    }
  };
  load_x(0);
  cp_commit();
  for (int i = tid; i < Q * kHeads; i += kThreads) {
    const int t = i / kHeads, hh = i - t * kHeads;
    float a = 0.f, d = 0.f;
    if (hh < nh) {
      const long gi = (row0 + t) * H + h0 + hh;
      a = dac[gi];
      d = dt[gi];
    }
    dacs[hh * Q + t] = a;
    dts[hh * Q + t] = d;
  }
  __syncthreads();
  for (int i = tid; i < Q * kHeads; i += kThreads) {
    const int hh = i / Q;
    ws[i] = expf(dacs[hh * Q + Q - 1] - dacs[i]) * dts[i];
  }

  const uint32_t c_addr = smem_u32(cs), b_addr = smem_u32(bs);
  const int nT = Q / 16;
  for (int hh = 0; hh < nh; ++hh) {
    if (hh + 1 < nh) load_x(hh + 1);
    cp_commit();
    cp_wait_prev();  // this head's x (and B, C) have landed
    __syncthreads();
    const uint32_t x_addr = smem_u32(xs + (hh & 1) * Q * RX);
    const float* dac_h = dacs + hh * Q;
    const float* dt_h = dts + hh * Q;
    const float* w_h = ws + hh * Q;
    const int h = h0 + hh;

    // y_intra: a warp's item is a pair of 16-row strips, i and
    // nT - 1 - i (so the causal work is even), times kCols columns.
    const int np = (nT + 1) / 2, npc = (P + kCols - 1) / kCols;
    for (int item = warp; item < np * npc; item += kWarps) {
      const int pc = (item / np) * kCols;
      for (int half = 0; half < 2; ++half) {
        const int i = half ? nT - 1 - item % np : item % np;
        if (half && i == item % np) break;
        const int tA = 16 * i + g, tB = tA + 8;
        const float dA = dac_h[tA], dB = dac_h[tB];
        float acc[kTiles][4];
#pragma unroll
        for (int n = 0; n < kTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
        for (int k = 0; k <= i; ++k) {
          float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int ks = 0; ks < N / 16; ++ks) {
            uint32_t a[4], bb[4];
            ldsm(a, c_addr + (16 * i + lane % 16) * RB +
                        (16 * ks + 8 * (lane / 16)) * 2);
            ldsm(bb, b_addr + (16 * k + lane % 8 + 8 * (lane / 16)) * RB +
                         (16 * ks + 8 * ((lane / 8) % 2)) * 2);
            mma(cb[0], a, bb[0], bb[1]);
            mma(cb[1], a, bb[2], bb[3]);
          }
          // M on this tile; fragment (nt, e) sits at row tA (e < 2) or
          // tB, column u = 16 k + 8 nt + 2 cq + e % 2.
          float mv[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = e < 2 ? tA : tB;
              const int u = 16 * k + 8 * nt + 2 * cq + (e % 2);
              const bool keep = k < i || (kStrict ? u < t : u <= t);
              mv[nt][e] = keep ? cb[nt][e] * expf((e < 2 ? dA : dB) -
                                                  dac_h[u]) * dt_h[u]
                               : 0.f;
            }
          uint32_t mh[4], ml[4];
          split(mv[0][0], mv[0][1], mh[0], ml[0]);
          split(mv[0][2], mv[0][3], mh[1], ml[1]);
          split(mv[1][0], mv[1][1], mh[2], ml[2]);
          split(mv[1][2], mv[1][3], mh[3], ml[3]);
          times_x(acc, mh, ml, x_addr + (16 * k + lane % 16) * RX, pc, P,
                  lane);
        }
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt) {
          const int col = pc + 8 * nt + 2 * cq;
          if (col < P) {
            *reinterpret_cast<float2*>(y + ((row0 + tA) * H + h) * P + col) =
                make_float2(acc[nt][0], acc[nt][1]);
            *reinterpret_cast<float2*>(y + ((row0 + tB) * H + h) * P + col) =
                make_float2(acc[nt][2], acc[nt][3]);
          }
        }
      }
    }

    // End-of-chunk state: items of 16 state rows x kCols columns.
    float* st = states + ((static_cast<long>(b) * NC + c) * H + h) *
                             static_cast<long>(N) * P;
    const int nS = N / 16;
    for (int item = warp; item < nS * npc; item += kWarps) {
      const int ns = item % nS, pc = (item / nS) * kCols;
      float acc[kTiles][4];
#pragma unroll
      for (int n = 0; n < kTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      for (int ku = 0; ku < nT; ++ku) {
        // A = B^T (rows: state index, columns: u) scaled by w_u.
        uint32_t a[4], ah[4], al[4];
        ldsm_t(a, b_addr + (16 * ku + lane % 8 + 8 * (lane / 16)) * RB +
                      (16 * ns + 8 * ((lane / 8) % 2)) * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = 16 * ku + 2 * cq + (e >= 2 ? 8 : 0);
          split(lo_f(a[e]) * w_h[u], hi_f(a[e]) * w_h[u + 1], ah[e], al[e]);
        }
        times_x(acc, ah, al, x_addr + (16 * ku + lane % 16) * RX, pc, P,
                lane);
      }
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const int col = pc + 8 * nt + 2 * cq;
        if (col < P) {
          *reinterpret_cast<float2*>(st + (16 * ns + g) * P + col) =
              make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(st + (16 * ns + g + 8) * P + col) =
              make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncthreads();  // the next head's prefetch reuses this buffer
  }
}

template <bool kStrict>
int launch(const void* x, const float* dac, const float* dt, const void* bm,
           const void* cm, float* y, float* states, int batch, int S, int H,
           int P, int N, int Q, cudaStream_t stream) {
  const int bytes = 2 * Q * (N * 2 + 16) + 2 * Q * (P * 2 + 16) +
                    3 * kHeads * Q * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)ssd_sm90_kernel<kStrict>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / Q, (H + kHeads - 1) / kHeads, batch);
  ssd_sm90_kernel<kStrict><<<grid, kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)x, dac, dt, (const __nv_bfloat16*)bm,
      (const __nv_bfloat16*)cm, y, states, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// x (batch, S, H, P), B and C (batch, S, N) bf16, 16-byte aligned; dac,
// dt (batch, S, H) f32.  Writes y_intra (batch, S, H, P) and states
// (batch, S / Q, H, N, P), both f32.  P, N, Q multiples of 16, S % Q ==
// 0.  strict = 1 launches the planted fault (diagonal masked out).
extern "C" int ssd_sm90_launch(const void* x, const float* dac,
                               const float* dt, const void* bm,
                               const void* cm, float* y, float* states,
                               int batch, int S, int H, int P, int N, int Q,
                               int strict, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0) return 0;
  if (P % 16 || N % 16 || Q % 16 || P <= 0 || N <= 0 || Q <= 0 || S % Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (strict)
    return launch<true>(x, dac, dt, bm, cm, y, states, batch, S, H, P, N, Q,
                        s);
  return launch<false>(x, dac, dt, bm, cm, y, states, batch, S, H, P, N, Q,
                       s);
}

// An empty kernel on the grid, block and shared memory ssd_sm90_kernel
// would run for these shapes: its device time is the launch floor
// beneath the scan's (a reading, not a bound).
__global__ void __launch_bounds__(kThreads) ssd_sm90_floor_kernel() {}

extern "C" int ssd_sm90_floor_launch(int batch, int S, int H, int P, int N,
                                     int Q, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || Q <= 0 || S % Q)
    return (int)cudaErrorInvalidValue;
  const int bytes = 2 * Q * (N * 2 + 16) + 2 * Q * (P * 2 + 16) +
                    3 * kHeads * Q * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)ssd_sm90_floor_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / Q, (H + kHeads - 1) / kHeads, batch);
  ssd_sm90_floor_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
