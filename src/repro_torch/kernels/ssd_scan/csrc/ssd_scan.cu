// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan/ssd_scan.py:
//   * ssd_kernel <- _ssd_kernel (:19), pallas_call at :73 (ssd_scan).
// Per batch row b and head h, over the sequence in order:
//   y[t]  = sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s  +  D_h x_t
// computed chunk by chunk: with cum the running sum of la = dt * A inside
// a chunk, a chunk's y is its intra-chunk term (C_i.B_j) exp(cum_i - cum_j)
// dt_j x_j over j <= i, plus the inter-chunk term exp(cum_i) C_i.S, plus
// the skip; then the state S [P, N] (f32) moves on as
// S <- exp(total) S + sum_j exp(total - cum_j) dt_j x_j B_j^T.
// Inputs x [B,S,H,P], B and C [B,S,N] in f32 or bf16; dt and la [B,S,H]
// and D [H] in f32 (the wrapper computes la = dt * -exp(A_log), as the TPU
// kernel's wrapper does); y [B,S,H,P] in f32 or bf16, as the caller asks:
// the model wants f32 (its reference keeps y in f32 until the gated norm),
// the TPU kernel writes its input's type.
//
// What the TPU layout cannot carry over, and what this kernel does instead:
//   * the TPU kernel holds the whole state [H, P, N] in VMEM (2.6 MB per
//     batch row at mamba2-2.7b's 80 x 64 x 128); a Hopper block has 227 KB
//     of shared memory.  So the grid is (H, B): one block per (head, batch
//     row) walks its chunks in order, with its head's state [P, N] f32 in
//     shared memory (32 KB at P 64, N 128).  B and C are shared by all
//     heads (one group), so each block computes its own C.B^T: recomputed
//     per head, 2 Q^2 N flops a chunk more than once per (b, chunk).
//   * the model's chunk is 256; a [256, 256] f32 score tile is 256 KB.  The
//     kernel walks 64-row sub-chunks (the TPU kernel's default chunk) and
//     carries the state across them.  The SSD output does not depend on the
//     chunk length except by rounding.  A ragged last sub-chunk (S not a
//     multiple of 64) is padded with dt = la = 0 rows, which add nothing.
//   * exp(cum_i - cum_j) overflows f32 above the diagonal (cum falls with
//     t, so the difference is positive there and reaches ~177 over a
//     256-row chunk at dt ~ 0.69, A = -1), and inf * 0 is NaN.  The kernel
//     never takes exp for j > i.
// Bound on this card: operations.  Per (head, 64-row sub-chunk) it does
// 2 Q^2 N (C.B^T) + Q^2 P (the causal half of att.x, counted whole) +
// 2 Q N P (C.S) + 2 Q N P (the state update) flops: ~3.7 MFLOP at P 64,
// N 128, against ~50 KB of bf16 in and 16 KB of f32 out, ~55 flops per
// byte.  This first version uses scalar f32 FMA (CUDA cores, 67 TFLOP/s),
// each of its four products a 16 x 16 grid of threads with 4 x up to 8
// register tiles over shared-memory operands whose rows are padded to an
// odd length (no bank conflicts); tensor cores (TF32 / bf16 mma) are later
// work.  P and N must be at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // rows a sub-chunk
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kMaxDim = 128;    // P and N: 16 threads x 8 register columns
constexpr int kCols = kMaxDim / 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// floats of dynamic shared memory: x [Q][P], B and C [Q][N+1],
// att [Q][Q+1], the state [P][N+1], cum, dt and the state weights [Q]
__host__ __device__ inline size_t smem_floats(int p, int n) {
  return static_cast<size_t>(kQ) * p + 2 * kQ * (n + 1) + kQ * (kQ + 1) +
         static_cast<size_t>(p) * (n + 1) + 3 * kQ;
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const TIn* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ la, const TIn* __restrict__ bm,
           const TIn* __restrict__ cm, const float* __restrict__ d_skip,
           TOut* __restrict__ y, int seq, int heads, int p_dim, int n_dim) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int ldn = n_dim + 1, lda = kQ + 1;
  float* xs = smem;                        // [Q][P]
  float* bs = xs + kQ * p_dim;             // [Q][N+1]
  float* cs = bs + kQ * ldn;               // [Q][N+1]
  float* as = cs + kQ * ldn;               // [Q][Q+1]: att, dt folded in
  float* ss = as + kQ * lda;               // [P][N+1]: the state
  float* cum = ss + p_dim * ldn;           // [Q]
  float* dts = cum + kQ;                   // [Q]
  float* win = dts + kQ;                   // [Q]: exp(total - cum_j) dt_j
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float dsk = d_skip[h];
  for (int i = tid; i < p_dim * ldn; i += kThreads) ss[i] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += kQ) {
    const int rows = min(kQ, seq - t0);
    const size_t row0 = static_cast<size_t>(b) * seq + t0;
    for (int i = tid; i < kQ * p_dim; i += kThreads) {
      const int j = i / p_dim;
      xs[i] = j < rows ? to_f(x[((row0 + j) * heads + h) * p_dim + i % p_dim])
                       : 0.f;
    }
    for (int i = tid; i < kQ * n_dim; i += kThreads) {
      const int j = i / n_dim, n = i % n_dim;
      const size_t g = (row0 + j) * n_dim + n;
      bs[j * ldn + n] = j < rows ? to_f(bm[g]) : 0.f;
      cs[j * ldn + n] = j < rows ? to_f(cm[g]) : 0.f;
    }
    if (tid < kQ) {
      const size_t g = (row0 + tid) * heads + h;
      dts[tid] = tid < rows ? dt[g] : 0.f;
      cum[tid] = tid < rows ? la[g] : 0.f;
    }
    __syncthreads();
    if (tid < 32) {                        // inclusive cumsum of la: a warp
      const float a0 = cum[2 * tid], a1 = cum[2 * tid + 1];   // scan, two
      float s = a0 + a1;                                      // rows a lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) before = 0.f;
      cum[2 * tid] = before + a0;
      cum[2 * tid + 1] = (before + a0) + a1;
    }
    __syncthreads();
    const float total = cum[kQ - 1];
    if (tid < kQ) win[tid] = expf(total - cum[tid]) * dts[tid];

    // att[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    {
      float acc[4][4] = {};
      for (int n = 0; n < n_dim; ++n) {
        float a[4], c[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = cs[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) c[q] = bs[(tx + 16 * q) * ldn + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += a[r] * c[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = ty + 16 * r, j = tx + 16 * q;
          as[i * lda + j] =
              j <= i ? acc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();

    // y[i][p] = sum_j att[i][j] x[j][p] + exp(cum_i) C_i . S[p] + D x[i][p]
    {
      float intra[4][kCols] = {}, inter[4][kCols] = {};
      const int j_end = min(kQ, ty + 48 + 1);   // j <= the thread's last row
      for (int j = 0; j < j_end; ++j) {
        float a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = as[(ty + 16 * r) * lda + j];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int p = tx + 16 * q;
          if (p < p_dim) {
            const float v = xs[j * p_dim + p];
#pragma unroll
            for (int r = 0; r < 4; ++r) intra[r][q] += a[r] * v;
          }
        }
      }
      for (int n = 0; n < n_dim; ++n) {
        float a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = cs[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int p = tx + 16 * q;
          if (p < p_dim) {
            const float v = ss[p * ldn + n];
#pragma unroll
            for (int r = 0; r < 4; ++r) inter[r][q] += a[r] * v;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= rows) continue;
        const float e = expf(cum[i]);
        TOut* out = y + ((row0 + i) * heads + h) * p_dim;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int p = tx + 16 * q;
          if (p < p_dim)
            out[p] = from_f<TOut>(intra[r][q] + inter[r][q] * e +
                                  dsk * xs[i * p_dim + p]);
        }
      }
    }
    __syncthreads();

    // S[p][n] <- exp(total) S[p][n] + sum_j x[j][p] w_j B[j][n]
    {
      float acc[kCols][kCols] = {};
      for (int j = 0; j < kQ; ++j) {
        const float wj = win[j];
        float c[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int n = tx + 16 * q;
          c[q] = n < n_dim ? bs[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kCols; ++r) {
          const int p = ty + 16 * r;
          if (p >= p_dim) continue;          // rows past P
          const float a = xs[j * p_dim + p] * wj;
#pragma unroll
          for (int q = 0; q < kCols; ++q) acc[r][q] += a * c[q];
        }
      }
      const float decay = expf(total);
#pragma unroll
      for (int r = 0; r < kCols; ++r)
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int p = ty + 16 * r, n = tx + 16 * q;
          if (p < p_dim && n < n_dim)
            ss[p * ldn + n] = ss[p * ldn + n] * decay + acc[r][q];
        }
    }
    __syncthreads();
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* dt, const void* la, const void* bm,
           const void* cm, const void* d_skip, void* y, int batch, int seq,
           int heads, int p_dim, int n_dim, cudaStream_t stream) {
  const size_t bytes = smem_floats(p_dim, n_dim) * sizeof(float);
  auto* kernel = ssd_kernel<TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(heads, batch), kThreads, bytes, stream>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(la), static_cast<const TIn*>(bm),
      static_cast<const TIn*>(cm), static_cast<const float*>(d_skip),
      static_cast<TOut*>(y), seq, heads, p_dim, n_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 = launched.  in_dtype (x, B, C) and out_dtype
// (y): 0 = float32, 1 = bfloat16.  p_dim and n_dim in 1..128; batch at
// most 65,535.
int ssd_scan_launch(int in_dtype, int out_dtype, const void* x,
                    const void* dt, const void* la, const void* bm,
                    const void* cm, const void* d_skip, void* y, int batch,
                    int seq, int heads, int p_dim, int n_dim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dim < 1 || p_dim > kMaxDim || n_dim < 1 || n_dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const int code = in_dtype * 2 + out_dtype;
  switch (code) {
    case 0: return launch<float, float>(x, dt, la, bm, cm, d_skip, y, batch, seq, heads, p_dim, n_dim, s);
    case 1: return launch<float, bf16>(x, dt, la, bm, cm, d_skip, y, batch, seq, heads, p_dim, n_dim, s);
    case 2: return launch<bf16, float>(x, dt, la, bm, cm, d_skip, y, batch, seq, heads, p_dim, n_dim, s);
    case 3: return launch<bf16, bf16>(x, dt, la, bm, cm, d_skip, y, batch, seq, heads, p_dim, n_dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
