// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan/ssd_scan.py:
//   * ssd_mma_kernel and ssd_kernel <- _ssd_kernel (:19), pallas_call at
//     :73 (ssd_scan).
// Per batch row b and head h, over the sequence in order:
//   y[t]  = sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s  +  D_h x_t
// computed chunk by chunk: with cum the running sum of la = dt * A inside
// a chunk (A = -exp(A_log[h]), computed here from a_log), a chunk's y is
// its intra-chunk term (C_i.B_j) exp(cum_i - cum_j) dt_j x_j over j <= i,
// plus the inter-chunk term exp(cum_i) C_i.S, plus the skip; then the
// state S [P, N] (f32) moves on as
// S <- exp(total) S + sum_j exp(total - cum_j) dt_j x_j B_j^T.
// Inputs x [B,S,H,P], B and C [B,S,N] in f32 or bf16; dt [B,S,H], A_log
// and D [H] in f32; y [B,S,H,P] in f32 or bf16, as the caller asks: the
// model wants f32 (its reference keeps y in f32 until the gated norm), the
// TPU kernel writes its input's type.
//
// What the TPU layout cannot carry over, and what both routes do instead:
//   * the TPU kernel holds the whole state [H, P, N] in VMEM (2.6 MB per
//     batch row at mamba2-2.7b's 80 x 64 x 128); a Hopper block has 227 KB
//     of shared memory.  So the grid is (H, B): one block per (head, batch
//     row) walks its chunks in order and keeps its head's state on chip.
//   * the model's chunk is 256; a [256, 256] f32 score tile is 256 KB.  The
//     kernels walk 64-row sub-chunks (the TPU kernel's default chunk) and
//     carry the state across them.  The SSD output does not depend on the
//     chunk length except by rounding.  A ragged last sub-chunk (S not a
//     multiple of 64) is padded with dt = la = 0 rows, which add nothing.
//   * exp(cum_i - cum_j) overflows f32 above the diagonal (cum falls with
//     t, so the difference is positive there and reaches ~177 over a
//     256-row chunk at dt ~ 0.69, A = -1), and inf * 0 is NaN.  The
//     exponent is masked to -inf (or the term skipped) before exp.
//
// Route "mma" (ssd_mma_kernel): bf16 x, B and C with P in {64, 128} and N
// in {64, 128}.  Bound on this card: bytes.  Per (head, 64-row sub-chunk)
// the scan does Q^2 P (the causal half of att.x) + 4 Q N P flops, and per
// batch row and sub-chunk Q^2 N (C.B^T's causal half): 48.5 GFLOP at B 4 x
// S 4,096 x H 80 x P 64 x N 128, ~97 in the two bf16 passes below, 0.098
// ms at 989 TFLOP/s; its bytes, x, B, C, dt in and the f32 y out once,
// are 516,948,608, 0.1543 ms at 3.35 TB/s.  The design:
//   * all four products on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulators).  Each has one operand exact in bf16 (x, B and C
//     are inputs); the other is split into hi = bf16(v) and lo = bf16(v -
//     hi) and multiplied twice, which keeps ~16 bits of it: one bf16 pass
//     misses the elementwise gate 1e-4 |y| + 1e-5 max|y| ~50-fold, two
//     passes land at ~0.2 of it (ref.ssd_chunked_split).  C.B^T: one pass;
//     att.x: att = (C.B^T) exp(cum_i - cum_j) dt_j split; C.S: the state
//     split; the state update: x_j w_j split (P values a row, fewer than
//     w_j B_j's N), times B.
//   * the state stays in registers for the whole sequence: each warp owns
//     16 of the P state rows as mma accumulators (64 f32 a thread at N
//     128), scales them by exp(total) and accumulates (x w)^T B onto them.
//     The inter-chunk term is computed transposed, y^T = S . C^T, so the
//     accumulators feed the next product's A operand straight from
//     registers (an m16n8 accumulator pair is an m16k16 A fragment): the
//     state never touches shared or device memory.  y^T's intra term
//     x^T . att^T accumulates onto the same registers.
//   * C.B^T and att are computed once a block: warp w takes the 16 score
//     rows of its row tile, only the column tiles at or below the
//     diagonal, and writes att's hi and lo pieces to shared memory; the
//     att.x product skips the k-steps above the diagonal.
//   * x, B, C and dt of the next sub-chunk load by cp.async into a second
//     stage while this one computes (2 x 44 KB at P 64, N 128); shared
//     rows are padded by 16 bytes so ldmatrix and the fragment stores hit
//     distinct banks.  ~108 KB a block at P 64: two blocks (8 warps) an
//     SM, 320 blocks on 264 slots at mamba2's B 4 x H 80.
//   * y goes through shared memory (aliasing att) so each thread stores 16
//     bytes of a row along P; D x is added there.
// Not yet: a grid that fills the last wave (320 blocks are 1.2 waves of
// 264), sharing C.B^T across heads, wgmma.
//
// Route "simt" (ssd_kernel): everything else (f32, odd widths; P and N at
// most 128).  Bound: operations, scalar f32 FMA (67 TFLOP/s).  Each of its
// four products is a 16 x 16 grid of threads with 4 x up to 8 register
// tiles over shared-memory operands whose rows are padded to an odd
// length (no bank conflicts); the state [P, N] f32 sits in shared memory
// (32 KB at P 64, N 128), C.B^T is recomputed per head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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
           const float* __restrict__ a_log, const TIn* __restrict__ bm,
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
  const float a_coef = -expf(a_log[h]);
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
      cum[tid] = tid < rows ? dt[g] * a_coef : 0.f;
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
int launch(const void* x, const void* dt, const void* a_log, const void* bm,
           const void* cm, const void* d_skip, void* y, int batch, int seq,
           int heads, int p_dim, int n_dim, cudaStream_t stream) {
  if (p_dim < 1 || p_dim > kMaxDim || n_dim < 1 || n_dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(p_dim, n_dim) * sizeof(float);
  auto* kernel = ssd_kernel<TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(heads, batch), kThreads, bytes, stream>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const TIn*>(bm),
      static_cast<const TIn*>(cm), static_cast<const float*>(d_skip),
      static_cast<TOut*>(y), seq, heads, p_dim, n_dim);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Route "mma": the tensor-core kernel
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kPad = 8;   // bf16 a shared row is padded by: 16 bytes

template <int N, int G>   // state width N; G groups of 64 state rows
struct Mma {
  static constexpr int P = 64 * G;
  static constexpr int kWarps = 4 * G;       // 16 state rows a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLdX = P + kPad, kLdN = N + kPad, kLdA = kQ + kPad;
  static constexpr int kLdY = P + 4;         // floats a staged row of y
  // bytes: a stage holds x [Q][P], B and C [Q][N] (bf16) and dt [Q]
  static constexpr int kX = kQ * kLdX * 2, kBC = kQ * kLdN * 2;
  static constexpr int kStage = kX + 2 * kBC + kQ * 4;
  static constexpr int kAtt = 2 * kQ * kLdA * 2;  // att's hi and lo pieces
  static constexpr int kY = kQ * kLdY * 4;        // y, staged (aliases att)
  static constexpr int kShared = kAtt > kY ? kAtt : kY;
  static constexpr int kBytes = 2 * kStage + kShared + kWarps * 3 * kQ * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// src_bytes 0 zero-fills the destination (a padded row)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.  Without .trans thread (g, t) receives row g, columns 2t
// and 2t + 1 of each; with .trans, rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulators.  Per
// thread (g = lane / 4, t = lane % 4): A's registers hold (row g, columns
// 2t, 2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B's (rows
// 2t, 2t+1 of column g), (rows 2t + 8.., column g); D's (g, 2t), (g,
// 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// (v0, v1) as two bf16 pieces: hi = bf16(v), lo = bf16(v - hi), each pair
// packed with v0 in the low half (a fragment register's order).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)),
                 bits(__floats2bfloat162_rn(v.z, v.w)));
}

// Start the copies of sub-chunk rows [t0, t0 + 64) into a stage; rows past
// the sequence are zero-filled (dt 0 makes them add nothing).
template <int N, int G>
__device__ __forceinline__ void load_stage(
    uint8_t* stage, const bf16* __restrict__ x, const float* __restrict__ dt,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm, int b, int h,
    int t0, int seq, int heads) {
  using M = Mma<N, G>;
  bf16* xs = reinterpret_cast<bf16*>(stage);
  bf16* bs = reinterpret_cast<bf16*>(stage + M::kX);
  bf16* cs = reinterpret_cast<bf16*>(stage + M::kX + M::kBC);
  float* dts = reinterpret_cast<float*>(stage + M::kX + 2 * M::kBC);
  const int rows = min(kQ, seq - t0);
  const size_t row0 = static_cast<size_t>(b) * seq + t0;
  constexpr int kXc = M::P / 8, kNc = N / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < kQ * kXc; i += M::kThreads) {
    const int j = i / kXc, c = i % kXc;
    const bool ok = j < rows;
    cp_async16(xs + j * M::kLdX + 8 * c,
               x + ((row0 + (ok ? j : 0)) * heads + h) * M::P + 8 * c,
               ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < kQ * kNc; i += M::kThreads) {
    const int j = i / kNc, c = i % kNc;
    const bool ok = j < rows;
    const size_t g = (row0 + (ok ? j : 0)) * N + 8 * c;
    cp_async16(bs + j * M::kLdN + 8 * c, bm + g, ok ? 16 : 0);
    cp_async16(cs + j * M::kLdN + 8 * c, cm + g, ok ? 16 : 0);
  }
  if (threadIdx.x < kQ) {
    const int j = threadIdx.x;
    const bool ok = j < rows;
    cp_async4(dts + j, dt + (row0 + (ok ? j : 0)) * heads + h, ok ? 4 : 0);
  }
  cp_async_commit();
}

template <int N, int G, typename TOut>
__global__ void __launch_bounds__(Mma<N, G>::kThreads, G == 1 ? 2 : 1)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const float* __restrict__ d_skip,
               TOut* __restrict__ y, int seq, int heads) {
  using M = Mma<N, G>;
  constexpr int P = M::P;
  extern __shared__ __align__(16) uint8_t smem_mma[];
  uint8_t* smem = smem_mma;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = warp % 4;           // the 16 score rows this warp computes
  const int grp = warp / 4;          // which of the G warps of a row tile
  const int pb = 16 * warp;          // the 16 state rows (p) this warp owns
  // ldmatrix lane offsets (row, column) into a 16 x 16 tile: (lr, lc) for
  // an A tile stored [m][k] and, with .trans, a B tile stored [k][n];
  // (br, bc) for a pair of B tiles stored [n][k] and, with .trans, an A
  // tile stored [k][m]
  const int lr = (lane % 8) + 8 * ((lane / 8) % 2), lc = 8 * (lane / 16);
  const int br = (lane % 8) + 8 * (lane / 16), bc = 8 * ((lane / 8) % 2);
  bf16* att_hi = reinterpret_cast<bf16*>(smem + 2 * M::kStage);
  bf16* att_lo = att_hi + kQ * M::kLdA;
  float* ystage = reinterpret_cast<float*>(smem + 2 * M::kStage);
  float* cum = reinterpret_cast<float*>(smem + 2 * M::kStage + M::kShared) +
               warp * 3 * kQ;        // this warp's copy of cum, w, e^cum
  float* wgt = cum + kQ;
  float* ecum = wgt + kQ;
  const float a_coef = -expf(a_log[h]);
  const float dsk = d_skip[h];

  float st[N / 8][4];                // S[pb + g (+8)][8 nt + 2t (+1)]
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[nt][e] = 0.f;

  const int nc = (seq + kQ - 1) / kQ;
  load_stage<N, G>(smem, x, dt, bm, cm, b, h, 0, seq, heads);
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kQ, rows = min(kQ, seq - t0);
    const uint8_t* stage = smem + (c & 1) * M::kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(stage);
    const bf16* bs = reinterpret_cast<const bf16*>(stage + M::kX);
    const bf16* cs = reinterpret_cast<const bf16*>(stage + M::kX + M::kBC);
    const float* dts =
        reinterpret_cast<const float*>(stage + M::kX + 2 * M::kBC);
    cp_async_wait_all();
    __syncthreads();                 // this stage landed; the other is free
    if (c + 1 < nc)
      load_stage<N, G>(smem + ((c + 1) & 1) * M::kStage, x, dt, bm, cm, b, h,
                       t0 + kQ, seq, heads);

    // every warp scans la itself (two rows a lane), into its own copy
    float total;
    {
      const float d0 = dts[2 * lane], d1 = dts[2 * lane + 1];
      const float a0 = d0 * a_coef, a1 = d1 * a_coef;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += v;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) before = 0.f;
      const float c0 = before + a0, c1 = c0 + a1;
      total = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      wgt[2 * lane] = expf(total - c0) * d0;
      wgt[2 * lane + 1] = expf(total - c1) * d1;
      ecum[2 * lane] = expf(c0);
      ecum[2 * lane + 1] = expf(c1);
      __syncwarp();
    }

    // att[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0,
    // for rows i of row tile rt, column tiles at or below the diagonal
    {
      const int i0 = 16 * rt;
      const float cum_i[2] = {cum[i0 + g], cum[i0 + g + 8]};
      for (int pr = grp; pr <= rt; pr += G) {   // columns [16 pr, +16)
        float acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t a[4], bb[4];
          ldsm_x4(a, cs + (i0 + lr) * M::kLdN + 16 * kk + lc);
          ldsm_x4(bb, bs + (16 * pr + br) * M::kLdN + 16 * kk + bc);
          mma_bf16(acc[0], a, bb[0], bb[1]);
          mma_bf16(acc[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * pr + 8 * half + 2 * t;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e / 2), jj = j + e % 2;
            const float dlt = jj <= i ? cum_i[e / 2] - cum[jj] : -INFINITY;
            v[e] = acc[half][e] * expf(dlt) * dts[jj];
          }
          uint32_t hi, lo;
          split(v[0], v[1], hi, lo);
          *reinterpret_cast<uint32_t*>(att_hi + (i0 + g) * M::kLdA + j) = hi;
          *reinterpret_cast<uint32_t*>(att_lo + (i0 + g) * M::kLdA + j) = lo;
          split(v[2], v[3], hi, lo);
          *reinterpret_cast<uint32_t*>(att_hi + (i0 + g + 8) * M::kLdA + j) =
              hi;
          *reinterpret_cast<uint32_t*>(att_lo + (i0 + g + 8) * M::kLdA + j) =
              lo;
        }
      }
    }
    __syncthreads();                 // att is whole

    // y^T[p][i] for the warp's rows p: exp(cum_i) (S . C^T) + x^T . att^T
    float acc[8][4];                 // (pb + g (+8), 8 ni + 2t (+1))
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {      // S as A, from registers
      uint32_t shi[4], slo[4];
      split(st[2 * kk][0], st[2 * kk][1], shi[0], slo[0]);
      split(st[2 * kk][2], st[2 * kk][3], shi[1], slo[1]);
      split(st[2 * kk + 1][0], st[2 * kk + 1][1], shi[2], slo[2]);
      split(st[2 * kk + 1][2], st[2 * kk + 1][3], shi[3], slo[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {         // C^T: C's rows are [i][n]
        uint32_t bb[4];
        ldsm_x4(bb, cs + (16 * np + br) * M::kLdN + 16 * kk + bc);
        mma_bf16(acc[2 * np], shi, bb[0], bb[1]);
        mma_bf16(acc[2 * np], slo, bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], shi, bb[2], bb[3]);
        mma_bf16(acc[2 * np + 1], slo, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float e0 = ecum[8 * ni + 2 * t], e1 = ecum[8 * ni + 2 * t + 1];
      acc[ni][0] *= e0;
      acc[ni][1] *= e1;
      acc[ni][2] *= e0;
      acc[ni][3] *= e1;
    }
    uint32_t xa[4][4];               // x^T [p][j] fragments, k-steps of j
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4_t(xa[kk], xs + (16 * kk + br) * M::kLdX + pb + bc);
#pragma unroll
    for (int np = 0; np < 4; ++np) {           // att^T: att's rows [i][j]
#pragma unroll
      for (int kk = 0; kk <= np; ++kk) {       // j <= i only
        const int off = (16 * np + br) * M::kLdA + 16 * kk + bc;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, att_hi + off);
        ldsm_x4(bl, att_lo + off);
        mma_bf16(acc[2 * np], xa[kk], bh[0], bh[1]);
        mma_bf16(acc[2 * np], xa[kk], bl[0], bl[1]);
        mma_bf16(acc[2 * np + 1], xa[kk], bh[2], bh[3]);
        mma_bf16(acc[2 * np + 1], xa[kk], bl[2], bl[3]);
      }
    }

    // S <- exp(total) S + (x w)^T B, (x w) split, B's rows [j][n]
    {
      const float decay = expf(total);
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j0 = 16 * kk + 2 * t;
        const float w[4] = {wgt[j0], wgt[j0 + 1], wgt[j0 + 8], wgt[j0 + 9]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // registers 2, 3 hold columns j0 + 8
          const float2 v = unpack(xa[kk][r]);
          split(v.x * w[2 * (r / 2)], v.y * w[2 * (r / 2) + 1], ahi[r],
                alo[r]);
        }
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bs + (16 * kk + lr) * M::kLdN + 16 * np + lc);
          mma_bf16(st[2 * np], ahi, bb[0], bb[1]);
          mma_bf16(st[2 * np], alo, bb[0], bb[1]);
          mma_bf16(st[2 * np + 1], ahi, bb[2], bb[3]);
          mma_bf16(st[2 * np + 1], alo, bb[2], bb[3]);
        }
      }
    }

    // y: staged as [i][p] in the att region, then 16 bytes a store
    __syncthreads();                 // every warp is done with att
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ystage[(8 * ni + 2 * t + e % 2) * M::kLdY + pb + g + 8 * (e / 2)] =
            acc[ni][e];
    __syncthreads();
    const size_t row0 = static_cast<size_t>(b) * seq + t0;
    constexpr int kQuads = P / 4;
    for (int i = threadIdx.x; i < rows * kQuads; i += M::kThreads) {
      const int r = i / kQuads, p4 = 4 * (i % kQuads);
      float4 v = *reinterpret_cast<const float4*>(ystage + r * M::kLdY + p4);
      const uint2 xv = *reinterpret_cast<const uint2*>(xs + r * M::kLdX + p4);
      const float2 x01 = unpack(xv.x), x23 = unpack(xv.y);
      v.x += dsk * x01.x;
      v.y += dsk * x01.y;
      v.z += dsk * x23.x;
      v.w += dsk * x23.y;
      store4(y + ((row0 + r) * heads + h) * P + p4, v);
    }
  }
}

template <int N, int G, typename TOut>
int launch_mma(const void* x, const void* dt, const void* a_log,
               const void* bm, const void* cm, const void* d_skip, void* y,
               int batch, int seq, int heads, cudaStream_t stream) {
  using M = Mma<N, G>;
  auto* kernel = ssd_mma_kernel<N, G, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, M::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(heads, batch), M::kThreads, M::kBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const float*>(d_skip),
      static_cast<TOut*>(y), seq, heads);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int G>
int launch_mma_out(int out_dtype, const void* x, const void* dt,
                   const void* a_log, const void* bm, const void* cm,
                   const void* d_skip, void* y, int batch, int seq,
                   int heads, cudaStream_t s) {
  if (out_dtype == 0)
    return launch_mma<N, G, float>(x, dt, a_log, bm, cm, d_skip, y, batch,
                                   seq, heads, s);
  return launch_mma<N, G, bf16>(x, dt, a_log, bm, cm, d_skip, y, batch, seq,
                                heads, s);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 = launched.  route: 0 = simt (ssd_kernel), 1 =
// mma (ssd_mma_kernel).  in_dtype (x, B, C) and out_dtype (y): 0 =
// float32, 1 = bfloat16.  simt: p_dim and n_dim in 1..128; mma: bf16 in,
// p_dim and n_dim 64 or 128, x, B and C 16-byte aligned.  batch at most
// 65,535.
int ssd_scan_launch(int route, int in_dtype, int out_dtype, const void* x,
                    const void* dt, const void* a_log, const void* bm,
                    const void* cm, const void* d_skip, void* y, int batch,
                    int seq, int heads, int p_dim, int n_dim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if (in_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    const int code = (n_dim == 128 ? 2 : n_dim == 64 ? 0 : -8) +
                     (p_dim == 128 ? 1 : p_dim == 64 ? 0 : -8);
    switch (code) {
      case 0: return launch_mma_out<64, 1>(out_dtype, x, dt, a_log, bm, cm, d_skip, y, batch, seq, heads, s);
      case 1: return launch_mma_out<64, 2>(out_dtype, x, dt, a_log, bm, cm, d_skip, y, batch, seq, heads, s);
      case 2: return launch_mma_out<128, 1>(out_dtype, x, dt, a_log, bm, cm, d_skip, y, batch, seq, heads, s);
      case 3: return launch_mma_out<128, 2>(out_dtype, x, dt, a_log, bm, cm, d_skip, y, batch, seq, heads, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (in_dtype * 2 + out_dtype) {
    case 0: return launch<float, float>(x, dt, a_log, bm, cm, d_skip, y, batch, seq, heads, p_dim, n_dim, s);
    case 1: return launch<float, bf16>(x, dt, a_log, bm, cm, d_skip, y, batch, seq, heads, p_dim, n_dim, s);
    case 2: return launch<bf16, float>(x, dt, a_log, bm, cm, d_skip, y, batch, seq, heads, p_dim, n_dim, s);
    default: return launch<bf16, bf16>(x, dt, a_log, bm, cm, d_skip, y, batch, seq, heads, p_dim, n_dim, s);
  }
}

}  // extern "C"
