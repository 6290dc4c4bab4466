// Blocked (flash) attention forward for Hopper (sm_90a): y and the row
// log-sum-exp of causal / sliding-window / full attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py:21 (_flash_kernel) launched at :86, and computes the
// function of the training path's forward, _blocked_fwd_impl in
// src/repro/models/layers.py:294: scale 1/sqrt(D); keys masked by
// causality (q_pos >= k_pos), by the window (q_pos - k_pos < window) and,
// here, by the tail (k_pos < Sk); f32 running max, denominator and
// accumulator; p rounded to the input type before P.V; the output rounded
// once, after division by max(l, 1e-20); lse = m + log(max(l, 1e-20)) with
// m taken as 0 for a row that saw no key.  Query rows sit at q_pos =
// q_offset + row.  Masked scores are -inf and a fully masked prefix of
// tiles leaves the row's state untouched, as _blocked_fwd_impl's isfinite
// guards do (the TPU kernel's -1e30 would fold such tiles into l).
//
// Bound on this card: operations.  4 * Sq * Sk * D flops per (batch, head)
// against 2 * (Sq + 2 * Sk) * D bytes of bf16 in and out: 2,731 flops per
// byte at S = 4,096, D = 128, far above the ~295 where the tensor cores
// (989 TFLOP/s bf16) overtake the memory (3.35 TB/s).  Design:
//   * bf16 with D = 64 or 128 runs on the tensor cores (mma.sync
//     m16n8k16, f32 accumulation): one block of 4 warps per (batch*head,
//     64-row query tile), each warp 16 query rows whose Q fragments stay in
//     registers; the 64-key K and V tiles stream through shared memory; the
//     score accumulators turn into the P.V operand in registers (no trip
//     through shared memory); the online-softmax state and the output
//     accumulator stay in registers for the whole key loop;
//   * float32, and bf16 of any other D (row a multiple of 16 bytes, D <=
//     256), runs a scalar kernel: 32 query rows a block, 4 threads a row,
//     f32 FMA from shared memory (the tensor cores have no float32 path
//     that keeps float32 accuracy);
//   * a tile of keys wholly above the diagonal or wholly outside the window
//     is never loaded (half the work of a causal call);
//   * query tiles are issued heaviest first (causal rows near the end see
//     the most keys), so the last wave is short.
// Not yet: TMA, wgmma, warp specialisation and a multi-stage K/V ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Params {
  const void* q;  // [BH, Sq, D]
  const void* k;  // [BH, Sk, D]
  const void* v;  // [BH, Sk, D]
  void* y;        // [BH, Sq, D]
  float* lse;     // [BH, Sq]
  int sq, sk, d;
  int causal, has_window, window, q_offset;
  float scale;
};

__device__ __forceinline__ bool key_valid(const Params& p, int qpos,
                                          int kpos) {
  return kpos < p.sk && (!p.causal || qpos >= kpos) &&
         (!p.has_window || qpos - kpos < p.window);
}

// Key tiles [*lo, *hi) that hold a valid key for some query row in
// [r0, r1): tiles wholly above the diagonal or below the window are skipped.
__device__ __forceinline__ void key_tiles(const Params& p, int r0, int r1,
                                          int bk, int* lo, int* hi) {
  const long long n = (p.sk + bk - 1) / bk;
  const long long qmin = static_cast<long long>(p.q_offset) + r0;
  const long long qmax = static_cast<long long>(p.q_offset) + r1 - 1;
  long long h = n, l = 0;
  if (p.causal) h = qmax < 0 ? 0 : min(n, qmax / bk + 1);
  if (p.has_window) {
    const long long first = qmin - p.window + 1;  // smallest valid key
    if (first > 0) l = min(n, first / bk);
  }
  *lo = static_cast<int>(l);
  *hi = static_cast<int>(h);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// p as the P.V product sees it: rounded to the input type.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lse_of(float m, float l) {
  return (m == -INFINITY ? 0.f : m) + logf(fmaxf(l, 1e-20f));
}

// ---------------------------------------------------------------------------
// scalar kernel: float32, and bf16 of any D
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 128;
constexpr int kSimtRows = 32;  // 4 threads a row
constexpr int kSimtKeys = 64;  // 16 scores a thread
constexpr int kSimtPs = kSimtKeys + 1;

// Dynamic shared memory (floats): Q [32][D+1], K [64][D+1], V [64][D],
// P [32][65].
size_t simt_smem(int d) {
  return sizeof(float) *
         (static_cast<size_t>(kSimtRows + kSimtKeys) * (d + 1) +
          static_cast<size_t>(kSimtKeys) * d + kSimtRows * kSimtPs);
}

// COLS = columns a thread owns (D <= 4 * COLS): thread (row, sub) owns
// columns sub + 4 c of its row.
template <typename T, int COLS>
__global__ void __launch_bounds__(kSimtThreads)
    flash_simt_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.d, ld = D + 1;
  float* qs = smem;
  float* ks = qs + kSimtRows * ld;
  float* vs = ks + kSimtKeys * ld;
  float* ps = vs + kSimtKeys * D;

  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kSimtRows;
  const T* q = static_cast<const T*>(p.q) + static_cast<size_t>(bh) * p.sq * D;
  const T* k = static_cast<const T*>(p.k) + static_cast<size_t>(bh) * p.sk * D;
  const T* v = static_cast<const T*>(p.v) + static_cast<size_t>(bh) * p.sk * D;
  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;

  for (int i = tid; i < kSimtRows * D; i += kSimtThreads) {
    const int r = i / D, c = i - r * D;
    qs[r * ld + c] =
        r0 + r < p.sq ? to_float(q[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
  }
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;  // the row's state, on its 4 threads
  const int qpos = p.q_offset + r0 + row;
  int lo, hi;
  key_tiles(p, r0, min(r0 + kSimtRows, p.sq), kSimtKeys, &lo, &hi);

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kSimtKeys;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kSimtKeys * D; i += kSimtThreads) {
      const int r = i / D, c = i - r * D;
      const bool in = k0 + r < p.sk;
      const size_t at = static_cast<size_t>(k0 + r) * D + c;
      ks[r * ld + c] = in ? to_float(k[at]) : 0.f;
      vs[r * D + c] = in ? to_float(v[at]) : 0.f;
    }
    __syncthreads();

    float s[kSimtKeys / 4];
#pragma unroll
    for (int j = 0; j < kSimtKeys / 4; ++j) s[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = qs[row * ld + c];
#pragma unroll
      for (int j = 0; j < kSimtKeys / 4; ++j)
        s[j] = fmaf(qv, ks[(sub + 4 * j) * ld + c], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSimtKeys / 4; ++j) {
      s[j] = key_valid(p, qpos, k0 + sub + 4 * j) ? s[j] * p.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kSimtKeys / 4; ++j) {
      const float pj = s[j] == -INFINITY ? 0.f : expf(s[j] - m_safe);
      psum += pj;
      ps[row * kSimtPs + sub + 4 * j] = round_to(pj, q);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by its own 4 lanes
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] *= corr;
    for (int j = 0; j < kSimtKeys; ++j) {
      const float pj = ps[row * kSimtPs + j];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (sub + 4 * c < D) acc[c] = fmaf(pj, vs[j * D + sub + 4 * c], acc[c]);
    }
  }

  if (r0 + row < p.sq) {
    T* y = static_cast<T*>(p.y) + (static_cast<size_t>(bh) * p.sq + r0 + row) * D;
    const float den = fmaxf(l, 1e-20f);
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (sub + 4 * c < D) store(&y[sub + 4 * c], acc[c] / den);
    if (sub == 0)
      p.lse[static_cast<size_t>(bh) * p.sq + r0 + row] = lse_of(m, l);
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernel: bf16, D = 64 or 128
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kMmaRows = 64;
constexpr int kMmaKeys = 64;

template <int D>
constexpr size_t mma_smem() {  // Q, K, V tiles of 64 rows, rows padded by 8
  return 3 * static_cast<size_t>(64) * (D + 8) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [r0, r0 + 64) of a [rows, D] bf16 matrix into a padded shared
// tile, 16 bytes a thread a step; rows past the end are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int rows) {
  constexpr int kChunks = D / 8, LD = D + 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// t = lane % 4: A regs {row g, cols 2t..2t+1}, {row g+8, same},
// {row g, cols 2t+8..}, {row g+8, cols 2t+8..}; B regs {k 2t..2t+1, n g},
// {k 2t+8.., n g}; C {row g, cols 2t, 2t+1}, {row g+8, cols 2t, 2t+1}.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kMmaRows * LD;
  bf16* vs = ks + kMmaKeys * LD;

  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const bf16* q = static_cast<const bf16*>(p.q) + static_cast<size_t>(bh) * p.sq * D;
  const bf16* k = static_cast<const bf16*>(p.k) + static_cast<size_t>(bh) * p.sk * D;
  const bf16* v = static_cast<const bf16*>(p.v) + static_cast<size_t>(bh) * p.sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile<D>(qs, q, r0, p.sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
  const bf16* qrow = qs + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld32(qrow + kk * 16);
    qf[kk][1] = ld32(qrow + 8 * LD + kk * 16);
    qf[kk][2] = ld32(qrow + kk * 16 + 8);
    qf[kk][3] = ld32(qrow + 8 * LD + kk * 16 + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
  const int qpos[2] = {p.q_offset + r0 + warp * 16 + g,
                       p.q_offset + r0 + warp * 16 + g + 8};
  int lo, hi;
  key_tiles(p, r0, min(r0 + kMmaRows, p.sq), kMmaKeys, &lo, &hi);

  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * kMmaKeys;
    __syncthreads();  // every warp is done with the previous K and V
    load_tile<D>(ks, k, k0, p.sk);
    load_tile<D>(vs, v, k0, p.sk);
    __syncthreads();

    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kMmaKeys / 8; ++n) {
        const bf16* kr = ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma(s[n], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key_valid(p, qpos[r], kpos) ? s[n][e] * p.scale : -INFINITY;
        mx[r] = fmaxf(mx[r], s[n][e]);
      }
    }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe[r]);
      m[r] = m_new;
    }

    // P as the A operand of P.V: score tiles 2kk and 2kk+1 are k-step kk
    uint32_t pa[kMmaKeys / 16][4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        pv[e] = s[n][e] == -INFINITY ? 0.f : expf(s[n][e] - m_safe[r]);
        psum[r] += pv[e];
      }
      pa[n >> 1][(n & 1) * 2] = pack(pv[0], pv[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack(pv[2], pv[3]);
    }
    // per-thread partial sums: every lane of a row scales by the same corr
    l[0] = l[0] * corr[0] + psum[0];
    l[1] = l[1] * corr[1] + psum[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vc = vs + (kk * 16 + 2 * t) * LD + n * 8 + g;
        mma(o[n], pa[kk], pack(vc[0], vc[LD]), pack(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* y = static_cast<bf16*>(p.y) + static_cast<size_t>(bh) * p.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(row) * D + n * 8 + 2 * t) =
          pack(o[n][2 * r] / den, o[n][2 * r + 1] / den);
    if (t == 0) p.lse[static_cast<size_t>(bh) * p.sq + row] = lse_of(m[r], l[r]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Params& p,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const Params& p, int bh, cudaStream_t stream) {
  const dim3 grid(bh, (p.sq + kSimtRows - 1) / kSimtRows);
  const size_t smem = simt_smem(p.d);
  if (p.d <= 64)
    return launch(flash_simt_kernel<T, 16>, grid, kSimtThreads, smem, p, stream);
  if (p.d <= 128)
    return launch(flash_simt_kernel<T, 32>, grid, kSimtThreads, smem, p, stream);
  if (p.d <= 256)
    return launch(flash_simt_kernel<T, 64>, grid, kSimtThreads, smem, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  tensor_cores: 1 takes the mma.sync
// kernel (bf16 with D 64 or 128 only), 0 the scalar one (D <= 256).
// window < 0 means no window.  Returns a cudaError_t (0 = launched).
int flash_attention_launch(int dtype, int tensor_cores, const void* q,
                           const void* k, const void* v, void* y, void* lse,
                           int bh, int sq, int sk, int d, int causal,
                           int window, int q_offset, float scale,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{q, k, v, y, static_cast<float*>(lse), sq, sk, d, causal,
           window >= 0, window, q_offset, scale};
  if (bh <= 0 || sq <= 0 || sk <= 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_cores) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(bh, (sq + kMmaRows - 1) / kMmaRows);
    if (d == 64)
      return launch(flash_mma_kernel<64>, grid, kMmaThreads, mma_smem<64>(), p, s);
    if (d == 128)
      return launch(flash_mma_kernel<128>, grid, kMmaThreads, mma_smem<128>(), p, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch_simt<float>(p, bh, s);
  if (dtype == 1) return launch_simt<bf16>(p, bh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
