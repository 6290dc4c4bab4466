// Paged decode attention for Hopper (sm_90a), with grouped-query heads,
// split across blocks along each row's pages (split-KV decode).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py:25 (_paged_kernel) launched at :87 (pallas_call under
// paged_attention, :61).  Same function: one query token per sequence
// against a physical page pool through a page table, scale 1/sqrt(D), an
// f32 softmax, tail masked by lengths, a zero-length row gives 0, output
// cast to q's type.  Differences from the TPU kernel:
//   * GQA is read natively: query head h reads KV head h / (H / Hkv), the
//     order jnp.repeat(..., axis=2) produces, so the caller never repeats
//     the pool to H heads;
//   * lengths are clamped to P * page, and page-table entries past
//     ceil(len / page) are never read (the TPU grid visits every entry);
//   * a call may read a run of the pool's KV heads, [kv0, kv0 + Hkv) of
//     its kv_stride, for the query heads of one tensor-parallel shard
//     (H of them, H / Hkv a head, or all H on one KV head): the shard
//     reads the whole pool in place, never a copy of its heads.
//
// Bound on this card: bytes.  Per call the kernel must read K and V of the
// valid tokens, sum_b len_b * Hkv * D * 2 * sizeof(T), plus q and the
// output; it does 4 * H * D f32 flops per token: 6 per byte of bf16 K/V at
// qwen2-1.5b's 6:1 head grouping, below the 20 flops per byte (67 TFLOP/s
// f32 over 3.35 TB/s) where f32 arithmetic would bound it.
//
// Why split: the TPU grid walks a row's pages in order on one core.  One
// block per (sequence, KV head) with the page loop inside it gives a
// decode batch of 8 slots and 2 KV heads 16 blocks on 132 SMs, and the
// longest row then runs alone on one SM, page after page.
// Here the grid is (B, Hkv, n_split): each block takes a fixed run of
// ceil(P / n_split) pages of one (sequence, KV head), so a batch fills the
// card and a row's pages are read by many SMs at once.  n_split is chosen
// by the wrapper from host-known shapes only (paged_attention.py n_splits),
// never from lengths, so the launch needs no device sync.
//   * Partition pass (paged_partition_kernel): the block issues cp.async
//     for every valid K and V row of its split at once (only up to the
//     row's length), keeps its query heads' q in registers while they land,
//     then computes the rep x split scores with 16-byte shared loads (a
//     power-of-two group of lanes per token, reduced by shuffles), an f32
//     softmax per head, and P.V with the tokens spread over the threads
//     (each thread a 16-byte column chunk and every TG-th token, the TG
//     partial sums added in shared memory laid over the spent K and V
//     tiles, which halves a block's shared memory and so lets more blocks
//     share an SM).  It writes an f32 partial: the
//     split's max m, sum l and unnormalised acc[D] for each of its rep
//     heads.  A split that starts past the row's length writes the empty
//     partial (m = -inf, l = 0) and exits.
//   * Merge pass (paged_merge_kernel): one block per (sequence, head)
//     combines the live partials, their weights in shared memory and the
//     sum over them unrolled into independent loads: M = max m_i,
//     y = sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i, 1e-20); an
//     empty partial has weight 0 (never -inf - -inf) and an all-empty row
//     gives 0.
// The wrapper allocates the partials; the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 8;        // query heads a pass keeps in registers
constexpr int kMaxChunks = 64;   // 16-byte chunks a K/V row may have

template <typename T>
struct Vec;  // a 16-byte chunk of a row as floats
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const void* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const void* p, float (&x)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem)
               : "memory");
}

// Floats rounded up to a 16-byte multiple.
__host__ __device__ __forceinline__ size_t round4(size_t n) {
  return (n + 3) & ~size_t(3);
}

struct Args {
  const void* q;             // [B, H, D]
  const void* k_pages;       // [N, page, Hkv, D]
  const void* v_pages;       // [N, page, Hkv, D]
  const int32_t* page_table; // [B, P]
  const int32_t* lengths;    // [B]
  float* acc;                // [B, H, n_split, D] unnormalised partials
  float* ml;                 // [B, H, n_split, 2] (m, l) of each partial
  void* out;                 // [B, H, D]
  int H, Hkv, D, page, P, n_split, split_pages;
  int kv_stride, kv0;        // the pool's KV heads; the first one read
  float scale;
};

// G: lanes that share one token's dot product (a power of two, the row's
// 16-byte chunks rounded up, at most 32); CPL: chunks each of them covers.
template <typename T, int G, int CPL>
__global__ void __launch_bounds__(kThreads)
    paged_partition_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = Vec<T>::N;
  constexpr int kPerWarp = 32 / G;  // tokens a warp takes a pass
  const int b = blockIdx.x, g = blockIdx.y, sp = blockIdx.z;
  const int D = a.D, rep = a.H / a.Hkv, h0 = g * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split_tokens = a.split_pages * a.page;
  const int len = max(0, min(a.lengths[b], a.P * a.page));
  const int t0 = sp * split_tokens;
  const int n = min(split_tokens, len - t0);  // tokens of this split
  const size_t part = (static_cast<size_t>(b) * a.H + h0) * a.n_split + sp;

  if (n <= 0) {  // the split starts past the row's length: empty partial
    for (int r = tid; r < rep; r += kThreads) {
      a.ml[2 * (part + static_cast<size_t>(r) * a.n_split)] = -INFINITY;
      a.ml[2 * (part + static_cast<size_t>(r) * a.n_split) + 1] = 0.f;
    }
    return;
  }

  const int chunks = D * static_cast<int>(sizeof(T)) / 16;  // per row
  const int TG = kThreads / chunks;  // token groups of the row-wise passes
  const int c = tid % chunks, tg = tid / chunks;
  T* ks = reinterpret_cast<T*>(smem);                  // [split_tokens][D]
  T* vs = ks + static_cast<size_t>(split_tokens) * D;  // [split_tokens][D]
  float* s = reinterpret_cast<float*>(vs + static_cast<size_t>(split_tokens) * D);
  // [TG][kHeads][D]: over the K and V tiles when one pass takes every
  // head (they are dead by then), else after the scores
  float* red = rep <= kHeads ? reinterpret_cast<float*>(smem)
                             : s + round4(static_cast<size_t>(rep) * split_tokens);

  // every valid K and V row of the split, all in flight at once: thread
  // (tg, c) copies chunk c of rows tg, tg + TG, ...
  if (tg < TG) {
    const int32_t* table = a.page_table + static_cast<size_t>(b) * a.P;
    const char* kp = static_cast<const char*>(a.k_pages) + c * 16;
    const char* vp = static_cast<const char*>(a.v_pages) + c * 16;
    const size_t row_bytes = static_cast<size_t>(D) * sizeof(T);
    for (int t = tg; t < n; t += TG) {
      const int tok = t0 + t;
      const int pid = __ldg(table + tok / a.page);
      const size_t row =
          ((static_cast<size_t>(pid) * a.page + tok % a.page) * a.kv_stride +
           a.kv0 + g) *
          row_bytes;
      cp_async16(reinterpret_cast<char*>(ks) + t * row_bytes + c * 16, kp + row);
      cp_async16(reinterpret_cast<char*>(vs) + t * row_bytes + c * 16, vp + row);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int sub = lane % G;  // this lane's chunk in its group
  const T* qb = static_cast<const T*>(a.q) + static_cast<size_t>(b) * a.H * D;
  bool landed = false;

  // scores, kHeads query heads a pass, their q in registers
  for (int r0 = 0; r0 < rep; r0 += kHeads) {
    const int nr = min(kHeads, rep - r0);
    float qr[CPL][kHeads][VEC];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int ck = sub + k * G;
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        if (r < nr && ck < chunks)
          Vec<T>::load(qb + static_cast<size_t>(h0 + r0 + r) * D + ck * VEC,
                       qr[k][r]);
        else
#pragma unroll
          for (int v = 0; v < VEC; ++v) qr[k][r][v] = 0.f;
      }
    }
    if (!landed) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      landed = true;
    }
    // a warp-uniform loop: lanes past n load nothing and write nothing
    for (int tb = warp * kPerWarp; tb < n; tb += kWarps * kPerWarp) {
      const int t = tb + lane / G;
      float dot[kHeads];
#pragma unroll
      for (int r = 0; r < kHeads; ++r) dot[r] = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int ck = sub + k * G;
        if (t < n && ck < chunks) {
          float x[VEC];
          Vec<T>::load(ks + static_cast<size_t>(t) * D + ck * VEC, x);
#pragma unroll
          for (int r = 0; r < kHeads; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) dot[r] = fmaf(qr[k][r][v], x[v], dot[r]);
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o /= 2)
#pragma unroll
        for (int r = 0; r < kHeads; ++r)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
      if (t < n && sub == 0) {
#pragma unroll
        for (int r = 0; r < kHeads; ++r)
          if (r < nr) s[(r0 + r) * split_tokens + t] = dot[r] * a.scale;
      }
    }
  }
  __syncthreads();

  // the split's softmax: one warp per head; p = e^(s - m) stays in s
  for (int r = warp; r < rep; r += kWarps) {
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[r * split_tokens + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(s[r * split_tokens + t] - mx);
      s[r * split_tokens + t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      a.ml[2 * (part + static_cast<size_t>(r) * a.n_split)] = mx;
      a.ml[2 * (part + static_cast<size_t>(r) * a.n_split) + 1] = sum;
    }
  }
  __syncthreads();

  // P.V: thread (tg, c) sums every TG-th token of column chunk c
  for (int r0 = 0; r0 < rep; r0 += kHeads) {
    const int nr = min(kHeads, rep - r0);
    float acc[kHeads][VEC];
#pragma unroll
    for (int r = 0; r < kHeads; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
    if (tg < TG) {
#pragma unroll 2
      for (int t = tg; t < n; t += TG) {
        float x[VEC];
        Vec<T>::load(vs + static_cast<size_t>(t) * D + c * VEC, x);
#pragma unroll
        for (int r = 0; r < kHeads; ++r) {
          if (r < nr) {
            const float p = s[(r0 + r) * split_tokens + t];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(p, x[v], acc[r][v]);
          }
        }
      }
    }
    __syncthreads();  // every read of V is done: red may lie over it
    if (tg < TG) {
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        if (r < nr) {
          float4* dst = reinterpret_cast<float4*>(
              red + (static_cast<size_t>(tg) * kHeads + r) * D + c * VEC);
#pragma unroll
          for (int v = 0; v < VEC; v += 4)
            dst[v / 4] = make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2],
                                     acc[r][v + 3]);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float sum = 0.f;
      for (int j = 0; j < TG; ++j)
        sum += red[(static_cast<size_t>(j) * kHeads + r) * D + d];
      a.acc[(part + static_cast<size_t>(r0 + r) * a.n_split) * D + d] = sum;
    }
    __syncthreads();  // red is rewritten by the next pass
  }
}

constexpr int kMergeThreads = 256;

// One block per (sequence, head): the live partials' weights e^(m_i - M) in
// shared memory (an empty partial weighs 0), then thread (sg, d4) sums
// float4 column group d4 over partials sg, sg + SG, ... (independent
// loads, many in flight), and the SG sums are added in shared memory.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    paged_merge_kernel(const Args a) {
  extern __shared__ float w[];  // [n_split] weights, then [SG][D] sums
  __shared__ float scratch[kMergeThreads / 32];
  const int b = blockIdx.x, h = blockIdx.y, D = a.D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split_tokens = a.split_pages * a.page;
  const int len = max(0, min(a.lengths[b], a.P * a.page));
  const int live = min(a.n_split, (len + split_tokens - 1) / split_tokens);
  const size_t part = (static_cast<size_t>(b) * a.H + h) * a.n_split;
  const float* ml = a.ml + 2 * part;

  float top = -INFINITY;
  for (int i = threadIdx.x; i < live; i += kMergeThreads)
    top = fmaxf(top, ml[2 * i]);
  top = warp_max(top);
  if (lane == 0) scratch[warp] = top;
  __syncthreads();
  top = scratch[0];
  for (int i = 1; i < kMergeThreads / 32; ++i) top = fmaxf(top, scratch[i]);
  __syncthreads();  // scratch is reused below
  float den = 0.f;
  for (int i = threadIdx.x; i < live; i += kMergeThreads) {
    const float m = ml[2 * i];
    const float wi = m == -INFINITY ? 0.f : expf(m - top);
    w[i] = wi;
    den += wi * ml[2 * i + 1];
  }
  den = warp_sum(den);
  if (lane == 0) scratch[warp] = den;
  __syncthreads();  // also makes w visible
  den = 0.f;
  for (int i = 0; i < kMergeThreads / 32; ++i) den += scratch[i];
  den = fmaxf(den, 1e-20f);

  const int D4 = D / 4, SG = kMergeThreads / D4;
  const int d4 = threadIdx.x % D4, sg = threadIdx.x / D4;
  float* sums = w + round4(a.n_split);  // [SG][D], 16-byte aligned
  const float4* acc = reinterpret_cast<const float4*>(a.acc + part * D);
  if (sg < SG) {
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = sg; i < live; i += SG) {
      const float wi = w[i];
      const float4 x = acc[static_cast<size_t>(i) * D4 + d4];
      y.x = fmaf(wi, x.x, y.x);
      y.y = fmaf(wi, x.y, y.y);
      y.z = fmaf(wi, x.z, y.z);
      y.w = fmaf(wi, x.w, y.w);
    }
    reinterpret_cast<float4*>(sums + sg * D)[d4] = y;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.H + h) * D;
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float y = 0.f;
    for (int j = 0; j < SG; ++j) y += sums[j * D + d];
    store(&out[d], y / den);
  }
}

// Dynamic shared memory of one partition block: K and V of a split, the
// f32 scores of its rep heads, the TG x kHeads x D f32 P.V partial sums
// (over K and V when rep <= kHeads).
size_t partition_smem(int elem_bytes, int rep, int D, int split_tokens) {
  const int chunks = D * elem_bytes / 16;
  const int tg = kThreads / chunks;
  const size_t kv = 2 * static_cast<size_t>(split_tokens) * D * elem_bytes;
  const size_t scores = round4(static_cast<size_t>(rep) * split_tokens) * sizeof(float);
  const size_t sums = static_cast<size_t>(tg) * kHeads * D * sizeof(float);
  return rep <= kHeads ? (kv > sums ? kv : sums) + scores : kv + scores + sums;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_both(const Args& a, int B, cudaStream_t stream) {
  const int chunks = a.D * static_cast<int>(sizeof(T)) / 16;
  if (chunks < 1 || chunks > kMaxChunks || a.D % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = partition_smem(sizeof(T), a.H / a.Hkv, a.D,
                                     a.split_pages * a.page);
  const dim3 grid(B, a.Hkv, a.n_split);
  int err;
  if (chunks > 32)
    err = launch(paged_partition_kernel<T, 32, 2>, grid, kThreads, smem, a, stream);
  else if (chunks > 16)
    err = launch(paged_partition_kernel<T, 32, 1>, grid, kThreads, smem, a, stream);
  else if (chunks > 8)
    err = launch(paged_partition_kernel<T, 16, 1>, grid, kThreads, smem, a, stream);
  else
    err = launch(paged_partition_kernel<T, 8, 1>, grid, kThreads, smem, a, stream);
  if (err != 0) return err;
  const int sg = kMergeThreads / (a.D / 4);
  if (sg < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(paged_merge_kernel<T>, dim3(B, a.H), kMergeThreads,
                (round4(a.n_split) + static_cast<size_t>(sg) * a.D) * sizeof(float), a,
                stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  scratch holds B * H * n_split *
// (D + 2) floats: the partials' acc, then their (m, l).  The pools hold
// kv_stride KV heads a token, of which heads [kv0, kv0 + Hkv) are read.
// Returns a cudaError_t (0 = both passes launched; a shape needing more
// shared memory than a block may have is refused).
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* lengths, void* out, void* scratch,
                           int B, int H, int Hkv, int D, int page, int P,
                           int n_split, int kv_stride, int kv0,
                           void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || D <= 0 || page <= 0 || P <= 0 ||
      n_split <= 0 || n_split > P || kv0 < 0 || kv0 + Hkv > kv_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  float* acc = static_cast<float*>(scratch);
  Args a{q, k_pages, v_pages, static_cast<const int32_t*>(page_table),
         static_cast<const int32_t*>(lengths), acc,
         acc + static_cast<size_t>(B) * H * n_split * D, out, H, Hkv, D, page,
         P, n_split, (P + n_split - 1) / n_split, kv_stride, kv0,
         1.0f / sqrtf(static_cast<float>(D))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_both<float>(a, B, s);
  if (dtype == 1) return launch_both<__nv_bfloat16>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
