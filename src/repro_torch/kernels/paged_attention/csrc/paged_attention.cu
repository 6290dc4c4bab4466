// Paged decode attention for Hopper (sm_90a), with grouped-query heads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py:25 (_paged_kernel) launched at :87 (pallas_call under
// paged_attention, :61).  Same function: one query token per sequence
// against a physical page pool through a page table, scale 1/sqrt(D),
// online softmax over pages in f32, tail masked by lengths, a zero-length
// row gives 0, output cast to q's type.  Differences from the TPU kernel:
//   * GQA is read natively: query head h reads KV head h / (H / Hkv), the
//     order jnp.repeat(..., axis=2) produces, so the caller no longer
//     repeats the whole pool to H heads every layer and step.
//   * lengths are clamped to P * page, and page-table entries past
//     ceil(len / page) are never read (the TPU grid visits every entry).
//
// Bound on this card: bytes.  Per call the kernel must read K and V of the
// valid tokens, sum_b len_b * Hkv * D * 2 * sizeof(T), plus q and the
// output; it does 4 * H * D f32 flops per token: 6 per byte of bf16 K/V at
// qwen2-1.5b's 6:1 head grouping, below the 20 flops per byte (67 TFLOP/s
// f32 over 3.35 TB/s) where f32 arithmetic would bound it.  Design against
// that bound:
//   * one block per (sequence, KV head), so every K/V page tile is read
//     from device memory once and used by all rep = H / Hkv query heads
//     that share it (6 for qwen2-1.5b);
//   * the TPU grid's sequential page axis becomes a loop inside the block;
//     the tiles of page j + 1 are fetched by cp.async into the second half
//     of a two-stage shared-memory ring while page j is computed, and only
//     the valid rows of the last page are fetched;
//   * scores, softmax state and the P.V accumulator stay in f32 in shared
//     memory; nothing but the output returns to device memory.
// With one block per (sequence, KV head) a small batch fills few of the
// 132 SMs; splitting the page loop across blocks is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fetch the first `rows` token rows of physical page `pid`, KV head g, of
// both pools into one ring stage: ks/vs [rows][D].  Rows are D * sizeof(T)
// bytes, a multiple of 16 (checked by the wrapper).
template <typename T>
__device__ __forceinline__ void fetch_page(T* ks, T* vs, const T* k_pages,
                                           const T* v_pages, int pid, int rows,
                                           int page, int Hkv, int g, int D) {
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;  // per row
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int t = c / chunks, w = c - t * chunks;
    const size_t row = ((static_cast<size_t>(pid) * page + t) * Hkv + g) * D;
    cp_async16(reinterpret_cast<char*>(ks + t * D) + w * 16,
               reinterpret_cast<const char*>(k_pages + row) + w * 16);
    cp_async16(reinterpret_cast<char*>(vs + t * D) + w * 16,
               reinterpret_cast<const char*>(v_pages + row) + w * 16);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,          // [B, H, D]
                           const T* __restrict__ k_pages,    // [N, page, Hkv, D]
                           const T* __restrict__ v_pages,    // [N, page, Hkv, D]
                           const int32_t* __restrict__ page_table,  // [B, P]
                           const int32_t* __restrict__ lengths,     // [B]
                           T* __restrict__ out,              // [B, H, D]
                           int H, int Hkv, int D, int page, int P,
                           float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = H / Hkv, h0 = g * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = page * D;

  T* ring = reinterpret_cast<T*>(smem);              // [2 stages][K, V][page][D]
  float* qs = reinterpret_cast<float*>(ring + 4 * tile);  // [rep][D]
  float* acc = qs + rep * D;                          // [rep][D]
  float* s = acc + rep * D;                           // [rep][page]
  float* m = s + rep * page;                          // [rep]
  float* l = m + rep;                                 // [rep]
  float* corr = l + rep;                              // [rep]

  const int len = max(0, min(lengths[b], P * page));
  const int n_pages = (len + page - 1) / page;
  const int32_t* table = page_table + static_cast<size_t>(b) * P;

  if (n_pages > 0) {
    fetch_page(ring, ring + tile, k_pages, v_pages, table[0], min(page, len),
               page, Hkv, g, D);
    cp_async_commit();
  }
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qs[i] = to_float(q[(static_cast<size_t>(b) * H + h0 + r) * D + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  for (int j = 0; j < n_pages; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_pages) {
      T* next = ring + (stage ^ 1) * 2 * tile;
      fetch_page(next, next + tile, k_pages, v_pages, table[j + 1],
                 min(page, len - (j + 1) * page), page, Hkv, g, D);
      cp_async_commit();
      cp_async_wait<1>();  // page j has landed; page j + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = ring + stage * 2 * tile;
    const T* vs = ks + tile;
    const int rows = min(page, len - j * page);

    // scores: one warp per (head, token) dot product over D
    for (int pair = warp; pair < rep * rows; pair += kWarps) {
      const int r = pair / rows, t = pair - r * rows;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot += qs[r * D + d] * to_float(ks[t * D + d]);
      dot = warp_sum(dot);
      if (lane == 0) s[r * page + t] = dot * scale;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int r = warp; r < rep; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < rows; t += 32) mx = fmaxf(mx, s[r * page + t]);
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < rows; t += 32) {
        const float p = expf(s[r * page + t] - m_new);
        s[r * page + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m[r] - m_new);
        corr[r] = c;
        l[r] = l[r] * c + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V, one (head, d) element per thread and pass
    for (int i = tid; i < rep * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float a = acc[i] * corr[r];
      for (int t = 0; t < rows; ++t)
        a += s[r * page + t] * to_float(vs[t * D + d]);
      acc[i] = a;
    }
    __syncthreads();  // this stage is refilled at iteration j + 1
  }

  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    store(&out[(static_cast<size_t>(b) * H + h0 + r) * D + d],
          acc[i] / fmaxf(l[r], 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* lengths, void* out, int B,
           int H, int Hkv, int D, int page, int P, size_t smem,
           cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), H, Hkv, D,
      page, P, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block: the K/V ring, then f32 q, acc,
// scores and the softmax state (see the kernel's carve-up).
size_t smem_bytes(int elem_bytes, int H, int Hkv, int D, int page) {
  const int rep = H / Hkv;
  return 4 * static_cast<size_t>(page) * D * elem_bytes +
         static_cast<size_t>(2 * rep * D + rep * page + 3 * rep) *
             sizeof(float);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched;
// a shape needing more shared memory than a block may have is refused).
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* lengths, void* out, int B, int H,
                           int Hkv, int D, int page, int P, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_table, lengths, out, B, H,
                         Hkv, D, page, P,
                         smem_bytes(4, H, Hkv, D, page), s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        q, k_pages, v_pages, page_table, lengths, out, B, H, Hkv, D, page, P,
        smem_bytes(2, H, Hkv, D, page), s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
