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
// (989 TFLOP/s bf16) overtake the memory (3.35 TB/s).  So the design keeps
// the tensor cores fed and the other work off their path:
//   * bf16 with D = 64 or 128 (flash_wgmma_kernel) runs both products on
//     wgmma, the only instruction that reaches the card's bf16 rate: one
//     block per (batch*head, 128-row query tile), three warpgroups;
//   * a producer warp (its warpgroup's registers handed to the consumers
//     by setmaxnreg) issues TMA loads: Q once, then K and V tiles of 64
//     keys into a 2-stage ring in shared memory, each slot tracked by
//     mbarriers (full: the copy's bytes have landed; empty: every consumer
//     warp is done with it, K and V released apart), so the next tiles'
//     copies overlap this tile's products and no thread spends registers or
//     instructions on addresses.  The tensor maps are 3-D [BH, S, D] with a
//     128-byte swizzle (D in 64-column halves), so a tile past S zero-fills
//     inside its own head and the tiles land in the layout wgmma reads
//     without bank conflicts;
//   * two consumer warpgroups of 64 query rows each: S = Q.K^T by wgmma
//     m64n64k16 with both operands in shared memory; the online softmax on
//     the accumulator registers (f32 m, l, acc; exp2 of log2-scaled
//     scores); p rounded to bf16 in registers becomes the A operand of
//     O += P.V (wgmma m64nDk16, A from registers, V read MN-major through
//     the descriptor's transpose bit), so P never touches shared memory.
//     Tile i's Q.K^T is issued before tile i-1's P.V and only its own wait
//     precedes tile i's softmax, so the softmax runs under the P.V; the
//     other warpgroup's products fill the tensor cores in between;
//   * the key tile is 64: ptxas gives each thread at most 168 registers
//     (65,536 / 384), setmaxnreg notwithstanding, and a 128-key tile's
//     scores and P beside the 64 f32 accumulators of O (D = 128) spill, and
//     ptxas then serialises the wgmma;
//   * masks only where they cut: a tile wholly inside the causal triangle,
//     the window and Sk skips the per-score test; a tile of keys wholly
//     above the diagonal or outside the window is never loaded (half the
//     work of a causal call); query tiles are issued heaviest first
//     (causal rows near the end see the most keys), so the last wave is
//     short;
//   * float32, and bf16 of any other D (row a multiple of 16 bytes, D <=
//     256), runs a scalar kernel (flash_simt_kernel): 32 query rows a
//     block, 4 threads a row, f32 FMA from shared memory (the tensor cores
//     have no float32 path that keeps float32 accuracy).
// Not yet: a persistent grid, a TMA store of y, a schedule that makes the
// two consumers' products take turns (tried with named barriers: no gain).

#include <cuda.h>
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
// tensor-core kernel: bf16, D = 64 or 128; TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 384;  // producer warpgroup + two consumers
constexpr int kMmaRows = 128;     // query rows a block: 64 a consumer
constexpr int kMmaKeys = 64;      // keys a tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kHalf = 64;         // columns of a 128-byte swizzled row
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiles are [D / 64 halves][rows][64] bf16, each half 128-byte swizzled by
// TMA and 1024-byte aligned (the swizzle repeats every 8 rows of 128 B).
template <int D>
struct __align__(1024) MmaSmem {
  bf16 q[D / kHalf][kMmaRows * kHalf];
  bf16 k[kStages][D / kHalf][kMmaKeys * kHalf];
  bf16 v[kStages][D / kHalf][kMmaKeys * kHalf];
  uint64_t q_full, k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

template <int D>
constexpr size_t mma_smem() {  // + slack to align the dynamic base to 1024
  return sizeof(MmaSmem<D>) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of the given parity has completed.  A phase that
// never completes is a fault of the kernel: trap after 2^24 polls (a tenth
// of a second at least) rather than hold the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++polls == (1u << 24)) __trap();
  } while (!done);
}

// A [64 x box_rows] bf16 box of a 3-D [BH, S, D] map (coordinates: column,
// row, head) into shared memory; completion counted on bar in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The accumulators are written by the asynchronous product: keep the
// compiler from moving their reads or writes across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared
// memory (descriptors), f32 accumulators: scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (the m16k16
// fragment layout of mma.sync, per warp), B MN-major in shared memory
// (the descriptor's transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers (the m16k16
// fragment layout of mma.sync, per warp), B MN-major in shared memory
// (the descriptor's transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// Accumulator layout of wgmma m64nN (f32), per warp w of the warpgroup,
// g = lane / 4, t = lane % 4: register 4j + e holds row 16w + g + 8(e / 2),
// column 8j + 2t + e % 2.  Columns 16kk..16kk+15 of P (registers 8kk..8kk+7)
// are then the four A registers of k-step kk, in mma.sync's m16k16 order.
typedef uint32_t PFrag[kMmaKeys / 16][4];

// The online softmax of one score tile, in place: raw Q.K^T in sc becomes
// p = e^(s - m) in f32.  Masks only if the tile cuts the causal triangle,
// the window or Sk; m and l run in log2 units; corr = e^(m_old - m_new)
// rescales the accumulator.
__device__ __forceinline__ void softmax_tile(float (&sc)[kMmaKeys / 2],
                                             const Params& p, int k0,
                                             bool cut, const int (&qpos)[2],
                                             int t, float scale2,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kMmaKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = sc[4 * j + e];
      if (cut && !key_valid(p, qpos[e >> 1], k0 + 8 * j + 2 * t + (e & 1)))
        x = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale2);
    m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - m_safe[r]);
    m[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kMmaKeys / 2; ++i) {  // a masked score gives 0
    sc[i] = exp2f(fmaf(sc[i], scale2, -m_safe[(i >> 1) & 1]));
    psum[(i >> 1) & 1] += sc[i];
  }
  // per-thread partial sums: every lane of a row scales by the same corr
  l[0] = l[0] * corr[0] + psum[0];
  l[1] = l[1] * corr[1] + psum[1];
}

// p rounded to bf16 as the A fragments of P.V (k-step kk = keys
// 16kk..16kk+15: registers 8kk..8kk+7 of the score tile).
__device__ __forceinline__ void pack_p(const float (&sc)[kMmaKeys / 2],
                                       PFrag& pa) {
#pragma unroll
  for (int j = 0; j < kMmaKeys / 8; ++j) {
    pa[j >> 1][(j & 1) * 2] = pack(sc[4 * j], sc[4 * j + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

static_assert(kMmaKeys == 64, "issue_qk's product is wgmma m64n64k16");

// S = Q.K^T for this consumer's 64 rows: K-major operands, k-steps of 16
// columns (32 bytes) inside a 128-byte swizzled half, 8-row groups 1024
// bytes apart.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kMmaKeys / 2],
                                         const bf16 (&q)[D / kHalf][kMmaRows * kHalf],
                                         const bf16 (&k)[D / kHalf][kMmaKeys * kHalf],
                                         int c) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        wgmma_desc(&q[kk / 4][64 * c * kHalf + (kk % 4) * 16], 16, 1024);
    const uint64_t db = wgmma_desc(&k[kk / 4][(kk % 4) * 16], 16, 1024);
    wgmma_ss_n64(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P.V: V is MN-major (D contiguous): 64-column halves kMmaKeys * 128
// bytes apart (LBO), 8-key groups 1024 bytes apart (SBO), a k-step of 16
// keys 2048 bytes.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const PFrag& pa,
                                         const bf16 (&v)[D / kHalf][kMmaKeys * kHalf]) {
#pragma unroll
  for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
    const uint64_t db = wgmma_desc(&v[0][kk * 16 * kHalf],
                                   kMmaKeys * kHalf * sizeof(bf16), 1024);
    wgmma_pv<D>(o, pa[kk], db);
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  extern __shared__ unsigned char smem_raw[];
  MmaSmem<D>& sm = *reinterpret_cast<MmaSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int kHalves = D / kHalf;
  constexpr uint32_t kTileBytes = kMmaKeys * D * sizeof(bf16);

  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  int lo, hi;
  key_tiles(p, r0, min(r0 + kMmaRows, p.sq), kMmaKeys, &lo, &hi);
  const int n_tiles = hi - lo;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumerWarps);
      mbar_init(&sm.v_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(&sm.q_full, kMmaRows * D * sizeof(bf16));
      for (int h = 0; h < kHalves; ++h)
        tma_load(sm.q[h], &tq, h * kHalf, r0, bh, &sm.q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = (lo + i) * kMmaKeys;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;
        mbar_wait(&sm.k_empty[s], free_parity);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        for (int h = 0; h < kHalves; ++h)
          tma_load(sm.k[s][h], &tk, h * kHalf, k0, bh, &sm.k_full[s]);
        mbar_wait(&sm.v_empty[s], free_parity);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        for (int h = 0; h < kHalves; ++h)
          tma_load(sm.v[s][h], &tv, h * kHalf, k0, bh, &sm.v_full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;  // this consumer's 64 rows: r0 + 64c ..
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = r0 + 64 * c + 16 * warp + g;  // and row + 8
  const int qpos[2] = {p.q_offset + row, p.q_offset + row + 8};
  const int wq_min = p.q_offset + r0 + 64 * c, wq_max = wq_min + 63;
  const float scale2 = p.scale * kLog2e;  // scores to log2 units

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[kMmaKeys / 2];
#pragma unroll
  for (int i = 0; i < kMmaKeys / 2; ++i) sc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  auto cuts = [&](int k0) {
    return k0 + kMmaKeys > p.sk || (p.causal && k0 + kMmaKeys - 1 > wq_min) ||
           (p.has_window && wq_max - k0 >= p.window);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // this warp is done with the slot
  };

  if (n_tiles > 0) {
    // Tile i's softmax runs while the tensor cores do tile i - 1's P.V:
    // S_i is issued before P_{i-1}.V_{i-1}, the wait for S_i lets the P.V
    // run on, and only once it has landed are O rescaled and P_i packed
    // into the registers it read.
    PFrag pa;
    mbar_wait(&sm.q_full, 0);
    mbar_wait(&sm.k_full[0], 0);
    wgmma_fence();
    issue_qk<D>(sc, sm.q, sm.k[0], c);
    wgmma_wait<0>();
    fence_regs(sc);
    release(&sm.k_empty[0]);
    softmax_tile(sc, p, lo * kMmaKeys, cuts(lo * kMmaKeys), qpos, t, scale2,
                 m, l, corr);
    pack_p(sc, pa);
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      const int k0 = (lo + i) * kMmaKeys;
      mbar_wait(&sm.k_full[s], (i / kStages) & 1);
      mbar_wait(&sm.v_full[sp], ((i - 1) / kStages) & 1);
      wgmma_fence();
      issue_qk<D>(sc, sm.q, sm.k[s], c);
      issue_pv<D>(o, pa, sm.v[sp]);
      wgmma_wait<1>();  // S_i has landed; the P.V may still run
      fence_regs(sc);
      release(&sm.k_empty[s]);
      softmax_tile(sc, p, k0, cuts(k0), qpos, t, scale2, m, l, corr);
      wgmma_wait<0>();
      fence_regs(o);
      release(&sm.v_empty[sp]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      pack_p(sc, pa);
    }
    const int sp = (n_tiles - 1) % kStages;
    mbar_wait(&sm.v_full[sp], ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<D>(o, pa, sm.v[sp]);
    wgmma_wait<0>();
    fence_regs(o);
    release(&sm.v_empty[sp]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* y = static_cast<bf16*>(p.y) + static_cast<size_t>(bh) * p.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int yr = row + 8 * r;
    if (yr >= p.sq) continue;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(yr) * D + 8 * j +
                                   2 * t) =
          pack(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
    if (t == 0)
      p.lse[static_cast<size_t>(bh) * p.sq + yr] =
          (m[r] == -INFINITY ? 0.f : m[r] * kLn2) + logf(den);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D map of a [bh, rows, d] bf16 tensor, boxes of 64 columns x
// box_rows rows of one head, 128-byte swizzle, zero fill past the edges.
int make_map(CUtensorMap* map, const void* base, int bh, int rows, int d,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(d) * sizeof(bf16),
      static_cast<cuuint64_t>(rows) * d * sizeof(bf16)};
  const cuuint32_t box[3] = {kHalf, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_wgmma(const Params& p, int bh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, bh, p.sq, D, kMmaRows);
  if (err == 0) err = make_map(&tk, p.k, bh, p.sk, D, kMmaKeys);
  if (err == 0) err = make_map(&tv, p.v, bh, p.sk, D, kMmaKeys);
  if (err != 0) return err;
  auto kernel = flash_wgmma_kernel<D>;
  const size_t smem = mma_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (p.sq + kMmaRows - 1) / kMmaRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
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

// dtype: 0 = float32, 1 = bfloat16.  tensor_cores: 1 takes the wgmma
// kernel (bf16 with D 64 or 128 only), 0 the scalar one (D <= 256).
// window < 0 means no window.  Returns a cudaError_t (0 = launched;
// cudaErrorNotSupported if the driver has no cuTensorMapEncodeTiled).
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
    if (d == 64) return launch_wgmma<64>(p, bh, s);
    if (d == 128) return launch_wgmma<128>(p, bh, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch_simt<float>(p, bh, s);
  if (dtype == 1) return launch_simt<bf16>(p, bh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
