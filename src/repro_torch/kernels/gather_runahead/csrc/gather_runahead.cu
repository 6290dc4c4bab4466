// Irregular row gathers for Hopper (sm_90a): the runahead gather, its
// one-row-per-warp baseline, and the Listing-1 gather-bag.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/gather_runahead/
// gather_runahead.py:
//   * runahead_gather_kernel  <- _runahead_kernel (:34), pallas_call at :91
//     (runahead_gather): out[i] = table[idx[i]], `depth` index blocks of
//     `block_rows` row copies in flight (the paper's MSHR window, §3.4.1);
//   * pipelined_gather_kernel <- _pipelined_kernel (:102), pallas_call at
//     :117 (pipelined_gather): the same gather, one row per grid step;
//   * gather_bag_kernel       <- _bag_kernel (:128), pallas_call at :177
//     (gather_bag): out[s] = sum_k w[s,k] * table[idx[s,k]], rows and
//     weights in f32, products summed over k in f32, cast to the table's
//     type, `depth` output rows of K fetches in flight.  The weights come
//     in as f32 (the wrapper's caller casts them, as the TPU kernel does).
//
// Bound on this card: bytes, all three.  The gathers do no arithmetic; the
// bag does 2 flops per fetched element, under 1 per byte of an f32 row,
// far below the 20 flops per byte (67 TFLOP/s f32 over 3.35 TB/s) where
// arithmetic would bound it.  What limits them is how many independent
// row reads are in flight: each read is a dependent load (index, then
// row), and device memory needs about (bandwidth x latency) bytes in
// flight to run at its rate.  Design against that:
//   * the runahead gather keeps, per block, a `depth`-stage ring of
//     [block_rows, row] tiles in shared memory, filled by cp.async (16 B a
//     lane, one warp per row).  Tile k is written out, then tile k + depth
//     is issued into its stage: depth * block_rows rows in flight per
//     block, the TPU kernel's window of DMAs, with no registers held;
//   * the baseline gives each row to one warp that loads it into registers
//     and stores it, with no ring: its reads in flight are what the warp
//     scheduler happens to overlap;
//   * the bag keeps a `depth`-stage ring of [K, row] tiles per block (one
//     warp, one output row at a time) and accumulates the K rows in f32
//     registers; only the output row goes back to device memory.
// The ring only runs ahead if the index stream does: the TPU kernel has
// its indices in SMEM before the grid starts (scalar prefetch), while a
// load of each index from device memory at issue time would put one
// memory latency on every step of the ring.  So each warp of the
// runahead gather reads its indices 32 at a time, one batch ahead
// (Lookahead); the bag reads a row's K indices in one load.  Every thread
// waits for its own copies (cp.async.wait_group) and reads back only the
// 16-byte chunks it copied itself, so the rings need no barrier.  The
// output is a byte-exact copy for the gathers at every depth.  Rows must
// be a multiple of 16 bytes and 16-byte aligned, and a bag row at most
// 2048 bytes (the wrapper checks); indices must lie in [0, V) (the
// contract, not checked here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherWarps = 8;  // warps per block of the two row gathers
constexpr int kMaxDepth = 8;
constexpr int kBagPasses = 4;    // a bag row is at most 4 x 32 chunks of 16 B

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

// How many of n_items this block owns: it walks items blockIdx.x,
// blockIdx.x + gridDim.x, ... (the grid never exceeds n_items).
__device__ __forceinline__ int owned_count(int n_items) {
  return (n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
}

// The row indices a warp reads in order, read ahead: lane l holds index
// base + l of the current batch of 32 and the next batch is already in
// flight, so a read waits on device memory once per 32 indices at most,
// not once per index.  This is the TPU kernel's scalar prefetch of the
// index stream.  `at(q)` points at index q < n; every lane calls get()
// with the same non-decreasing q.
template <typename At>
struct Lookahead {
  At at;
  long long n, base = 0;
  int32_t cur, next;

  __device__ Lookahead(At at_, long long n_) : at(at_), n(n_) {
    cur = load(0);
    next = load(32);
  }
  __device__ int32_t load(long long first) const {
    const long long q = first + (threadIdx.x & 31);
    return q < n ? *at(q) : 0;
  }
  __device__ int32_t get(long long q) {
    while (q >= base + 32) {  // the same on every lane
      base += 32;
      cur = next;
      next = load(base + 32);
    }
    return __shfl_sync(0xffffffffu, cur, static_cast<int>(q - base));
  }
};

// ---------------------------------------------------------------------------
// runahead gather
// ---------------------------------------------------------------------------

template <int DEPTH>
__global__ void __launch_bounds__(kGatherWarps * 32)
    runahead_gather_kernel(const unsigned char* __restrict__ table,
                           const int32_t* __restrict__ idx,
                           unsigned char* __restrict__ out, int n_tiles,
                           int block_rows, int row_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = row_bytes >> 4;
  const size_t tile_bytes = static_cast<size_t>(block_rows) * row_bytes;
  const int mine = owned_count(n_tiles);
  // this warp copies rows warp, warp + kGatherWarps, ... of every tile:
  // per_tile of them; its q-th row index is row q % per_tile of the block's
  // (q / per_tile)-th tile
  const int per_tile = max(0, (block_rows - warp + kGatherWarps - 1) /
                                  kGatherWarps);
  Lookahead rows(
      [=](long long q) {
        const long long k = q / per_tile, r = q - k * per_tile;
        return idx + (blockIdx.x + k * gridDim.x) * block_rows + warp +
               r * kGatherWarps;
      },
      static_cast<long long>(mine) * per_tile);

  // Issue the row copies of this block's k-th tile into stage k % DEPTH.
  // Past the last tile an empty group is committed, so that wait_group
  // always counts DEPTH groups behind the current one.
  auto issue = [&](int k) {
    if (k < mine) {
      unsigned char* stage = smem + (k % DEPTH) * tile_bytes;
      for (int i = 0; i < per_tile; ++i) {
        const int r = warp + i * kGatherWarps;
        const int64_t row =
            rows.get(static_cast<long long>(k) * per_tile + i);
        const unsigned char* src = table + row * row_bytes;
        unsigned char* dst = stage + static_cast<size_t>(r) * row_bytes;
        for (int c = lane; c < chunks; c += 32)
          cp_async16(dst + c * 16, src + c * 16);
      }
    }
    cp_async_commit();
  };

  for (int k = 0; k < DEPTH; ++k) issue(k);
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<DEPTH - 1>();  // this thread's copies of tile k landed
    const size_t tile = blockIdx.x + static_cast<size_t>(k) * gridDim.x;
    const unsigned char* stage = smem + (k % DEPTH) * tile_bytes;
    unsigned char* dst = out + tile * tile_bytes;
    for (int r = warp; r < block_rows; r += kGatherWarps) {
      const size_t off = static_cast<size_t>(r) * row_bytes;
      for (int c = lane; c < chunks; c += 32)
        *reinterpret_cast<int4*>(dst + off + c * 16) =
            *reinterpret_cast<const int4*>(stage + off + c * 16);
    }
    issue(k + DEPTH);  // the stage just drained takes tile k + DEPTH
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// pipelined gather: the baseline, one row per warp
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kGatherWarps * 32)
    pipelined_gather_kernel(const unsigned char* __restrict__ table,
                            const int32_t* __restrict__ idx,
                            unsigned char* __restrict__ out, int n,
                            int row_bytes) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kGatherWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int chunks = row_bytes >> 4;
  const int4* src =
      reinterpret_cast<const int4*>(table + static_cast<int64_t>(idx[i]) *
                                                row_bytes);
  int4* dst = reinterpret_cast<int4*>(out + i * row_bytes);
  for (int c = lane; c < chunks; c += 32) dst[c] = __ldg(src + c);
}

// ---------------------------------------------------------------------------
// gather-bag (Listing 1)
// ---------------------------------------------------------------------------

// A 16-byte chunk of a row as f32 values, and back.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void unpack(int4 v, float (&x)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(&v);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  }
  static __device__ __forceinline__ int4 pack(const float (&x)[4]) {
    const float4 f = make_float4(x[0], x[1], x[2], x[3]);
    return *reinterpret_cast<const int4*>(&f);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void unpack(int4 v, float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ int4 pack(const float (&x)[8]) {
    int4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return v;
  }
};

// One warp per block; the block walks output rows blockIdx.x, +gridDim.x,
// ... with a DEPTH-stage ring of [K, row] tiles.  Lane l copies, and later
// accumulates, chunks l, l + 32, ... of every one of the K rows.
template <typename T, int DEPTH>
__global__ void __launch_bounds__(32)
    gather_bag_kernel(const T* __restrict__ table,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ weights, T* __restrict__ out,
                      int S, int K, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = Chunk<T>;
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int chunks = row_bytes >> 4;
  const size_t tile_bytes = static_cast<size_t>(K) * row_bytes;
  const int mine = owned_count(S);

  // A row's K indices (and later its weights) come in one coalesced load
  // of 32 lanes per 32 entries and go out by __shfl_sync.  With K near 32
  // that is already one memory latency per row, so a Lookahead here only
  // adds work.
  auto issue = [&](int j) {
    if (j < mine) {
      const size_t s = blockIdx.x + static_cast<size_t>(j) * gridDim.x;
      unsigned char* stage = smem + (j % DEPTH) * tile_bytes;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int kn = min(32, K - k0);
        const int32_t my_idx = lane < kn ? idx[s * K + k0 + lane] : 0;
        for (int k = 0; k < kn; ++k) {
          const int64_t row = __shfl_sync(kFull, my_idx, k);
          const unsigned char* src =
              reinterpret_cast<const unsigned char*>(table) + row * row_bytes;
          unsigned char* dst =
              stage + static_cast<size_t>(k0 + k) * row_bytes;
          for (int c = lane; c < chunks; c += 32)
            cp_async16(dst + c * 16, src + c * 16);
        }
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < DEPTH; ++j) issue(j);
  for (int j = 0; j < mine; ++j) {
    cp_async_wait<DEPTH - 1>();
    const size_t s = blockIdx.x + static_cast<size_t>(j) * gridDim.x;
    const unsigned char* stage = smem + (j % DEPTH) * tile_bytes;
    float acc[kBagPasses][C::kElems];
#pragma unroll
    for (int p = 0; p < kBagPasses; ++p)
#pragma unroll
      for (int e = 0; e < C::kElems; ++e) acc[p][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int kn = min(32, K - k0);
      const float my_w = lane < kn ? weights[s * K + k0 + lane] : 0.f;
      for (int k = 0; k < kn; ++k) {
        const float w = __shfl_sync(kFull, my_w, k);
        const unsigned char* src =
            stage + static_cast<size_t>(k0 + k) * row_bytes;
#pragma unroll
        for (int p = 0; p < kBagPasses; ++p) {
          const int c = p * 32 + lane;
          if (c < chunks) {
            float x[C::kElems];
            C::unpack(*reinterpret_cast<const int4*>(src + c * 16), x);
            // products rounded, then summed: the TPU kernel's order of
            // operations, kept out of a fused multiply-add on purpose
#pragma unroll
            for (int e = 0; e < C::kElems; ++e)
              acc[p][e] = __fadd_rn(acc[p][e], __fmul_rn(w, x[e]));
          }
        }
      }
    }
    unsigned char* dst = reinterpret_cast<unsigned char*>(out) + s * row_bytes;
#pragma unroll
    for (int p = 0; p < kBagPasses; ++p) {
      const int c = p * 32 + lane;
      if (c < chunks)
        *reinterpret_cast<int4*>(dst + c * 16) = C::pack(acc[p]);
    }
    issue(j + DEPTH);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

// Opt in to `smem` bytes of dynamic shared memory where that is over the
// default 48 KB, then size a grid of at most `items` blocks that fills the
// card at the occupancy the kernel reaches, or of `cap` blocks if that is
// fewer and positive.  Returns a cudaError_t.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, int items,
                    int cap, int* grid) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long want = static_cast<long long>(per_sm) * sms;
  if (cap > 0 && cap < want) want = cap;
  *grid = static_cast<int>(want < items ? want : items);
  return 0;
}

template <int DEPTH>
int launch_runahead(const void* table, const void* idx, void* out,
                    int n_tiles, int block_rows, int row_bytes,
                    int grid_blocks, cudaStream_t stream) {
  auto kernel = runahead_gather_kernel<DEPTH>;
  const int threads = kGatherWarps * 32;
  const size_t smem = static_cast<size_t>(DEPTH) * block_rows * row_bytes;
  int grid = 0;
  const int e =
      persistent_grid(kernel, threads, smem, n_tiles, grid_blocks, &grid);
  if (e != 0) return e;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const unsigned char*>(table),
      static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out),
      n_tiles, block_rows, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DEPTH>
int launch_bag(const void* table, const void* idx, const void* w, void* out,
               int S, int K, int D, cudaStream_t stream) {
  auto kernel = gather_bag_kernel<T, DEPTH>;
  const size_t smem = static_cast<size_t>(DEPTH) * K * D * sizeof(T);
  int grid = 0;
  const int e = persistent_grid(kernel, 32, smem, S, 0, &grid);
  if (e != 0) return e;
  kernel<<<grid, 32, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), S, K, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bag_depth(int depth, const void* table, const void* idx, const void* w,
              void* out, int S, int K, int D, cudaStream_t s) {
  switch (depth) {
    case 1: return launch_bag<T, 1>(table, idx, w, out, S, K, D, s);
    case 2: return launch_bag<T, 2>(table, idx, w, out, S, K, D, s);
    case 3: return launch_bag<T, 3>(table, idx, w, out, S, K, D, s);
    case 4: return launch_bag<T, 4>(table, idx, w, out, S, K, D, s);
    case 5: return launch_bag<T, 5>(table, idx, w, out, S, K, D, s);
    case 6: return launch_bag<T, 6>(table, idx, w, out, S, K, D, s);
    case 7: return launch_bag<T, 7>(table, idx, w, out, S, K, D, s);
    case 8: return launch_bag<T, 8>(table, idx, w, out, S, K, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

static_assert(kMaxDepth == 8, "the depth switches instantiate 1..8");

}  // namespace

extern "C" {

// Every function returns a cudaError_t: 0 = launched.

// n_tiles = n / block_rows index blocks; depth in 1..8; grid_blocks > 0
// caps the number of blocks (0 = fill the card at the kernel's occupancy).
int runahead_gather_launch(const void* table, const void* idx, void* out,
                           int n_tiles, int block_rows, int row_bytes,
                           int depth, int grid_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = n_tiles, b = block_rows, r = row_bytes, g = grid_blocks;
  switch (depth) {
    case 1: return launch_runahead<1>(table, idx, out, n, b, r, g, s);
    case 2: return launch_runahead<2>(table, idx, out, n, b, r, g, s);
    case 3: return launch_runahead<3>(table, idx, out, n, b, r, g, s);
    case 4: return launch_runahead<4>(table, idx, out, n, b, r, g, s);
    case 5: return launch_runahead<5>(table, idx, out, n, b, r, g, s);
    case 6: return launch_runahead<6>(table, idx, out, n, b, r, g, s);
    case 7: return launch_runahead<7>(table, idx, out, n, b, r, g, s);
    case 8: return launch_runahead<8>(table, idx, out, n, b, r, g, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int pipelined_gather_launch(const void* table, const void* idx, void* out,
                            int n, int row_bytes, void* stream) {
  const int blocks = (n + kGatherWarps - 1) / kGatherWarps;
  pipelined_gather_kernel<<<blocks, kGatherWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table),
      static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out), n,
      row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (the table and the output); weights
// are float32; depth in 1..8.
int gather_bag_launch(int dtype, const void* table, const void* idx,
                      const void* w, void* out, int S, int K, int D,
                      int depth, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bag_depth<float>(depth, table, idx, w, out, S, K, D, s);
  if (dtype == 1)
    return bag_depth<__nv_bfloat16>(depth, table, idx, w, out, S, K, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
