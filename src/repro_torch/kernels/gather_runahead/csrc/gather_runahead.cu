// Irregular row gathers for Hopper (sm_90a): the runahead gather, its
// one-row-per-warp baseline, and the Listing-1 gather-bag.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/gather_runahead/
// gather_runahead.py:
//   * runahead_bulk_kernel and runahead_cp_async_kernel <- _runahead_kernel
//     (:34), pallas_call at :91 (runahead_gather): out[i] = table[idx[i]],
//     `depth` index blocks of `block_rows` row copies in flight (the
//     paper's MSHR window, §3.4.1);
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
// arithmetic would bound it.  What limits the gathers is how many
// independent row reads are in flight, and the instructions it takes to
// keep them in flight: each read is a dependent load (index, then row),
// and device memory needs about (bandwidth x latency) bytes in flight to
// run at its rate.  The baseline gives each row to one warp that loads it
// into registers and stores it, with no ring: its reads in flight are
// what the warp scheduler happens to overlap.
//
// The runahead gather keeps, per block, a ring of `depth` stages (1..16,
// every depth the Algorithm-1 allocator in core/runahead/vmem_allocator.py
// plans) of [block_rows, row] tiles in shared memory: tile k is written
// out, then its stage takes tile k + depth, so a block has depth x
// block_rows rows in flight (the TPU kernel's window of DMAs), and with
// one block per SM the card has SMs x depth x block_rows (Fig. 14's MSHR
// count).  Its first design filled the ring with 16-byte cp.async, one
// warp of eight per row, and copied each tile out through registers.  At
// the allocator's plan for dbrx-132b's embedding (32,768 rows of 12,288 B,
// depth 15, one-row tiles, since 15 larger tiles do not fit 227 KB) it
// took 0.3113 ms against index_select's 0.2818 and a bytes bound of
// 0.2228 (H100 SXM, 700 W): 7 of 8 warps had no row, and the one that did
// issued 768 cp.async per row, then waited and copied 12 KB out (24 int4
// loads and stores a lane) before it could issue the next tile.  Memory
// had far more than enough in flight (24 MB over the card); one warp's
// instruction stream set the pace.  So the kernel has two routes, chosen
// by shape in the wrapper (gather_runahead.py, route()):
//   * "bulk" (TMA), where the ring and one 8-byte barrier a stage fit a
//     block's shared memory and each TMA operation moves enough bytes
//     over the blocks an SM holds: one warp a block; its lanes issue one
//     bulk copy (cp.async.bulk) per row into the tile's stage, counted on
//     the stage's mbarrier (armed for the tile's bytes), and when the barrier
//     completes one lane writes the whole tile out with one bulk store
//     (cp.async.bulk.global.shared::cta), whose group it waits on only
//     (.read) before the stage takes its next tile, keeping one store in
//     flight.  No register or instruction touches a row's bytes.  Rows
//     are read with L2 priority evict_last and tiles written evict_first,
//     so a row named again may still be in L2 (faster at every shape
//     timed);
//   * "cp_async", the rings that leave no room for those barriers, and
//     deep rings of small rows, where the few one-warp bulk blocks an SM
//     holds wait on their operations: the first design, warp w copying
//     rows w, w + 8, ... of each tile with 16-byte cp.async and later
//     copying the same chunks out through registers.  Spreading a one-row
//     tile's chunks over all eight warps instead was slower at the rings
//     that leave no room for the barriers, so it was dropped.
// With grid_blocks = SMs both routes keep the contract above; the bulk
// route, one warp an SM then, is the slower there (chip_smoke.py phase 7
// times both).
// The ring only runs ahead if the index stream does: the TPU kernel has
// its indices in SMEM before the grid starts (scalar prefetch), while a
// load of each index from device memory at issue time would put one
// memory latency on every step of the ring.  So each warp of the
// runahead gather reads its indices 32 at a time, one batch ahead
// (Lookahead), and the bag reads each batch of 32 entries (indices and
// weights) one batch ahead of the batch it issues.  The gathers' output
// is a byte-exact copy at every depth, on both routes.  Ring stages are
// walked with a running counter (no k % depth), so that no instantiation
// spills, and the cp_async route is held to one block an SM's registers.
//
// The bag's bytes bound counts the indices, the weights, each distinct
// table row once and the output.  What held it far above that bound was
// the rows it fetched: a padded-CSR bag (Listing 1's GCN aggregate) names
// the pad row (index 0, weight 0) in most of its entries and a few hub
// rows in many.  At OGBN-Arxiv size 70% of the entries are the pad, and
// fetching every entry's row moves 4.1x the rows that each output row's
// distinct indices need, 3/4 of them two rows (the pad and the Zipf hub).
// So the bag
//   * fetches each distinct index of a batch of 32 entries once
//     (__match_any_sync).  The pad and hub rows that are left then cost
//     nothing measurable: copying them through L1 (cp.async.ca), keeping
//     them in a warp's shared memory, or spreading them over 251 rows
//     each left the time as it was;
//   * gives each warp a ring of row slots that its batches in flight share
//     (a batch waits only while the ring has too few free slots for it),
//     sized for one batch of 32 distinct rows, not depth x K rows, so
//     several warps fit a block and more rows are in flight on an SM.
//     So `depth` is now an upper limit, not the number in flight: a warp
//     has up to min(depth x ceil(K / 32), 8) batches in flight, and only
//     while their distinct rows fit its ring of min(K, 32) slots; a row
//     with many distinct indices holds back the next.  At OGBN-Arxiv size
//     depths 1, 2 and 4 take about the same time.
// With the fetches cut, what took the time was the accumulation, one
// multiply-add per element of every entry: the bag's arithmetic is below
// its bytes, but the instructions that issue it, per entry and lane, were
// not.  So the kernel is instantiated for the passes of 32 chunks a row
// needs (no idle passes are issued), and an entry that repeats the entry
// before it with weight 0 on both (a run of pads) is skipped, which
// leaves the sum bit for bit as adding it would; every other entry is
// added in k order, so the output, and the NaN of a 0 * inf, are those of
// adding every entry.
// In the cp.async rings (the cp_async route and the bag) every thread
// waits for its own copies (cp.async.wait_group) and reads back only the
// 16-byte chunks it copied itself, so they need no barrier; in the bulk
// route the whole warp waits on the barriers and the storing lane on its
// own bulk stores.
// Rows must be a multiple of 16 bytes and 16-byte aligned, and
// a bag row at most 2048 bytes (the wrapper checks); indices must lie in
// [0, V) (the contract, not checked here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherWarps = 8;  // warps a block: cp_async route, pipelined
constexpr int kMaxRunaheadDepth = 16;  // the runahead gather's ring stages
constexpr int kRouteCpAsync = 0, kRouteBulk = 1;  // runahead_gather_launch
constexpr int kMaxBagDepth = 8;
constexpr int kBagWarps = 4;     // most warps a block of the bag holds
constexpr int kBagFlight = 8;    // most batches a warp of the bag has in flight
constexpr size_t kMaxSmemBytes = 232448;  // dynamic shared memory a block

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
// Wait until at most n (0..7) of this thread's groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// How many of n_items this block owns: it walks items blockIdx.x,
// blockIdx.x + gridDim.x, ... (the grid never exceeds n_items).
__device__ __forceinline__ int owned_count(int n_items) {
  return (n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
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
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory by the TMA, counted on bar.  The
// rows stay in L2 ahead of other lines (evict_last): a row that the index
// stream names again may still be there.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_last.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], pol;\n}\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// `bytes` from shared memory out to device memory by the TMA, in this
// thread's current bulk group; the output leaves L2 first (evict_first),
// since nothing here reads it again.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, pol;\n}\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's bulk groups are still reading shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The row indices a warp reads in order, read ahead: lane l holds index
// base + l of the current batch of 32 and the next batch is already in
// flight, so a read waits on device memory once per 32 indices at most,
// not once per index.  This is the TPU kernel's scalar prefetch of the
// index stream.  `at(q)` points at index q < n.  Every lane calls get()
// with the same non-decreasing q; or advance() with the same
// non-decreasing q, the warp's lowest, and then peek() with its own q in
// [that q, that q + 32).
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
  __device__ void advance(long long q) {
    while (q >= base + 32) {  // the same on every lane
      base += 32;
      cur = next;
      next = load(base + 32);
    }
  }
  __device__ int32_t peek(long long q) const {
    const int d = static_cast<int>(q - base);  // in [0, 64)
    const int32_t a = __shfl_sync(0xffffffffu, cur, d & 31);
    const int32_t b = __shfl_sync(0xffffffffu, next, d & 31);
    return d < 32 ? a : b;
  }
  __device__ int32_t get(long long q) {
    advance(q);
    return __shfl_sync(0xffffffffu, cur, static_cast<int>(q - base));
  }
};

// ---------------------------------------------------------------------------
// runahead gather
// ---------------------------------------------------------------------------

// Route "bulk": one warp a block.  Lane 0 arms stage s's barrier for a
// tile's bytes, then each lane issues one bulk copy per row of its own
// into it; the whole warp reads the indices (Lookahead) and waits on the
// barriers, so it stays converged.  When tile k has landed, lane 0
// writes it out with one bulk store; then the stage of tile k - 1, whose
// store has read it (at most the newest group is still reading), takes
// tile k - 1 + DEPTH.  At DEPTH 1 the one stage waits for its own store.
// The block's k-th tile is tile blockIdx.x + k * gridDim.x of the output.
template <int DEPTH>
__global__ void __launch_bounds__(32)
    runahead_bulk_kernel(const unsigned char* __restrict__ table,
                         const int32_t* __restrict__ idx,
                         unsigned char* __restrict__ out, int n_tiles,
                         int block_rows, int row_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t tile_bytes = static_cast<uint32_t>(block_rows) * row_bytes;
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(smem + DEPTH * tile_bytes);
  const int lane = threadIdx.x;
  const bool leader = lane == 0;
  const int mine = owned_count(n_tiles);
  if (leader) {
    for (int s = 0; s < DEPTH; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();
  Lookahead rows(
      [=](long long q) {
        const long long k = q / block_rows;
        return idx + (blockIdx.x + k * gridDim.x) * block_rows +
               (q - k * block_rows);
      },
      static_cast<long long>(mine) * block_rows);

  // tile k into stage s: the barrier armed first, then lane l copies rows
  // l, l + 32, ... of the tile
  auto issue = [&](int k, int s) {
    unsigned char* stage = smem + s * tile_bytes;
    if (leader) mbar_expect_tx(&full[s], tile_bytes);
    __syncwarp();
    const long long q = static_cast<long long>(k) * block_rows;
    for (int r0 = 0; r0 < block_rows; r0 += 32) {
      const int r = r0 + lane;
      rows.advance(q + r0);
      const int64_t row = rows.peek(q + min(r, block_rows - 1));
      if (r < block_rows)
        bulk_load(stage + r * row_bytes, table + row * row_bytes, row_bytes,
                  &full[s]);
    }
  };

  // stores left reading their stages when a stage is refilled: the
  // newest one, except with a single stage
  constexpr int kLag = DEPTH > 1 ? 1 : 0;
  const int first = min(DEPTH, mine);
#pragma unroll 1
  for (int k = 0; k < first; ++k) issue(k, k);
  int s = 0, refill = DEPTH - kLag;  // stages of tiles k and k - kLag
  uint32_t parity = 0;
#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    mbar_wait(&full[s], parity);  // tile k has landed in stage s
    if (leader) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const size_t tile = blockIdx.x + static_cast<size_t>(k) * gridDim.x;
      bulk_store(out + tile * tile_bytes, smem + s * tile_bytes, tile_bytes);
      bulk_commit();
    }
    if (refill == DEPTH) refill = 0;
    if (k >= kLag && k - kLag + DEPTH < mine) {
      if (leader) bulk_wait_read<kLag>();  // tile k - kLag's store has read
      issue(k - kLag + DEPTH, refill);
    }
    ++refill;
    if (++s == DEPTH) s = 0, parity ^= 1;
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Route "cp_async": eight warps a block; warp w copies rows w, w + 8, ...
// of each tile into the ring with 16-byte cp.async, lane l chunks l, l +
// 32, ... of a row, and later copies the same chunks out through
// registers, after its own wait_group.  Tile k is drained from its stage,
// then the stage takes tile k + DEPTH.  Its rings fill most of an SM's
// shared memory, so its launch bounds ask for one block an SM: without
// that minimum ptxas held it to 64 registers a thread and spilled.
template <int DEPTH>
__global__ void __launch_bounds__(kGatherWarps * 32, 1)
    runahead_cp_async_kernel(const unsigned char* __restrict__ table,
                             const int32_t* __restrict__ idx,
                             unsigned char* __restrict__ out, int n_tiles,
                             int block_rows, int row_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = row_bytes >> 4;
  const size_t tile_bytes = static_cast<size_t>(block_rows) * row_bytes;
  const int mine = owned_count(n_tiles);
  // this warp copies per_tile rows of every tile; its q-th row index is
  // row warp + (q % per_tile) * 8 of the block's (q / per_tile)-th tile
  const int per_tile = max(0, (block_rows - warp + kGatherWarps - 1) /
                                  kGatherWarps);
  Lookahead rows(
      [=](long long q) {
        const long long k = q / per_tile, i = q - k * per_tile;
        return idx + (blockIdx.x + k * gridDim.x) * block_rows + warp +
               i * kGatherWarps;
      },
      static_cast<long long>(mine) * per_tile);

  // Issue this warp's copies of the block's k-th tile into `stage`.  Past
  // the last tile an empty group is committed, so that wait_group always
  // counts DEPTH groups behind the current one.
  auto issue = [&](int k, unsigned char* stage) {
    if (k < mine) {
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

#pragma unroll 1
  for (int k = 0; k < DEPTH; ++k) issue(k, smem + k * tile_bytes);
  int s = 0;
#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<DEPTH - 1>();  // this thread's copies of tile k landed
    const size_t tile = blockIdx.x + static_cast<size_t>(k) * gridDim.x;
    unsigned char* stage = smem + s * tile_bytes;
    unsigned char* dst = out + tile * tile_bytes;
    for (int r = warp; r < block_rows; r += kGatherWarps) {
      const size_t off = static_cast<size_t>(r) * row_bytes;
      for (int c = lane; c < chunks; c += 32)
        *reinterpret_cast<int4*>(dst + off + c * 16) =
            *reinterpret_cast<const int4*>(stage + off + c * 16);
    }
    issue(k + DEPTH, stage);  // the stage just drained takes tile k + DEPTH
    if (++s == DEPTH) s = 0;
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

// Where a warp is in its walk: the j-th of its output rows and the b-th
// batch of 32 entries of that row.
struct BagCursor {
  int j = 0, b = 0;
  __device__ void next(int batches) {
    if (++b == batches) b = 0, ++j;
  }
};

// Every warp walks its own output rows (warp w of the grid's W takes rows
// w, w + W, ...) one batch of up to 32 entries at a time, with up to FLIGHT
// batches in flight, over a ring of `ring` row slots of its own in shared
// memory.  Lane l holds entry l of a batch: its index and weight come in
// one coalesced load, one batch ahead of the batch being prepared.  A
// batch's distinct indices are found by __match_any_sync; the lowest lane
// of each index (its leader) takes the next free slot of the ring, and
// only the leaders' rows are copied, so a row that an output row names
// many times (the pad) is fetched once per batch.  A batch waits to be
// issued while the ring has too few free slots for it; the ring holds at
// least one batch, so an empty ring always takes the next.  Lane l copies,
// and later accumulates, chunks l, l + 32, ... (PASSES of them) of every
// row, so each thread reads back only the copies it waited for and the
// ring needs no barrier.  The accumulation walks the batch's entries in k
// order, each reading its leader's slot.
template <typename T, int FLIGHT, int PASSES>
__global__ void __launch_bounds__(kBagWarps * 32)
    gather_bag_kernel(const T* __restrict__ table,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ weights, T* __restrict__ out,
                      int S, int K, int D, int ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = Chunk<T>;
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int block_warps = blockDim.x >> 5;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int chunks = row_bytes >> 4;
  unsigned char* const slots =
      smem + static_cast<size_t>(threadIdx.x >> 5) * ring * row_bytes;
  const int warps = gridDim.x * block_warps;
  const int me = blockIdx.x * block_warps + (threadIdx.x >> 5);
  const int batches = max(1, (K + 31) >> 5);  // K = 0: one empty batch
  const int rows = me < S ? static_cast<int>((static_cast<long long>(S) -
                                               me + warps - 1) / warps)
                          : 0;
  const int total = rows * batches;  // at most max(S, S * K) < 2^31
  auto first_k = [&](const BagCursor& at) { return at.b * 32; };
  auto out_row = [&](const BagCursor& at) {
    return static_cast<size_t>(me) + static_cast<size_t>(at.j) * warps;
  };

  // the raw entries of the batch after the pending one (index -1 past the
  // row's K entries and past the warp's last batch)
  BagCursor raw_at;
  int raw_q = 0;
  int32_t raw_idx = -1;
  float raw_w = 0.f;
  auto load_raw = [&]() {
    raw_idx = -1, raw_w = 0.f;
    const int k = first_k(raw_at) + lane;
    if (raw_q < total && k < K) {
      const size_t e = out_row(raw_at) * K + k;
      raw_idx = idx[e];
      raw_w = weights[e];
    }
  };

  // the pending batch: prepared, waiting for room in the ring
  int32_t pend_idx;
  float pend_w;
  unsigned pend_leaders;
  int pend_n, pend_rank;
  auto prepare = [&]() {
    pend_idx = raw_idx, pend_w = raw_w;
    const bool active = first_k(raw_at) + lane < K;
    const int leader = __ffs(__match_any_sync(kFull, pend_idx)) - 1;
    pend_leaders = __ballot_sync(kFull, active && leader == lane);
    pend_n = __popc(pend_leaders);
    pend_rank = __popc(pend_leaders & ((1u << leader) - 1u));
    raw_at.next(batches), ++raw_q;
    load_raw();
  };

  // batches in flight, oldest first: each lane's entry's weight and ring
  // slot, and the slots each batch holds
  float fl_w[FLIGHT];
  int fl_slot[FLIGHT], fl_n[FLIGHT];
  int issued = 0, done = 0, head = 0, used = 0;
  auto issue = [&]() {
    int slot = head;
    for (unsigned m = pend_leaders; m; m &= m - 1) {
      const int64_t row = __shfl_sync(kFull, pend_idx, __ffs(m) - 1);
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(table) + row * row_bytes;
      unsigned char* dst = slots + static_cast<size_t>(slot) * row_bytes;
      for (int c = lane; c < chunks; c += 32)
        cp_async16(dst + c * 16, src + c * 16);
      if (++slot == ring) slot = 0;
    }
    cp_async_commit();
    int my_slot = head + pend_rank;
    if (my_slot >= ring) my_slot -= ring;
    const int f = issued - done;
#pragma unroll
    for (int i = 0; i < FLIGHT; ++i)
      if (i == f) fl_w[i] = pend_w, fl_slot[i] = my_slot, fl_n[i] = pend_n;
    head = slot, used += pend_n, ++issued;
  };

  float acc[PASSES][C::kElems];
  BagCursor at;
  if (total > 0) load_raw(), prepare();
  while (done < total) {
    while (issued < total && issued - done < FLIGHT &&
           used + pend_n <= ring) {
      issue();
      if (issued < total) prepare();
    }
    cp_async_wait_upto(issued - done - 1);  // the oldest batch landed
    if (at.b == 0) {
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
#pragma unroll
        for (int e = 0; e < C::kElems; ++e) acc[p][e] = 0.f;
    }
    // An entry that repeats the entry before it, both of weight 0 (the
    // run of pads that ends a padded row), is skipped, bit for bit as if
    // added: the sum starts at +0 and a round-to-nearest sum is -0 only
    // if both its terms are, so it is never -0 and adding +-0 leaves it
    // as it is; where the row is not finite, the first entry of the run
    // has already made the sum NaN.  Every other entry is added in k
    // order.
    const int kn = min(32, K - first_k(at));
    const float my_w = fl_w[0];
    const int my_slot = fl_slot[0];
    const float prev_w = __shfl_up_sync(kFull, my_w, 1);
    const int prev_slot = __shfl_up_sync(kFull, my_slot, 1);
    const bool repeat =
        lane > 0 && my_w == 0.f && prev_w == 0.f && my_slot == prev_slot;
    for (unsigned m = __ballot_sync(kFull, lane < kn && !repeat); m;
         m &= m - 1) {
      const int k = __ffs(m) - 1;
      const float w = __shfl_sync(kFull, my_w, k);
      const unsigned char* src =
          slots +
          static_cast<size_t>(__shfl_sync(kFull, my_slot, k)) * row_bytes;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
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
    if (at.b == batches - 1) {
      unsigned char* dst =
          reinterpret_cast<unsigned char*>(out) + out_row(at) * row_bytes;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int c = p * 32 + lane;
        if (c < chunks)
          *reinterpret_cast<int4*>(dst + c * 16) = C::pack(acc[p]);
      }
    }
    used -= fl_n[0];
#pragma unroll
    for (int i = 0; i + 1 < FLIGHT; ++i)
      fl_w[i] = fl_w[i + 1], fl_slot[i] = fl_slot[i + 1],
      fl_n[i] = fl_n[i + 1];
    ++done, at.next(batches);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

// Opt in to `smem` bytes of dynamic shared memory where that is over the
// default 48 KB, then size a grid of at most `items` blocks that fills the
// card at the occupancy the kernel reaches, or of `cap` blocks if that is
// fewer and positive (0: no cap); `per_sm` (if not null) takes the blocks an SM holds.
// Returns a cudaError_t.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, int items,
                    int cap, int* grid, int* per_sm_out = nullptr) {
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
  if (per_sm_out) *per_sm_out = per_sm;
  return 0;
}

// Launch a ring kernel with `smem` bytes of shared memory a block over a
// grid that fills the card, or of grid_blocks blocks if that is fewer.
template <typename Kernel>
int launch_ring(Kernel kernel, int threads, size_t smem, const void* table,
                const void* idx, void* out, int n_tiles, int block_rows,
                int row_bytes, int grid_blocks, cudaStream_t stream) {
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
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

template <int DEPTH>
int launch_runahead(int route, const void* table, const void* idx, void* out,
                    int n_tiles, int block_rows, int row_bytes,
                    int grid_blocks, cudaStream_t stream) {
  const size_t ring = static_cast<size_t>(DEPTH) * block_rows * row_bytes;
  if (route == kRouteBulk)  // the ring, then one barrier a stage
    return launch_ring(runahead_bulk_kernel<DEPTH>, 32,
                       ring + DEPTH * sizeof(uint64_t), table, idx, out,
                       n_tiles, block_rows, row_bytes, grid_blocks, stream);
  if (route != kRouteCpAsync) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ring(runahead_cp_async_kernel<DEPTH>, kGatherWarps * 32,
                     ring, table, idx, out, n_tiles, block_rows, row_bytes,
                     grid_blocks, stream);
}

// The bag with up to FLIGHT batches in flight a warp and rows of at most
// PASSES x 32 chunks: each warp a ring of one batch of rows (min(K, 32),
// at least 1: at most 64 KB), as many warps a block (up to kBagWarps) as
// one block's shared memory holds, and a grid that fills the card.  With
// `warps_per_sm` not null, reports the warps an SM holds and launches
// nothing.
template <typename T, int FLIGHT, int PASSES>
int launch_bag(const void* table, const void* idx, const void* w, void* out,
               int S, int K, int D, cudaStream_t stream, int* warps_per_sm) {
  auto kernel = gather_bag_kernel<T, FLIGHT, PASSES>;
  const int ring = K < 32 ? (K > 1 ? K : 1) : 32;
  const size_t warp_bytes = static_cast<size_t>(ring) * D * sizeof(T);
  const int block_warps = static_cast<int>(
      kMaxSmemBytes / warp_bytes < kBagWarps ? kMaxSmemBytes / warp_bytes
                                             : kBagWarps);
  const size_t smem = block_warps * warp_bytes;
  int grid = 0, per_sm = 0;
  const int e = persistent_grid(kernel, block_warps * 32, smem,
                                (S + block_warps - 1) / block_warps, 0, &grid,
                                &per_sm);
  if (e != 0) return e;
  if (warps_per_sm) {
    *warps_per_sm = per_sm * block_warps;
    return 0;
  }
  kernel<<<grid, block_warps * 32, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), S, K, D, ring);
  return static_cast<int>(cudaGetLastError());
}

// Passes of 32 chunks of 16 bytes a row takes: 1, 2 or 4 (a row of 65 to
// 96 chunks takes 4, the last one partly idle); rows of more than 128
// chunks (2048 bytes) are refused.
template <typename T, int FLIGHT>
int bag_passes(const void* table, const void* idx, const void* w, void* out,
               int S, int K, int D, cudaStream_t s, int* warps_per_sm) {
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  if (chunks > 4 * 32) return static_cast<int>(cudaErrorInvalidValue);
  if (chunks <= 32)
    return launch_bag<T, FLIGHT, 1>(table, idx, w, out, S, K, D, s,
                                    warps_per_sm);
  if (chunks <= 64)
    return launch_bag<T, FLIGHT, 2>(table, idx, w, out, S, K, D, s,
                                    warps_per_sm);
  return launch_bag<T, FLIGHT, 4>(table, idx, w, out, S, K, D, s,
                                  warps_per_sm);
}

// Most batches in flight a warp: `depth` output rows of ceil(K / 32)
// batches, at most kBagFlight.
template <typename T>
int bag_flight(int depth, const void* table, const void* idx, const void* w,
               void* out, int S, int K, int D, cudaStream_t s,
               int* warps_per_sm) {
  const long long batches = K > 32 ? (K + 31) / 32 : 1;
  const long long want = static_cast<long long>(depth) * batches;
  const int flight = static_cast<int>(want < kBagFlight ? want : kBagFlight);
#define BAG_CASE(F)                                                      \
  case F:                                                                \
    return bag_passes<T, F>(table, idx, w, out, S, K, D, s, warps_per_sm);
  switch (flight) {
    BAG_CASE(1) BAG_CASE(2) BAG_CASE(3) BAG_CASE(4)
    BAG_CASE(5) BAG_CASE(6) BAG_CASE(7) BAG_CASE(8)
  }
#undef BAG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename... Args>
int bag_dtype(int dtype, Args... args) {
  if (dtype == 0) return bag_flight<float>(args...);
  if (dtype == 1) return bag_flight<__nv_bfloat16>(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

static_assert(kMaxRunaheadDepth == 16,
              "the runahead depth switch instantiates 1..16");
static_assert(kMaxBagDepth == 8 && kBagFlight == 8,
              "the bag's depth and flight switches instantiate 1..8");

}  // namespace

extern "C" {

// Every function returns a cudaError_t: 0 = launched.

// route: 0 = cp_async, 1 = bulk (TMA; the ring and a barrier a stage
// must fit a block's shared memory); n_tiles = n / block_rows index
// blocks; depth in 1..16 (the wrapper refuses a ring over shared memory);
// grid_blocks > 0 caps the number of blocks (0 = fill the card at the
// kernel's occupancy).
int runahead_gather_launch(int route, const void* table, const void* idx,
                           void* out, int n_tiles, int block_rows,
                           int row_bytes, int depth, int grid_blocks,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = n_tiles, b = block_rows, r = row_bytes, g = grid_blocks;
#define RUNAHEAD_CASE(D) \
  case D:                 \
    return launch_runahead<D>(route, table, idx, out, n, b, r, g, s);
  switch (depth) {
    RUNAHEAD_CASE(1) RUNAHEAD_CASE(2) RUNAHEAD_CASE(3) RUNAHEAD_CASE(4)
    RUNAHEAD_CASE(5) RUNAHEAD_CASE(6) RUNAHEAD_CASE(7) RUNAHEAD_CASE(8)
    RUNAHEAD_CASE(9) RUNAHEAD_CASE(10) RUNAHEAD_CASE(11) RUNAHEAD_CASE(12)
    RUNAHEAD_CASE(13) RUNAHEAD_CASE(14) RUNAHEAD_CASE(15) RUNAHEAD_CASE(16)
  }
#undef RUNAHEAD_CASE
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
// are float32; depth in 1..8 output rows in flight a warp at most (at
// most 8 batches of 32 entries, while their distinct rows fit its ring).
int gather_bag_launch(int dtype, const void* table, const void* idx,
                      const void* w, void* out, int S, int K, int D,
                      int depth, void* stream) {
  if (depth < 1 || depth > kMaxBagDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  return bag_dtype(dtype, depth, table, idx, w, out, S, K, D,
                   static_cast<cudaStream_t>(stream),
                   static_cast<int*>(nullptr));
}

// The warps of the bag an SM holds at these arguments, into *warps.
int gather_bag_warps_per_sm(int dtype, int K, int D, int depth, int* warps) {
  if (depth < 1 || depth > kMaxBagDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  return bag_dtype(dtype, depth, nullptr, nullptr, nullptr, nullptr, 1, K,
                   D, static_cast<cudaStream_t>(nullptr), warps);
}

}  // extern "C"
