// MoE token dispatch and combine for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/moe_dispatch/
// moe_dispatch.py:
//   * dispatch_kernel <- _dispatch_kernel (:23), pallas_call at :45
//     (dispatch): out[slot[t]] = x[t]; a dropped token (slot -1) goes
//     nowhere.  The TPU kernel copies a dropped token into a trash row
//     that its wrapper slices off, and leaves unfilled rows unwritten;
//     here dropped tokens are skipped and the rows no choice fills are
//     zeroed, as the plain version gives them, because the expert matrix
//     products read every row.  slot may be [T] or [T, K] (every kept
//     choice of token t receives x[t]), so the MoE layer scatters its
//     T x K choices without repeating x K times.
//   * combine_kernel  <- _combine_kernel (:53), pallas_call at :106
//     (combine): y[t] = sum_k w[t,k] * [slot[t,k] >= 0] * ye[slot[t,k]],
//     products and sums in f32 in k order (each product rounded, then
//     added: the plain version's order, so the two agree bit for bit),
//     rounded once to ye's type.  The TPU kernel keeps `depth` tokens'
//     rows in flight; here a block takes a part of one token's row, and
//     the parts of all tokens fill the card (below).
//
// Bound on this card: bytes, both.  Dispatch does no arithmetic; combine
// does 2 flops per fetched element, far below the ~20 flops per byte
// where f32 arithmetic would bound it.  What matters is that every row
// read is independent and wide:
//   * dispatch is one launch.  Block b gives token b (b < tokens) its
//     scatter: it reads the token's K slots (broadcast loads), skips the
//     row if every choice was dropped, and reads the row once with 16-byte
//     vector loads, storing each chunk to every kept slot.  The same block
//     zeroes the rows of its own slot range [b R, b R + R) that no kept
//     choice fills: it scans the T x K slots once into a flag per row in
//     shared memory.  So every output byte is written once and every kept
//     token read once: the bytes the function needs, and no more (a memset
//     of the whole output first would write the kept rows twice), with no
//     order needed between blocks.  R is the fewest rows whose bytes are
//     16 times the scan's T x K x 4 (one row a block at decode), so the
//     scans' extra reads stay under 1/16 of the output; the scan loads 16
//     bytes at a time.  When the blocks are too few to fill the card
//     (264, two an SM), each row's columns are split over as many blocks
//     as make up the difference (5 at dbrx's decode, 64 blocks; the
//     split is split_rows, which combine shares).  One
//     launch, because at dbrx's decode shape (~0.9 MB) each graph node
//     (a memset of flags, a scatter, a zeroing pass) costs more than the
//     bytes: three took longer than index_copy_.
//   * combine splits each token's row of 16-byte chunks over as many
//     blocks (parts) as fill the card, with at least kMinPartChunks chunks
//     a part: at dbrx's decode shape (8 tokens of 768 chunks) 24 parts of
//     32 chunks, 192 blocks of one warp, a chunk a thread.  Each thread
//     reads its token's K slots and weights straight into registers
//     (broadcast loads, no shared memory and no barrier), then issues the
//     loads of its chunk of every kept row before it adds any of them: two
//     dependent trips to memory in all, slots then rows.  With many tokens
//     (4 x 1,024) a block takes a whole row, 256 threads.  A dropped slot
//     is never fetched: the TPU kernel fetches row 0 and multiplies it by
//     0, which costs a read and turns an inf in row 0 into NaN.
// Rows must be a multiple of 16 bytes and 16-byte aligned; kept slots must
// be distinct and lie in [0, n_slots) (the contract; not checked here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDispatchThreads = 128;  // most threads a token's block
constexpr int kCombineThreads = 256;
constexpr int kMaxFanin = 8;        // K the kernels take
constexpr int kMaxRange = 4096;     // rows a dispatch block zeroes at most
constexpr int kFillBlocks = 264;    // blocks that fill an H100: 2 a
                                    // streaming multiprocessor
constexpr int kMinPartChunks = 32;  // 16-byte chunks a part takes at least

// How a launch of `blocks` rows of `chunks` 16-byte chunks splits each
// row's columns when the rows are too few to fill the card: `parts` blocks
// a row, `part_chunks` chunks each, `threads` a block (a warp per 32
// chunks, at most max_threads).
struct Split {
  int parts, part_chunks, threads;
};

Split split_rows(int blocks, int chunks, int max_threads) {
  const int max_parts =
      chunks / kMinPartChunks > 1 ? chunks / kMinPartChunks : 1;
  int parts = (kFillBlocks + blocks - 1) / blocks;
  parts = parts < 1 ? 1 : parts > max_parts ? max_parts : parts;
  const int part_chunks = (chunks + parts - 1) / parts;
  const int warps = (part_chunks + 31) / 32;   // a short row, fewer threads
  const int threads = warps * 32 < max_threads ? warps * 32 : max_threads;
  return {(chunks + part_chunks - 1) / part_chunks, part_chunks, threads};
}

__device__ __forceinline__ void mark(unsigned char* filled, int slot,
                                     long long base, int n_rows) {
  const long long r = slot - base;       // a drop (-1) is < 0
  if (r >= 0 && r < n_rows) filled[r] = 1;
}

__global__ void __launch_bounds__(kDispatchThreads)
dispatch_kernel(const uint4* __restrict__ x, const int* __restrict__ slot,
                uint4* __restrict__ out, int tokens, int fanin, int chunks,
                int n_slots, int rows_per_block, int part_chunks) {
  extern __shared__ unsigned char s_filled[];   // a flag per row of range
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * part_chunks;      // this block's columns
  const int c1 = min(chunks, c0 + part_chunks);
  // the zeroing of this block's slot range (uniform per block)
  const long long base = static_cast<long long>(b) * rows_per_block;
  const int n_rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block),
          max(0ll, static_cast<long long>(n_slots) - base)));
  if (n_rows > 0) {
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x) s_filled[r] = 0;
    __syncthreads();
    const int entries = tokens * fanin;   // scanned 16 bytes a load
    const int n4 =
        (reinterpret_cast<uintptr_t>(slot) & 15) == 0 ? entries / 4 : 0;
    const int4* slot4 = reinterpret_cast<const int4*>(slot);
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const int4 v = __ldg(slot4 + i);
      mark(s_filled, v.x, base, n_rows);
      mark(s_filled, v.y, base, n_rows);
      mark(s_filled, v.z, base, n_rows);
      mark(s_filled, v.w, base, n_rows);
    }
    for (int e = 4 * n4 + threadIdx.x; e < entries; e += blockDim.x)
      mark(s_filled, __ldg(slot + e), base, n_rows);
    __syncthreads();
    for (int r = 0; r < n_rows; ++r) {
      if (s_filled[r]) continue;
      uint4* row = out + (base + r) * chunks;
      for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x)
        row[c] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (b >= tokens) return;
  // the scatter of token b
  int dest[kMaxFanin];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kMaxFanin; ++k) {
    dest[k] = k < fanin ? __ldg(slot + static_cast<size_t>(b) * fanin + k)
                        : -1;
    any = any || dest[k] >= 0;
  }
  if (!any) return;                        // every choice dropped
  const uint4* src = x + static_cast<size_t>(b) * chunks;
  for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    const uint4 v = __ldg(src + c);        // the token's row, read once
#pragma unroll
    for (int k = 0; k < kMaxFanin; ++k)
      if (dest[k] >= 0) out[static_cast<size_t>(dest[k]) * chunks + c] = v;
  }
}

template <typename T>
struct Chunk;  // a 16-byte chunk as f32 values, and back

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      const unsigned hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const uint4* __restrict__ ye, const int* __restrict__ slot,
               const float* __restrict__ w, uint4* __restrict__ y, int fanin,
               int chunks, int part_chunks) {
  const size_t t = blockIdx.x;
  const int c0 = blockIdx.y * part_chunks;      // this block's columns
  const int c1 = min(chunks, c0 + part_chunks);
  int src[kMaxFanin];                           // the token's slots and
  float wk[kMaxFanin];                          // weights, broadcast loads
#pragma unroll
  for (int k = 0; k < kMaxFanin; ++k) {
    src[k] = k < fanin ? __ldg(slot + t * fanin + k) : -1;
    wk[k] = k < fanin ? __ldg(w + t * fanin + k) : 0.f;
  }
  constexpr int kE = Chunk<T>::kElems;
  for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    uint4 rows[kMaxFanin];
#pragma unroll
    for (int k = 0; k < kMaxFanin; ++k) {  // every kept row in flight first
      if (src[k] >= 0)
        rows[k] = __ldg(ye + static_cast<size_t>(src[k]) * chunks + c);
    }
    float acc[kE], f[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxFanin; ++k) {
      if (src[k] >= 0) {
        Chunk<T>::unpack(rows[k], f);
#pragma unroll
        for (int e = 0; e < kE; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wk[k], f[e]));
      }
    }
    y[t * chunks + c] = Chunk<T>::pack(acc);
  }
}

}  // namespace

extern "C" {

// Every function returns a cudaError_t: 0 = launched.

// x [tokens, row_bytes / elt]; slot [tokens, fanin] int32 with fanin in
// 1..8; out [n_slots, row] receives the kept rows, and zeros in the rows no
// choice fills.  One launch.
int moe_dispatch_launch(const void* x, const void* slot, void* out,
                        int tokens, int fanin, int row_bytes, int n_slots,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fanin < 1 || fanin > kMaxFanin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return 0;
  const int chunks = row_bytes / 16;
  // rows a block zeroes: their bytes 16x the scan's, at most kMaxRange
  const long long scan = 16ll * tokens * fanin * 4;
  const int range = static_cast<int>(
      scan <= row_bytes ? 1
                        : min(static_cast<long long>(kMaxRange),
                              (scan + row_bytes - 1) / row_bytes));
  const int zero_blocks = (n_slots + range - 1) / range;
  const int blocks = tokens > zero_blocks ? tokens : zero_blocks;
  // too few blocks to fill the card (decode): split the rows' columns
  const Split sp = split_rows(blocks, chunks, kDispatchThreads);
  dispatch_kernel<<<dim3(blocks, sp.parts), sp.threads, range, s>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(slot),
      static_cast<uint4*>(out), tokens, fanin, chunks, n_slots, range,
      sp.part_chunks);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 = float32, 1 = bfloat16; ye [n_slots, row]; slot int32 and
// w float32 [tokens, fanin] with fanin in 1..8; y [tokens, row].
int moe_combine_launch(int dtype, const void* ye, const void* slot,
                       const void* w, void* y, int tokens, int fanin,
                       int row_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fanin < 1 || fanin > kMaxFanin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tokens == 0) return 0;
  const auto* a = static_cast<const uint4*>(ye);
  const auto* sl = static_cast<const int*>(slot);
  const auto* ww = static_cast<const float*>(w);
  auto* o = static_cast<uint4*>(y);
  const int chunks = row_bytes / 16;
  const Split sp = split_rows(tokens, chunks, kCombineThreads);
  const dim3 grid(tokens, sp.parts);
  if (dtype == 0)
    combine_kernel<float><<<grid, sp.threads, 0, s>>>(a, sl, ww, o, fanin,
                                                      chunks, sp.part_chunks);
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<grid, sp.threads, 0, s>>>(
        a, sl, ww, o, fanin, chunks, sp.part_chunks);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The parts a combine launch splits each token's row into (its grid's
// second dimension), for tokens > 0.
int moe_combine_parts(int tokens, int row_bytes) {
  return split_rows(tokens, row_bytes / 16, kCombineThreads).parts;
}

}  // extern "C"
