// LRU hit series over a grid of cache geometries, for Hopper (sm_90a): the
// §3.4 profiler that Algorithm 1 reads, h_i(L_i, S_i) for every (ways,
// line) point at once.
//
// Replaces the accelerator form of the profiler in src/repro/core/cgra/
// jaxcache.py:56-96: _single_config_scan (a lax.scan of T LRU steps) under
// vmap over C configurations (_grid_hits).  It has no Pallas twin; in eager
// PyTorch the scan is T x ~12 launches.  Same function: addresses are int32
// (the caller wraps them); line address, set and tag use floor division
// and floor modulo, as jnp's // and % do (C's / and % truncate, which
// would put a negative address in another set); a cold way holds tag -1;
// ways == 0 never hits.
//
// Bound on this card: neither bytes nor arithmetic but the longest chain
// of dependent LRU updates.  The reference's form runs T dependent steps
// per configuration; three exact properties of LRU shorten that:
//   * inclusion: at one (line, sets) pair -- a group -- an access hits
//     under w ways exactly when its stack distance in its set is below w,
//     so one stack per group serves every ways of the group;
//   * sets are independent: each (group, set) stack is a chain of its own;
//   * an access with the same tag as the previous access to its set has
//     depth 0 and changes nothing.
// The reference's cold ways are copies of tag -1 with stamp 0, evicted
// first, lowest way first: LRU order with -1 used at time 0.  So each
// stack starts as tag -1 at depth 0.
//
// Design, three kernels on one stream:
//   * split_kernel: set and tag of every access under every group, [G, T]
//     pairs, a thread an access.  The divisions (a runtime divisor: ~20
//     dependent instructions each) are so done once and in parallel, not
//     by every chain's warp for every access of the window.
//   * stack_kernel: one warp per (group, set) chain.  Lane p holds the tag
//     at depth p; the first `filled` lanes are valid (no int32 value can
//     mark an empty slot: line 1 with 1 set produces every tag).  The stack
//     is capped at the group's largest ways (<= 32).  The warp walks its
//     group's pairs 256 at a time, the next 256 loads in flight: a ballot
//     finds the accesses in this warp's set, and a shuffle from the
//     previous member finds the repeats.  For each other member in order,
//     a ballot over the stack gives its depth p (a miss is p = cap), and
//     one __shfl_up_sync with a select on lanes <= p moves it to the front.
//     Each member's depth is written as a byte of [G, T].
//   * expand_kernel: hits[c, t] = depth[group(c), t] < ways[c], 16 bytes a
//     thread, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 8;           // batches of 32 accesses an iteration
constexpr int kExpandThreads = 256;
constexpr int kExpandBytes = 16;     // hits a thread writes
constexpr int kSplitThreads = 256;

// jnp's floor division and floor modulo of int32, for b > 0.
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return r < 0 ? r + b : r;
}

// groups[g] = (line, sets, cap, end): end is one past the group's last
// chain, a running sum of sets over the groups with cap > 0.  Block
// (x, g) writes pairs[g, t] = (set, tag) for kSplitThreads accesses.
__global__ void __launch_bounds__(kSplitThreads)
    split_kernel(const int32_t* __restrict__ addrs, int T,
                 const int4* __restrict__ groups,
                 int2* __restrict__ pairs) {
  const int t = blockIdx.x * kSplitThreads + threadIdx.x;
  if (t >= T) return;
  const int4 gr = groups[blockIdx.y];
  if (gr.z == 0) return;                 // no chain reads this group
  const int32_t line_addr = floor_div(__ldg(addrs + t), gr.x);
  pairs[static_cast<size_t>(blockIdx.y) * T + t] =
      make_int2(floor_mod(line_addr, gr.y), floor_div(line_addr, gr.y));
}

__global__ void __launch_bounds__(32)
    stack_kernel(const int2* __restrict__ pairs, int T,
                 const int4* __restrict__ groups,
                 uint8_t* __restrict__ depth) {
  const int b = blockIdx.x, lane = threadIdx.x;
  int g = 0;
  int4 gr = groups[0];
  while (b >= gr.w) gr = groups[++g];    // a group with cap 0 has no
  const int cap = gr.z;                  // chain: never chosen
  const int32_t set = b - (gr.w - gr.y);
  const int2* in = pairs + static_cast<size_t>(g) * T;
  uint8_t* out = depth + static_cast<size_t>(g) * T;

  int32_t stack = -1;      // lane p: the tag at depth p, if p < filled
  int filled = 1;          // the cold set: tag -1 at depth 0
  int32_t last = -1;       // the tag at depth 0
  const int step = 32 * kUnroll;
  int2 next[kUnroll];      // (set, tag) of the next iteration's accesses
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = 32 * u + lane;
    next[u] = t < T ? __ldg(in + t) : make_int2(-1, 0);
  }
  for (int t0 = 0; t0 < T; t0 += step) {
    int32_t tag[kUnroll];
    unsigned member[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      tag[u] = next[u].y;
      member[u] = __ballot_sync(kFull, next[u].x == set);   // -1: past T
      const int tn = t0 + step + 32 * u + lane;
      next[u] = tn < T ? __ldg(in + tn) : make_int2(-1, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned m = member[u];
      if (m == 0) continue;
      const bool mine = (m >> lane) & 1u;
      const unsigned before = m & ((1u << lane) - 1u);
      // the previous access to this set: the member below, or the last
      // tag moved to the front
      const int32_t below =
          __shfl_sync(kFull, tag[u], before ? 31 - __clz(before) : lane);
      const int32_t prev = before ? below : last;
      unsigned todo = __ballot_sync(kFull, mine && tag[u] != prev);
      int d = 0;
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int32_t x = __shfl_sync(kFull, tag[u], j);
        const unsigned hit = __ballot_sync(kFull, lane < filled && stack == x);
        const int p = hit ? __ffs(hit) - 1 : cap;
        const int32_t up = __shfl_up_sync(kFull, stack, 1);
        if (lane <= p && lane < cap) stack = lane == 0 ? x : up;
        if (!hit && filled < cap) ++filled;
        if (lane == j) d = p;
      }
      last = __shfl_sync(kFull, tag[u], 31 - __clz(m));
      if (mine) out[t0 + 32 * u + lane] = static_cast<uint8_t>(d);
    }
  }
}

// configs[c] = (group, ways).  Block x covers kExpandThreads * 16 accesses
// of one configuration.
__global__ void __launch_bounds__(kExpandThreads)
    expand_kernel(const uint8_t* __restrict__ depth, int T,
                  const int2* __restrict__ configs, int tiles,
                  uint8_t* __restrict__ hits) {
  const int c = blockIdx.x / tiles;
  const size_t t = (static_cast<size_t>(blockIdx.x % tiles) * kExpandThreads +
                    threadIdx.x) * kExpandBytes;
  if (t >= static_cast<size_t>(T)) return;
  const int2 cw = configs[c];
  const uint8_t* d = depth + static_cast<size_t>(cw.x) * T;
  uint8_t* h = hits + static_cast<size_t>(c) * T;
  if ((T % kExpandBytes) == 0) {       // rows start on 16-byte boundaries
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (cw.y > 0) {
      const uint4 dv = *reinterpret_cast<const uint4*>(d + t);
      const unsigned w4 = static_cast<unsigned>(cw.y) * 0x01010101u;
      v = make_uint4(__vcmpltu4(dv.x, w4) & 0x01010101u,
                     __vcmpltu4(dv.y, w4) & 0x01010101u,
                     __vcmpltu4(dv.z, w4) & 0x01010101u,
                     __vcmpltu4(dv.w, w4) & 0x01010101u);
    }
    *reinterpret_cast<uint4*>(h + t) = v;
  } else {
    const size_t left = static_cast<size_t>(T) - t;
    const int n = left < kExpandBytes ? static_cast<int>(left) : kExpandBytes;
    for (int i = 0; i < n; ++i)
      h[t + i] = cw.y > 0 && d[t + i] < cw.y;
  }
}

}  // namespace

extern "C" {

// addrs [T] int32; groups [G, 4] int32 (line, sets >= 1; cap in 0..32;
// end); configs [C, 2] int32 (group, ways with ways <= its group's cap);
// pairs [G, T] int2 and depth [G, T] bytes of scratch; hits [C, T] bytes
// of 0 or 1.  Launches the split and stack passes (n_chains warps; none
// when n_chains is 0) and the expand pass.  Returns a cudaError_t: 0 =
// launched.
int cache_grid_launch(const void* addrs, int T, const void* groups, int G,
                      int n_chains, const void* configs, int C, void* pairs,
                      void* depth, void* hits, void* stream) {
  if (T < 0 || G < 1 || G > 65535 || C < 1 || n_chains < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chains > 0) {
    split_kernel<<<dim3((T + kSplitThreads - 1) / kSplitThreads, G),
                   kSplitThreads, 0, s>>>(
        static_cast<const int32_t*>(addrs), T,
        static_cast<const int4*>(groups), static_cast<int2*>(pairs));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    stack_kernel<<<n_chains, 32, 0, s>>>(
        static_cast<const int2*>(pairs), T,
        static_cast<const int4*>(groups), static_cast<uint8_t*>(depth));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int per_block = kExpandThreads * kExpandBytes;
  const int tiles = (T + per_block - 1) / per_block;
  expand_kernel<<<static_cast<unsigned>(C) * tiles, kExpandThreads, 0, s>>>(
      static_cast<const uint8_t*>(depth), T,
      static_cast<const int2*>(configs), tiles, static_cast<uint8_t*>(hits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
