// LRU hit series over a grid of cache geometries, for Hopper (sm_90a): the
// §3.4 profiler that Algorithm 1 reads, h_i(L_i, S_i) for every (ways,
// line) point at once.
//
// Replaces the accelerator form of the profiler in src/repro/core/cgra/
// jaxcache.py:56-96: _single_config_scan (a lax.scan of T LRU steps) under
// vmap over C configurations (_grid_hits).  It has no Pallas twin; in eager
// PyTorch the scan is T x ~12 launches, so it becomes one kernel.  Same
// function, step by step: addresses are int32 (the caller wraps them);
// line address, set and tag use floor division and floor modulo, as jnp's
// // and % do (C's / and % truncate, which would put a negative address in
// another set); tags start at -1 and last-use stamps at 0, with the step
// counter starting at 1; a hit takes the first matching way among the
// first n_ways; a miss replaces the way with the smallest stamp among them,
// ties to the lowest way; ways == 0 never hits and never updates.
//
// Bound on this card: neither bytes nor arithmetic.  A configuration's T
// steps form one dependent chain (each step reads the set the previous
// one may have written), so the floor is T times the latency of a step,
// not the T * 4 bytes it reads or the C * T bytes it writes.  Design:
//   * one warp per configuration, one block per warp, lanes as ways
//     (max_ways <= 32): tags and stamps of [max_sets, max_ways] live in
//     shared memory, and lane w only ever reads or writes column w, so the
//     steps need no barrier;
//   * per step, the match is one __ballot_sync and __ffs; the LRU victim a
//     five-round warp argmin of (stamp << 5 | way), only on a miss;
//   * the divisions are off the chain: lane j computes set and tag of
//     access t0 + j for 32 accesses at once, and each step takes them by
//     __shfl_sync;
//   * hits are collected as 32 bits of a register and written as 32 bytes
//     at once; the C chains run in parallel on the card's SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// jnp's floor division and floor modulo of int32, for b > 0.
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return r < 0 ? r + b : r;
}

__global__ void __launch_bounds__(32)
    cache_grid_kernel(const int32_t* __restrict__ addrs, int T,
                      const int32_t* __restrict__ lines,
                      const int32_t* __restrict__ sets,
                      const int32_t* __restrict__ ways, int max_sets,
                      int max_ways, uint8_t* __restrict__ hits) {
  extern __shared__ int32_t smem[];
  int32_t* tags = smem;                           // [max_sets][max_ways]
  int32_t* stamps = smem + max_sets * max_ways;   // [max_sets][max_ways]
  const int c = blockIdx.x, lane = threadIdx.x;
  const int32_t line = lines[c], n_sets = sets[c], n_ways = ways[c];
  uint8_t* out = hits + static_cast<size_t>(c) * T;

  for (int i = lane; i < max_sets * max_ways; i += 32) {
    tags[i] = -1;
    stamps[i] = 0;
  }
  __syncwarp();

  const bool own = lane < n_ways;  // this lane is a way of the cache
  int32_t t = 1;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int n_here = min(32, T - t0);
    int32_t my_set = 0, my_tag = 0;
    if (lane < n_here) {
      const int32_t line_addr = floor_div(addrs[t0 + lane], line);
      my_set = floor_mod(line_addr, n_sets);
      my_tag = floor_div(line_addr, n_sets);
    }
    unsigned hit_bits = 0;
    if (n_ways > 0) {
      for (int j = 0; j < n_here; ++j, ++t) {
        const int32_t s = __shfl_sync(kFull, my_set, j);
        const int32_t tag = __shfl_sync(kFull, my_tag, j);
        int32_t* my_slot_tag = tags + s * max_ways + lane;
        int32_t* my_slot_stamp = stamps + s * max_ways + lane;
        const unsigned match = __ballot_sync(kFull, own && *my_slot_tag == tag);
        int way;
        if (match) {
          way = __ffs(match) - 1;
          hit_bits |= 1u << j;
        } else {
          unsigned long long key =
              own ? (static_cast<unsigned long long>(
                         static_cast<uint32_t>(*my_slot_stamp))
                     << 5) |
                        lane
                  : ~0ull;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long other = __shfl_xor_sync(kFull, key, o);
            key = other < key ? other : key;
          }
          way = static_cast<int>(key & 31);
        }
        if (lane == way) {
          *my_slot_tag = tag;
          *my_slot_stamp = t;
        }
      }
    }
    if (lane < n_here) out[t0 + lane] = (hit_bits >> lane) & 1u;
  }
}

}  // namespace

extern "C" {

// addrs [T] int32; lines, sets, ways [C] int32 (lines, sets >= 1;
// 0 <= ways <= max_ways <= 32); hits [C, T] bytes of 0 or 1.  Returns a
// cudaError_t: 0 = launched.
int cache_grid_launch(const void* addrs, int T, const void* lines,
                      const void* sets, const void* ways, int C, int max_sets,
                      int max_ways, void* hits, void* stream) {
  if (max_ways < 1 || max_ways > 32 || max_sets < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(int32_t) * static_cast<size_t>(max_sets) *
                      max_ways;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cache_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cache_grid_kernel<<<C, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(addrs), T,
      static_cast<const int32_t*>(lines), static_cast<const int32_t*>(sets),
      static_cast<const int32_t*>(ways), max_sets, max_ways,
      static_cast<uint8_t*>(hits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
