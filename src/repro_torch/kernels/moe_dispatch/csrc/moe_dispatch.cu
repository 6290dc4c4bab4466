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
//     rows in flight; here a block takes one token, which timed faster on
//     the H100 than 2, 3 or 4 at every shape the MoE path gives it.
//
// Bound on this card: bytes, both.  Dispatch does no arithmetic; combine
// does 2 flops per fetched element, far below the ~20 flops per byte
// where f32 arithmetic would bound it.  What matters is that every row
// read is independent and wide:
//   * dispatch gives each token to one block, which reads the token's K
//     slots (broadcast loads), returns at once if every choice was
//     dropped, and reads the row once with 16-byte vector loads, storing
//     each chunk to every kept slot and marking those slots filled.  A
//     second kernel then zeroes the rows left unmarked, so every output
//     byte is written once and every kept token read once: the bytes the
//     function needs, and no more (a memset of the whole output first
//     would write the kept rows twice);
//   * combine gives each token to one block.  The block reads the token's
//     K slots and weights in one coalesced load into shared memory, then
//     each thread issues the loads of its 16-byte chunk of every kept row
//     before it adds any of them, so K row reads are in flight a thread,
//     and the many blocks an SM holds keep more in flight.  A dropped
//     slot is never fetched: the TPU kernel fetches row 0 and multiplies
//     it by 0, which costs a read and turns an inf in row 0 into NaN.
// Rows must be a multiple of 16 bytes and 16-byte aligned; kept slots must
// be distinct and lie in [0, n_slots) (the contract; not checked here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDispatchThreads = 128;  // most threads a token's block
constexpr int kCombineThreads = 256;
constexpr int kMaxFanin = 8;        // K the kernels take

__global__ void __launch_bounds__(kDispatchThreads)
dispatch_kernel(const uint4* __restrict__ x, const int* __restrict__ slot,
                uint4* __restrict__ out, unsigned char* __restrict__ filled,
                int fanin, int chunks) {
  const int t = blockIdx.x;
  int dest[kMaxFanin];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kMaxFanin; ++k) {
    dest[k] = k < fanin ? __ldg(slot + static_cast<size_t>(t) * fanin + k)
                        : -1;
    any = any || dest[k] >= 0;
  }
  if (!any) return;                        // every choice dropped
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMaxFanin; ++k)
      if (dest[k] >= 0) filled[dest[k]] = 1;
  }
  const uint4* src = x + static_cast<size_t>(t) * chunks;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const uint4 v = __ldg(src + c);        // the token's row, read once
#pragma unroll
    for (int k = 0; k < kMaxFanin; ++k)
      if (dest[k] >= 0) out[static_cast<size_t>(dest[k]) * chunks + c] = v;
  }
}

__global__ void __launch_bounds__(kDispatchThreads)
zero_unfilled_kernel(uint4* __restrict__ out,
                     const unsigned char* __restrict__ filled, int chunks) {
  const int r = blockIdx.x;
  if (filled[r]) return;
  uint4* row = out + static_cast<size_t>(r) * chunks;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    row[c] = make_uint4(0u, 0u, 0u, 0u);
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
               int chunks) {
  __shared__ int s_slot[kMaxFanin];
  __shared__ float s_w[kMaxFanin];
  const size_t t = blockIdx.x;
  if (threadIdx.x < fanin) {               // one coalesced load of the
    s_slot[threadIdx.x] = slot[t * fanin + threadIdx.x];    // token's slots
    s_w[threadIdx.x] = w[t * fanin + threadIdx.x];          // and weights
  }
  __syncthreads();
  constexpr int kE = Chunk<T>::kElems;
  for (int c = threadIdx.x; c < chunks; c += kCombineThreads) {
    uint4 rows[kMaxFanin];
#pragma unroll
    for (int k = 0; k < kMaxFanin; ++k) {  // every kept row in flight first
      if (k < fanin && s_slot[k] >= 0)
        rows[k] = __ldg(ye + static_cast<size_t>(s_slot[k]) * chunks + c);
    }
    float acc[kE], f[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxFanin; ++k) {
      if (k < fanin && s_slot[k] >= 0) {
        Chunk<T>::unpack(rows[k], f);
#pragma unroll
        for (int e = 0; e < kE; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(s_w[k], f[e]));
      }
    }
    y[t * chunks + c] = Chunk<T>::pack(acc);
  }
}

}  // namespace

extern "C" {

// Every function returns a cudaError_t: 0 = launched.

// x [tokens, row_bytes / elt]; slot [tokens, fanin] int32 with fanin in
// 1..8; filled [n_slots] bytes of scratch; out [n_slots, row] receives the
// kept rows, and zeros in the rows no choice fills.
int moe_dispatch_launch(const void* x, const void* slot, void* out,
                        void* filled, int tokens, int fanin, int row_bytes,
                        int n_slots, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fanin < 1 || fanin > kMaxFanin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return 0;
  cudaError_t err = cudaMemsetAsync(filled, 0, n_slots, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = row_bytes / 16;
  const int warps = (chunks + 31) / 32;    // a short row takes fewer threads
  const int threads =
      warps * 32 < kDispatchThreads ? warps * 32 : kDispatchThreads;
  if (tokens > 0) {
    dispatch_kernel<<<tokens, threads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const int*>(slot),
        static_cast<uint4*>(out), static_cast<unsigned char*>(filled), fanin,
        chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  zero_unfilled_kernel<<<n_slots, threads, 0, s>>>(
      static_cast<uint4*>(out), static_cast<const unsigned char*>(filled),
      chunks);
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
  if (dtype == 0)
    combine_kernel<float><<<tokens, kCombineThreads, 0, s>>>(a, sl, ww, o,
                                                             fanin, chunks);
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<tokens, kCombineThreads, 0, s>>>(
        a, sl, ww, o, fanin, chunks);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
