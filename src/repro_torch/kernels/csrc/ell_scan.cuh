// Shared pieces of the ELL-table kernels (lane_probe.cu, spmm_ell.cu).
//
// Both kernels give one block to one output row v and one thread to each of
// up to kThreads lane columns, so a gathered frontier row is one coalesced
// read.  The row's neighbour slots nbrs[v, 0..K) are scanned kTile at a time:
// every thread loads kSlotsPerThread slots (coalesced, all loads issued before
// any is used), one barrier tells the block whether the tile holds any live id
// (< n_live), and a tile of sentinels costs nothing more.  Live ids are
// compacted in slot order into shared memory and every thread visits them in
// that order, so each column sums its live slots sequentially, in slot order,
// in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ell {

constexpr int kThreads = 256;        // threads per block = lane columns per block
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerThread = 4;   // neighbour slots each thread loads per tile
constexpr int kTile = kThreads * kSlotsPerThread;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

struct ScanShared {
  int ids[kThreads];
  int warp_count[kWarps];
};

// Calls visit(id) for every live id (< n_live) of row[0, K), in slot order, on
// every thread of the block.  All threads of the block must call it together.
template <typename Visit>
__device__ __forceinline__ void for_each_live(const int* __restrict__ row, int K,
                                              int n_live, ScanShared& sh,
                                              Visit&& visit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    int idx[kSlotsPerThread];
    bool any = false;
#pragma unroll
    for (int s = 0; s < kSlotsPerThread; ++s) {
      const int k = k0 + s * kThreads + threadIdx.x;
      idx[s] = k < K ? __ldg(row + k) : n_live;
      any |= idx[s] < n_live;
    }
    if (!__syncthreads_or(any)) continue;  // uniform: every thread gets the same answer
#pragma unroll
    for (int s = 0; s < kSlotsPerThread; ++s) {
      const bool live = idx[s] < n_live;
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (lane == 0) sh.warp_count[warp] = __popc(ballot);
      __syncthreads();
      int base = 0, count = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const int c = sh.warp_count[i];
        base += i < warp ? c : 0;
        count += c;
      }
      if (live) sh.ids[base + __popc(ballot & ((1u << lane) - 1u))] = idx[s];
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < count; ++j) visit(sh.ids[j]);
      __syncthreads();  // ids and warp_count are rewritten by the next sub-tile
    }
  }
}

}  // namespace ell
