// ELL SpMM over the row extent:
//
//   out[v,b] = w[v] * sum_{k < row_len[v]} scores[min(nbrs[v,k], n), b]
//
// for R rows v over an [n + 1, B] score buffer whose row n (the sentinel
// dump row) is zero.  On the probe path R = n; a row slice of the table has
// R < n.  That is the Pallas kernel's function whenever live slots come
// first in each row (every table the port builds or accepts).
//
// Replaces the Pallas kernel src/repro/kernels/spmm_ell/spmm_ell.py
// (_kernel, launched by spmm_ell_pallas).
//
// Bound on the H100: bytes of the live slots: their ids, the score rows they
// gather (the buffer mostly stays in the 50 MB L2) and the [R, B] output.
// The executor (ell_chunks.cuh) reads each row only up to row_len, splits a
// hub row across blocks and packs short rows; at B = 64 fp32 a slot group is
// 16 threads of float4 columns, so the block's 16 groups all work.  A
// sentinel slot (>= n) would gather the zero dump row, so it is skipped
// without touching scores.  fp32 accumulation for fp32, fp16 and bf16
// storage.
#include "ell_chunks.cuh"

using namespace ell;

template <typename T, int VEC>
struct SpmmOp {
  const T* scores;
  T* out;
  const float* weights;
  int B, n, c0;

  __device__ bool live(int x) const { return x < n; }

  __device__ void load(int x, float (&v)[VEC]) const {
    load_vec<T, VEC>(scores + (long long)max(x, 0) * B + c0, v);
  }

  __device__ void add(int, const float (&v)[VEC], float (&acc)[VEC]) const {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += v[e];
  }

  struct Row {
    float w;
  };

  __device__ void begin_row(int v, Row& r) const { r.w = __ldg(weights + v); }

  __device__ void end_row(int v, const Row& r, const float (&acc)[VEC]) const {
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = acc[e] * r.w;
    store_vec<T, VEC>(out + (long long)v * B + c0, o);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) spmm_ell_kernel(
    const int* __restrict__ nbrs, const T* __restrict__ scores,
    const float* __restrict__ weights, T* __restrict__ out, int K, int n, int B,
    int tc, Plan P) {
  const Layout L = make_layout<VEC>(tc, B);
  const SpmmOp<T, VEC> op{scores, out, weights, B, n, L.c0};
  run_chunk<VEC>(P, op, nbrs, K, B, L);
}

template <typename T, int VEC>
static int launch_vec(const int* nbrs, const T* scores, const float* weights,
                      T* out, int K, int n, int B, int tc, const Plan& P,
                      int n_chunks, int tiles, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, VEC);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spmm_ell_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spmm_ell_kernel<T, VEC><<<dim3(n_chunks, tiles), kThreads, smem, stream>>>(
      nbrs, scores, weights, out, K, n, B, tc, P);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* nbrs, const void* scores, const void* weights,
                  void* out, int K, int n, int B, const Plan& P, int n_chunks,
                  int vec, int tc, int tiles, void* stream) {
  if (n_chunks == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* nb = (const int*)nbrs;
  const T* sc = (const T*)scores;
  const float* w = (const float*)weights;
  T* o = (T*)out;
  switch (vec) {
    case 1: return launch_vec<T, 1>(nb, sc, w, o, K, n, B, tc, P, n_chunks, tiles, s);
    case 2: return launch_vec<T, 2>(nb, sc, w, o, K, n, B, tc, P, n_chunks, tiles, s);
    case 4: return launch_vec<T, 4>(nb, sc, w, o, K, n, B, tc, P, n_chunks, tiles, s);
    case 8:
      if constexpr (sizeof(T) <= 2)
        return launch_vec<T, 8>(nb, sc, w, o, K, n, B, tc, P, n_chunks, tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}

#define SPMM_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* nbrs, const void* scores,                    \
                      const void* weights, void* out, const void* chunks,      \
                      const void* short_rows, const void* short_ptr,           \
                      const void* long_rows, const void* long_first,           \
                      void* counters, void* partial, int n_chunks,             \
                      int max_slots, int max_rows, int K, int n, int B,        \
                      int vec, int tc, int tiles, void* stream) {              \
    const Plan P{(const int4*)chunks, (const int*)short_rows,                  \
                 (const int*)short_ptr, (const int*)long_rows,                 \
                 (const int*)long_first, (int*)counters, (float*)partial,      \
                 max_slots, max_rows};                                         \
    return launch<T>(nbrs, scores, weights, out, K, n, B, P, n_chunks, vec,    \
                     tc, tiles, stream);                                       \
  }

SPMM_ENTRY(spmm_ell_f32, float)
SPMM_ENTRY(spmm_ell_f16, __half)
SPMM_ENTRY(spmm_ell_bf16, __nv_bfloat16)
