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
//
// spmm_csr, the same sum over the rows of an in-CSR block (the production
// serve step's push, core/distributed.py::coo_push):
//
//   out[v,b] = w[v] * sum_{k < row_len[v]} scores[indices[row_ptr[v] - base + k], b]
//
// for the R rows of one row block, gathering from the [n, B] all-gathered
// frontier.  Replaces no Pallas kernel: the JAX package's push is a segment
// sum over COO edges, which the port ran as a gather and an index_add_ (one
// float atomic per edge and column).  Here each row has one writer and the
// weight is applied in the row's epilogue: no atomics, no gathered
// temporary, no zeroed accumulator.  Bound on the H100: the gathered source
// rows, each live edge's source row read from HBM once (m x B x 4 bytes:
// 376 GB, 112 ms a level at the Twitter/32 step's 45.9 M edges and B =
// 2,048).  Column tiles are launch_layout's full rows (1,024 fp32 columns,
// 4 KB contiguous a gather).  Narrow tiles whose [n, tile] frontier slice
// would stay in the 50 MB L2 (8 fp32 columns: 41.7 MB at n = 1.3 M) were
// measured slower at every width (tools/spmm_csr_sweep.py): 32-byte
// gathers and ids re-read once a tile cost more than reading 4 KB rows
// from HBM, so the tile does not depend on the frontier's size.
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

// Rows is EllRows for spmm_ell (row v's ids at nbrs + v * K) and CsrRows
// for spmm_csr (at indices + row_ptr[v] - base; K is not read).
template <typename T, int VEC, class Rows>
__global__ void __launch_bounds__(kThreads, kMinBlocks) spmm_ell_kernel(
    const int* __restrict__ nbrs, const T* __restrict__ scores,
    const float* __restrict__ weights, T* __restrict__ out, int K, int n, int B,
    int tc, Plan P, Rows R) {
  const Layout L = make_layout<VEC>(tc, B);
  const SpmmOp<T, VEC> op{scores, out, weights, B, n, L.c0};
  run_chunk<VEC>(P, op, nbrs, K, B, L, R);
}

template <typename T, int VEC, class Rows>
static int launch_vec(const int* nbrs, const T* scores, const float* weights,
                      T* out, int K, int n, int B, int tc, const Plan& P,
                      int n_chunks, int tiles, cudaStream_t stream, Rows R) {
  const size_t smem = smem_bytes(P, VEC);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spmm_ell_kernel<T, VEC, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spmm_ell_kernel<T, VEC, Rows><<<dim3(n_chunks, tiles), kThreads, smem, stream>>>(
      nbrs, scores, weights, out, K, n, B, tc, P, R);
  return (int)cudaGetLastError();
}

template <typename T, class Rows = EllRows>
static int launch(const void* nbrs, const void* scores, const void* weights,
                  void* out, int K, int n, int B, const Plan& P, int n_chunks,
                  int vec, int tc, int tiles, void* stream, Rows R = Rows()) {
  if (n_chunks == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* nb = (const int*)nbrs;
  const T* sc = (const T*)scores;
  const float* w = (const float*)weights;
  T* o = (T*)out;
  switch (vec) {
    case 1: return launch_vec<T, 1>(nb, sc, w, o, K, n, B, tc, P, n_chunks, tiles, s, R);
    case 2: return launch_vec<T, 2>(nb, sc, w, o, K, n, B, tc, P, n_chunks, tiles, s, R);
    case 4: return launch_vec<T, 4>(nb, sc, w, o, K, n, B, tc, P, n_chunks, tiles, s, R);
    case 8:
      if constexpr (sizeof(T) <= 2)
        return launch_vec<T, 8>(nb, sc, w, o, K, n, B, tc, P, n_chunks, tiles, s, R);
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

extern "C" int spmm_csr_f32(const void* indices, const void* row_ptr,
                            const void* scores, const void* weights, void* out,
                            const void* chunks, const void* short_rows,
                            const void* short_ptr, const void* long_rows,
                            const void* long_first, void* counters, void* partial,
                            int n_chunks, int max_slots, int max_rows, int base,
                            int n, int B, int vec, int tc, int tiles,
                            void* stream) {
  const Plan P{(const int4*)chunks, (const int*)short_rows,
               (const int*)short_ptr, (const int*)long_rows,
               (const int*)long_first, (int*)counters, (float*)partial,
               max_slots, max_rows};
  return launch<float>(indices, scores, weights, out, 0, n, B, P, n_chunks, vec,
                       tc, tiles, stream, CsrRows{(const int*)row_ptr, base});
}
