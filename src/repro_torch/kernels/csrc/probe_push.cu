// Fused PROBE push level over the row extent: for each row v and column b,
//   out[v, b] = w[v] * sum_{k < row_len[v]} prune(scores[clip(nbrs[v, k], 0, n), b])
// with prune(s) = s > thresh ? s : 0 when thresh > 0 (no abs), a sentinel
// id (>= n) reading zero, and then out[exclude[b], b] = 0 for every column
// whose exclude[b] < n (a negative exclude clips to row 0, as in the
// reference).  Sums are fp32; the output is in the scores' dtype.  That is
// the Pallas kernel's function whenever live slots come first in each row
// (every table the port builds or accepts; graph/structs.py).
//
// Replaces the Pallas kernel src/repro/kernels/probe_push/probe_push.py
// (_kernel, launched by probe_push_pallas).
//
// Bound on the H100: bytes of the live slots, as for spmm_ell.cu: their
// ids, the score rows they gather (the [n, B] buffer mostly stays in the
// 50 MB L2), row_len and the weights, the [n, B] output and the B exclusion
// ids.  The executor (ell_chunks.cuh) reads each row only up to row_len,
// splits a hub row across blocks and packs short rows.  A sentinel slot is
// skipped without touching scores, so the kernel reads the unpadded [n, B]
// scores and needs no zero dump row.  The threshold costs one compare per
// gathered value in registers; each thread loads its columns' exclusion ids
// once, and the exclusion is one compare per stored value, applied by the
// row's epilogue (for a split row, only by its last-arriving block).
#include "ell_chunks.cuh"

using namespace ell;

template <typename T, int VEC>
struct PushOp {
  const T* scores;
  T* out;
  const float* weights;
  int B, n, c0;
  bool prune;
  float thresh;
  int excl[VEC];  // the row each column excludes (INT_MAX: none)

  __device__ bool live(int x) const { return x < n; }

  __device__ void load(int x, float (&v)[VEC]) const {
    load_vec<T, VEC>(scores + (long long)max(x, 0) * B + c0, v);
  }

  __device__ void add(int, const float (&v)[VEC], float (&acc)[VEC]) const {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += (!prune || v[e] > thresh) ? v[e] : 0.f;
  }

  struct Row {
    float w;
  };

  __device__ void begin_row(int v, Row& r) const { r.w = __ldg(weights + v); }

  __device__ void end_row(int v, const Row& r, const float (&acc)[VEC]) const {
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = excl[e] == v ? 0.f : acc[e] * r.w;
    store_vec<T, VEC>(out + (long long)v * B + c0, o);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) probe_push_kernel(
    const int* __restrict__ nbrs, const T* __restrict__ scores,
    const float* __restrict__ weights, const int* __restrict__ exclude,
    T* __restrict__ out, int K, int n, int B, float thresh, int tc, Plan P) {
  const Layout L = make_layout<VEC>(tc, B);
  PushOp<T, VEC> op;
  op.scores = scores;
  op.out = out;
  op.weights = weights;
  op.B = B;
  op.n = n;
  op.c0 = L.c0;
  op.prune = thresh > 0.f;
  op.thresh = thresh;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int x = L.col ? __ldg(exclude + L.c0 + e) : n;
    op.excl[e] = x < n ? max(x, 0) : INT_MAX;
  }
  run_chunk<VEC>(P, op, nbrs, K, B, L);
}

template <typename T, int VEC>
static int launch_vec(const int* nbrs, const T* scores, const float* weights,
                      const int* exclude, T* out, int K, int n, int B,
                      float thresh, int tc, const Plan& P, int n_chunks,
                      int tiles, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, VEC);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_push_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_push_kernel<T, VEC><<<dim3(n_chunks, tiles), kThreads, smem, stream>>>(
      nbrs, scores, weights, exclude, out, K, n, B, thresh, tc, P);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* nbrs, const void* scores, const void* weights,
                  const void* exclude, void* out, int K, int n, int B,
                  const Plan& P, int n_chunks, int vec, int tc, int tiles,
                  float thresh, void* stream) {
  if (n_chunks == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* nb = (const int*)nbrs;
  const T* sc = (const T*)scores;
  const float* w = (const float*)weights;
  const int* ex = (const int*)exclude;
  T* o = (T*)out;
  switch (vec) {
    case 1: return launch_vec<T, 1>(nb, sc, w, ex, o, K, n, B, thresh, tc, P, n_chunks, tiles, s);
    case 2: return launch_vec<T, 2>(nb, sc, w, ex, o, K, n, B, thresh, tc, P, n_chunks, tiles, s);
    case 4: return launch_vec<T, 4>(nb, sc, w, ex, o, K, n, B, thresh, tc, P, n_chunks, tiles, s);
    case 8:
      if constexpr (sizeof(T) <= 2)
        return launch_vec<T, 8>(nb, sc, w, ex, o, K, n, B, thresh, tc, P, n_chunks, tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}

#define PUSH_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* nbrs, const void* scores,                    \
                      const void* weights, const void* exclude, void* out,     \
                      const void* chunks, const void* short_rows,              \
                      const void* short_ptr, const void* long_rows,            \
                      const void* long_first, void* counters, void* partial,   \
                      int n_chunks, int max_slots, int max_rows, int K, int n, \
                      int B, int vec, int tc, int tiles, float thresh,         \
                      void* stream) {                                          \
    const Plan P{(const int4*)chunks, (const int*)short_rows,                  \
                 (const int*)short_ptr, (const int*)long_rows,                 \
                 (const int*)long_first, (int*)counters, (float*)partial,      \
                 max_slots, max_rows};                                         \
    return launch<T>(nbrs, scores, weights, exclude, out, K, n, B, P,          \
                     n_chunks, vec, tc, tiles, thresh, stream);                \
  }

PUSH_ENTRY(probe_push_f32, float)
PUSH_ENTRY(probe_push_f16, __half)
PUSH_ENTRY(probe_push_bf16, __nv_bfloat16)
