// One compacted-lane probe level (deposit + inject + prune + ELL push +
// exclude) for W lane columns over R output rows.
//
// Replaces the Pallas kernel src/repro/kernels/lane_probe/lane_probe.py
// (_kernel, launched by lane_probe_pallas).  Per column c and row v:
//
//   tot[v,c] = total[v,c] + (fin[c] ? dep[v,c] : 0)
//   eff(x)   = (fin[c] ? 0 : table[x - row0 + tab0, c]) + [x == u_p[c]]
//              zeroed where eff <= thr[c] (if prune) and where x >= n_live
//   out[v,c] = w[v] * sum_{k < row_len[v]} eff(nbrs[v,k]),
//              0 where u_prev[c] == row0 + v
//
// That is the Pallas kernel's function whenever live slots come first in
// each row (every table the port builds or accepts; graph/structs.py).
//
// Bound on the H100: bytes, and only those of live slots: the row extent
// (the plan of kernels/ell_plan.py, built from row_len) keeps the kernel
// off the sentinel padding, so a level moves the live ids, the gathered
// frontier rows (the [T, W] frontier mostly stays in the 50 MB L2) and the
// [R, W] dep / total / out / tot rows.  The executor (ell_chunks.cuh) splits
// a hub row across blocks and packs short rows, with vectorised column
// loads and several gathers in flight per thread.  A thread whose columns
// are all finished reads no table row; one with no finished column reads no
// dep row, and, when tot is total itself (in place), touches neither.
// Accumulation is fp32 for fp32 and bf16 storage.
#include "ell_chunks.cuh"

using namespace ell;

struct LaneArgs {
  const int* nbrs;
  const float* weights;
  const void* table;
  const void* dep;
  const void* total;
  const int* fin;
  const int* u_p;
  const int* u_prev;
  const float* thr;
  void* out;
  void* tot;
  int K, table_rows, W, row0, tab0, n_live, prune, inplace, tc;
};

template <typename T, int VEC>
struct LaneOp {
  const T* table;
  const T* dep;
  const T* total;
  T* out;
  T* tot;
  const float* weights;
  int W, table_rows, row0, tab0, n_live, c0;
  bool prune, inplace, any_open, any_fin;
  bool fin[VEC];
  int up[VEC], uprev[VEC];
  float thr[VEC];

  __device__ bool live(int x) const { return x < n_live; }

  __device__ void load(int x, float (&v)[VEC]) const {
    if (any_open) {
      const int addr = min(max(x - row0 + tab0, 0), table_rows - 1);
      load_vec<T, VEC>(table + (long long)addr * W + c0, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
  }

  __device__ void add(int x, const float (&v)[VEC], float (&acc)[VEC]) const {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float ev = fin[e] ? 0.f : v[e];
      ev += x == up[e] ? 1.f : 0.f;
      if (prune && !(ev > thr[e])) ev = 0.f;
      acc[e] += ev;
    }
  }

  struct Row {
    float t[VEC], d[VEC], w;
  };

  __device__ void begin_row(int v, Row& r) const {
    const long long at = (long long)v * W + c0;
    r.w = __ldg(weights + v);
    if (inplace && !any_fin) return;  // tot is total and nothing deposits
    load_vec<T, VEC>(total + at, r.t);
    if (any_fin) load_vec<T, VEC>(dep + at, r.d);
  }

  __device__ void end_row(int v, const Row& r, const float (&acc)[VEC]) const {
    const long long at = (long long)v * W + c0;
    if (!inplace || any_fin) {
      float t[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = fin[e] ? r.t[e] + r.d[e] : r.t[e];
      store_vec<T, VEC>(tot + at, t);
    }
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = uprev[e] == row0 + v ? 0.f : acc[e] * r.w;
    store_vec<T, VEC>(out + at, o);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lane_probe_kernel(LaneArgs a, Plan P) {
  const Layout L = make_layout<VEC>(a.tc, a.W);
  LaneOp<T, VEC> op;
  op.table = (const T*)a.table;
  op.dep = (const T*)a.dep;
  op.total = (const T*)a.total;
  op.out = (T*)a.out;
  op.tot = (T*)a.tot;
  op.weights = a.weights;
  op.W = a.W;
  op.table_rows = a.table_rows;
  op.row0 = a.row0;
  op.tab0 = a.tab0;
  op.n_live = a.n_live;
  op.c0 = L.c0;
  op.prune = a.prune != 0;
  op.inplace = a.inplace != 0;
  op.any_open = false;
  op.any_fin = false;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const bool ok = L.col;
    op.fin[e] = ok && a.fin[L.c0 + e] != 0;
    op.up[e] = ok ? a.u_p[L.c0 + e] : INT_MAX;
    op.uprev[e] = ok ? a.u_prev[L.c0 + e] : INT_MAX;
    op.thr[e] = ok ? a.thr[L.c0 + e] : 0.f;
    op.any_open |= ok && !op.fin[e];
    op.any_fin |= op.fin[e];
  }
  run_chunk<VEC>(P, op, a.nbrs, a.K, a.W, L);
}

template <typename T, int VEC>
static int launch_vec(const LaneArgs& a, const Plan& P, int n_chunks, int tiles,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(P, VEC);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lane_probe_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lane_probe_kernel<T, VEC><<<dim3(n_chunks, tiles), kThreads, smem, stream>>>(a, P);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const LaneArgs& a, const Plan& P, int n_chunks, int vec,
                  int tiles, void* stream) {
  if (n_chunks == 0 || a.W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 1: return launch_vec<T, 1>(a, P, n_chunks, tiles, s);
    case 2: return launch_vec<T, 2>(a, P, n_chunks, tiles, s);
    case 4: return launch_vec<T, 4>(a, P, n_chunks, tiles, s);
    case 8:
      if constexpr (sizeof(T) <= 2) return launch_vec<T, 8>(a, P, n_chunks, tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}

#define LANE_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(                                                          \
      const void* nbrs, const void* weights, const void* table,                \
      const void* dep, const void* total, const void* fin, const void* u_p,    \
      const void* u_prev, const void* thr, void* out, void* tot,               \
      const void* chunks, const void* short_rows, const void* short_ptr,       \
      const void* long_rows, const void* long_first, void* counters,           \
      void* partial, int n_chunks, int max_slots, int max_rows, int K,         \
      int table_rows, int W, int row0, int tab0, int n_live, int prune,        \
      int inplace, int vec, int tc, int tiles, void* stream) {                 \
    const LaneArgs a{(const int*)nbrs, (const float*)weights, table, dep,      \
                     total, (const int*)fin, (const int*)u_p,                  \
                     (const int*)u_prev, (const float*)thr, out, tot, K,       \
                     table_rows, W, row0, tab0, n_live, prune, inplace, tc};   \
    const Plan P{(const int4*)chunks, (const int*)short_rows,                  \
                 (const int*)short_ptr, (const int*)long_rows,                 \
                 (const int*)long_first, (int*)counters, (float*)partial,      \
                 max_slots, max_rows};                                         \
    return launch<T>(a, P, n_chunks, vec, tiles, stream);                      \
  }

LANE_ENTRY(lane_probe_level_f32, float)
LANE_ENTRY(lane_probe_level_bf16, __nv_bfloat16)
