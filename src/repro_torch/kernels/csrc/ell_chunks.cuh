// Chunked ELL gather-sum: the executor of kernels/ell_plan.py's work plan,
// shared by lane_probe.cu, spmm_ell.cu and probe_push.cu.
//
// Row v reads only its slots k < row_len[v]; the plan cuts those ranges into
// chunks and one block runs one chunk (blockIdx.x) over one tile of columns
// (blockIdx.y).  A block's 256 threads are laid out as (slot group, column
// thread): tc threads cover the tile's columns, vec columns each (one 16-,
// 8- or 4-byte load), and kThreads / tc slot groups work side by side.
//
// * Packed chunk (a run of short rows): the block stages every id of its
//   rows into shared memory in one pass (each thread a few coalesced loads
//   in flight), then slot group g takes rows g, g + groups, ... and sums
//   each row's slots in slot order, U gathers in flight.
// * Split chunk (one piece of a long row): the piece's ids are staged the
//   same way, group g sums slots g, g + groups, ..., the groups are added
//   through shared memory in group order, and the piece's fp32 sum goes to
//   partial[p].  The row's last-arriving block (an arrival counter per row
//   and column tile, zeroed by the wrapper for each launch) adds the pieces
//   in piece order and finishes the row.  No float atomics: the same inputs
//   give the same bits on every run.
//
// A Rows policy says where row v's ids start: ``EllRows``, row v of the
// [R, K] ELL table ``nbrs`` (lane_probe, spmm_ell, probe_push: the default),
// or ``CsrRows``, ``nbrs + row_ptr[v] - base`` in an in-CSR block's
// ``indices`` (spmm_csr).  Slot k of row v is the k-th id from there
// either way.  The ELL address stays written out at its two uses (under
// ``if constexpr``, not behind a member function): so written, the ELL
// kernels compile to the SASS they had without the policy.
//
// An Op supplies the per-kernel parts:
//   bool live(int x)                  slot id x contributes (uniform in a group)
//   void load(int x, float (&v)[VEC]) the gathered values of id x
//   void add(int x, v, acc)           acc += contribution of x
//   Row                               what a row's epilogue loads
//   void begin_row(int v, Row&)       start the row's own loads (weight, and
//                                     lane_probe's total / dep)
//   void end_row(int v, Row&, acc)    weight, exclusion, stores; once per
//                                     (row, column), for a split row by its
//                                     last-arriving block only
// A row's own loads start before its gathers and its stores come after
// them, so one memory latency covers both.
#pragma once

#include <climits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ell {

constexpr int kThreads = 256;  // threads per block (ell_plan.THREADS)

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

// Blocks per SM the kernels are compiled for (__launch_bounds__): three
// cap a thread at 85 registers, so 768 threads per SM keep gathers in
// flight without the spills a cap of 64 costs the widest vectors.
constexpr int kMinBlocks = 3;

struct Plan {
  const int4* chunks;     // [n_chunks] (kind, a, b, p), see ell_plan.py
  const int* short_rows;  // [S]
  const int* short_ptr;   // [S + 1]
  const int* long_rows;   // [L]
  const int* long_first;  // [L + 1]
  int* counters;          // [L * col_tiles], zero at launch
  float* partial;         // [n_pieces, width] fp32 piece sums
  int max_slots;          // ids one chunk stages (shared memory)
  int max_rows;           // rows of one packed chunk
};

// Rows of an ELL table: row v's ids start at nbrs + v * K.
struct EllRows {
  static constexpr bool kCsr = false;
};

// Rows of an in-CSR block, ``nbrs`` its ``indices``: row v's ids start at
// row_ptr[v] - base (row_ptr holds the global CSR offsets of the block's
// rows, base the global offset of its first edge); K is not read.
struct CsrRows {
  static constexpr bool kCsr = true;
  const int* __restrict__ row_ptr;
  int base;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T x[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  const Pack<T, VEC> q = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = to_f32(q.x[e]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  Pack<T, VEC> q;
#pragma unroll
  for (int e = 0; e < VEC; ++e) q.x[e] = from_f32<T>(v[e]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = q;
}

// fp32 partials written by other blocks: read through L2 (__ldcg), never L1.
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p + e));
      v[e] = q.x; v[e + 1] = q.y; v[e + 2] = q.z; v[e + 3] = q.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldcg(p);
  }
}

struct Layout {
  int tc, groups, g, ct, c0;  // c0: first column of this thread
  bool col;                   // c0 < width
};

template <int VEC>
__device__ __forceinline__ Layout make_layout(int tc, int width) {
  Layout L;
  L.tc = tc;
  L.groups = kThreads / tc;
  L.g = threadIdx.x / tc;
  L.ct = threadIdx.x % tc;
  L.c0 = (blockIdx.y * tc + L.ct) * VEC;
  L.col = L.c0 < width;
  return L;
}

constexpr int kStage = 4;  // ids each thread loads per staging round

// Sums ids[begin, end) with the given stride into acc, in slot order, U
// gathers in flight.
template <int VEC, int U, class Op>
__device__ __forceinline__ void gather(const Op& op, const int* ids, int begin,
                                       int end, int stride, float (&acc)[VEC]) {
  for (int k = begin; k < end; k += U * stride) {
    int x[U];
    float v[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = k + u * stride;
      x[u] = j < end ? ids[j] : INT_MAX;
      if (op.live(x[u])) op.load(x[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (op.live(x[u])) op.add(x[u], v[u], acc);
  }
}

template <int VEC, class Op, class Rows>
__device__ __forceinline__ void run_packed(const Plan& P, const Op& op,
                                           const int* __restrict__ nbrs, long long K,
                                           int a, int b, const Layout& L, int* ids,
                                           int* offs, int* rows, Rows R) {
  const int nr = b - a;
  const int base = __ldg(P.short_ptr + a);
  for (int i = threadIdx.x; i <= nr; i += kThreads) {
    offs[i] = __ldg(P.short_ptr + a + i) - base;
    if (i < nr) rows[i] = __ldg(P.short_rows + a + i);
  }
  __syncthreads();
  // stage the chunk's ids: flat slot f lies in the row i with
  // offs[i] <= f < offs[i + 1] (binary search; empty rows are skipped)
  const int total = offs[nr];
  for (int f0 = 0; f0 < total; f0 += kStage * kThreads) {
    int x[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int f = f0 + s * kThreads + threadIdx.x;
      if (f < total) {
        int lo = 0, hi = nr;  // offs[lo] <= f < offs[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (offs[mid] <= f) lo = mid; else hi = mid;
        }
        if constexpr (Rows::kCsr)
          x[s] = __ldg(nbrs + (__ldg(R.row_ptr + rows[lo]) - R.base) + (f - offs[lo]));
        else
          x[s] = __ldg(nbrs + rows[lo] * K + (f - offs[lo]));
      }
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int f = f0 + s * kThreads + threadIdx.x;
      if (f < total) ids[f] = x[s];
    }
  }
  __syncthreads();
  if (!L.col) return;
  for (int i = L.g; i < nr; i += L.groups) {
    const int v = rows[i];
    typename Op::Row rs;
    op.begin_row(v, rs);
    float acc[VEC] = {};
    gather<VEC, 4>(op, ids, offs[i], offs[i + 1], 1, acc);
    op.end_row(v, rs, acc);
  }
}

template <int VEC, class Op, class Rows>
__device__ __forceinline__ void run_split(const Plan& P, const Op& op,
                                          const int* __restrict__ nbrs, long long K,
                                          int width, int4 ch, const Layout& L,
                                          int* ids, float* red, Rows R) {
  const int l = ch.x - 1, k0 = ch.y, len = ch.z - ch.y, p = ch.w;
  const int v = __ldg(P.long_rows + l);
  const int* row;
  if constexpr (Rows::kCsr)
    row = nbrs + (__ldg(R.row_ptr + v) - R.base) + k0;
  else
    row = nbrs + v * K + k0;
  for (int f0 = 0; f0 < len; f0 += kStage * kThreads) {
    int x[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int f = f0 + s * kThreads + threadIdx.x;
      if (f < len) x[s] = __ldg(row + f);
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int f = f0 + s * kThreads + threadIdx.x;
      if (f < len) ids[f] = x[s];
    }
  }
  __syncthreads();
  float acc[VEC] = {};
  if (L.col) gather<VEC, 8>(op, ids, L.g, len, L.groups, acc);
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[threadIdx.x * VEC + e] = acc[e];
  __syncthreads();
  if (L.g == 0 && L.col) {
    float s[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = red[L.ct * VEC + e];
    for (int gg = 1; gg < L.groups; ++gg) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] += red[(gg * L.tc + L.ct) * VEC + e];
    }
    float* dst = P.partial + (long long)p * width + L.c0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = s[e];
    __threadfence();  // the piece is visible before the arrival is counted
  }
  __syncthreads();
  __shared__ int last;
  const int first = __ldg(P.long_first + l);
  const int n_pieces = __ldg(P.long_first + l + 1) - first;
  int* counter = P.counters + l * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n_pieces - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // group g adds pieces g, g + groups, ...; then the groups are added in
  // group order, as for one piece
  float s[VEC] = {};
  if (L.col) {
#pragma unroll 4
    for (int q = first + L.g; q < first + n_pieces; q += L.groups) {
      float t[VEC];
      load_partial<VEC>(P.partial + (long long)q * width + L.c0, t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] += t[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[threadIdx.x * VEC + e] = s[e];
  __syncthreads();
  if (L.g == 0 && L.col) {
    typename Op::Row rs;
    op.begin_row(v, rs);
    for (int gg = 1; gg < L.groups; ++gg) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] += red[(gg * L.tc + L.ct) * VEC + e];
    }
    op.end_row(v, rs, s);
  }
}

// Dynamic shared memory of one block: ids, packed-row offsets and ids, and
// the split chunks' group sums.
inline size_t smem_bytes(const Plan& P, int vec) {
  return sizeof(int) * ((size_t)P.max_slots + 2 * (size_t)P.max_rows + 1) +
         sizeof(float) * (size_t)kThreads * vec;
}

template <int VEC, class Op, class Rows = EllRows>
__device__ __forceinline__ void run_chunk(const Plan& P, const Op& op,
                                          const int* __restrict__ nbrs, int K,
                                          int width, const Layout& L,
                                          Rows R = Rows()) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  int* ids = reinterpret_cast<int*>(red + kThreads * VEC);
  int* offs = ids + P.max_slots;
  int* rows = offs + P.max_rows + 1;
  const int4 ch = P.chunks[blockIdx.x];
  if (ch.x == 0)
    run_packed<VEC>(P, op, nbrs, K, ch.y, ch.z, L, ids, offs, rows, R);
  else
    run_split<VEC>(P, op, nbrs, K, width, ch, L, ids, red, R);
}

}  // namespace ell
