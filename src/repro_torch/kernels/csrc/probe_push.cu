// Fused PROBE push level: for each row v and column b,
//   out[v, b] = w[v] * sum_k prune(scores[clip(nbrs[v, k], 0, n), b])
// with prune(s) = s > thresh ? s : 0 when thresh > 0 (no abs), the
// sentinel id n (and any id above it) reading a zero row, and then
// out[exclude[b], b] = 0 for every column whose exclude[b] < n (a negative
// exclude clips to row 0, as in the reference).  Sums are fp32; the output
// is in the scores' dtype.
//
// Replaces the Pallas kernel src/repro/kernels/probe_push/probe_push.py
// (_kernel, launched by probe_push_pallas).
//
// Bound on the H100: bytes.  Like spmm_ell.cu it reads the whole [n, K]
// neighbour table once, and on a skewed graph (K close to n, nearly every
// slot a sentinel) the table dwarfs scores and out.  The design is
// spmm_ell.cu's (ell_scan.cuh): one block per row, one thread per column,
// each table row read once and coalesced, sentinel slots skipped without
// touching scores.  So the kernel needs no zero dump row: it reads the
// unpadded [n, B] scores.  The threshold and the exclusion cost one compare
// each, in registers, before the store.
#include "ell_scan.cuh"

using namespace ell;

template <typename T>
__global__ void __launch_bounds__(kThreads) probe_push_kernel(
    const int* __restrict__ nbrs, const T* __restrict__ scores,
    const float* __restrict__ weights, const int* __restrict__ exclude,
    T* __restrict__ out, int K, int n, int B, float thresh) {
  __shared__ ScanShared sh;
  const int v = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const bool col = c < B;
  const bool prune = thresh > 0.f;
  float acc = 0.f;
  for_each_live(nbrs + (long long)v * K, K, n, sh, [&](int x) {
    if (col) {
      const float s = to_f32(scores[(long long)max(x, 0) * B + c]);
      acc += (!prune || s > thresh) ? s : 0.f;
    }
  });
  if (col) {
    const int e = exclude[c];
    const bool excluded = e < n && max(e, 0) == v;
    out[(long long)v * B + c] = from_f32<T>(excluded ? 0.f : acc * weights[v]);
  }
}

template <typename T>
static int launch(const void* nbrs, const void* scores, const void* weights,
                  const void* exclude, void* out, int n, int K, int B,
                  float thresh, void* stream) {
  if (n > 0 && B > 0) {
    const dim3 grid(n, (B + kThreads - 1) / kThreads);
    probe_push_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbrs, (const T*)scores, (const float*)weights,
        (const int*)exclude, (T*)out, K, n, B, thresh);
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_push_f32(const void* nbrs, const void* scores,
                              const void* weights, const void* exclude,
                              void* out, int n, int K, int B, float thresh,
                              void* stream) {
  return launch<float>(nbrs, scores, weights, exclude, out, n, K, B, thresh,
                       stream);
}

extern "C" int probe_push_bf16(const void* nbrs, const void* scores,
                               const void* weights, const void* exclude,
                               void* out, int n, int K, int B, float thresh,
                               void* stream) {
  return launch<__nv_bfloat16>(nbrs, scores, weights, exclude, out, n, K, B,
                               thresh, stream);
}
