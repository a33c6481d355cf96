// ELL SpMM: out[v,b] = w[v] * sum_k scores[min(nbrs[v,k], n), b] for R rows
// v over an [n + 1, B] score buffer whose row n (the sentinel dump row) is
// zero.  On the probe path R = n; a row slice of the table has R < n.
//
// Replaces the Pallas kernel src/repro/kernels/spmm_ell/spmm_ell.py
// (_kernel, launched by spmm_ell_pallas).
//
// Bound on the H100: bytes.  The call reads all of nbrs (n x K int32) once,
// and on a skewed graph (K close to n, nearly every slot the sentinel)
// nbrs dwarfs scores and out.  The design is lane_probe.cu's: one block per
// row, one thread per column, each nbrs row read once and coalesced
// (ell_scan.cuh); a sentinel slot (>= n) would gather the zero dump row, so
// it is skipped without touching scores.  fp32 accumulation for fp32, fp16
// and bf16 storage.
#include "ell_scan.cuh"

using namespace ell;

template <typename T>
__global__ void __launch_bounds__(kThreads) spmm_ell_kernel(
    const int* __restrict__ nbrs, const T* __restrict__ scores,
    const float* __restrict__ weights, T* __restrict__ out, int K, int n,
    int B) {
  __shared__ ScanShared sh;
  const int v = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const bool col = c < B;
  float acc = 0.f;
  for_each_live(nbrs + (long long)v * K, K, n, sh, [&](int x) {
    if (col) acc += to_f32(scores[(long long)max(x, 0) * B + c]);
  });
  if (col) out[(long long)v * B + c] = from_f32<T>(acc * weights[v]);
}

template <typename T>
static int launch(const void* nbrs, const void* scores, const void* weights,
                  void* out, int R, int K, int n, int B, void* stream) {
  if (R > 0 && B > 0) {
    const dim3 grid(R, (B + kThreads - 1) / kThreads);
    spmm_ell_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbrs, (const T*)scores, (const float*)weights, (T*)out, K,
        n, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int spmm_ell_f32(const void* nbrs, const void* scores,
                            const void* weights, void* out, int R, int K,
                            int n, int B, void* stream) {
  return launch<float>(nbrs, scores, weights, out, R, K, n, B, stream);
}

extern "C" int spmm_ell_f16(const void* nbrs, const void* scores,
                            const void* weights, void* out, int R, int K,
                            int n, int B, void* stream) {
  return launch<__half>(nbrs, scores, weights, out, R, K, n, B, stream);
}

extern "C" int spmm_ell_bf16(const void* nbrs, const void* scores,
                             const void* weights, void* out, int R, int K,
                             int n, int B, void* stream) {
  return launch<__nv_bfloat16>(nbrs, scores, weights, out, R, K, n, B, stream);
}
