// One compacted-lane probe level (deposit + inject + prune + ELL push +
// exclude) for W lane columns over R output rows.
//
// Replaces the Pallas kernel src/repro/kernels/lane_probe/lane_probe.py
// (_kernel, launched by lane_probe_pallas).  Per column c and row v:
//
//   tot[v,c] = total[v,c] + (fin[c] ? dep[v,c] : 0)
//   eff(x)   = (fin[c] ? 0 : table[x - row0 + tab0, c]) + [x == u_p[c]]
//              zeroed where eff <= thr[c] (if prune) and where x >= n_live
//   out[v,c] = w[v] * sum_k eff(nbrs[v,k]),  0 where u_prev[c] == row0 + v
//
// Bound on the H100: bytes.  The level reads all of nbrs (R x K int32) once;
// on a skewed graph K is close to n and nearly every slot is the sentinel,
// so nbrs dwarfs the [rows, W] frontier, dep, total and outputs.  The design
// reads each nbrs row once, coalesced, several loads in flight per thread
// (ell_scan.cuh); a slot >= n_live is skipped before its table row is
// touched (its eff is 0 in the TPU kernel too), and a finished column reads
// no table at all.  Accumulation is fp32 for fp32 and bf16 storage.
#include "ell_scan.cuh"

using namespace ell;

template <typename T>
__global__ void __launch_bounds__(kThreads) lane_probe_kernel(
    const int* __restrict__ nbrs, const float* __restrict__ weights,
    const T* __restrict__ table, const T* __restrict__ dep,
    const T* __restrict__ total, const int* __restrict__ fin,
    const int* __restrict__ u_p, const int* __restrict__ u_prev,
    const float* __restrict__ thr, T* __restrict__ out, T* __restrict__ tot,
    int K, int table_rows, int W, int row0, int tab0, int n_live, int prune) {
  __shared__ ScanShared sh;
  const int v = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const bool col = c < W;
  const long long at = (long long)v * W + c;

  bool f = false;
  int up = 0;
  float th = 0.f;
  if (col) {
    f = fin[c] != 0;
    up = u_p[c];
    th = thr[c];
    float t = to_f32(total[at]);
    if (f) t += to_f32(dep[at]);
    tot[at] = from_f32<T>(t);
  }

  float acc = 0.f;
  for_each_live(nbrs + (long long)v * K, K, n_live, sh, [&](int x) {
    if (!col) return;
    const int addr = min(max(x - row0 + tab0, 0), table_rows - 1);
    float e = f ? 0.f : to_f32(table[(long long)addr * W + c]);
    e += x == up ? 1.f : 0.f;
    if (prune && !(e > th)) e = 0.f;
    acc += e;
  });

  if (col) {
    float o = acc * weights[v];
    if (u_prev[c] == row0 + v) o = 0.f;
    out[at] = from_f32<T>(o);
  }
}

template <typename T>
static int launch(const void* nbrs, const void* weights, const void* table,
                  const void* dep, const void* total, const void* fin,
                  const void* u_p, const void* u_prev, const void* thr,
                  void* out, void* tot, int R, int K, int table_rows, int W,
                  int row0, int tab0, int n_live, int prune, void* stream) {
  if (R > 0 && W > 0) {
    const dim3 grid(R, (W + kThreads - 1) / kThreads);
    lane_probe_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbrs, (const float*)weights, (const T*)table,
        (const T*)dep, (const T*)total, (const int*)fin, (const int*)u_p,
        (const int*)u_prev, (const float*)thr, (T*)out, (T*)tot, K,
        table_rows, W, row0, tab0, n_live, prune);
  }
  return (int)cudaGetLastError();
}

extern "C" int lane_probe_level_f32(
    const void* nbrs, const void* weights, const void* table, const void* dep,
    const void* total, const void* fin, const void* u_p, const void* u_prev,
    const void* thr, void* out, void* tot, int R, int K, int table_rows, int W,
    int row0, int tab0, int n_live, int prune, void* stream) {
  return launch<float>(nbrs, weights, table, dep, total, fin, u_p, u_prev, thr,
                       out, tot, R, K, table_rows, W, row0, tab0, n_live,
                       prune, stream);
}

extern "C" int lane_probe_level_bf16(
    const void* nbrs, const void* weights, const void* table, const void* dep,
    const void* total, const void* fin, const void* u_p, const void* u_prev,
    const void* thr, void* out, void* tot, int R, int K, int table_rows, int W,
    int row0, int tab0, int n_live, int prune, void* stream) {
  return launch<__nv_bfloat16>(nbrs, weights, table, dep, total, fin, u_p,
                               u_prev, thr, out, tot, R, K, table_rows, W,
                               row0, tab0, n_live, prune, stream);
}
