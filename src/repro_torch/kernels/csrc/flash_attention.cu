// FlashAttention-2 forward: o = softmax(q k^T * scale [causal mask]) v per
// (batch, head), in the model's [B, S, H, dh] layout; k and v are
// [B, T, Hkv, dh] and query head h reads kv head h / (H / Hkv) (GQA, MQA).
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py (_kernel, launched
// by flash_attention_pallas).  Same arithmetic: q scaled in fp32 before the
// product, causal mask row >= col with -1e30 on masked logits, running max,
// running sum and output accumulator in fp32, final acc / max(l, 1e-30),
// output in q's dtype.  Any S, T and dh <= 128; causal needs S == T.
//
// Bound on the H100: operations.  At the LM prefill shape (S = T = 32k,
// dh = 64) the work is 4 * dh FLOPs per unmasked (query, key) pair against
// one read of q, k, v and one write of o.  This first design runs on the
// CUDA cores in fp32, not on the tensor cores (wgmma and TMA come later):
// one block of 128 threads per (64-query tile, head, batch); KV tiles of 64
// keys are staged in shared memory as fp32 (k transposed), and each thread
// owns a 4 x 8 tile of the logits and a 4 x (dh / 8) tile of the output, so
// both products read float4s from shared memory and the row statistics are
// reduced over the 8 threads of a row group with shuffles.  Causal blocks
// stop at the diagonal tile and are scheduled heaviest first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile
constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kRows = 4;        // query rows per thread
constexpr int kKeys = 8;        // keys per thread in s = q k^T
constexpr int kPad = 4;         // keeps float4 alignment, spreads banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// DHP: the head width padded to 64 or 128 (padding columns hold zeros).
template <int DHP>
struct Smem {
  float qt[DHP][kBQ + kPad];  // scaled q, transposed: qt[d][row]
  float kt[DHP][kBK + kPad];  // k tile, transposed: kt[d][key]
  float vs[kBK][DHP + kPad];  // v tile: vs[key][d]
  float ps[kBQ][kBK + kPad];  // probabilities: ps[row][key]
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < kKeys; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < kKeys; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int T_, int H, int Hkv, int dh, int causal,
    float scale) {
  constexpr int kOut = DHP / 8;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DHP>& sm = *reinterpret_cast<Smem<DHP>*>(smem_raw);

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows rg * 4 .. rg * 4 + 3
  const int cg = tid & 7;   // column group: 8 lanes of one warp share a row group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long long q_stride = (long long)H * dh;    // between positions of q, o
  const long long kv_stride = (long long)Hkv * dh;  // between positions of k, v
  const T* qb = q + ((long long)b * S * H + h) * dh;
  const T* kb = k + ((long long)b * T_ * Hkv + hk) * dh;
  const T* vb = v + ((long long)b * T_ * Hkv + hk) * dh;
  T* ob = o + ((long long)b * S * H + h) * dh;

  for (int i = tid; i < kBQ * DHP; i += kThreads) {
    const int r = i / DHP, d = i % DHP;
    const int s = q0 + r;
    sm.qt[d][r] = (s < S && d < dh) ? to_f32(qb[s * q_stride + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = (T_ + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's kt, vs, ps are no longer read
    for (int i = tid; i < kBK * DHP; i += kThreads) {
      const int j = i / DHP, d = i % DHP;
      const int key = k0 + j;
      const bool in = key < T_ && d < dh;
      sm.kt[d][j] = in ? to_f32(kb[key * kv_stride + d]) : 0.f;
      sm.vs[j][d] = in ? to_f32(vb[key * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    // s = (q * scale) k^T for rows rg * 4 + r, keys cg * 8 + c
    float s[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&sm.qt[d][rg * kRows]);
      const float4 ka = *reinterpret_cast<const float4*>(&sm.kt[d][cg * kKeys]);
      const float4 kc = *reinterpret_cast<const float4*>(&sm.kt[d][cg * kKeys + 4]);
      const float qr[kRows] = {qv.x, qv.y, qv.z, qv.w};
      const float kk[kKeys] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) s[r][c] = fmaf(qr[r], kk[c], s[r][c]);
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + rg * kRows + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int col = k0 + cg * kKeys + c;
        if (col >= T_) {
          s[r][c] = -INFINITY;  // past the last key: no weight at all
        } else if (causal && col > row) {
          s[r][c] = kNegInf;
        }
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      l[r] = l[r] * corr + group_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[r][c] *= corr;
      float* prow = &sm.ps[rg * kRows + r][cg * kKeys];
      *reinterpret_cast<float4*>(prow) = make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
      *reinterpret_cast<float4*>(prow + 4) = make_float4(s[r][4], s[r][5], s[r][6], s[r][7]);
    }
    __syncthreads();

    // acc += p v for rows rg * 4 + r, output columns cg * kOut + c
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float p[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(&sm.ps[rg * kRows + r][j]);
        p[r][0] = pv.x; p[r][1] = pv.y; p[r][2] = pv.z; p[r][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c4 = 0; c4 < kOut; c4 += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&sm.vs[j + jj][cg * kOut + c4]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][c4 + 0] = fmaf(p[r][jj], vv.x, acc[r][c4 + 0]);
            acc[r][c4 + 1] = fmaf(p[r][jj], vv.y, acc[r][c4 + 1]);
            acc[r][c4 + 2] = fmaf(p[r][jj], vv.z, acc[r][c4 + 2]);
            acc[r][c4 + 3] = fmaf(p[r][jj], vv.w, acc[r][c4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + rg * kRows + r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int d = cg * kOut + c;
      if (d < dh) ob[row * q_stride + d] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int DHP>
int launch_dhp(const void* q, const void* k, const void* v, void* o, int B,
               int S, int T_, int H, int Hkv, int dh, int causal, float scale,
               cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<DHP>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, DHP><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, T_, H, Hkv, dh, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T_, int H, int Hkv, int dh, int causal, float scale,
           void* stream) {
  if (dh < 1 || dh > 128 || Hkv < 1 || H % Hkv != 0 || T_ < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (dh <= 64)
    return launch_dhp<T, 64>(q, k, v, o, B, S, T_, H, Hkv, dh, causal, scale,
                             (cudaStream_t)stream);
  return launch_dhp<T, 128>(q, k, v, o, B, S, T_, H, Hkv, dh, causal, scale,
                            (cudaStream_t)stream);
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int T, int H, int Hkv,
                                   int dh, int causal, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, o, B, S, T, H, Hkv, dh, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int S, int T, int H,
                                    int Hkv, int dh, int causal, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, Hkv, dh, causal, scale,
                               stream);
}
