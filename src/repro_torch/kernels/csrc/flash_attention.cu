// FlashAttention-2 forward: o = softmax(q k^T * scale [causal mask]) v per
// (batch, head), in the model's [B, S, H, dh] layout; k and v are
// [B, T, Hkv, dh] and query head h reads kv head h / (H / Hkv) (GQA, MQA).
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py (_kernel, launched
// by flash_attention_pallas).  Same arithmetic: causal mask row >= col,
// masked logits get no weight, running max, running sum and output
// accumulator in fp32, final acc / max(l, 1e-30), output in q's dtype.  Any
// S and T; causal needs S == T.
//
// Bound on the H100: operations.  At the LM prefill shape (S = T = 32k,
// dh = 64) the work is 4 * dh tensor-core FLOPs and one exp per unmasked
// (query, key) pair against one read of q, k, v and one write of o; at
// dh = 64 the exponentials on the special-function units take about as long
// as the products on the tensor cores.  Two routes (ops.py::route picks one
// from the dtype and dh):
//
// * flash_tc_kernel (bf16, dh % 8 == 0, dh <= 128): the tensor-core route.
//   One block of three warpgroups per (128-query tile, head, batch).
//   Warpgroup 0 is the producer: one thread issues TMA loads of the q tile
//   and of K and V tiles into a ring of stages (128-byte swizzle,
//   a full and an empty mbarrier per stage); its registers go to the
//   consumers through setmaxnreg.  Warpgroups 1 and 2 each own 64 query
//   rows: s = q k^T is wgmma m64nBKk16 with both operands in shared memory
//   (k K-major, as TMA lays it down), the online softmax runs on the fp32
//   accumulator fragment in registers (scale * log2 e folded into one FMA,
//   exp2, quad shuffles for the row max), p is rounded to bf16 in registers
//   and o += p v is wgmma m64n{64,128}k16 with p as the register operand
//   and v MN-major (the transpose bit).  Each turn issues s of tile j
//   together with p v of tile j - 1, and the two consumer warpgroups take
//   turns on named barriers to issue their products, so one warpgroup's
//   softmax runs while the other's products occupy the tensor cores.
//   Head widths below 64 are zero-filled to 64 by TMA (the box is 64
//   columns wide); widths above 64 load as two 64-column boxes.  Causal
//   blocks stop at the diagonal tile and run heaviest first; only tiles
//   that cross a warpgroup's diagonal or the last key are masked.  No
//   atomics: the same inputs give the same bits.
//   Tile sizes: 64 query rows is wgmma's M.  The key tile BK keeps s (BK / 2
//   floats a thread), p (BK / 4) and o (dh / 2) inside the registers ptxas
//   gives the consumers: 128 keys at dh <= 64, 64 at dh 128 (with 128 keys
//   there ptxas serialises the products for lack of registers, warning
//   C7512).  Stages: 3 at dh <= 64 and 4 at dh 128 (112 and 160 KB of shared
//   memory); on the H100 two stages starved the products and more than
//   three at dh 64 did not help.
// * flash_kernel<T, DHP> (fp32, and bf16 with dh % 8 != 0): CUDA cores in
//   fp32.  One block of 128 threads per (64-query tile, head, batch); KV
//   tiles of 64 keys are staged in shared memory as fp32 (k transposed),
//   and each thread owns a 4 x 8 tile of the logits and a 4 x (dh / 8) tile
//   of the output, so both products read float4s from shared memory and the
//   row statistics are reduced over the 8 threads of a row group with
//   shuffles.  q is scaled in fp32 before the product, masked logits are
//   -1e30 and p stays fp32.
#include <cuda.h>  // CUtensorMap; the encoder is found at run time, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// The tensor-core route: bf16, dh % 8 == 0, wgmma fed by TMA.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBox = 64;  // bf16 columns of one 128-byte swizzled box
constexpr float kLog2e = 1.4426950408889634f;

// Consumer warpgroups of 64 query rows each; warpgroup 0 produces.  (Three
// consumers fit in shared memory at dh = 64 but not in registers: at 160 a
// thread ptxas serialises the products.)
constexpr int kConsumers = 2;

// DHP: the head width padded to 64 or 128 (TMA fills the padding with zeros).
template <int DHP>
struct Cfg {
  static constexpr int kBQ = 64 * kConsumers;  // query rows per block
  static constexpr int kBK = DHP == 64 ? 128 : 64;  // keys per KV tile
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBoxes = DHP / kBox;
  static constexpr int kStages = DHP == 64 ? 3 : 4;
  static constexpr int kQBytes = kBoxes * kBQ * 128;
  static constexpr int kBoxBytes = kBK * 128;            // one K or V box
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // K or V of a stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBars = 1 + 2 * kStages;          // q, full[], empty[]
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 8 * kBars;
  // registers: the block holds 65536 / kThreads each (in steps of 8); the
  // producer gives all but 24 to the consumers
  static constexpr int kConsumerRegs =
      ((65536 / kThreads / 8 * 8) * kThreads - 128 * 24) / (128 * kConsumers) / 8 * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spins until the phase of the given parity completes.  A wait that never
// ends (a broken pipeline) traps after 2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' product issues.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so the compiler
// neither moves their uses across the wait nor reuses them before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = SW128.
// K-major (q, k): rows of 128 bytes, 8-row groups 1024 bytes apart (stride),
// the leading offset unused.  MN-major (v): the 8 keys of a group 128 bytes
// apart, key groups 1024 bytes apart (stride), 64-column boxes kBoxBytes
// apart (leading).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d (64 x 64, fp32) {=, +=} A (64 x 16, shared) * B (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) {=, +=} A (64 x 16, shared) * B (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Online softmax of one 64 x N tile of s, held as the wgmma accumulator
// fragment: the thread (warp w of the warpgroup, lane l) holds rows
// row_a = 16 w + l / 4 and row_a + 8 at s[4 n + {0, 1}] and s[4 n + {2, 3}],
// columns col0 + 8 n + {0, 1} with col0 = k0 + 2 (l % 4).  Masked entries
// get no weight (every row keeps its diagonal or an in-range key in each
// tile it visits, so the row max stays finite).  Leaves exp2(s c - m) in s,
// updates the running max m (log2 units) and the thread's share of the
// running sum l, and returns the factor by which the output must shrink.
template <int N>  // N / 2 floats: a 64 x N tile
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c, bool mask, int row_a,
                                             int col0, int T_, int causal) {
  if (mask) {
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * n + (e & 1);
        const int row = row_a + 8 * (e >> 1);
        if (col >= T_ || (causal && col > row)) s[4 * n + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
    const float m_new = fmaxf(m[i], quad_max(mx) * c);
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * n + 2 * i + e];
        x = ex2(fmaf(x, c, -m_new));
        sum += x;
      }
    l[i] = l[i] * corr[i] + sum;
  }
}

template <int DHP>
__global__ void __launch_bounds__(128 * (kConsumers + 1), 1) flash_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S, int T_,
    int H, int Hkv, int dh, int causal, float scale) {
  using C = Cfg<DHP>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment: q, then the stages (K, V), then
  // the barriers (q, full[], empty[])
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + C::kQBytes;
  const uint32_t bars = skv + C::kStages * C::kStageBytes;
  const uint32_t q_full = bars;
  const uint32_t full0 = bars + 8, empty0 = bars + 8 * (1 + C::kStages);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;  // heaviest causal tiles first
  const int q0 = tile * kBQ;
  const int hk = h / (H / Hkv);
  int n_tiles = (T_ + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(sq + x * kBQ * 128, &tq, q_full, x * kBox, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::kStages;
        mbar_wait(empty0 + 8 * st, ((j / C::kStages) & 1) ^ 1);  // first round: free
        mbar_expect_tx(full0 + 8 * st, C::kStageBytes);
        const uint32_t kb = skv + st * C::kStageBytes, vb = kb + C::kTileBytes;
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(kb + x * C::kBoxBytes, &tk, full0 + 8 * st, x * kBox, hk, j * kBK, b);
          tma_load(vb + x * C::kBoxBytes, &tv, full0 + 8 * st, x * kBox, hk, j * kBK, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows q0 + 64 c .. q0 + 64 c + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int c = wg - 1;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row_a = q0 + 64 * c + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int mine = 1 + c, next = 1 + (c + 1) % kConsumers;  // named barriers of the turns
  const uint32_t qa = sq + 64 * c * 128;  // this warpgroup's rows of each q box
  const float sl2 = scale * kLog2e;
  // scale * log2 e folds into the exponent's FMA when it is positive; else s
  // is scaled first and the softmax runs on it unscaled
  const bool fold = sl2 > 0.f;
  const float cf = fold ? sl2 : 1.f;

  float s[kBK / 2], acc[DHP / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t p[kBK / 4];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;

  auto issue_s = [&](int st) {  // s = q k^T of the tile in stage st
    const uint32_t kb = skv + st * C::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const uint32_t k_off = (kk / 4) * C::kBoxBytes + (kk % 4) * 32;
      const uint32_t q_off = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
      const uint64_t da = sw128_desc(qa + q_off, 16, 1024);
      const uint64_t db = sw128_desc(kb + k_off, 16, 1024);
      if constexpr (kBK == 128) wgmma_ss_n128(s, da, db, kk > 0);
      else wgmma_ss_n64(s, da, db, kk > 0);
    }
  };
  auto issue_pv = [&](int st) {  // acc += p v of the tile in stage st
    const uint32_t vb = skv + st * C::kStageBytes + C::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t d = sw128_desc(vb + kk * 2048, C::kBoxBytes, 1024);
      if constexpr (DHP == 64) wgmma_rs_n64(acc, &p[4 * kk], d);
      else wgmma_rs_n128(acc, &p[4 * kk], d);
    }
  };
  auto softmax = [&](int j) {
    if (!fold) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] *= sl2;
    }
    // only tiles that reach past this warpgroup's first row, or past T
    const bool mask = (causal && (j + 1) * kBK - 1 > q0 + 64 * c) || (j + 1) * kBK > T_;
    softmax_tile<kBK>(s, m, l, corr, cf, mask, row_a, j * kBK + cq, T_, causal);
  };
  auto to_p = [&]() {  // the accumulator fragment is the A-register fragment
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (j % C::kStages));
  };

  if (c == kConsumers - 1) bar_arrive(1);  // consumer 0 takes the first turn
  mbar_wait(q_full, 0);

  mbar_wait(full0, 0);
  bar_sync(mine);
  wg_fence();
  issue_s(0);
  wg_commit();
  bar_arrive(next);
  wg_wait<0>();
  pin(s);
  softmax(0);
  to_p();

  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % C::kStages;
    mbar_wait(full0 + 8 * st, (j / C::kStages) & 1);
    bar_sync(mine);
    wg_fence();
    issue_s(st);
    wg_commit();
    issue_pv((j - 1) % C::kStages);
    wg_commit();
    bar_arrive(next);
    wg_wait<1>();  // s of tile j is in
    pin(s);
    // ptxas schedules the wait below ahead of these exponentials (as the
    // SASS shows), so the softmax overlaps the other warpgroup's products,
    // not this one's p v.  Packing p in place, or keeping p live past the
    // wait, did not move it; two alternating p register sets made ptxas
    // serialise the products (C7520, the branch on the tile count's parity).
    softmax(j);
    wg_wait<0>();
    pin(acc);
    pin(p);
    release(j - 1);
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n) {
      acc[4 * n + 0] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }
    to_p();
  }

  bar_sync(mine);
  wg_fence();
  issue_pv((n_tiles - 1) % C::kStages);
  wg_commit();
  if (c != kConsumers - 1) bar_arrive(next);  // the last warpgroup's last turn is not awaited
  wg_wait<0>();
  pin(acc);
  pin(p);

  // o = acc / l in bf16: each quad writes 16 contiguous bytes of a row
  __nv_bfloat16* ob = o + ((long long)b * S * H + h) * dh;
  const long long q_stride = (long long)H * dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    const float inv = 1.f / fmaxf(quad_sum(l[i]), 1e-30f);
    if (row >= S) continue;
    __nv_bfloat16* orow = ob + row * q_stride;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n) {
      const int col = 8 * n + cq;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the kernels
// link no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// x as a 4-d bf16 tensor {dh, heads, len, B} (innermost first), read in
// boxes of {64 columns, 1 head, 128 rows, 1 batch} with the 128-byte swizzle;
// columns past dh and rows past len read as zeros.
bool encode(CUtensorMap* map, EncodeTiled fn, const void* x, int dh, int heads, int len,
            int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)len,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)dh * 2;  // bytes; dh % 8 == 0 keeps these % 16
  const cuuint64_t strides[3] = {row, row * heads, row * heads * len};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_, int H,
           int Hkv, int dh, int causal, float scale, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  using C = Cfg<DHP>;
  if (!encode(&mq, fn, q, dh, H, S, B, C::kBQ) ||
      !encode(&mk, fn, k, dh, Hkv, T_, B, C::kBK) || !encode(&mv, fn, v, dh, Hkv, T_, B, C::kBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + C::kBQ - 1) / C::kBQ);
  flash_tc_kernel<DHP><<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, S, T_, H, Hkv, dh, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// The tensor-core route (bf16, dh % 8 == 0, dh <= 128, 16-byte-aligned rows).
extern "C" int flash_attention_bf16_tc(const void* q, const void* k, const void* v,
                                       void* o, int B, int S, int T, int H, int Hkv,
                                       int dh, int causal, float scale, void* stream) {
  if (dh < 8 || dh > 128 || dh % 8 != 0 || Hkv < 1 || H % Hkv != 0 || T < 1 ||
      (S + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (dh <= 64)
    return tc::launch<64>(q, k, v, o, B, S, T, H, Hkv, dh, causal, scale,
                          (cudaStream_t)stream);
  return tc::launch<128>(q, k, v, o, B, S, T, H, Hkv, dh, causal, scale,
                         (cudaStream_t)stream);
}
