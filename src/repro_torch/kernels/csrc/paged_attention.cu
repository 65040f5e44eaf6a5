// Paged chunk attention through block tables, for sm_90a.
//
// Replaces the Pallas TPU kernels of repro/kernels/paged_attention.py:
// paged_attention_chunk (:148, body _chunk_kernel_body :57) and its int8
// variant _paged_chunk_kernel_q8 (:129).  Each query row (one of the C*G
// rows of a request's chunk for one kv head) attends, with an online
// softmax, over the pool tokens its block table names at absolute
// positions <= its own.  Only the first num_live[b] table slots are
// walked: the loop bound takes the place of the TPU index-map clamp, so
// dead slots are neither read nor computed.  An all-masked row writes 0
// (the max(l, 1e-30) guard of the TPU kernel).
//
// Design.  One block of 4 warps per (tile of 16 query rows, kv head,
// request).  Each warp owns 4 rows and keeps their q, running max, sum and
// f32 accumulator in registers, lanes splitting head_dim (d = lane + 32k,
// so head_dim 80 needs no padding: lanes past D hold zeros).  For each
// live table slot the block stages the (bs, D) K and V tiles in shared
// memory as f32, once for all 16 rows, then each warp walks the tile's
// tokens: a warp-wide butterfly sum gives the score, and tokens past a
// row's position are skipped, so masked and dead tokens are exact no-ops
// and the bounded walk equals the unbounded one bitwise.
//
// Storage types.  The query is f32 or bf16; the pools are f32, fp16, bf16
// or int8, whatever the query's type.  Every pool type is converted to f32
// as its tile is staged, and nothing after the staging depends on it.  An
// int8 tile is staged as float(code) * scale, with the (block, kv head)
// scale read once per live slot through the same table entry as the page
// (k_scales[tables[b, j] * KH + h]).  int8 -> f32 is exact and the
// multiply is one f32 rounding, so the fused kernel equals the f32 kernel
// on materialized dequantized pools bitwise, and the scale of a dead slot
// is never read.
//
// What bounds it on an H100: decode (C == 1) reads each live K/V page once
// per (request, kv head), so it is bound by HBM bytes (3.35 TB/s): 1 byte
// per element plus 4 bytes of scale per (block, kv head) for int8 pools.
// A prefill chunk re-reads the same pages for every row tile and does
// 4*C*ctx*D flops per head on CUDA cores (no tensor cores yet, wgmma and
// TMA are later work), so it is bound by the f32 FMA rate.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, out: (B, C, KH, G, D) of TQ; pools: (N, bs, KH, D) of TKV; scales:
// (N, KH) f32, read for int8 pools only; tables: (B, nblk); qpos: (B, C);
// live: (B,).  All contiguous.
template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_chunk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                   const TKV* __restrict__ v_pool,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   const int32_t* __restrict__ tables,
                   const int32_t* __restrict__ qpos,
                   const int32_t* __restrict__ live, TQ* __restrict__ out,
                   int C, int KH, int G, int D, int bs, int nblk,
                   float scale) {
  constexpr bool kQuantized = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  float* ks = smem;            // (bs, D)
  float* vs = smem + bs * D;   // (bs, D)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = C * G;
  const int row0 = blockIdx.x * kRowsPerBlock;

  // per-row state in registers
  float qr[kRowsPerWarp][DPL];
  float acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int pos[kRowsPerWarp];
  size_t qoff[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    const bool ok = r < rows;
    const int c = ok ? r / G : 0;
    const int g = ok ? r % G : 0;
    // a row outside the chunk gets position -1: every token is masked
    pos[i] = ok ? qpos[(size_t)b * C + c] : -1;
    qoff[i] = (((size_t)b * C + c) * KH + h) * (size_t)G * D + (size_t)g * D;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + 32 * k;
      qr[i][k] = (ok && d < D) ? to_f32(q[qoff[i] + d]) : 0.f;
      acc[i][k] = 0.f;
    }
  }

  // walk bound: the request's live slots, cut to the deepest block any row
  // of this tile can see (the slots past it are fully masked for the tile)
  int maxpos = -1;
  for (int r = row0; r < min(row0 + kRowsPerBlock, rows); ++r)
    maxpos = max(maxpos, qpos[(size_t)b * C + r / G]);
  const int nlive = min(live[b], nblk);
  const int jend = maxpos < 0 ? 0 : min(nlive, maxpos / bs + 1);

  const int tile = bs * D;
  for (int j = 0; j < jend; ++j) {
    const size_t blk = (size_t)tables[(size_t)b * nblk + j];
    __syncthreads();  // the previous tile is no longer read
    if constexpr (kQuantized) {
      const float ksc = k_scales[blk * KH + h];
      const float vsc = v_scales[blk * KH + h];
      for (int e = threadIdx.x; e < tile; e += blockDim.x) {
        const int t = e / D, d = e - t * D;
        const size_t src = ((blk * bs + t) * KH + h) * (size_t)D + d;
        ks[e] = __fmul_rn(to_f32(k_pool[src]), ksc);
        vs[e] = __fmul_rn(to_f32(v_pool[src]), vsc);
      }
    } else {
      for (int e = threadIdx.x; e < tile; e += blockDim.x) {
        const int t = e / D, d = e - t * D;
        const size_t src = ((blk * bs + t) * KH + h) * (size_t)D + d;
        ks[e] = to_f32(k_pool[src]);
        vs[e] = to_f32(v_pool[src]);
      }
    }
    __syncthreads();
    const int base = j * bs;
    for (int t = 0; t < bs; ++t) {
      const float* kt = ks + t * D;
      const float* vt = vs + t * D;
      float kv[DPL], vv[DPL];
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int d = lane + 32 * k;
        kv[k] = d < D ? kt[d] : 0.f;
        vv[k] = d < D ? vt[d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (base + t > pos[i]) continue;  // causal mask (warp-uniform)
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < DPL; ++k) s = fmaf(qr[i][k], kv[k], s);
        s = warp_sum(s) * scale;
        const float mn = fmaxf(m[i], s);
        const float corr = expf(m[i] - mn);
        const float p = expf(s - mn);
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int k = 0; k < DPL; ++k) acc[i][k] = acc[i][k] * corr + p * vv[k];
        m[i] = mn;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + 32 * k;
      if (d < D) store_f32(out + qoff[i] + d, acc[i][k] * inv);
    }
  }
}

struct Args {
  const void *q, *k, *v, *ksc, *vsc, *tables, *qpos, *live;
  void* out;
  int B, C, KH, G, D, bs, nblk;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int DPL>
int launch(const Args& a) {
  const int rows = a.C * a.G;
  dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock, a.KH, a.B);
  const size_t smem = 2 * (size_t)a.bs * a.D * sizeof(float);
  paged_chunk_kernel<TQ, TKV, DPL><<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.qpos), static_cast<const int32_t*>(a.live),
      static_cast<TQ*>(a.out), a.C, a.KH, a.G, a.D, a.bs, a.nblk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_head_dim(const Args& a) {
  switch ((a.D + 31) / 32) {
    case 1: return launch<TQ, TKV, 1>(a);
    case 2: return launch<TQ, TKV, 2>(a);
    case 3: return launch<TQ, TKV, 3>(a);
    case 4: return launch<TQ, TKV, 4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int by_pool_type(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0: return by_head_dim<TQ, float>(a);
    case 1: return by_head_dim<TQ, __nv_bfloat16>(a);
    case 2: return by_head_dim<TQ, __half>(a);
    case 3: return by_head_dim<TQ, int8_t>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16, 2 = float16, 3 = int8.  q_dtype is
// 0 or 1; kv_dtype any of the four, and 3 needs k_scales / v_scales.
// Returns the cudaError_t of the launch.
extern "C" int paged_attention_chunk(int q_dtype, int kv_dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* k_scales,
                                     const void* v_scales, const void* tables,
                                     const void* qpos, const void* live,
                                     void* out, int B, int C, int KH, int G,
                                     int D, int bs, int nblk, float scale,
                                     void* stream) {
  const Args a{q, k, v, k_scales, v_scales, tables, qpos, live, out,
               B, C, KH, G, D, bs, nblk, scale,
               static_cast<cudaStream_t>(stream)};
  if (kv_dtype == 3 && (k_scales == nullptr || v_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0) return by_pool_type<float>(kv_dtype, a);
  if (q_dtype == 1) return by_pool_type<__nv_bfloat16>(kv_dtype, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
