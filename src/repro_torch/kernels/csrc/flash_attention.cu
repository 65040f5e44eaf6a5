// Dense GQA flash attention (forward), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_tpu (:83, body _flash_kernel :33).  q (B, T, H, D), k/v
// (B, T, KH, D) -> out (B, T, H, D); query head kh * G + g reads kv head kh
// (G = H / KH).  Semantics kept from the TPU kernel: a score is (q . k) *
// scale with scale = 1 / sqrt(D), causal keeps kpos <= qpos, the softmax is
// online, and the output is acc / max(l, 1e-30) in q's dtype.  The TPU's
// cq/ck chunking is tiling only: these kernels pick their own tiles and
// mask a ragged T.  Rows are (position, group) pairs, position-major, so a
// row's position is row / G and GQA needs no extra pass.
//
// Two variants; the wrapper (flash_attention.py: choose_variant) picks one:
//
// 1. Tensor-core tile (flash_tile_kernel), bf16 with D 64, 80, 128 or 256: the
//    shared tile of attention_tile.cuh over dense K/V rows (row stride
//    KH * D).  The grid is (64-row tiles, KH, B), heaviest causal tiles
//    first.  Under the causal mask a tile walks keys up to its last row's
//    position, so key tiles above the diagonal are neither loaded nor
//    computed (the TPU kernel's `run` predicate); only diagonal tiles are
//    masked, and keys past T are zero-filled.  P is rounded to bf16 for the
//    P V product (the TPU kernel keeps P in f32): a known difference, held
//    at the bf16 tolerance.  Bound on an H100: tensor-core operations, 4 * D
//    flops per visible (query, key) pair at 989 TFLOP/s bf16; mma.sync and
//    a two-stage cp.async ring reach a fraction of it (attention_tile.cuh).
//
// 2. CUDA-core walk (flash_kernel), the exact f32 path (and bf16 at any
//    other D).  One block of 4 warps per (16 query rows, kv head, batch
//    row); each warp keeps 4 rows' q, running max, sum and f32 accumulator
//    in registers, lanes splitting head_dim (d = lane + 32k).  The block
//    walks the keys in tiles of 32 staged in shared memory as f32, stopping
//    at its last position under the causal mask, and P stays f32.  Bound:
//    the f32 FMA rate (67 TFLOP/s); each score is a warp-wide butterfly sum,
//    so it runs far from that.
//
// Both variants write each row's log-sum-exp (m + log l, natural logs of
// the scaled scores) to an optional f32 (B, H, T) array when the caller
// passes one: the backward (flash_attention_bwd.cu) recomputes P from it.
// Inference passes null; the output is the same bits either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTileK = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int Tn, int H, int KH, int D,
             int causal, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                // (kTileK, D)
  float* vs = smem + kTileK * D;   // (kTileK, D)

  const int b = blockIdx.z;
  const int h = blockIdx.y;  // kv head
  const int G = H / KH;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = Tn * G;
  const int row0 = blockIdx.x * kRowsPerBlock;

  float qr[kRowsPerWarp][DPL];
  float acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int lim[kRowsPerWarp];  // last key a row sees; -1 for a row past T
  size_t qoff[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    const bool ok = r < rows;
    const int t = ok ? r / G : 0;
    const int g = ok ? r % G : 0;
    lim[i] = ok ? (causal ? t : Tn - 1) : -1;
    qoff[i] = (((size_t)b * Tn + t) * H + (size_t)h * G + g) * D;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DPL; ++kk) {
      const int d = lane + 32 * kk;
      qr[i][kk] = (ok && d < D) ? to_f32(q[qoff[i] + d]) : 0.f;
      acc[i][kk] = 0.f;
    }
  }

  // keys the block walks: up to its last row's position under the causal
  // mask, all T otherwise
  const int last_row = min(row0 + kRowsPerBlock, rows) - 1;
  const int kend = causal ? last_row / G + 1 : Tn;

  for (int k0 = 0; k0 < kend; k0 += kTileK) {
    const int n = min(kTileK, kend - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
      const int t = e / D, d = e - t * D;
      const size_t src = (((size_t)b * Tn + k0 + t) * KH + h) * D + d;
      ks[e] = to_f32(k[src]);
      vs[e] = to_f32(v[src]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float* kt = ks + t * D;
      const float* vt = vs + t * D;
      float kv[DPL], vv[DPL];
#pragma unroll
      for (int kk = 0; kk < DPL; ++kk) {
        const int d = lane + 32 * kk;
        kv[kk] = d < D ? kt[d] : 0.f;
        vv[kk] = d < D ? vt[d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (k0 + t > lim[i]) continue;  // masked (warp-uniform)
        float s = 0.f;
#pragma unroll
        for (int kk = 0; kk < DPL; ++kk) s = fmaf(qr[i][kk], kv[kk], s);
        s = warp_sum(s) * scale;
        const float mn = fmaxf(m[i], s);
        const float corr = expf(m[i] - mn);
        const float p = expf(s - mn);
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int kk = 0; kk < DPL; ++kk)
          acc[i][kk] = acc[i][kk] * corr + p * vv[kk];
        m[i] = mn;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (lim[i] < 0) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0) {
      const int r = row0 + warp * kRowsPerWarp + i;
      lse[((size_t)b * H + (size_t)h * G + r % G) * Tn + r / G] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
    }
#pragma unroll
    for (int kk = 0; kk < DPL; ++kk) {
      const int d = lane + 32 * kk;
      if (d < D) store_f32(out + qoff[i] + d, acc[i][kk] * inv);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Tn, int H, int KH, int D, int causal,
           float scale, cudaStream_t stream) {
  const int rows = Tn * (H / KH);
  dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock, KH, B);
  const size_t smem = 2 * (size_t)kTileK * D * sizeof(float);
  // 64 KB at D 256: past the 48 KB a kernel gets without asking
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(2 * (size_t)kTileK * 32 * DPL * sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_kernel<T, DPL><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Tn, H, KH, D,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Tn, int H, int KH, int D, int causal,
                float scale, cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    case 2: return launch<T, 2>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    case 3: return launch<T, 3>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    case 4: return launch<T, 4>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    case 5: case 6: case 7: case 8:
      return launch<T, 8>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------- 1. tensor-core tile
// The tile's view of one (batch row, kv head).
struct FlashSrc {
  using KV = __nv_bfloat16;
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const void* base;
  float* lse;  // (B, H, T) or null
  int rows, Tn, H, KH, G, D, b, h, causal;

  __device__ size_t qoff(int r) const {
    return (((size_t)b * Tn + r / G) * H + (size_t)h * G + r % G) * D;
  }
  __device__ const __nv_bfloat16* q_row(int r) const { return q + qoff(r); }
  __device__ __nv_bfloat16* out_row(int r) const { return out + qoff(r); }
  __device__ int pos(int r) const { return causal ? r / G : Tn - 1; }
  __device__ size_t koff(int kp) const {
    return (((size_t)b * Tn + kp) * KH + h) * (size_t)D;
  }
  __device__ const __nv_bfloat16* k_row(int kp) const { return k + koff(kp); }
  __device__ const __nv_bfloat16* v_row(int kp) const { return v + koff(kp); }
  __device__ void store_lse(int r, float value) const {
    if (lse != nullptr)
      lse[((size_t)b * H + (size_t)h * G + r % G) * Tn + r / G] = value;
  }
};

template <int D>
__global__ void __launch_bounds__(attn_tile::kThreads)
flash_tile_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int Tn, int H, int KH, int causal, float scale) {
  extern __shared__ int4 tile_smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int G = H / KH;
  const int rows = Tn * G;
  // heaviest causal tiles (the last rows) first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = tile * attn_tile::kRows;
  const int last = min(row0 + attn_tile::kRows, rows) - 1;
  const int kend = causal ? last / G + 1 : Tn;
  const FlashSrc src{q, out, k, v, k, lse, rows, Tn, H, KH, G, D, b, h, causal};
  attn_tile::run<D, false>(src, row0, kend, scale,
                           reinterpret_cast<char*>(tile_smem));
}

template <int D>
int launch_tile(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Tn, int H, int KH, int causal,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = attn_tile::smem_bytes<D, false>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tile_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = Tn * (H / KH);
  dim3 grid((rows + attn_tile::kRows - 1) / attn_tile::kRows, KH, B);
  flash_tile_kernel<D><<<grid, attn_tile::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, Tn, H, KH, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The CUDA-core walk (variant 2).  dtype: 0 = float32, 1 = bfloat16 (q, k,
// v and out alike).  lse: f32 (B, H, T) for the rows' log-sum-exp, or null.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, void* lse, int B,
                               int Tn, int H, int KH, int D, int causal,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return by_head_dim<float>(q, k, v, out, l, B, Tn, H, KH, D, causal, scale,
                              s);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(q, k, v, out, l, B, Tn, H, KH, D,
                                      causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core tile (variant 1): bf16 q, k, v and out; D 64, 80, 128 or
// 256.  lse as for flash_attention.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_tile(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int B, int Tn, int H, int KH, int D,
                                    int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return launch_tile<64>(q, k, v, out, l, B, Tn, H, KH, causal, scale, s);
    case 80: return launch_tile<80>(q, k, v, out, l, B, Tn, H, KH, causal, scale, s);
    case 128: return launch_tile<128>(q, k, v, out, l, B, Tn, H, KH, causal, scale, s);
    case 256: return launch_tile<256>(q, k, v, out, l, B, Tn, H, KH, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
