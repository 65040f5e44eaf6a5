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
// 2. The f32 tile (flash_f32_kernel), the exact path: f32 at any D <= 256,
//    and bf16 at the head dims the tensor-core tile is not built for.  The
//    register-blocked FMA tile of attention_f32.cuh over the same dense
//    rows: 64 query rows a CTA (one warp's rows where a 64-row grid would
//    leave SMs idle, as the model zoo's short f32 prefills do), K/V tiles
//    of 32 keys through a two-stage cp.async ring, S and P V as f32 FMA
//    micro-tiles from shared memory, one online softmax rescale per key
//    tile; causal CTAs stop at their last row's position, heaviest first.
//    Bound: the f32 FMA rate (67 TFLOP/s), 4 * D flops per visible (query,
//    key) pair; it reaches about half of it.
//
// Both variants write each row's log-sum-exp (m + log l, natural logs of
// the scaled scores) to an optional f32 (B, H, T) array when the caller
// passes one: the backward (flash_attention_bwd.cu) recomputes P from it.
// Inference passes null; the output is the same bits either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "attention_tile.cuh"

namespace {

// The tiles' view of one (batch row, kv head): q, out (B, T, H, D) and
// k, v (B, T, KH, D), all of type T.  Both tiles take it.
template <typename T>
struct FlashSrc {
  using KV = T;
  const T* q;
  T* out;
  const T* k;
  const T* v;
  const void* base;
  float* lse;  // (B, H, T) or null
  int rows, Tn, H, KH, G, D, b, h, causal;

  __device__ size_t qoff(int r) const {
    return (((size_t)b * Tn + r / G) * H + (size_t)h * G + r % G) * D;
  }
  __device__ const T* q_row(int r) const { return q + qoff(r); }
  __device__ T* out_row(int r) const { return out + qoff(r); }
  __device__ int pos(int r) const { return causal ? r / G : Tn - 1; }
  __device__ size_t koff(int kp) const {
    return (((size_t)b * Tn + kp) * KH + h) * (size_t)D;
  }
  __device__ const T* k_row(int kp) const { return k + koff(kp); }
  __device__ const T* v_row(int kp) const { return v + koff(kp); }
  __device__ void store_lse(int r, float value) const {
    if (lse != nullptr)
      lse[((size_t)b * H + (size_t)h * G + r % G) * Tn + r / G] = value;
  }
};

// A CTA's first row and its walk bound: heaviest causal tiles (the last
// rows) first; under the causal mask the walk stops at the last row's
// position.
__device__ __forceinline__ void flash_rows(int rows_per_cta, int rows, int Tn,
                                           int G, int causal, int& row0,
                                           int& kend) {
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  row0 = tile * rows_per_cta;
  const int last = min(row0 + rows_per_cta, rows) - 1;
  kend = causal ? last / G + 1 : Tn;
}

// ------------------------------------------------- 1. tensor-core tile
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
  int row0, kend;
  flash_rows(attn_tile::kRows, rows, Tn, G, causal, row0, kend);
  const FlashSrc<__nv_bfloat16> src{q,  out, k,  v, k, lse, rows, Tn,
                                    H,  KH,  G,  D, b, h,   causal};
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

// ------------------------------------------------------------ 2. f32 tile
template <int DP, int W, typename T>
__global__ void __launch_bounds__(32 * attn_f32::full_warps<DP>(), attn_f32::min_blocks<DP>())
flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Tn, int H, int KH, int D,
                 int causal, float scale, int copy) {
  extern __shared__ int4 f32_smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int G = H / KH;
  const int rows = Tn * G;
  int row0, kend;
  flash_rows(attn_f32::Shape<DP, W, T>::kRows, rows, Tn, G, causal, row0,
             kend);
  const FlashSrc<T> src{q, out, k, v, k, lse, rows, Tn, H, KH, G, D, b, h,
                        causal};
  attn_f32::run<DP, W>(src, row0, kend, scale, copy,
                       reinterpret_cast<char*>(f32_smem));
}

template <int DP, int W, typename T>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Tn, int H, int KH, int D, int causal,
               float scale, int copy, cudaStream_t stream) {
  using S = attn_f32::Shape<DP, W, T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<DP, W, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = Tn * (H / KH);
  dim3 grid((rows + S::kRows - 1) / S::kRows, KH, B);
  flash_f32_kernel<DP, W, T><<<grid, S::kThreads, S::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Tn, H, KH, D,
      causal, scale, copy);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, typename T>
int f32_by_rows(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Tn, int H, int KH, int D, int causal,
                float scale, cudaStream_t s) {
  constexpr int kFull = attn_f32::full_warps<DP>();
  const int copy = attn_f32::copy_width(k, v, (size_t)D * sizeof(T));
  if (attn_f32::wide_rows(Tn * (H / KH), KH * B))
    return launch_f32<DP, kFull, T>(q, k, v, out, lse, B, Tn, H, KH, D,
                                    causal, scale, copy, s);
  return launch_f32<DP, 1, T>(q, k, v, out, lse, B, Tn, H, KH, D, causal,
                              scale, copy, s);
}

template <typename T>
int f32_by_head_dim(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int Tn, int H, int KH, int D,
                    int causal, float scale, cudaStream_t s) {
  switch (attn_f32::padded_dim(D)) {
    case 64: return f32_by_rows<64, T>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    case 80: return f32_by_rows<80, T>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    case 128: return f32_by_rows<128, T>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    case 256: return f32_by_rows<256, T>(q, k, v, out, lse, B, Tn, H, KH, D, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The f32 tile (variant 2).  dtype: 0 = float32, 1 = bfloat16 (q, k, v and
// out alike); D <= 256.  lse: f32 (B, H, T) for the rows' log-sum-exp, or
// null.  Returns the cudaError_t of the launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, void* lse, int B,
                               int Tn, int H, int KH, int D, int causal,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (H % KH != 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return f32_by_head_dim<float>(q, k, v, out, l, B, Tn, H, KH, D, causal,
                                  scale, s);
  if (dtype == 1)
    return f32_by_head_dim<__nv_bfloat16>(q, k, v, out, l, B, Tn, H, KH, D,
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
