// Dense GQA flash attention, backward, for sm_90a.
//
// The TPU kernel repro/kernels/flash_attention.py: flash_attention_tpu (:83)
// has no backward: the reference trains through autodiff of its jnp
// chunked attention (repro/models/attention.py:70).  The port's forward is
// the CUDA kernel of flash_attention.cu, so its gradient is this file:
// dQ, dK, dV from q, k, v (B, T, KH or H, D), the forward's output o and
// dO (B, T, H, D), and the forward's row log-sum-exp lse (B, H, T, f32).
// Query head kh * G + g reads kv head kh (G = H / KH); a score is
// (q . k) * scale; causal keeps kpos <= qpos.  With P = exp(S * scale - lse)
// (the forward's softmax, recomputed) and Delta_i = sum_d dO_id O_id:
//
//   dV_j = sum_i P_ij dO_i          dP_ij = dO_i . V_j
//   dS_ij = P_ij (dP_ij - Delta_i)
//   dK_j = scale sum_i dS_ij Q_i    dQ_i = scale sum_j dS_ij K_j
//
// Two variants; the wrapper (flash_attention.py: choose_bwd_variant) picks
// one.  Neither uses atomics: every sum runs in one fixed order, so two
// calls on the same inputs give the same bits.  Both start with
// delta_kernel (Delta, one warp per (b, t, h) row).
//
// 1. Tensor-core tiles (dq_tile_kernel, dkdv_tile_kernel), bf16 with D 64,
//    80, 128 or 256.  Built from the forward's parts (attention_tile.cuh:
//    cp.async ring, ldmatrix, mma.sync.m16n8k16 bf16 with f32 accumulate,
//    ex2, 16-byte padded smem rows).  A block is one warpgroup (4 warps).
//    - dQ: a block owns 64 query rows of one head (16 a warp), grid
//      (query tiles, H, B), heaviest causal tiles first.  Q and dO stay in
//      shared memory; K/V tiles of 64 keys (32 at D 256) stream through a
//      two-stage ring up to the tile's last row.  Per K/V tile a warp
//      computes S = Q K^T and dP = dO V^T, P = 2^(S scale log2e - lse
//      log2e), dS = P (dP - Delta) in f32 in the accumulator layout, packs
//      dS to bf16 A fragments (the forward's P V register trick) and adds
//      dS K with K as an ldmatrix.trans B operand.  dQ is scaled and
//      stored once.
//    - dK/dV: a block owns 64 keys of one kv head (32 at D 256), a warp 16
//      keys (at D 256 a pair of warps shares 16 keys, each accumulating
//      128 of the head dims and both computing S and dP); grid (key tiles,
//      KH x splits, B).  It walks its query heads and, under the causal
//      mask, the query tiles at or below the diagonal, Q, dO, lse and Delta
//      streaming through the ring in tiles of 64 queries (32 where a warp
//      accumulates more than 80 dims).  A warp computes S^T = K Q^T and
//      dP^T = V dO^T directly, so P^T and dS^T land with keys as rows, the
//      A-fragment layout of dV += P^T dO and dK += dS^T Q; lse and Delta
//      are per-column values read from shared memory.
//    - GQA: where (key tiles x KH x B) is under BWD_TARGET_BLOCKS, the
//      wrapper splits each kv head's G query heads over `splits` blocks;
//      each writes f32 partial dK/dV to scratch, and split_sum_kernel adds
//      them in split order into the bf16 gradients.
//    Rounding: P and dS are rounded to bf16 for their products (as
//    FlashAttention-2 does); S, dP, dP - Delta, the exponentials and every
//    accumulator stay f32.  Masking as the forward: rows and keys past T
//    are zero-filled by cp.async's src-size 0 and never read; masked P and
//    dS entries are set by a select; a warp that sees no (query, key) pair
//    of a tile skips it.
// 2. CUDA-core walk (dkdv_kernel, dq_kernel), the exact f32 path (and bf16
//    at any other D):
//    - dkdv_kernel: one block per (key tile, kv head, b).  It holds the
//      tile's K and V in shared memory and its dK and dV sums in registers,
//      and walks every query tile of each of the G query heads of its kv
//      head (under the causal mask only the tiles at or below the
//      diagonal), recomputing S, P, dP and dS for each.
//    - dq_kernel: one block per (query tile, head, b), heaviest causal
//      tiles first; it holds Q, dO and its dQ sum and walks the key tiles
//      up to its last row (all of them without the mask).
//    Every product is an f32 product of tiles staged in shared memory as
//    f32 (bf16 inputs widen exactly), by a 16 x 16 thread grid whose
//    threads each own a micro tile of the output (rows ty + 16 i, columns
//    tx + 16 j).  Rows of the Q, K, V and dO tiles are padded to an odd
//    stride, so the 16 threads of a half-warp reading one column of 16
//    rows hit 16 banks.  Head dims are padded with zeros to DP, a multiple
//    of 16 (80 stays 80).  Tiles are 64 rows (query rows and keys) up to
//    DP 128, 32 past it.  Masked entries of P and dS are set to 0 by a
//    select; rows and keys past T are zero-filled and never written.
// dQ, dK and dV are written once, in the input's dtype.
//
// What bounds it on an H100: the five products (S, dP, dV, dK, dQ) are 10 D
// flops per visible (query, key) pair and head, 2.5x the forward's 4 D,
// against the bytes of q, k, v, o, dO, lse and the three gradients, so it
// is bound by operations: the bf16 tensor-core peak (989 TFLOP/s) for bf16
// inputs, the f32 rate (67 TFLOP/s) for f32.  Both variants recompute S and
// dP in each of their two kernels (7 products where 5 would do) and so do
// the tiles' split warps at D 256; the tiles run on mma.sync, a fraction of
// the tensor-core peak that only wgmma reaches (with K/V through TMA: later
// work, as for the forward).  The CUDA-core walk runs far from either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid over each product's output
constexpr int kTG = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int DP>
struct Cfg {
  static_assert(DP % kTG == 0 && DP <= 256, "padded head dim");
  static constexpr int kTile = DP <= 128 ? 64 : 32;  // rows and keys a tile
  static constexpr int kStride = DP + 1;             // f32 per Q/K/V/dO row
  static constexpr int kPStride = kTile + 1;         // f32 per P/dS row
  static constexpr int kRT = kTile / kTG;            // tile rows a thread
  static constexpr int kDT = DP / kTG;               // head dims a thread
  static constexpr size_t kSmem =
      sizeof(float) * (4 * (size_t)kTile * kStride + 2 * (size_t)kTile * kPStride +
                       2 * kTile);
};

// acc[i][j] += sum_{k < K} A(ty + 16 i, k) * B(k, tx + 16 j), where A(m, k)
// is a[m * am + k * ak] and B(k, n) is b[k * bk + n * bn], in shared memory.
template <int K, int TM, int TN>
__device__ __forceinline__ void product(float (&acc)[TM][TN], const float* a,
                                        int am, int ak, const float* b, int bk,
                                        int bn, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[(ty + kTG * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[k * bk + (tx + kTG * j) * bn];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Rows [r0, r0 + kTile) of a (T, DP) view whose row t starts at
// src + t * stride (D elements), as f32 with zeros past T and past D.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t stride, int r0, int Tn,
                                          int D) {
  using C = Cfg<DP>;
  for (int e = threadIdx.x; e < C::kTile * DP; e += kThreads) {
    const int r = e / DP, d = e - r * DP;
    float x = 0.f;
    if (r0 + r < Tn && d < D) x = to_f32(src[(size_t)(r0 + r) * stride + d]);
    dst[r * C::kStride + d] = x;
  }
}

// The tile's lse and Delta rows (zeros past T).
template <int DP>
__device__ __forceinline__ void load_stats(float* ls, float* ds,
                                           const float* lse,
                                           const float* delta, int r0,
                                           int Tn) {
  for (int i = threadIdx.x; i < Cfg<DP>::kTile; i += kThreads) {
    const bool ok = r0 + i < Tn;
    ls[i] = ok ? lse[r0 + i] : 0.f;
    ds[i] = ok ? delta[r0 + i] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T over one (query tile, key tile) pair; then P and
// dS into shared memory (rows: queries, columns: keys), masked entries 0.
template <int DP>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* Ls, const float* Ds,
                                       float* Ps, float* dSs, int q0, int k0,
                                       int Tn, int causal, float scale,
                                       int ty, int tx) {
  using C = Cfg<DP>;
  float s[C::kRT][C::kRT], dp[C::kRT][C::kRT];
#pragma unroll
  for (int i = 0; i < C::kRT; ++i)
#pragma unroll
    for (int j = 0; j < C::kRT; ++j) s[i][j] = dp[i][j] = 0.f;
  product<DP>(s, Qs, C::kStride, 1, Ks, 1, C::kStride, ty, tx);
  product<DP>(dp, dOs, C::kStride, 1, Vs, 1, C::kStride, ty, tx);
#pragma unroll
  for (int i = 0; i < C::kRT; ++i) {
    const int qi = ty + kTG * i;
    const int qp = q0 + qi;
#pragma unroll
    for (int j = 0; j < C::kRT; ++j) {
      const int kj = tx + kTG * j;
      const int kp = k0 + kj;
      const bool ok = qp < Tn && kp < Tn && (!causal || kp <= qp);
      const float p = ok ? expf(s[i][j] * scale - Ls[qi]) : 0.f;
      Ps[qi * C::kPStride + kj] = p;
      dSs[qi * C::kPStride + kj] = ok ? p * (dp[i][j] - Ds[qi]) : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1. Delta (B, H, T) = rowsum(dO * O), one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int B, int Tn, int H, int D) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B * Tn * H) return;  // warp-uniform
  const T* op = o + (size_t)row * D;
  const T* dp = dout + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(op[d]), to_f32(dp[d]), acc);
  acc = warp_sum(acc);
  const int h = row % H, bt = row / H;
  if (lane == 0) delta[((size_t)(bt / Tn) * H + h) * Tn + bt % Tn] = acc;
}

// 2. dK and dV of one key tile of one kv head, summed over its G query
// heads and every query tile that sees it.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Tn, int H, int KH,
            int D, int causal, float scale) {
  using C = Cfg<DP>;
  constexpr int BT = C::kTile;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * C::kStride;
  float* Qs = Vs + BT * C::kStride;
  float* dOs = Qs + BT * C::kStride;
  float* Ps = dOs + BT * C::kStride;
  float* dSs = Ps + BT * C::kPStride;
  float* Ls = dSs + BT * C::kPStride;
  float* Ds = Ls + BT;

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int G = H / KH;
  const int ty = threadIdx.x / kTG, tx = threadIdx.x % kTG;
  const size_t kv_stride = (size_t)KH * D, q_stride = (size_t)H * D;
  const size_t kv_base = ((size_t)b * Tn * KH + kvh) * D;
  load_rows<T, DP>(Ks, k + kv_base, kv_stride, k0, Tn, D);
  load_rows<T, DP>(Vs, v + kv_base, kv_stride, k0, Tn, D);

  float dka[C::kRT][C::kDT], dva[C::kRT][C::kDT];
#pragma unroll
  for (int i = 0; i < C::kRT; ++i)
#pragma unroll
    for (int j = 0; j < C::kDT; ++j) dka[i][j] = dva[i][j] = 0.f;

  // under the causal mask, queries before k0 see no key of the tile
  const int q_first = causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_base = ((size_t)b * Tn * H + h) * D;
    const float* lrow = lse + ((size_t)b * H + h) * Tn;
    const float* drow = delta + ((size_t)b * H + h) * Tn;
    for (int q0 = q_first; q0 < Tn; q0 += BT) {
      __syncthreads();  // the previous step's tiles are no longer read
      load_rows<T, DP>(Qs, q + q_base, q_stride, q0, Tn, D);
      load_rows<T, DP>(dOs, dout + q_base, q_stride, q0, Tn, D);
      load_stats<DP>(Ls, Ds, lrow, drow, q0, Tn);
      __syncthreads();
      scores<DP>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, Tn, causal, scale,
                 ty, tx);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q (rows: keys, columns: head dim)
      product<BT>(dva, Ps, 1, C::kPStride, dOs, C::kStride, 1, ty, tx);
      product<BT>(dka, dSs, 1, C::kPStride, Qs, C::kStride, 1, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < C::kRT; ++i) {
    const int kp = k0 + ty + kTG * i;
    if (kp >= Tn) continue;
#pragma unroll
    for (int j = 0; j < C::kDT; ++j) {
      const int d = tx + kTG * j;
      if (d >= D) continue;
      const size_t off = kv_base + (size_t)kp * kv_stride + d;
      store_f32(dk + off, dka[i][j] * scale);
      store_f32(dv + off, dva[i][j]);
    }
  }
}

// 3. dQ of one query tile of one head, summed over the key tiles it sees.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Tn, int H, int KH, int D, int causal,
          float scale) {
  using C = Cfg<DP>;
  constexpr int BT = C::kTile;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * C::kStride;
  float* Ks = dOs + BT * C::kStride;
  float* Vs = Ks + BT * C::kStride;
  float* Ps = Vs + BT * C::kStride;
  float* dSs = Ps + BT * C::kPStride;
  float* Ls = dSs + BT * C::kPStride;
  float* Ds = Ls + BT;

  const int b = blockIdx.z, h = blockIdx.y;
  // heaviest causal tiles (the last rows) first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * BT;
  const int kvh = h / (H / KH);
  const int ty = threadIdx.x / kTG, tx = threadIdx.x % kTG;
  const size_t kv_stride = (size_t)KH * D, q_stride = (size_t)H * D;
  const size_t kv_base = ((size_t)b * Tn * KH + kvh) * D;
  const size_t q_base = ((size_t)b * Tn * H + h) * D;
  load_rows<T, DP>(Qs, q + q_base, q_stride, q0, Tn, D);
  load_rows<T, DP>(dOs, dout + q_base, q_stride, q0, Tn, D);
  load_stats<DP>(Ls, Ds, lse + ((size_t)b * H + h) * Tn,
                 delta + ((size_t)b * H + h) * Tn, q0, Tn);

  float dqa[C::kRT][C::kDT];
#pragma unroll
  for (int i = 0; i < C::kRT; ++i)
#pragma unroll
    for (int j = 0; j < C::kDT; ++j) dqa[i][j] = 0.f;

  // keys the tile sees: up to its last row under the causal mask
  const int kend = causal ? min(q0 + BT, Tn) : Tn;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();  // the previous step's K, V and dS are no longer read
    load_rows<T, DP>(Ks, k + kv_base, kv_stride, k0, Tn, D);
    load_rows<T, DP>(Vs, v + kv_base, kv_stride, k0, Tn, D);
    __syncthreads();
    scores<DP>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, Tn, causal, scale,
               ty, tx);
    __syncthreads();
    // dQ += dS K (rows: queries, columns: head dim)
    product<BT>(dqa, dSs, C::kPStride, 1, Ks, C::kStride, 1, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < C::kRT; ++i) {
    const int qp = q0 + ty + kTG * i;
    if (qp >= Tn) continue;
#pragma unroll
    for (int j = 0; j < C::kDT; ++j) {
      const int d = tx + kTG * j;
      if (d < D) store_f32(dq + q_base + (size_t)qp * q_stride + d,
                           dqa[i][j] * scale);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Tn, int H, int KH, int D,
           int causal, float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * Tn * H;
  delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                    stream>>>(static_cast<const T*>(o), dot, delta, B, Tn, H,
                              D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (Tn + C::kTile - 1) / C::kTile;
  dkdv_kernel<T, DP><<<dim3(tiles, KH, B), kThreads, C::kSmem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Tn, H, KH, D, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, DP><<<dim3(tiles, H, B), kThreads, C::kSmem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Tn, H, KH, D, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Tn, int H, int KH, int D,
                int causal, float scale, cudaStream_t s) {
#define REPRO_BWD(DP)                                                       \
  return launch<T, DP>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Tn, H, \
                       KH, D, causal, scale, s)
  if (D <= 32) REPRO_BWD(32);
  if (D <= 64) REPRO_BWD(64);
  if (D <= 80) REPRO_BWD(80);
  if (D <= 96) REPRO_BWD(96);
  if (D <= 128) REPRO_BWD(128);
  if (D <= 160) REPRO_BWD(160);
  if (D <= 192) REPRO_BWD(192);
  if (D <= 256) REPRO_BWD(256);
#undef REPRO_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------- 1. tensor-core tiles
using bf16 = __nv_bfloat16;
using attn_tile::cp_async16;
using attn_tile::cp_async4;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;
using attn_tile::ex2;
using attn_tile::kLog2e;
using attn_tile::ldsm_x4;
using attn_tile::ldsm_x4_t;
using attn_tile::mma_bf16;
using attn_tile::pack_bf16;

constexpr int kTileThreads = 128;  // one warpgroup
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kQRows = 64;         // query rows of a dQ block, 16 a warp

template <int D>
struct BwdShape {
  static_assert(D % 16 == 0 && D <= 256, "head_dim must be a multiple of 16, <= 256");
  static constexpr int kStride = D + 8;             // bf16 per smem row
  static constexpr int kKeys = D > 128 ? 32 : 64;   // keys of a dQ walk's K/V tile
  static constexpr int kSplitD = D > 128 ? 2 : 1;   // warps sharing 16 keys
  static constexpr int kDW = D / kSplitD;           // dK/dV dims a warp sums
  static constexpr int kKVKeys = 16 * kTileWarps / kSplitD;  // keys a dK/dV block
  static constexpr int kQT = kDW <= 80 ? 64 : 32;   // queries of a dK/dV walk's tile
  static constexpr size_t kSmemQ =
      sizeof(bf16) * (2 * kQRows + 4 * kKeys) * kStride;
  static constexpr size_t kSmemKV =
      sizeof(bf16) * (2 * kKVKeys + 4 * kQT) * kStride + sizeof(float) * 4 * kQT;
};

// acc (16 x N) += A B, where A is rows [r0, r0 + 16) of sA (16 x D) and
// B(d, n) = sB[n][d] for n in [0, N): S = Q K^T, dP = dO V^T and their
// transposes S^T = K Q^T, dP^T = V dO^T.
template <int D, int N>
__device__ __forceinline__ void product_abt(float (&acc)[N / 8][4],
                                            const bf16* sA, int r0,
                                            const bf16* sB, int lane) {
  constexpr int kStride = BwdShape<D>::kStride;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, sA + (r0 + (lane & 15)) * kStride + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, sB + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride +
                     ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x NW) += P X, where P (16 x K) is in the C fragments of K / 8
// n-tiles (rounded here to bf16 A fragments) and X(k, n) = sX[k][d0 + n]:
// dQ += dS K, dV += P^T dO, dK += dS^T Q.
template <int D, int K, int NW>
__device__ __forceinline__ void product_pv(float (&acc)[NW / 8][4],
                                           const float (&p)[K / 8][4],
                                           const bf16* sX, int d0, int lane) {
  constexpr int kStride = BwdShape<D>::kStride;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < NW / 16; ++nd) {
      uint32_t b[4];
      ldsm_x4_t(b, sX + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                       d0 + nd * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * nd], a, b[0], b[1]);
      mma_bf16(acc[2 * nd + 1], a, b[2], b[3]);
    }
  }
}

// Copy rows [r0, r0 + R) of a (T, D) view whose row t starts at
// src + t * stride into smem rows of kStride, zero-filling rows at or past
// `end` (nothing is read there).
template <int D, int R>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int end) {
  constexpr int kCpr = D / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < R * kCpr; c += kTileThreads) {
    const int r = c / kCpr, part = c % kCpr;
    const bool ok = r0 + r < end;
    cp_async16(dst + r * BwdShape<D>::kStride + part * 8,
               src + (size_t)(ok ? r0 + r : 0) * stride + part * 8, ok);
  }
}

// dQ of 64 query rows of head h, summed over the K/V tiles they see.
template <int D>
__global__ void __launch_bounds__(kTileThreads)
dq_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, int Tn, int H, int KH, int causal,
               float scale) {
  using S = BwdShape<D>;
  constexpr int kKeys = S::kKeys;
  constexpr int kTile = kKeys * S::kStride;
  extern __shared__ int4 dq_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(dq_smem);
  bf16* sdO = sQ + kQRows * S::kStride;
  bf16* ring = sdO + kQRows * S::kStride;  // stage s: K at [2s], V at [2s + 1]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  // heaviest causal tiles (the last rows) first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kQRows;
  const int kvh = h / (H / KH);
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  const size_t q_base = ((size_t)b * Tn * H + h) * D;
  const size_t kv_base = ((size_t)b * Tn * KH + kvh) * D;

  copy_rows<D, kQRows>(sQ, q + q_base, q_stride, q0, Tn);
  copy_rows<D, kQRows>(sdO, dout + q_base, q_stride, q0, Tn);
  // keys the tile sees: up to its last row under the causal mask
  const int kend = causal ? min(q0 + kQRows, Tn) : Tn;
  const int ntiles = (kend + kKeys - 1) / kKeys;
  auto load_kv = [&](int t, int stage) {
    bf16* dst = ring + 2 * stage * kTile;
    copy_rows<D, kKeys>(dst, k + kv_base, kv_stride, t * kKeys, kend);
    copy_rows<D, kKeys>(dst + kTile, v + kv_base, kv_stride, t * kKeys, kend);
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();  // group 0: Q, dO and K/V tile 0

  // this thread's two rows: position (-1 past T), lse in log2 units, Delta
  const int wlo = q0 + 16 * warp;  // the warp's first row
  const int whi = min(wlo + 15, Tn - 1);
  int rpos[2];
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wlo + gid + 8 * i;
    const bool ok = r < Tn;
    rpos[i] = ok ? r : -1;
    l2[i] = ok ? lse[((size_t)b * H + h) * Tn + r] * kLog2e : 0.f;
    dl[i] = ok ? delta[((size_t)b * H + h) * Tn + r] : 0.f;
  }
  const float sl = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile t has landed
    __syncthreads();
    const bf16* sK = ring + 2 * (t & 1) * kTile;
    const bf16* sV = sK + kTile;
    const int k0 = t * kKeys;
    // warp-uniform: some row of this warp sees some key of the tile
    if (wlo < Tn && (!causal || k0 <= whi)) {
      float s[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      product_abt<D, kKeys>(s, sQ, 16 * warp, sK, lane);
      product_abt<D, kKeys>(dp, sdO, 16 * warp, sV, lane);
      const bool need_mask = (causal && k0 + kKeys - 1 > wlo) || k0 + kKeys > Tn;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * tig + (e & 1);
          const int i = e >> 1;
          float p = ex2(fmaf(s[j][e], sl, -l2[i]));
          if (need_mask) p = (kp < Tn && (!causal || kp <= rpos[i])) ? p : 0.f;
          s[j][e] = p * (dp[j][e] - dl[i]);  // dS
        }
      }
      product_pv<D, kKeys, D>(acc, s, sK, 0, lane);
    }
    __syncthreads();  // this stage may be overwritten from here on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rpos[i] < 0) continue;
    bf16* dst = dq + q_base + (size_t)rpos[i] * q_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * tig) =
          pack_bf16(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// dK and dV of the block's keys of kv head kvh, summed over the query heads
// of its split and every query tile that sees them.  With part null the
// block writes the bf16 gradients; else f32 partials at part (dK of split s
// at [s], dV at [splits + s], each B * T * KH * D floats).
template <int D>
__global__ void __launch_bounds__(kTileThreads)
dkdv_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, float* __restrict__ part, int splits,
                 int Tn, int H, int KH, int causal, float scale) {
  using S = BwdShape<D>;
  constexpr int KB = S::kKVKeys, QT = S::kQT, DW = S::kDW;
  constexpr int kQTile = QT * S::kStride;
  extern __shared__ int4 kv_smem[];
  bf16* sK = reinterpret_cast<bf16*>(kv_smem);
  bf16* sV = sK + KB * S::kStride;
  bf16* ring = sV + KB * S::kStride;  // stage s: Q at [2s], dO at [2s + 1]
  float* sStats = reinterpret_cast<float*>(ring + 4 * kQTile);  // stage s: lse at [2s], Delta at [2s + 1]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / splits, split = blockIdx.y % splits;
  const int G = H / KH;
  const int per = (G + splits - 1) / splits;
  const int g0 = split * per, g1 = min(G, g0 + per);
  const int k0 = blockIdx.x * KB;
  const int kr = 16 * (warp / S::kSplitD);  // the warp's first key in the block
  const int kw0 = k0 + kr;
  const int d0 = (warp % S::kSplitD) * DW;  // the warp's first head dim
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  const size_t kv_base = ((size_t)b * Tn * KH + kvh) * D;

  copy_rows<D, KB>(sK, k + kv_base, kv_stride, k0, Tn);
  copy_rows<D, KB>(sV, v + kv_base, kv_stride, k0, Tn);
  // under the causal mask, query tiles before the block's first key see none
  const int q_first = causal ? k0 / QT * QT : 0;
  const int nq = (Tn - q_first + QT - 1) / QT;  // query tiles a head
  const int nsteps = (g1 - g0) * nq;
  auto load_q = [&](int step, int stage) {
    const int h = kvh * G + g0 + step / nq;
    const int q0 = q_first + step % nq * QT;
    const size_t q_base = ((size_t)b * Tn * H + h) * D;
    bf16* dst = ring + 2 * stage * kQTile;
    copy_rows<D, QT>(dst, q + q_base, q_stride, q0, Tn);
    copy_rows<D, QT>(dst + kQTile, dout + q_base, q_stride, q0, Tn);
    if (threadIdx.x < QT) {
      const int r = q0 + threadIdx.x;
      const bool ok = r < Tn;
      const size_t row = ((size_t)b * H + h) * Tn + (ok ? r : 0);
      cp_async4(sStats + 2 * stage * QT + threadIdx.x, lse + row, ok);
      cp_async4(sStats + (2 * stage + 1) * QT + threadIdx.x, delta + row, ok);
    }
  };
  if (nsteps > 0) load_q(0, 0);
  cp_async_commit();  // group 0: K, V and step 0's tiles
  const float sl = scale * kLog2e;

  float dka[DW / 8][4], dva[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) load_q(step + 1, (step + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: this step has landed
    __syncthreads();
    const int st = step & 1;
    const bf16* sQ = ring + 2 * st * kQTile;
    const bf16* sdO = sQ + kQTile;
    const float* sL = sStats + 2 * st * QT;
    const float* sD = sL + QT;
    const int q0 = q_first + step % nq * QT;
    // warp-uniform: some query of the tile sees some key of this warp
    if (kw0 < Tn && (!causal || q0 + QT - 1 >= kw0)) {
      float pt[QT / 8][4], dsT[QT / 8][4];  // S^T -> P^T, dP^T -> dS^T
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[j][e] = dsT[j][e] = 0.f;
      product_abt<D, QT>(pt, sK, kr, sQ, lane);
      product_abt<D, QT>(dsT, sV, kr, sdO, lane);
      const bool need_mask = (causal && q0 < kw0 + 15) || q0 + QT > Tn;
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tig + (e & 1);  // query in the tile
          const int qp = q0 + col, kp = kw0 + gid + 8 * (e >> 1);
          float p = ex2(fmaf(pt[j][e], sl, -sL[col] * kLog2e));
          if (need_mask) p = (qp < Tn && (!causal || kp <= qp)) ? p : 0.f;
          pt[j][e] = p;
          dsT[j][e] = p * (dsT[j][e] - sD[col]);
        }
      }
      product_pv<D, QT, DW>(dva, pt, sdO, d0, lane);
      product_pv<D, QT, DW>(dka, dsT, sQ, d0, lane);
    }
    __syncthreads();  // this stage may be overwritten from here on
  }
  cp_async_wait<0>();

  const size_t n_all = (size_t)gridDim.z * Tn * KH * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kw0 + gid + 8 * i;
    if (kp >= Tn) continue;
    const size_t off = kv_base + (size_t)kp * kv_stride + d0 + 2 * tig;
    if (part != nullptr) {
      float* pk = part + (size_t)split * n_all + off;
      float* pv = part + (size_t)(splits + split) * n_all + off;
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        *reinterpret_cast<float2*>(pk + 8 * n) =
            make_float2(dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
        *reinterpret_cast<float2*>(pv + 8 * n) =
            make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
            pack_bf16(dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
            pack_bf16(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
  }
}

// dK and dV = the sum of the splits' f32 partials, in split order.
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ part, int splits, size_t n,
                 bf16* __restrict__ dk, bf16* __restrict__ dv) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += part[(size_t)s * n + i];
      c += part[(size_t)(splits + s) * n + i];
    }
    dk[i] = __float2bfloat16(a);
    dv[i] = __float2bfloat16(c);
  }
}

template <int D>
int launch_tile(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const bf16* dout, const float* lse, float* delta, bf16* dq,
                bf16* dk, bf16* dv, float* part, int splits, int B, int Tn,
                int H, int KH, int causal, float scale, cudaStream_t stream) {
  using S = BwdShape<D>;
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      dq_tile_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemQ));
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      dkdv_tile_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemKV));
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  const int rows = B * Tn * H;
  delta_kernel<bf16><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                       0, stream>>>(o, dout, delta, B, Tn, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = (Tn + S::kKVKeys - 1) / S::kKVKeys;
  dkdv_tile_kernel<D><<<dim3(kv_tiles, KH * splits, B), kTileThreads,
                        S::kSmemKV, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, splits > 1 ? part : nullptr, splits,
      Tn, H, KH, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t n = (size_t)B * Tn * KH * D;
    const size_t want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    split_sum_kernel<<<blocks, kThreads, 0, stream>>>(part, splits, n, dk, dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int q_tiles = (Tn + kQRows - 1) / kQRows;
  dq_tile_kernel<D><<<dim3(q_tiles, H, B), kTileThreads, S::kSmemQ, stream>>>(
      q, k, v, dout, lse, delta, dq, Tn, H, KH, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dQ, dK, dV of dense flash attention.  dtype: 0 = float32, 1 = bfloat16
// (q, k, v, o, dout and the three gradients alike); q, o, dout, dq
// (B, T, H, D); k, v, dk, dv (B, T, KH, D); lse (B, H, T) f32 from the
// forward; delta: f32 scratch of B * H * T.  D <= 256, H a multiple of KH.
// Returns the first nonzero cudaError_t of its three launches.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Tn, int H, int KH, int D,
                                   int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (KH <= 0 || H % KH != 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return by_head_dim<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Tn, H,
                              KH, D, causal, scale, s);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B,
                                      Tn, H, KH, D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core tiles (variant 1): bf16 q, k, v, o, dout and the three
// gradients; D 64, 80, 128 or 256.  splits: blocks a kv head's query heads
// are split over (1 to G); part: f32 scratch of 2 * splits * B * T * KH * D
// when splits > 1 (else unused).  Other arguments as flash_attention_bwd.
extern "C" int flash_attention_bwd_tile(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* part, int splits, int B, int Tn, int H, int KH, int D,
    int causal, float scale, void* stream) {
  if (KH <= 0 || H % KH != 0 || splits < 1 || splits > H / KH ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_BWD_TILE(DD)                                                   \
  return launch_tile<DD>(                                                    \
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),              \
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),              \
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),        \
      static_cast<float*>(delta), static_cast<bf16*>(dq),                    \
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),                        \
      static_cast<float*>(part), splits, B, Tn, H, KH, causal, scale,        \
      static_cast<cudaStream_t>(stream))
  switch (D) {
    case 64: REPRO_BWD_TILE(64);
    case 80: REPRO_BWD_TILE(80);
    case 128: REPRO_BWD_TILE(128);
    case 256: REPRO_BWD_TILE(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD_TILE
}
