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
// delta_kernel (Delta, one warp per (b, t, h) row) and, where the wrapper
// spreads a kv head's G query heads over `splits` dK/dV blocks (a GQA grid
// too short for the card), add the splits' f32 partials in split order
// (split_sum_kernel).
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
//    Rounding: P and dS are rounded to bf16 for their products (as
//    FlashAttention-2 does); S, dP, dP - Delta, the exponentials and every
//    accumulator stay f32.
// 2. The f32 tile (dq_f32_kernel, dkdv_f32_kernel), the exact path: f32 at
//    any D <= 256, and bf16 at the head dims the tensor-core tiles are not
//    built for.  Register-blocked FMA products on the CUDA cores, built
//    from the forward's f32 tile (attention_f32.cuh: its S micro-tile with
//    the d-split reduce-scatter, its P V column layout, the two-stage
//    cp.async ring with widening, key_pad, wide_rows).  Nothing rounds
//    below f32 and nothing uses TF32; bf16 inputs widen exactly in shared
//    memory and the gradients are stored in the input's dtype.
//    - dQ: rows are (position, group) pairs of one kv head, position-major
//      as in the forward, so K/V tiles serve all G query heads.  A warp owns
//      16 rows (8 past D 128), a CTA 64 (4 warps, 8 past D 128); where a
//      64-row grid would leave SMs idle only the first warp owns rows (16
//      or 8 a CTA) and the others share the copies.  The grid is 1-D, row
//      tile major: the heaviest causal tiles of every head go first, so
//      the last wave holds the lightest tiles.  Q and dO are widened once
//      into shared memory, each row's lse (in log2 units) and Delta sit in
//      registers.  K/V tiles of kKeys keys (32; 16 at D 128 and 256, where
//      32 would not leave two CTAs an SM, or at D 256 not fit) stream
//      through the ring up to the CTA's last row.  Per tile a warp
//      computes S = Q K^T and dP = dO V^T as the forward's S micro-tile (8
//      rows x 4 keys a lane over a d-slice, shuffle reduce-scatter), P =
//      2^(S scale log2e - lse log2e) (no running max: lse is known),
//      dS = P (dP - Delta) into the warp's own rows of shared memory (a
//      __syncwarp orders them), and dQ += dS K in the forward's P V layout
//      with K in V's place (8 rows x D / 16 columns a lane, keys in
//      order).  dQ is scaled and stored once.
//    - dK/dV: rows are the keys of one kv head, 64 a CTA (or one warp's)
//      in the same warp layout; a 1-D grid, key tile major (the first keys,
//      the heaviest causal tiles, of every head and split first).  Where
//      KH x B is small the wrapper spreads a kv head's query heads over
//      splits (to four waves of two CTAs an SM), which also evens out a
//      causal grid's unequal tiles.  K and V are widened once into shared
//      memory.  For each query head of the split, in order, tiles
//      of kKeys queries (under the causal mask only from the CTA's first
//      key on) stream Q, dO, lse and Delta through the ring.  S^T = K Q^T
//      and dP^T = V dO^T run as the same S micro-tile with keys as rows,
//      P^T and dS^T take per-column lse and Delta, and dV += P^T dO and
//      dK += dS^T Q run in the P V layout: two accumulators of 8 keys x D /
//      16 columns a lane (80 floats at D 80, 128 at D 128 and, with 8-key
//      warps, at D 256).
//    Shared memory a CTA (f32 rows padded as the forward's): dQ 79 KB at D
//    64, 95 at D 80, 107 at D 128, 199 at D 256; dK/dV 89, 105, 113 and
//    205 KB: two CTAs an SM up to D 128, one of 8 warps at D 256.  The
//    kernels take 208-255 registers a thread and spill nothing in f32
//    (ptxas -v); on bf16 inputs the dK/dV kernel spills 12-16 bytes at D
//    128 and 256, where bf16 normally takes the tensor-core tiles.
//    Bits.  Every accumulator adds its terms in one order (keys, or query
//    heads then queries, ascending), one FMA a term.  A masked or skipped
//    pair adds an exact zero, so which tiles a CTA or warp visits (its
//    bound, its first query tile) never changes a bit: 64-row and one-warp
//    CTAs give the same bits.
// Masking, both variants: rows and keys past T are zero-filled by
// cp.async's src-size 0 and never read; masked P and dS entries are set by
// a select; a warp that sees no (query, key) pair of a tile skips it.
// dQ, dK and dV are written once, in the input's dtype.
//
// What bounds it on an H100: the five products (S, dP, dV, dK, dQ) are 10 D
// flops per visible (query, key) pair and head, 2.5x the forward's 4 D,
// against the bytes of q, k, v, o, dO, lse and the three gradients, so it
// is bound by operations: the bf16 tensor-core peak (989 TFLOP/s) for bf16
// inputs, the f32 FMA rate (67 TFLOP/s) for the f32 tile.  Both variants
// recompute S and dP in each of their two kernels (7 products where 5
// would do: 14 D flops a pair), and so do the tiles' split warps at D 256.
// The tensor-core tiles run on mma.sync, a fraction of the tensor-core
// peak that only wgmma reaches (with K/V through TMA: later work, as for
// the forward).  The f32 tile's products read 12 shared words per 32 FMAs
// (S and dP) and 12 per 32 to 16 per 64 (the P V products), as the
// forward's tile; each kernel holds 40-52% of the FMA rate at the
// training shapes (two CTAs of 4 warps an SM, 255 registers), so the
// 14 D flops of its two kernels take about 3x the operations bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_f32.cuh"
#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 256;  // delta_kernel's and split_sum_kernel's blocks

using attn_f32::store_f32;
using attn_f32::to_f32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Delta (B, H, T) = rowsum(dO * O), one warp a row.
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

template <typename T>
cudaError_t launch_delta(const T* o, const T* dout, float* delta, int B,
                         int Tn, int H, int D, cudaStream_t stream) {
  const int rows = B * Tn * H;
  delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                    stream>>>(o, dout, delta, B, Tn, H, D);
  return cudaGetLastError();
}

// dK and dV = the sum of the splits' f32 partials, in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ part, int splits, size_t n,
                 T* __restrict__ dk, T* __restrict__ dv) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += part[(size_t)s * n + i];
      c += part[(size_t)(splits + s) * n + i];
    }
    store_f32(dk + i, a);
    store_f32(dv + i, c);
  }
}

template <typename T>
cudaError_t launch_split_sum(const float* part, int splits, size_t n, T* dk,
                             T* dv, cudaStream_t stream) {
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  split_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(part, splits, n, dk, dv);
  return cudaGetLastError();
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
  cudaError_t err = launch_delta<bf16>(o, dout, delta, B, Tn, H, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = (Tn + S::kKVKeys - 1) / S::kKVKeys;
  dkdv_tile_kernel<D><<<dim3(kv_tiles, KH * splits, B), kTileThreads,
                        S::kSmemKV, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, splits > 1 ? part : nullptr, splits,
      Tn, H, KH, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    err = launch_split_sum<bf16>(part, splits, (size_t)B * Tn * KH * D, dk, dv,
                                 stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int q_tiles = (Tn + kQRows - 1) / kQRows;
  dq_tile_kernel<D><<<dim3(q_tiles, H, B), kTileThreads, S::kSmemQ, stream>>>(
      q, k, v, dout, lse, delta, dq, Tn, H, KH, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ 2. f32 tile
using attn_f32::kStages;

// The f32 tile's geometry at a padded head dim DP for CTAs whose first
// kRowWarps warps own rows (all of them, 64 rows, or one), storage type T.
// As attn_f32::Shape, with tiles of kKeys streamed rows (keys in dQ,
// queries in dK/dV) and, for load_kv and widen, the same member names.
//   S: lane = kDS d-slices x (kNRB 8-row blocks x kNKB blocks of 4 columns).
//   P V: lane = kNRB 8-row blocks x kNCG column groups; a lane's columns are
//   float4s at 4 cg + 4 kNCG m, then single columns at 4 kNCG kF4 + cg.
template <int DP, int kRowWarps, typename T>
struct F32Bwd {
  static_assert(DP % 16 == 0 && DP <= attn_f32::kMaxDim, "padded head dim: 16 | DP <= 256");
  static constexpr int kDP = DP;
  static constexpr int kWR = DP > 128 ? 8 : 16;      // rows a warp
  static constexpr int kThreads = 32 * attn_f32::full_warps<DP>();
  static constexpr int kRows = kWR * kRowWarps;        // rows a CTA
  static constexpr int kKeys = DP >= 128 ? 16 : 32;    // rows a streamed tile
  static constexpr int kRN = 4;                        // columns a lane in S
  static constexpr int kNRB = kWR / 8;                 // 8-row blocks a warp
  static constexpr int kNKB = kKeys / kRN;             // column blocks
  static constexpr int kDS = 32 / (kNRB * kNKB);       // d-slices
  static constexpr int kRPL = 8 / kDS;                 // S rows a lane keeps
  static constexpr int kNCG = 32 / kNRB;               // column groups in P V
  static constexpr int kF4 = DP / (4 * kNCG);          // float4 columns a lane
  static constexpr int kR1 = (DP - 4 * kNCG * kF4) / kNCG;  // single columns
  static constexpr int kF4n = kF4 > 0 ? kF4 : 1;       // (array extents)
  static constexpr int kR1n = kR1 > 0 ? kR1 : 1;
  static constexpr int kQS = DP + 4;                   // floats a resident row
  static constexpr int kKS = DP + attn_f32::key_pad(DP, kDS);  // a streamed row
  static constexpr int kPS = kKeys + 4;                // floats a P or dS row
  static_assert(kDS * kNRB * kNKB == 32 && kDS <= 8 && (DP / 4) % kDS == 0,
                "a warp's lanes cover its S tile");
  static_assert(4 * kNCG * kF4 + kNCG * kR1 == DP, "a warp's lanes cover its rows");
  static constexpr bool kWiden = !std::is_same<T, float>::value;
  static constexpr bool kQ8 = false;
  static constexpr int kRaw = DP * (int)sizeof(T);   // bytes a raw row (16 | kRaw)
  static constexpr size_t kTileF = sizeof(float) * kKeys * kKS;
  static constexpr size_t kRingTile = kWiden ? (size_t)kKeys * kRaw : kTileF;
  static constexpr size_t kRing = kStages * 2 * kRingTile + (kWiden ? 2 * kTileF : 0);
  static constexpr size_t kResident = sizeof(float) * kRows * kQS;  // one row set
  static constexpr size_t kPTile = sizeof(float) * kRows * kPS;
  // dQ: ring, Q and dO, dS; dK/dV: ring, K and V, P^T and dS^T, the ring's
  // lse and Delta
  static constexpr size_t kBytesQ = kRing + 2 * kResident + kPTile;
  static constexpr size_t kBytesKV =
      kRing + 2 * kResident + 2 * kPTile + sizeof(float) * kStages * 2 * kKeys;
};

// CTAs an SM the f32 tile is built for: two up to D 128, one of 8 warps
// at D 256 (shared memory allows no more).
template <int DP>
__host__ __device__ constexpr int bwd_min_blocks() { return DP > 128 ? 1 : 2; }

// Rows kp of x (and y) at off + kp * stride: load_kv's source for the
// streamed tiles (K and V in dQ, Q and dO in dK/dV).
template <typename T>
struct Stream {
  using KV = T;
  const T* x;
  const T* y;
  const void* base;
  size_t off, stride;
  int D;
  __device__ const T* k_row(int kp) const { return x + off + (size_t)kp * stride; }
  __device__ const T* v_row(int kp) const { return y + off + (size_t)kp * stride; }
};

// a[i][j] = sum over this lane's d-slice of A(arow + i) . B(kb + kNKB j),
// A rows of S::kQS floats (resident), B rows of S::kKS (streamed); the
// forward's S micro-tile.  Then the reduce-scatter over the slices leaves
// a[0 .. kRPL) the full products of rows arow + kRPL * slice + i.
template <class S>
__device__ __forceinline__ void micro_s(float (&a)[8][S::kRN], const float* sA,
                                        int arow, const float* sB, int kb,
                                        int slice, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < S::kRN; ++j) a[i][j] = 0.f;
#pragma unroll 2
  for (int step = 0; step < S::kDP / (4 * S::kDS); ++step) {
    const int c = 4 * (S::kDS * step + slice);
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = *reinterpret_cast<const float4*>(sA + (arow + i) * S::kQS + c);
#pragma unroll
    for (int j = 0; j < S::kRN; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(sB + (kb + S::kNKB * j) * S::kKS + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[i][j] = fmaf(x[i].x, y.x, a[i][j]);
        a[i][j] = fmaf(x[i].y, y.y, a[i][j]);
        a[i][j] = fmaf(x[i].z, y.z, a[i][j]);
        a[i][j] = fmaf(x[i].w, y.w, a[i][j]);
      }
    }
  }
  attn_f32::scatter_rows<S::kDS / 2, 8, S::kRN>(a, lane);
}

// o(orow + i, the lane's columns) += sum_c P(orow + i, c) X(c, columns) over
// the kKeys columns of P (rows of S::kPS floats) and rows of X (S::kKS),
// c in order; the forward's P V product.
template <class S>
__device__ __forceinline__ void micro_pv(float4 (&o4)[8][S::kF4n],
                                         float (&o1)[8][S::kR1n],
                                         const float* sP, int orow,
                                         const float* sX, int cg) {
#pragma unroll 2
  for (int c4 = 0; c4 < S::kKeys / 4; ++c4) {
    float4 pr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      pr[i] = *reinterpret_cast<const float4*>(sP + (orow + i) * S::kPS + 4 * c4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* xrow = sX + (4 * c4 + cc) * S::kKS;
      float4 x4[S::kF4n];
      float x1[S::kR1n];
#pragma unroll
      for (int c = 0; c < S::kF4; ++c)
        x4[c] = *reinterpret_cast<const float4*>(xrow + 4 * cg + 4 * S::kNCG * c);
#pragma unroll
      for (int c = 0; c < S::kR1; ++c)
        x1[c] = xrow[4 * S::kNCG * S::kF4 + cg + S::kNCG * c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = attn_f32::lane4(pr[i], cc);
#pragma unroll
        for (int c = 0; c < S::kF4; ++c) {
          o4[i][c].x = fmaf(p, x4[c].x, o4[i][c].x);
          o4[i][c].y = fmaf(p, x4[c].y, o4[i][c].y);
          o4[i][c].z = fmaf(p, x4[c].z, o4[i][c].z);
          o4[i][c].w = fmaf(p, x4[c].w, o4[i][c].w);
        }
#pragma unroll
        for (int c = 0; c < S::kR1; ++c) o1[i][c] = fmaf(p, x1[c], o1[i][c]);
      }
    }
  }
}

template <class S>
__device__ __forceinline__ void zero(float4 (&o4)[8][S::kF4n],
                                     float (&o1)[8][S::kR1n]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < S::kF4n; ++c) o4[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < S::kR1n; ++c) o1[i][c] = 0.f;
  }
}

// dst[d] = x * mul for the lane's columns d < D of one row.
template <class S, typename T>
__device__ __forceinline__ void store_row(T* dst, const float4 (&o4)[S::kF4n],
                                          const float (&o1)[S::kR1n],
                                          float mul, int cg, int D) {
#pragma unroll
  for (int c = 0; c < S::kF4; ++c) {
    const int d = 4 * cg + 4 * S::kNCG * c;
    if (d < D) store_f32(dst + d, o4[c].x * mul);
    if (d + 1 < D) store_f32(dst + d + 1, o4[c].y * mul);
    if (d + 2 < D) store_f32(dst + d + 2, o4[c].z * mul);
    if (d + 3 < D) store_f32(dst + d + 3, o4[c].w * mul);
  }
#pragma unroll
  for (int c = 0; c < S::kR1; ++c) {
    const int d = 4 * S::kNCG * S::kF4 + cg + S::kNCG * c;
    if (d < D) store_f32(dst + d, o1[c] * mul);
  }
}

// Stage t's streamed tiles: X at ring tile 2 s, Y at 2 s + 1, or the widened
// copies of both (every thread calls it after the stage has landed).
template <class S, typename T>
__device__ __forceinline__ void stage_tiles(char* ring, int t, const float*& sX,
                                            const float*& sY) {
  const int st = t & 1;
  char* rx = ring + (2 * st) * S::kRingTile;
  char* ry = ring + (2 * st + 1) * S::kRingTile;
  if constexpr (S::kWiden) {
    float* wx = reinterpret_cast<float*>(ring + kStages * 2 * S::kRingTile);
    float* wy = wx + S::kKeys * S::kKS;
    attn_f32::widen<S, T>(rx, nullptr, wx);
    attn_f32::widen<S, T>(ry, nullptr, wy);
    __syncthreads();
    sX = wx;
    sY = wy;
  } else {
    sX = reinterpret_cast<const float*>(rx);
    sY = reinterpret_cast<const float*>(ry);
  }
}

// dQ of the CTA's rows: (position, group) pairs [row0, row0 + kRows) of one
// kv head, summed over the K/V tiles up to the CTA's last row.  Block i is
// row tile i / (KH B) of (batch row, kv head) i % (KH B): heaviest causal
// tiles (the last rows) of every head first.
template <int DP, int W, typename T>
__global__ void __launch_bounds__(32 * attn_f32::full_warps<DP>(), bwd_min_blocks<DP>())
dq_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int B, int Tn, int H, int KH, int D,
              int causal, float scale, int copy) {
  using S = F32Bwd<DP, W, T>;
  constexpr int kKeys = S::kKeys, kRN = S::kRN, kRPL = S::kRPL;
  constexpr int kNKB = S::kNKB, kDS = S::kDS;
  extern __shared__ int4 f32_smem[];
  char* ring = reinterpret_cast<char*>(f32_smem);
  float* sQ = reinterpret_cast<float*>(ring + S::kRing);
  float* sdO = sQ + S::kRows * S::kQS;
  float* sP = sdO + S::kRows * S::kQS;  // dS, the warp's own rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x % (KH * B) / KH, kh = blockIdx.x % KH;
  const int G = H / KH, rows = Tn * G;
  const int tiles = (rows + S::kRows - 1) / S::kRows;
  const int tile = causal ? tiles - 1 - blockIdx.x / (KH * B)
                          : blockIdx.x / (KH * B);
  const int row0 = tile * S::kRows;
  const int kend = causal ? (min(row0 + S::kRows, rows) - 1) / G + 1 : Tn;
  const bool rowed = warp < W;  // else the warp only copies
  const int wrow = warp * S::kWR;
  const int slice = lane % kDS;
  const int kb = lane / kDS % kNKB;
  const int arow = wrow + 8 * (lane / (kDS * kNKB));
  const int srow = arow + kRPL * slice;
  const int orow = wrow + 8 * (lane / S::kNCG);
  const int cg = lane % S::kNCG;
  // row r of the kv head: position r / G, query head kh * G + r % G
  auto qoff = [&](int r) {
    return (((size_t)b * Tn + r / G) * H + (size_t)kh * G + r % G) * D;
  };
  auto soff = [&](int r) {  // its lse and Delta
    return ((size_t)b * H + (size_t)kh * G + r % G) * Tn + r / G;
  };

  const Stream<T> kv{k, v, k, (size_t)b * Tn * KH * D + (size_t)kh * D,
                     (size_t)KH * D, D};
  auto load = [&](int t) {
    const int st = t & 1;
    attn_f32::load_kv<S>(kv, t * kKeys, kend, copy,
                         ring + (2 * st) * S::kRingTile,
                         ring + (2 * st + 1) * S::kRingTile, nullptr, nullptr);
  };
  const int ntiles = (kend + kKeys - 1) / kKeys;
  if (ntiles > 0) load(0);
  attn_tile::cp_async_commit();
  // Q and dO as f32, zeros past D and past the rows
  for (int e = tid; e < S::kRows * DP; e += S::kThreads) {
    const int r = e / DP, d = e % DP;
    const bool ok = row0 + r < rows && d < D;
    const size_t off = ok ? qoff(row0 + r) + d : 0;
    sQ[r * S::kQS + d] = ok ? to_f32(q[off]) : 0.f;
    sdO[r * S::kQS + d] = ok ? to_f32(dout[off]) : 0.f;
  }
  // the lane's S rows: position (-1: none), lse in log2 units, Delta
  int rpos[kRPL];
  float l2[kRPL], dl[kRPL];
#pragma unroll
  for (int i = 0; i < kRPL; ++i) {
    const int r = row0 + srow + i;
    const bool ok = rowed && r < rows;
    rpos[i] = ok ? (causal ? r / G : Tn - 1) : -1;
    l2[i] = ok ? __fmul_rn(lse[soff(r)], attn_f32::kLog2e) : 0.f;
    dl[i] = ok ? delta[soff(r)] : 0.f;
  }
  int wmax = rpos[0], wmin = rpos[0];
#pragma unroll
  for (int i = 1; i < kRPL; ++i) {
    wmax = max(wmax, rpos[i]);
    wmin = min(wmin, rpos[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
  }
  const float sl = scale * attn_f32::kLog2e;  // scores in log2 units

  float4 o4[8][S::kF4n];
  float o1[8][S::kR1n];
  zero<S>(o4, o1);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);  // its stage was freed by tile t - 1
    attn_tile::cp_async_commit();
    attn_tile::cp_async_wait<1>();  // every group but the newest: tile t is in
    __syncthreads();
    const float* sK;
    const float* sV;
    stage_tiles<S, T>(ring, t, sK, sV);
    const int k0 = t * kKeys;
    if (k0 <= wmax) {  // warp-uniform: some row of this warp sees the tile
      float s[8][kRN], dp[8][kRN];
      micro_s<S>(s, sQ, arow, sK, kb, slice, lane);
      micro_s<S>(dp, sdO, arow, sV, kb, slice, lane);
      const bool need_mask = k0 + kKeys - 1 > wmin || k0 + kKeys > kend;
#pragma unroll
      for (int i = 0; i < kRPL; ++i) {
        float* prow = sP + (srow + i) * S::kPS + kb;
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          float p = attn_tile::ex2(__fmul_rn(s[i][j], sl) - l2[i]);
          if (need_mask) {
            const int kp = k0 + kb + kNKB * j;
            p = (kp <= rpos[i] && kp < kend) ? p : 0.f;
          }
          prow[kNKB * j] = p * (dp[i][j] - dl[i]);  // dS
        }
      }
      __syncwarp();  // the warp's dS rows are written; the warp reads them
      micro_pv<S>(o4, o1, sP, orow, sK, cg);
    }
    __syncthreads();  // this stage and dS may be overwritten from here on
  }
  attn_tile::cp_async_wait<0>();
  if (!rowed) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + orow + i;
    if (r < rows) store_row<S>(dq + qoff(r), o4[i], o1[i], scale, cg, D);
  }
}

// dK and dV of the CTA's keys [k0, k0 + kRows) of one kv head, summed over
// the query heads of its split and every query tile that sees them.  Block
// i is key tile i / (KH splits B) of (batch row, kv head, split) i % (KH
// splits B): heaviest causal tiles (the first keys) of every head first.
// With part null the CTA writes the gradients; else f32 partials at part
// (dK of split s at [s], dV at [splits + s], each B * T * KH * D floats).
template <int DP, int W, typename T>
__global__ void __launch_bounds__(32 * attn_f32::full_warps<DP>(), bwd_min_blocks<DP>())
dkdv_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                int splits, int B, int Tn, int H, int KH, int D, int causal,
                float scale, int copy) {
  using S = F32Bwd<DP, W, T>;
  constexpr int kKeys = S::kKeys, kRN = S::kRN, kRPL = S::kRPL;
  constexpr int kNKB = S::kNKB, kDS = S::kDS;
  extern __shared__ int4 f32_smem[];
  char* ring = reinterpret_cast<char*>(f32_smem);
  float* sK = reinterpret_cast<float*>(ring + S::kRing);
  float* sV = sK + S::kRows * S::kQS;
  float* sPt = sV + S::kRows * S::kQS;  // P^T and dS^T, the warp's own rows
  float* sdSt = sPt + S::kRows * S::kPS;
  float* sStat = sdSt + S::kRows * S::kPS;  // stage s: lse at [2 s], Delta at [2 s + 1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int heads = KH * splits;
  const int b = blockIdx.x % (heads * B) / heads;
  const int kh = blockIdx.x % heads / splits, split = blockIdx.x % splits;
  const int G = H / KH;
  const int per = (G + splits - 1) / splits;
  const int g0 = split * per, g1 = min(G, g0 + per);
  const int k0 = blockIdx.x / (heads * B) * S::kRows;
  const bool rowed = warp < W;  // else the warp only copies
  const int wrow = warp * S::kWR;
  const int kw0 = k0 + wrow;  // the warp's first key
  const int slice = lane % kDS;
  const int kb = lane / kDS % kNKB;
  const int arow = wrow + 8 * (lane / (kDS * kNKB));
  const int srow = arow + kRPL * slice;
  const int orow = wrow + 8 * (lane / S::kNCG);
  const int cg = lane % S::kNCG;
  const size_t kv_stride = (size_t)KH * D;
  const size_t kv_base = (size_t)b * Tn * kv_stride + (size_t)kh * D;

  // under the causal mask, queries before the CTA's first key see none
  const int q_first = causal ? k0 : 0;
  const int nq = (Tn - q_first + kKeys - 1) / kKeys;  // query tiles a head
  const int nsteps = (g1 - g0) * nq;
  auto load = [&](int step) {
    const int st = step & 1;
    const int h = kh * G + g0 + step / nq;
    const int q0 = q_first + step % nq * kKeys;
    const Stream<T> qd{q, dout, q, ((size_t)b * Tn * H + h) * D, (size_t)H * D,
                       D};
    attn_f32::load_kv<S>(qd, q0, Tn, copy, ring + (2 * st) * S::kRingTile,
                         ring + (2 * st + 1) * S::kRingTile, nullptr, nullptr);
    if (tid < kKeys) {
      const int r = q0 + tid;
      const bool ok = r < Tn;
      const size_t row = ((size_t)b * H + h) * Tn + (ok ? r : 0);
      attn_tile::cp_async4(sStat + (2 * st) * kKeys + tid, lse + row, ok);
      attn_tile::cp_async4(sStat + (2 * st + 1) * kKeys + tid, delta + row, ok);
    }
  };
  if (nsteps > 0) load(0);
  attn_tile::cp_async_commit();
  // K and V as f32, zeros past D and past T
  for (int e = tid; e < S::kRows * DP; e += S::kThreads) {
    const int r = e / DP, d = e % DP;
    const bool ok = k0 + r < Tn && d < D;
    const size_t off = ok ? kv_base + (size_t)(k0 + r) * kv_stride + d : 0;
    sK[r * S::kQS + d] = ok ? to_f32(k[off]) : 0.f;
    sV[r * S::kQS + d] = ok ? to_f32(v[off]) : 0.f;
  }
  const float sl = scale * attn_f32::kLog2e;  // scores in log2 units

  float4 dk4[8][S::kF4n], dv4[8][S::kF4n];
  float dk1[8][S::kR1n], dv1[8][S::kR1n];
  zero<S>(dk4, dk1);
  zero<S>(dv4, dv1);
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) load(step + 1);  // its stage was freed by step - 1
    attn_tile::cp_async_commit();
    attn_tile::cp_async_wait<1>();  // every group but the newest: step is in
    __syncthreads();
    const float* sQ;
    const float* sdO;
    stage_tiles<S, T>(ring, step, sQ, sdO);
    const float* sL = sStat + 2 * (step & 1) * kKeys;
    const float* sD = sL + kKeys;
    const int q0 = q_first + step % nq * kKeys;
    // warp-uniform: some query of the tile sees some key of this warp
    if (rowed && kw0 < Tn && (!causal || q0 + kKeys - 1 >= kw0)) {
      float st[8][kRN], dpt[8][kRN];  // S^T -> P^T, dP^T -> dS^T
      micro_s<S>(st, sK, arow, sQ, kb, slice, lane);
      micro_s<S>(dpt, sV, arow, sdO, kb, slice, lane);
      const bool need_mask = (causal && q0 < kw0 + S::kWR - 1) ||
                             q0 + kKeys > Tn || kw0 + S::kWR > Tn;
      float l2[kRN], dl[kRN];
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        l2[j] = __fmul_rn(sL[kb + kNKB * j], attn_f32::kLog2e);
        dl[j] = sD[kb + kNKB * j];
      }
#pragma unroll
      for (int i = 0; i < kRPL; ++i) {
        const int kp = k0 + srow + i;
        float* prow = sPt + (srow + i) * S::kPS + kb;
        float* drow = sdSt + (srow + i) * S::kPS + kb;
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          float p = attn_tile::ex2(__fmul_rn(st[i][j], sl) - l2[j]);
          if (need_mask) {
            const int qp = q0 + kb + kNKB * j;
            p = (qp < Tn && kp < Tn && (!causal || kp <= qp)) ? p : 0.f;
          }
          prow[kNKB * j] = p;
          drow[kNKB * j] = p * (dpt[i][j] - dl[j]);
        }
      }
      __syncwarp();  // the warp's P^T and dS^T rows are written
      micro_pv<S>(dv4, dv1, sPt, orow, sdO, cg);
      micro_pv<S>(dk4, dk1, sdSt, orow, sQ, cg);
    }
    __syncthreads();  // this stage, P^T and dS^T may be overwritten from here on
  }
  attn_tile::cp_async_wait<0>();
  if (!rowed) return;
  const size_t n_all = (size_t)B * Tn * kv_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kp = k0 + orow + i;
    if (kp >= Tn) continue;
    const size_t off = kv_base + (size_t)kp * kv_stride;
    if (part != nullptr) {
      store_row<S>(part + (size_t)split * n_all + off, dk4[i], dk1[i], scale,
                   cg, D);
      store_row<S>(part + (size_t)(splits + split) * n_all + off, dv4[i],
                   dv1[i], 1.f, cg, D);
    } else {
      store_row<S>(dk + off, dk4[i], dk1[i], scale, cg, D);
      store_row<S>(dv + off, dv4[i], dv1[i], 1.f, cg, D);
    }
  }
}

// Arguments of one f32-tile backward.
template <typename T>
struct F32Args {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dq;
  T* dk;
  T* dv;
  float* part;
  int splits, B, Tn, H, KH, D, causal;
  float scale;
  cudaStream_t stream;
};

template <int DP, int W, typename T>
cudaError_t launch_dkdv_f32(const F32Args<T>& a, int copy) {
  using S = F32Bwd<DP, W, T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkdv_f32_kernel<DP, W, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kBytesKV));
  if (attr != cudaSuccess) return attr;
  const int tiles = (a.Tn + S::kRows - 1) / S::kRows;
  dkdv_f32_kernel<DP, W, T>
      <<<tiles * a.KH * a.splits * a.B, S::kThreads, S::kBytesKV, a.stream>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv,
          a.splits > 1 ? a.part : nullptr, a.splits, a.B, a.Tn, a.H, a.KH, a.D,
          a.causal, a.scale, copy);
  return cudaGetLastError();
}

template <int DP, int W, typename T>
cudaError_t launch_dq_f32(const F32Args<T>& a, int copy) {
  using S = F32Bwd<DP, W, T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_f32_kernel<DP, W, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kBytesQ));
  if (attr != cudaSuccess) return attr;
  const int tiles = (a.Tn * (a.H / a.KH) + S::kRows - 1) / S::kRows;
  dq_f32_kernel<DP, W, T>
      <<<tiles * a.KH * a.B, S::kThreads, S::kBytesQ, a.stream>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.B, a.Tn, a.H, a.KH,
          a.D, a.causal, a.scale, copy);
  return cudaGetLastError();
}

// dK/dV (and the split sum), then dQ.  wide: 1 64-row CTAs, 0 one warp's
// rows, -1 as attn_f32::wide_rows chooses for each kernel's grid.
template <int DP, typename T>
cudaError_t launch_f32(const F32Args<T>& a, int wide) {
  constexpr int kFull = attn_f32::full_warps<DP>();
  const size_t row_bytes = (size_t)a.D * sizeof(T);
  const int G = a.H / a.KH;
  const bool kv_wide =
      wide < 0 ? attn_f32::wide_rows(a.Tn, a.KH * a.splits * a.B) : wide != 0;
  const int copy_qd = attn_f32::copy_width(a.q, a.dout, row_bytes);
  cudaError_t err = kv_wide ? launch_dkdv_f32<DP, kFull, T>(a, copy_qd)
                            : launch_dkdv_f32<DP, 1, T>(a, copy_qd);
  if (err != cudaSuccess) return err;
  if (a.splits > 1) {
    err = launch_split_sum<T>(a.part, a.splits, (size_t)a.B * a.Tn * a.KH * a.D,
                              a.dk, a.dv, a.stream);
    if (err != cudaSuccess) return err;
  }
  const bool q_wide =
      wide < 0 ? attn_f32::wide_rows(a.Tn * G, a.KH * a.B) : wide != 0;
  const int copy_kv = attn_f32::copy_width(a.k, a.v, row_bytes);
  return q_wide ? launch_dq_f32<DP, kFull, T>(a, copy_kv)
                : launch_dq_f32<DP, 1, T>(a, copy_kv);
}

template <typename T>
int f32_bwd(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const float* lse, float* delta, void* dq,
            void* dk, void* dv, float* part, int splits, int B, int Tn, int H,
            int KH, int D, int causal, float scale, int wide,
            cudaStream_t stream) {
  const F32Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(dout),
                     lse, delta, static_cast<T*>(dq), static_cast<T*>(dk),
                     static_cast<T*>(dv), part, splits, B, Tn, H, KH, D,
                     causal, scale, stream};
  cudaError_t err = launch_delta<T>(static_cast<const T*>(o), a.dout, delta, B,
                                    Tn, H, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (attn_f32::padded_dim(D)) {
    case 64: return static_cast<int>(launch_f32<64, T>(a, wide));
    case 80: return static_cast<int>(launch_f32<80, T>(a, wide));
    case 128: return static_cast<int>(launch_f32<128, T>(a, wide));
    case 256: return static_cast<int>(launch_f32<256, T>(a, wide));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The f32 tile (variant 2).  dtype: 0 = float32, 1 = bfloat16 (q, k, v, o,
// dout and the three gradients alike); q, o, dout, dq (B, T, H, D); k, v,
// dk, dv (B, T, KH, D); lse (B, H, T) f32 from the forward; delta: f32
// scratch of B * H * T.  D <= 256, H a multiple of KH.  splits: dK/dV
// blocks a kv head's query heads are spread over (1 to G); part: f32
// scratch of 2 * splits * B * T * KH * D when splits > 1 (else unused).
// wide: 1 64-row CTAs, 0 one warp's rows, -1 chosen by the grid (the
// results are the same bits).  Returns the first nonzero cudaError_t of
// its launches.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   void* part, int splits, int B, int Tn,
                                   int H, int KH, int D, int causal,
                                   float scale, int wide, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  if (KH <= 0 || H % KH != 0 || D <= 0 || D > attn_f32::kMaxDim ||
      splits < 1 || splits > H / KH || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return f32_bwd<float>(q, k, v, o, dout, l, dl, dq, dk, dv, pt, splits, B,
                          Tn, H, KH, D, causal, scale, wide, s);
  if (dtype == 1)
    return f32_bwd<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, pt,
                                  splits, B, Tn, H, KH, D, causal, scale, wide,
                                  s);
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
