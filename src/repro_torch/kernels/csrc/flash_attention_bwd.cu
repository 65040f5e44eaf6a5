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
// Three kernels, no atomics, so every sum runs in one fixed order and the
// result is deterministic:
//   1. delta_kernel: Delta, one warp per (b, t, h) row.
//   2. dkdv_kernel: one block per (key tile, kv head, b).  It holds the
//      tile's K and V in shared memory and its dK and dV sums in registers,
//      and walks every query tile of each of the G query heads of its kv
//      head (under the causal mask only the tiles at or below the diagonal),
//      recomputing S, P, dP and dS for each.
//   3. dq_kernel: one block per (query tile, head, b), heaviest causal tiles
//      first; it holds Q, dO and its dQ sum and walks the key tiles up to its
//      last row (all of them without the mask).
// Every product is an f32 product of tiles staged in shared memory as f32
// (bf16 inputs widen exactly), by a 16 x 16 thread grid whose threads each
// own a micro tile of the output (rows ty + 16 i, columns tx + 16 j).  Rows
// of the Q, K, V and dO tiles are padded to an odd stride, so the 16
// threads of a half-warp reading one column of 16 rows hit 16 banks.
// Head dims are padded with zeros to DP, a multiple of 16 (80 stays 80).
// Tiles are 64 rows (query rows and keys) up to DP 128, 32 past it.
// Masked entries of P and dS are set to 0 by a select; rows and keys past
// T are zero-filled and never written.  dQ, dK and dV are written once, in
// the input's dtype.
//
// What bounds it on an H100: the five products (S, dP, dV, dK, dQ) are 10 D
// flops per visible (query, key) pair and head, 2.5x the forward's 4 D,
// against the bytes of q, k, v, o, dO, lse and the three gradients, so it
// is bound by operations: the bf16 tensor-core peak (989 TFLOP/s) for bf16
// inputs, the f32 rate (67 TFLOP/s) for f32.  This first version runs on
// the CUDA cores in f32 and recomputes S and dP in both kernels (7 products
// where 5 would do), so it runs far from the bf16 bound; a tensor-core
// version (mma or wgmma, K and V through TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
