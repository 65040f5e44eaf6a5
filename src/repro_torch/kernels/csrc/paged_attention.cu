// Paged chunk attention through block tables, for sm_90a.
//
// Replaces the Pallas TPU kernels of repro/kernels/paged_attention.py:
// paged_attention_chunk (:148, body _chunk_kernel_body :57, decode wrapper
// paged_attention :227) and its int8 variant _paged_chunk_kernel_q8
// (:129).  Each query row (one of the C*G rows of a request's chunk for
// one kv head) attends, with an online softmax, over the pool tokens its
// block table names at absolute positions <= its own.  Only the first
// num_live[b] table slots are walked: the loop bound takes the place of
// the TPU index-map clamp, so dead slots are neither read nor computed.
// An all-masked row writes 0 (the max(l, 1e-30) guard of the TPU kernel).
//
// Three variants; the wrapper (paged_attention.py: choose_variant) picks
// one from the query type, the pool type, C*G, D and bs:
//
// 1. Tensor-core tile (paged_tile_kernel), bf16 q over bf16 or int8 pages
//    with C*G >= 16: prefill and mixed chunks.  The shared tile of
//    attention_tile.cuh, with each 64-key tile gathered key by key through
//    the table (a page of one kv head is a (bs, D) box of row stride
//    KH*D; a D = 80 row is 160 B in bf16 and 80 B in int8, both whole
//    16-byte chunks).  The walk bound is min(num_live[b], deepest block
//    any row of the tile sees), so the bounded and the unbounded walk
//    visit the same tiles.  Bound on an H100: tensor-core operations for
//    a long chunk (4*D flops per visible pair, re-reading the pages once
//    per 64-row tile), HBM bytes for a short one.
//
// 2. Split-KV decode (paged_split_kernel + split_combine_kernel), every
//    query type, C*G < 16: decode steps, where one query row per kv head
//    leaves a tensor-core tile 15/16 empty.  Decode is bound by HBM bytes
//    (each live page read once per (request, kv head): 3.35 TB/s), so the
//    work is spread over the pages: the grid is (splits, KH, B), a split
//    being a fixed run of pages_per_split table slots counted from slot 0
//    (its boundaries depend on the table width, bs and D alone, never on num_live or the walk bound: the wrapper's split_plan
//    gives a split 128 keys, or 64 at D 256, where 128 keys of f32 K and V
//    would not fit in shared memory; every pool type takes the same cut,
//    so the fused int8 walk equals the walk over dequantized pools).  A split copies its K and V rows into
//    shared memory with cp.async, all at once, while it loads q; scores,
//    P and the partial accumulator are f32 on the CUDA cores; it writes
//    (m, l, acc) to f32 scratch.  A split past the bound writes
//    (m = -1e30, l = 0, acc = 0), an exact no-op in the combine, so the
//    bounded and unbounded walks give identical bits.  The combine kernel
//    merges each row's splits in split order (deterministic) and applies
//    the max(l, 1e-30) guard.
//
// 3. The f32 tile (paged_f32_kernel), the exact path: an f32 q with
//    C*G >= 16, and every shape the other two do not take (fp16 or f32
//    pages under a bf16 q, head dims the tensor-core tile is not built for,
//    decode rows whose D does not divide by 16 or whose page is wider than a
//    split).  The register-blocked FMA tile of attention_f32.cuh: 64 query
//    rows a CTA (decode rows fill only its first warp's), K/V tiles of 32
//    keys gathered key by key through the table into a two-stage cp.async
//    ring, so bs does not bound shared memory; S and P V as f32 FMA
//    micro-tiles, one online softmax rescale per key tile.  The walk bound is min(num_live[b] * bs, the deepest
//    position any row of the CTA sees + 1): keys past it are zero-filled
//    and never read, and the bounded and unbounded walks visit the same
//    tiles.  Bound on an H100: the f32 FMA rate (67 TFLOP/s) for a chunk,
//    4*D flops per visible pair.
//
// Storage types.  The query is f32 or bf16; the pools are f32, fp16, bf16
// or int8.  In the split and f32 variants every pool type becomes f32
// as it is read, an int8 code as __fmul_rn(float(code), scale) with the
// (block, kv head) scale read through the same table entry as the page
// (k_scales[tables[b, j] * KH + h]): the same rounding as
// quant.dequantize_pool, so with an f32 q the fused kernel equals the
// kernel on materialized dequantized pools bitwise.  The tile variant folds
// the scales instead (attention_tile.cuh).  A dead slot's scale is never
// read in any variant.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_f32.cuh"
#include "attention_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;
constexpr int kSplitKeys = 128;  // keys one split covers at most
constexpr int kSplitRows = 15;   // C * G of the split variant
constexpr size_t kMaxSmem = 227 * 1024;

using attn_f32::store_f32;
using attn_f32::to_f32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Let a kernel take `bytes` of dynamic shared memory (the default stops at
// 48 KB, static shared memory included).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The tiles' view of one (request, kv head): rows are the request's C*G
// (position, group) pairs of q, out (B, C, KH, G, D) of TQ; key kp lives in
// table slot kp / bs, row kp % bs of the pools (N, bs, KH, D) of TKV.  Both
// tiles take it.
template <typename TQ, typename TKV>
struct PagedSrc {
  using KV = TKV;
  const TQ* q;
  TQ* out;
  const TKV* k_pool;
  const TKV* v_pool;
  const float* k_scales;
  const float* v_scales;
  const int32_t* table;  // this request's row of the tables
  const int32_t* qpos;   // this request's positions
  const void* base;
  int rows, C, KH, G, D, bs, b, h;

  __device__ size_t qoff(int r) const {
    return (((size_t)b * C + r / G) * KH + h) * (size_t)G * D +
           (size_t)(r % G) * D;
  }
  __device__ const TQ* q_row(int r) const { return q + qoff(r); }
  __device__ TQ* out_row(int r) const { return out + qoff(r); }
  __device__ int pos(int r) const { return qpos[r / G]; }
  __device__ size_t page(int kp) const { return (size_t)table[kp / bs]; }
  __device__ size_t koff(int kp) const {
    return ((page(kp) * bs + kp % bs) * KH + h) * (size_t)D;
  }
  __device__ const TKV* k_row(int kp) const { return k_pool + koff(kp); }
  __device__ const TKV* v_row(int kp) const { return v_pool + koff(kp); }
  __device__ const float* k_scale(int kp) const {
    return k_scales + page(kp) * KH + h;
  }
  __device__ const float* v_scale(int kp) const {
    return v_scales + page(kp) * KH + h;
  }
};

// The deepest position any of the `n` rows from row0 sees (-1 for none);
// every thread of the block (up to 8 warps, n <= its threads) calls it and
// gets the same value.
__device__ __forceinline__ int cta_max_pos(const int32_t* qpos, int row0,
                                           int n, int rows, int G) {
  __shared__ int wmax[8];
  const int r = row0 + (int)threadIdx.x;
  int p = ((int)threadIdx.x < n && r < rows) ? qpos[r / G] : -1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) p = max(p, __shfl_xor_sync(0xffffffffu, p, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = p;
  __syncthreads();
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) p = max(p, wmax[w]);
  return p;
}

// ------------------------------------------------- 1. tensor-core tile
template <int D, typename TKV>
__global__ void __launch_bounds__(attn_tile::kThreads)
paged_tile_kernel(const __nv_bfloat16* __restrict__ q,
                  const TKV* __restrict__ k_pool,
                  const TKV* __restrict__ v_pool,
                  const float* __restrict__ k_scales,
                  const float* __restrict__ v_scales,
                  const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ qpos,
                  const int32_t* __restrict__ live,
                  __nv_bfloat16* __restrict__ out, int C, int KH, int G,
                  int bs, int nblk, float scale) {
  extern __shared__ int4 tile_smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int rows = C * G;
  const int row0 = blockIdx.x * attn_tile::kRows;
  // walk bound: the live slots, cut to the deepest block any row sees
  const int maxpos = cta_max_pos(qpos + (size_t)b * C, row0, attn_tile::kRows,
                                 rows, G);
  const int jend = maxpos < 0 ? 0 : min(min(live[b], nblk), maxpos / bs + 1);
  const PagedSrc<__nv_bfloat16, TKV> src{
      q, out, k_pool, v_pool, k_scales, v_scales, tables + (size_t)b * nblk,
      qpos + (size_t)b * C, k_pool, rows, C, KH, G, D, bs, b, h};
  attn_tile::run<D, std::is_same<TKV, int8_t>::value>(
      src, row0, jend * bs, scale, reinterpret_cast<char*>(tile_smem));
}

// ------------------------------------------------------------ 3. f32 tile
template <int DP, int W, typename TQ, typename TKV>
__global__ void __launch_bounds__(32 * attn_f32::full_warps<DP>(), attn_f32::min_blocks<DP>())
paged_f32_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                 const TKV* __restrict__ v_pool,
                 const float* __restrict__ k_scales,
                 const float* __restrict__ v_scales,
                 const int32_t* __restrict__ tables,
                 const int32_t* __restrict__ qpos,
                 const int32_t* __restrict__ live, TQ* __restrict__ out,
                 int C, int KH, int G, int D, int bs, int nblk, float scale,
                 int copy) {
  extern __shared__ int4 f32_smem[];
  constexpr int kRows = attn_f32::Shape<DP, W, TKV>::kRows;
  const int b = blockIdx.z, h = blockIdx.y;
  const int rows = C * G;
  const int row0 = blockIdx.x * kRows;
  // walk bound: the live slots' keys, cut to the deepest position a row sees
  const int maxpos = cta_max_pos(qpos + (size_t)b * C, row0, kRows, rows, G);
  const int kend =
      maxpos < 0 ? 0 : max(0, min(min(live[b], nblk) * bs, maxpos + 1));
  const PagedSrc<TQ, TKV> src{
      q, out, k_pool, v_pool, k_scales, v_scales, tables + (size_t)b * nblk,
      qpos + (size_t)b * C, k_pool, rows, C, KH, G, D, bs, b, h};
  attn_f32::run<DP, W>(src, row0, kend, scale, copy,
                       reinterpret_cast<char*>(f32_smem));
}

// ----------------------------------------------------- 2. split-KV decode
template <typename TKV>
__device__ __forceinline__ void load16_f32(const TKV* p, float* x,
                                           float scl) {
  constexpr int kEpc = 16 / sizeof(TKV);
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const TKV* v = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
  for (int e = 0; e < kEpc; ++e) {
    if constexpr (std::is_same<TKV, int8_t>::value)
      x[e] = __fmul_rn(to_f32(v[e]), scl);
    else
      x[e] = to_f32(v[e]);
  }
}

// Partials: m, l (B, KH, R, nsplit); acc (B, KH, R, nsplit, D), all f32.
// A split holds pps * bs <= kSplitKeys keys (skeys, the stride of its
// shared rows); NV = ceil(D / 32) accumulators a lane keeps per row in P V.
template <typename TQ, typename TKV, int NV>
__global__ void __launch_bounds__(kWarps * 32)
paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                   const TKV* __restrict__ v_pool,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   const int32_t* __restrict__ tables,
                   const int32_t* __restrict__ qpos,
                   const int32_t* __restrict__ live,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int C, int KH, int G, int D,
                   int bs, int nblk, int pps, int nsplit, float scale) {
  constexpr bool kQuantized = std::is_same<TKV, int8_t>::value;
  constexpr int kEpc = 16 / sizeof(TKV);  // elements per 16-byte chunk
  extern __shared__ int4 split_smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int R = C * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t prow = ((size_t)b * KH + h) * R;  // row r's partials: prow + r

  int maxpos = -1;
  for (int c = 0; c < C; ++c) maxpos = max(maxpos, qpos[(size_t)b * C + c]);
  const int jend = maxpos < 0 ? 0 : min(min(live[b], nblk), maxpos / bs + 1);
  const int j0 = s * pps, j1 = min(j0 + pps, jend);
  if (j1 <= j0) {  // past the walk bound: the combine's exact no-op
    for (int r = tid; r < R; r += blockDim.x) {
      part_m[(prow + r) * nsplit + s] = kNegInf;
      part_l[(prow + r) * nsplit + s] = 0.f;
    }
    for (int e = tid; e < R * D; e += blockDim.x)
      part_acc[((prow + e / D) * nsplit + s) * D + e % D] = 0.f;
    return;
  }
  const int key0 = j0 * bs, nk = (j1 - j0) * bs;
  const int cpr = D / kEpc;  // 16-byte chunks per row
  const int skeys = pps * bs;

  TKV* sk = reinterpret_cast<TKV*>(split_smem);  // (skeys, D)
  TKV* sv = sk + skeys * D;                      // (skeys, D)
  float* sq = reinterpret_cast<float*>(sv + skeys * D);  // (R, D)
  float* ss = sq + R * D;                        // (R, skeys)
  float* ksk = ss + R * skeys;                   // (skeys,) int8 only
  float* vsk = ksk + skeys;                      // (skeys,) int8 only
  float* red = vsk + skeys;                      // (kWarps, R, D)
  int* spage = reinterpret_cast<int*>(red + kWarps * R * D);  // (pps,)
  float* kspage = reinterpret_cast<float*>(spage + pps);      // (pps,)
  float* vspage = kspage + pps;                               // (pps,)

  // the split's live table entries (and int8 scales), read once
  for (int j = tid; j < j1 - j0; j += blockDim.x) {
    const int page = tables[(size_t)b * nblk + j0 + j];
    spage[j] = page;
    if constexpr (kQuantized) {
      kspage[j] = k_scales[(size_t)page * KH + h];
      vspage[j] = v_scales[(size_t)page * KH + h];
    }
  }
  __syncthreads();
  // every K and V row of the split in flight at once
  for (int c = tid; c < nk * cpr; c += blockDim.x) {
    const int key = c / cpr, part = c % cpr;
    const size_t row =
        (((size_t)spage[key / bs] * bs + key % bs) * KH + h) * (size_t)D +
        (size_t)part * kEpc;
    attn_tile::cp_async16(sk + key * D + part * kEpc, k_pool + row, true);
    attn_tile::cp_async16(sv + key * D + part * kEpc, v_pool + row, true);
  }
  attn_tile::cp_async_commit();
  for (int e = tid; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    sq[e] = to_f32(q[(((size_t)b * C + r / G) * KH + h) * (size_t)G * D +
                     (size_t)(r % G) * D + d]);
  }
  if constexpr (kQuantized) {
    for (int key = tid; key < nk; key += blockDim.x) {
      ksk[key] = kspage[key / bs];
      vsk[key] = vspage[key / bs];
    }
  }
  attn_tile::cp_async_wait<0>();
  __syncthreads();

  // scores, a thread per key: s = (q . k) * scale, masked by position
  if (tid < nk) {
    const int kp = key0 + tid;
    const float ksc = kQuantized ? ksk[tid] : 1.f;
    float acc[kSplitRows];
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) acc[r] = 0.f;
    const TKV* kr = sk + tid * D;
    for (int part = 0; part < cpr; ++part) {
      float x[kEpc];
      load16_f32(kr + part * kEpc, x, ksc);
#pragma unroll
      for (int r = 0; r < kSplitRows; ++r) {
        if (r < R) {
          const float* qr = sq + r * D + part * kEpc;
#pragma unroll
          for (int e = 0; e < kEpc; ++e) acc[r] = fmaf(qr[e], x[e], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      if (r < R)
        ss[r * skeys + tid] =
            kp <= qpos[(size_t)b * C + r / G] ? acc[r] * scale : -INFINITY;
    }
  }
  __syncthreads();

  // the split's softmax, a warp per row: m, l out; P in place of S
  for (int r = warp; r < R; r += kWarps) {
    float* sr = ss + r * skeys;
    float mx = kNegInf;
    for (int key = lane; key < nk; key += 32) mx = fmaxf(mx, sr[key]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int key = lane; key < nk; key += 32) {
      const float p = expf(sr[key] - mx);
      sr[key] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_m[(prow + r) * nsplit + s] = mx;
      part_l[(prow + r) * nsplit + s] = sum;
    }
  }
  __syncthreads();

  // acc = P V: warp w takes keys [32w, 32w + 32) in order, lanes split D
  // (d = lane + 32i); the four warps' sums are added in warp order
  float a[kSplitRows][NV];
#pragma unroll
  for (int r = 0; r < kSplitRows; ++r)
#pragma unroll
    for (int i = 0; i < NV; ++i) a[r][i] = 0.f;
  const int kw1 = min(32 * warp + 32, nk);
  for (int key = 32 * warp; key < kw1; ++key) {
    float v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      v[i] = d < D ? to_f32(sv[key * D + d]) : 0.f;
      if constexpr (kQuantized) v[i] = __fmul_rn(v[i], vsk[key]);
    }
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      if (r < R) {
        const float p = ss[r * skeys + key];
#pragma unroll
        for (int i = 0; i < NV; ++i) a[r][i] = fmaf(p, v[i], a[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kSplitRows; ++r) {
    if (r < R) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        if (d < D) red[(warp * R + r) * D + d] = a[r][i];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += blockDim.x) {
    float sum = red[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w * R * D + e];
    part_acc[((prow + e / D) * nsplit + s) * D + e % D] = sum;
  }
}

// Merge each row's splits in split order; out = acc / max(l, 1e-30).
// Grid (R, KH, B): the first warp turns the splits' maxima into weights
// e^(m_s - M) in shared memory and lane 0 sums l_s e^(m_s - M) in split
// order; then each thread folds acc_s e^(m_s - M) in split order for its
// d (d = threadIdx.x + 128 i).
template <typename TQ>
__global__ void __launch_bounds__(kWarps * 32)
split_combine_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, TQ* __restrict__ out,
                     int C, int KH, int G, int D, int nsplit) {
  extern __shared__ float weight[];  // (nsplit,)
  __shared__ float inv;
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t row = ((size_t)b * KH + h) * (C * G) + r;
  const float* m = part_m + row * nsplit;
  if (threadIdx.x < 32) {
    float mx = kNegInf;
    for (int s = threadIdx.x; s < nsplit; s += 32) mx = fmaxf(mx, m[s]);
    mx = warp_max(mx);
    for (int s = threadIdx.x; s < nsplit; s += 32) weight[s] = expf(m[s] - mx);
    __syncwarp();
    if (threadIdx.x == 0) {
      const float* l = part_l + row * nsplit;
      float sum = 0.f;
      for (int s = 0; s < nsplit; ++s) sum = fmaf(l[s], weight[s], sum);
      inv = 1.f / fmaxf(sum, 1e-30f);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float* acc = part_acc + row * nsplit * D + d;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s)
      o = fmaf(acc[(size_t)s * D], weight[s], o);
    store_f32(out + (((size_t)b * C + r / G) * KH + h) * (size_t)G * D +
                  (size_t)(r % G) * D + d,
              o * inv);
  }
}

// ------------------------------------------------------------- launchers
struct Args {
  const void *q, *k, *v, *ksc, *vsc, *tables, *qpos, *live;
  void* out;
  int B, C, KH, G, D, bs, nblk;
  float scale;
  cudaStream_t stream;
};

template <int DP, int W, typename TQ, typename TKV>
int launch_f32(const Args& a, int copy) {
  using S = attn_f32::Shape<DP, W, TKV>;
  auto kernel = paged_f32_kernel<DP, W, TQ, TKV>;
  static const cudaError_t attr = allow_smem(kernel, S::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = a.C * a.G;
  dim3 grid((rows + S::kRows - 1) / S::kRows, a.KH, a.B);
  kernel<<<grid, S::kThreads, S::kBytes, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.qpos), static_cast<const int32_t*>(a.live),
      static_cast<TQ*>(a.out), a.C, a.KH, a.G, a.D, a.bs, a.nblk, a.scale,
      copy);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, typename TQ, typename TKV>
int f32_rows(const Args& a) {
  return launch_f32<DP, attn_f32::full_warps<DP>(), TQ, TKV>(
      a, attn_f32::copy_width(a.k, a.v, (size_t)a.D * sizeof(TKV)));
}

template <typename TQ, typename TKV>
int f32_by_head_dim(const Args& a) {
  switch (attn_f32::padded_dim(a.D)) {
    case 64: return f32_rows<64, TQ, TKV>(a);
    case 80: return f32_rows<80, TQ, TKV>(a);
    case 128: return f32_rows<128, TQ, TKV>(a);
    case 256: return f32_rows<256, TQ, TKV>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int f32_by_pool_type(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0: return f32_by_head_dim<TQ, float>(a);
    case 1: return f32_by_head_dim<TQ, __nv_bfloat16>(a);
    case 2: return f32_by_head_dim<TQ, __half>(a);
    case 3: return f32_by_head_dim<TQ, int8_t>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, typename TKV>
int launch_tile(const Args& a) {
  constexpr size_t smem =
      attn_tile::smem_bytes<D, std::is_same<TKV, int8_t>::value>();
  auto kernel = paged_tile_kernel<D, TKV>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = a.C * a.G;
  dim3 grid((rows + attn_tile::kRows - 1) / attn_tile::kRows, a.KH, a.B);
  kernel<<<grid, attn_tile::kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.qpos), static_cast<const int32_t*>(a.live),
      static_cast<__nv_bfloat16*>(a.out), a.C, a.KH, a.G, a.bs, a.nblk,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int tile_by_head_dim(const Args& a) {
  switch (a.D) {
    case 64: return launch_tile<64, TKV>(a);
    case 80: return launch_tile<80, TKV>(a);
    case 128: return launch_tile<128, TKV>(a);
    case 256: return launch_tile<256, TKV>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of a split over `keys` keys with R rows of D.
template <typename TKV>
size_t split_smem_bytes(int rows, int d, int keys) {
  return 2 * (size_t)keys * d * sizeof(TKV) +
         sizeof(float) * ((size_t)rows * d + (size_t)rows * keys +
                          5 * (size_t)keys + (size_t)kWarps * rows * d);
}

template <typename TQ, typename TKV, int NV>
int launch_split_nv(const Args& a, float* pm, float* pl, float* pacc, int pps,
                    int nsplit) {
  const int R = a.C * a.G;
  const size_t smem = split_smem_bytes<TKV>(R, a.D, pps * a.bs);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_split_kernel<TQ, TKV, NV>;
  static const cudaError_t attr = allow_smem(kernel, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(nsplit, a.KH, a.B), kWarps * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.qpos), static_cast<const int32_t*>(a.live),
      pm, pl, pacc, a.C, a.KH, a.G, a.D, a.bs, a.nblk, pps, nsplit, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_combine_kernel<TQ><<<dim3(R, a.KH, a.B), kWarps * 32,
                             nsplit * sizeof(float), a.stream>>>(
      pm, pl, pacc, static_cast<TQ*>(a.out), a.C, a.KH, a.G, a.D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_split(const Args& a, float* pm, float* pl, float* pacc, int pps,
                 int nsplit) {
  if (a.D <= 128)
    return launch_split_nv<TQ, TKV, 4>(a, pm, pl, pacc, pps, nsplit);
  return launch_split_nv<TQ, TKV, 8>(a, pm, pl, pacc, pps, nsplit);
}

template <typename TQ>
int split_by_pool_type(int kv_dtype, const Args& a, float* pm, float* pl,
                       float* pacc, int pps, int nsplit) {
  switch (kv_dtype) {
    case 0: return launch_split<TQ, float>(a, pm, pl, pacc, pps, nsplit);
    case 1: return launch_split<TQ, __nv_bfloat16>(a, pm, pl, pacc, pps, nsplit);
    case 2: return launch_split<TQ, __half>(a, pm, pl, pacc, pps, nsplit);
    case 3: return launch_split<TQ, int8_t>(a, pm, pl, pacc, pps, nsplit);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v,
               const void* k_scales, const void* v_scales, const void* tables,
               const void* qpos, const void* live, void* out, int B, int C,
               int KH, int G, int D, int bs, int nblk, float scale,
               void* stream) {
  return Args{q, k, v, k_scales, v_scales, tables, qpos, live, out,
              B, C, KH, G, D, bs, nblk, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16, 2 = float16, 3 = int8.  q_dtype is
// 0 or 1; kv_dtype any of the four, and 3 needs k_scales / v_scales.  Each
// entry point returns the cudaError_t of its launches.

// The f32 tile (variant 3): D <= 256, any bs.
extern "C" int paged_attention_chunk(int q_dtype, int kv_dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* k_scales,
                                     const void* v_scales, const void* tables,
                                     const void* qpos, const void* live,
                                     void* out, int B, int C, int KH, int G,
                                     int D, int bs, int nblk, float scale,
                                     void* stream) {
  const Args a = make_args(q, k, v, k_scales, v_scales, tables, qpos, live,
                           out, B, C, KH, G, D, bs, nblk, scale, stream);
  if (kv_dtype == 3 && (k_scales == nullptr || v_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D < 1 || attn_f32::padded_dim(D) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0) return f32_by_pool_type<float>(kv_dtype, a);
  if (q_dtype == 1) return f32_by_pool_type<__nv_bfloat16>(kv_dtype, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core tile (variant 1): bf16 q; kv_dtype 1 (bf16) or 3 (int8);
// D 64, 80, 128 or 256.
extern "C" int paged_attention_tile(int kv_dtype, const void* q,
                                    const void* k, const void* v,
                                    const void* k_scales,
                                    const void* v_scales, const void* tables,
                                    const void* qpos, const void* live,
                                    void* out, int B, int C, int KH, int G,
                                    int D, int bs, int nblk, float scale,
                                    void* stream) {
  const Args a = make_args(q, k, v, k_scales, v_scales, tables, qpos, live,
                           out, B, C, KH, G, D, bs, nblk, scale, stream);
  if (kv_dtype == 1) return tile_by_head_dim<__nv_bfloat16>(a);
  if (kv_dtype == 3 && k_scales != nullptr && v_scales != nullptr)
    return tile_by_head_dim<int8_t>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split-KV walk and its combine (variant 2): C*G <= 15, D a multiple of
// 16 up to 256, pages_per_split * bs <= 128 keys whose K and V fit in
// shared memory beside the split's f32 rows (the wrapper's split_plan).  part_m, part_l (B, KH, C*G,
// nsplit) and part_acc (B, KH, C*G, nsplit, D) are f32 scratch.
extern "C" int paged_attention_split(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* qpos, const void* live, void* part_m, void* part_l,
    void* part_acc, void* out, int B, int C, int KH, int G, int D, int bs,
    int nblk, int pps, int nsplit, float scale, void* stream) {
  const Args a = make_args(q, k, v, k_scales, v_scales, tables, qpos, live,
                           out, B, C, KH, G, D, bs, nblk, scale, stream);
  if (C * G > kSplitRows || D % 16 != 0 || D > attn_f32::kMaxDim || pps < 1 ||
      pps * bs > kSplitKeys || (long long)pps * nsplit < nblk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == 3 && (k_scales == nullptr || v_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pacc = static_cast<float*>(part_acc);
  if (q_dtype == 0)
    return split_by_pool_type<float>(kv_dtype, a, pm, pl, pacc, pps, nsplit);
  if (q_dtype == 1)
    return split_by_pool_type<__nv_bfloat16>(kv_dtype, a, pm, pl, pacc, pps,
                                             nsplit);
  return static_cast<int>(cudaErrorInvalidValue);
}
