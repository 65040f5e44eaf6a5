// The exact (f32) attention tile for sm_90a: register-blocked FMA products
// on the CUDA cores, shared by the dense flash attention kernel
// (flash_attention.cu, variant 2) and the paged chunk kernel
// (paged_attention.cu, variant 3).
//
// It ports the body of repro/kernels/flash_attention.py:_flash_kernel (:33)
// and of repro/kernels/paged_attention.py:_chunk_kernel_body (:57), with its
// int8 variant _paged_chunk_kernel_q8 (:129), wherever the tensor-core tile
// (attention_tile.cuh) does not apply: every f32 query, and bf16 queries at
// head dims or pool types that tile is not built for.  Like that tile it
// takes a source (`Src`) that names where a query row and a key row live.
// Nothing here rounds below f32 and nothing uses TF32: the f32 limits
// (1e-4 against the plain version) leave no room for three-digit products.
//
// Design.  A CTA walks K/V tiles of kKeys = 32 keys through a two-stage
// cp.async ring in shared memory, f32: tile t+1's copy is in flight while
// tile t is multiplied.  Q is widened to f32 once into shared memory.  Rows
// are (position, group) pairs, position-major, so GQA needs no extra pass.
// A warp owns 16 consecutive rows (8 past D 128, where its output columns
// would not fit in registers), a CTA 64: 4 warps (8 past D 128).  Where a
// grid of 64-row CTAs would leave SMs idle (the flash kernel's short
// prefills), only the first warp owns rows and the others share the
// copies; the paged kernel's small grids are decode rows, whose 64-row
// CTAs already hold rows in their first warp only.
//   S = Q K^T: a lane sums an 8-row x 4-key micro-tile (keys kb + 8 j) over
//   every kDS-th 16-byte chunk of d (2 or 4 slices), from LDS.128: 12 words
//   feed 32 FMAs, in d order; a reduce-scatter of shuffles over the slices
//   leaves each lane the full scores of 8 / kDS of its rows.  The K row
//   stride is padded so the 8 lanes of a quarter-warp hit distinct banks.
//   Online softmax once per (row, key tile): the 8 key blocks of a row take
//   its tile max with 3 shuffles, corr = 2^(m_old - m_new) rescales O and l
//   once, P = 2^(S - m_new) goes to the warp's own rows of shared memory
//   with each row's corr, so a __syncwarp orders them.  Scores are in log2
//   units (scale * log2 e); the exponentials are the SFU's ex2.approx.
//   O += P V: a lane owns 8 rows x D / 16 columns (8 x D / 32 past D 128):
//   per key it reads P for its rows (LDS.128 a 4 keys) and its columns of
//   V (LDS.128 and single words), D / 2 (D / 4) FMAs, keys in order.
// Head dims are padded to 64, 80, 128 or 256 with zeros in shared memory:
// a zero of Q meets a zero of K, so padding adds exact zeros.  Shared
// memory, f32 rows: 63 KB at D 64 (three CTAs an SM), 75 KB at D 80
// (three), 111 KB at D 128 (two), 211 KB at D 256 (one of 8 warps).
//
// Masking.  A key at or past the walk bound `kend` is zero-filled by
// cp.async's src-size 0 and never read from memory, so a NaN there cannot
// meet a zero of P.  Masked scores are set to -inf by select, never by
// adding.  A tile past the bound is not visited; a warp whose rows see no
// key of a tile skips it.  A row that sees no key of a visited tile gets
// corr = 1 and p = 0, an exact no-op, so which tiles a CTA or warp visits
// (its kend, its rows) never changes a bit of the result: the bounded and
// the unbounded walks agree bitwise, and the 64-row and one-warp CTAs give
// the same bits.  out = O / max(l, 1e-30), so an all-masked row writes 0.
// No atomics: two calls give the same bits.
//
// Storage types.  f32 K/V rows are copied straight into the f32 ring.
// fp16, bf16 and int8 rows are copied as stored into a raw ring and widened
// into one f32 K and V tile in shared memory after they land; an int8 code
// becomes __fmul_rn(float(code), scale) with the (block, kv head) scale of
// its key's table slot, copied per live key through the same table entry as
// the page.  That is quant.dequantize_pool's rounding, so under one query
// type the fused int8 walk equals the walk over dequantized f32 pools
// bitwise.  Rows whose bytes are not whole 16-byte chunks (or start off a
// 16-byte boundary) are copied 4 bytes at a time, or element by element
// where not even that divides.
//
// What bounds it on an H100: 4 * D flops per visible (row, key) pair on the
// CUDA cores (67 TFLOP/s f32 at 1980 MHz; 128 FMA lanes an SM a clock).
// Shared memory gives 32 words an SM a clock, so a micro-tile that reads
// 12 words per 32 FMAs caps S and P V at two thirds of that rate; the
// tile reaches about half of it in steady state (tools/f32_tile_waves.py),
// a warp's other cycles going to issuing a tile's copies and to the
// softmax.  8 x 8 micro-tiles (4 FMAs a word) cost the registers that a
// third CTA an SM needs, and ran no faster; bulk copies by the TMA engine,
// one a key row, were slower than cp.async at rows of 256 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace attn_f32 {

constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;  // the running max's floor
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDim = 256;

// Ways a K/V row is copied into shared memory (copy_width)
constexpr int kCopy16 = 16;  // cp.async, 16 bytes
constexpr int kCopy4 = 4;    // cp.async, 4 bytes
constexpr int kCopy1 = 1;    // element by element (ld + st.shared)

// The padded head dim a head dim runs at, or 0 past kMaxDim.
__host__ __device__ constexpr int padded_dim(int d) {
  return d <= 64 ? 64 : d <= 80 ? 80 : d <= 128 ? 128 : d <= kMaxDim ? 256 : 0;
}

// Keys a K/V tile, at every head dim (the plain model of this tile's
// order, ref.F32_TILE_KEYS, walks the same tiles)
constexpr int kKeys = 32;

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

template <int N> struct Bits;
template <> struct Bits<1> { using T = uint8_t; };
template <> struct Bits<2> { using T = uint16_t; };
template <> struct Bits<4> { using T = uint32_t; };

// Floats of padding after a K/V row of DP floats so that the 8 lanes of a
// quarter-warp, reading ds consecutive 16-byte chunks of each of 8 / ds
// consecutive keys, hit 8 distinct groups of 4 banks: the row stride in
// 16-byte chunks must be ds times an odd number, modulo 8.
__host__ __device__ constexpr int key_pad(int dp, int ds) {
  int p = 0;
  while (ds < 8 && !(((dp + p) / 4) % 8 % ds == 0 && ((dp + p) / 4) % 8 / ds % 2 == 1))
    p += 4;
  return p;
}

// Warps of a CTA: 4, or 8 past D 128 (where a warp owns 8 rows).
template <int DP>
__host__ __device__ constexpr int full_warps() { return DP > 128 ? 8 : 4; }

// The tile at a padded head dim DP for CTAs whose first kRowWarps warps own
// rows (all of them, 64 rows, or one).
//   S: lane = kDS d-slices x (kNRB 8-row blocks x 8 key blocks of 4 keys).
//   P V: lane = kNRB 8-row blocks x kNCG column groups; a lane's columns are
//   float4s at 4 cg + 4 kNCG m, then single columns at 4 kNCG kF4 + cg.
template <int DP, int kRowWarps, typename KV>
struct Shape {
  static_assert(DP % 16 == 0 && DP <= kMaxDim, "padded head dim: 16 | DP <= 256");
  static constexpr int kWR = DP > 128 ? 8 : 16;      // rows a warp
  static constexpr int kThreads = 32 * full_warps<DP>();
  static constexpr int kRows = kWR * kRowWarps;        // rows a CTA
  static constexpr int kKeys = attn_f32::kKeys;        // keys a K/V tile
  static constexpr int kRN = 4;                        // keys a lane in S
  static constexpr int kNRB = kWR / 8;                 // 8-row blocks a warp
  static constexpr int kNKB = kKeys / kRN;             // key blocks
  static constexpr int kDS = 32 / (kNRB * kNKB);       // d-slices
  static constexpr int kRPL = 8 / kDS;                 // softmax rows a lane
  static constexpr int kNCG = 32 / kNRB;               // column groups in P V
  static constexpr int kF4 = DP / (4 * kNCG);          // float4 columns a lane
  static constexpr int kR1 = (DP - 4 * kNCG * kF4) / kNCG;  // single columns
  static constexpr int kQS = DP + 4;                   // floats a Q row
  static constexpr int kKS = DP + key_pad(DP, kDS);    // floats a K/V row
  static constexpr int kPS = kKeys + 4;                // floats a P row
  static_assert(kDS * kNRB * kNKB == 32 && kDS <= 8 && (DP / 4) % kDS == 0,
                "a warp's lanes cover its S tile");
  static_assert(4 * kNCG * kF4 + kNCG * kR1 == DP, "a warp's lanes cover O");
  static constexpr bool kWiden = !std::is_same<KV, float>::value;
  static constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  static constexpr int kRaw = DP * (int)sizeof(KV);  // bytes a raw row (16 | kRaw)
  static constexpr size_t kTileF = sizeof(float) * kKeys * kKS;
  static constexpr size_t kRingTile = kWiden ? (size_t)kKeys * kRaw : kTileF;
  static constexpr size_t kQBytes = sizeof(float) * kRows * kQS;
  static constexpr size_t kPBytes = sizeof(float) * kRows * (kPS + 2);
  static constexpr size_t kBytes =
      kQBytes + kPBytes + kStages * 2 * kRingTile  // Q, P (+ corr, l), ring
      + (kWiden ? 2 * kTileF : 0)                  // widened K and V
      + (kQ8 ? sizeof(float) * kStages * 2 * kKeys : 0);  // the scale ring
};

// CTAs of this shape an SM should find room for (its shared memory allows
// that many at the full width).
template <int DP>
__host__ __device__ constexpr int min_blocks() {
  return DP <= 80 ? 3 : DP == 256 ? 1 : 2;
}

// How K/V rows of `row_bytes` from k and v can be copied (kCopy*).
inline int copy_width(const void* k, const void* v, size_t row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | row_bytes;
  return a % 16 == 0 ? kCopy16 : a % 4 == 0 ? kCopy4 : kCopy1;
}

// Whether a grid of 64-row CTAs over `rows` rows per (head, batch) pair,
// `pairs` pairs, fills every SM of the current device; else CTAs of one
// warp's rows.
inline bool wide_rows(int rows, int pairs) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (long long)((rows + 63) / 64) * pairs >= sms;
}

// Copy keys [k0, k0 + kKeys) of K and V (zeros at or past kend, and past D
// in a row) into one stage: rows of S::kRaw bytes (raw ring) or of
// S::kKS floats (f32 ring); an int8 source also copies each live key's
// scales.
template <class S, class Src>
__device__ __forceinline__ void load_kv(const Src& src, int k0, int kend,
                                        int copy, char* kdst, char* vdst,
                                        float* kscl, float* vscl) {
  using KV = typename Src::KV;
  constexpr int kDstRow = S::kWiden ? S::kRaw : (int)sizeof(float) * S::kKS;
  constexpr int kDP = S::kRaw / (int)sizeof(KV);
  const int tid = threadIdx.x;
  const int live = src.D * (int)sizeof(KV);  // bytes of a row that are D
  const char* base = static_cast<const char*>(src.base);
  if (copy == kCopy16) {
    constexpr int kC = S::kRaw / 16;
    for (int c = tid; c < S::kKeys * kC; c += S::kThreads) {
      const int key = c / kC, chunk = c % kC;
      const int kp = k0 + key;
      const bool ok = kp < kend && chunk * 16 < live;
      const int off = key * kDstRow + chunk * 16;
      attn_tile::cp_async16(
          kdst + off,
          ok ? reinterpret_cast<const char*>(src.k_row(kp)) + chunk * 16 : base,
          ok);
      attn_tile::cp_async16(
          vdst + off,
          ok ? reinterpret_cast<const char*>(src.v_row(kp)) + chunk * 16 : base,
          ok);
    }
  } else if (copy == kCopy4) {
    constexpr int kC = S::kRaw / 4;
    for (int c = tid; c < S::kKeys * kC; c += S::kThreads) {
      const int key = c / kC, chunk = c % kC;
      const int kp = k0 + key;
      const bool ok = kp < kend && chunk * 4 < live;
      const int off = key * kDstRow + chunk * 4;
      attn_tile::cp_async4(
          kdst + off,
          ok ? reinterpret_cast<const char*>(src.k_row(kp)) + chunk * 4 : base,
          ok);
      attn_tile::cp_async4(
          vdst + off,
          ok ? reinterpret_cast<const char*>(src.v_row(kp)) + chunk * 4 : base,
          ok);
    }
  } else {
    using B = typename Bits<sizeof(KV)>::T;
    for (int e = tid; e < S::kKeys * kDP; e += S::kThreads) {
      const int key = e / kDP, d = e % kDP;
      const int kp = k0 + key;
      const bool ok = kp < kend && d < src.D;
      B* kd = reinterpret_cast<B*>(kdst + key * kDstRow);
      B* vd = reinterpret_cast<B*>(vdst + key * kDstRow);
      kd[d] = ok ? reinterpret_cast<const B*>(src.k_row(kp))[d] : B(0);
      vd[d] = ok ? reinterpret_cast<const B*>(src.v_row(kp))[d] : B(0);
    }
  }
  if constexpr (S::kQ8) {
    if (tid < S::kKeys) {
      const int kp = k0 + tid;
      const bool ok = kp < kend;
      attn_tile::cp_async4(kscl + tid, ok ? src.k_scale(kp) : src.base, ok);
      attn_tile::cp_async4(vscl + tid, ok ? src.v_scale(kp) : src.base, ok);
    }
  }
}

// Widen a raw tile (rows of S::kRaw bytes) into f32 rows of S::kKS floats;
// int8 codes times their key's scale, rounded once.
template <class S, typename KV>
__device__ __forceinline__ void widen(const char* raw, const float* scl,
                                      float* dst) {
  struct alignas(4 * sizeof(KV)) Quad { KV x[4]; };
  constexpr int kDP = S::kRaw / (int)sizeof(KV);
  constexpr int kG = kDP / 4;
  for (int c = threadIdx.x; c < S::kKeys * kG; c += S::kThreads) {
    const int key = c / kG, part = c % kG;
    const Quad in = reinterpret_cast<const Quad*>(raw + key * S::kRaw)[part];
    float4 f;
    if constexpr (S::kQ8) {
      const float s = scl[key];
      f = make_float4(__fmul_rn(to_f32(in.x[0]), s), __fmul_rn(to_f32(in.x[1]), s),
                      __fmul_rn(to_f32(in.x[2]), s), __fmul_rn(to_f32(in.x[3]), s));
    } else {
      f = make_float4(to_f32(in.x[0]), to_f32(in.x[1]), to_f32(in.x[2]),
                      to_f32(in.x[3]));
    }
    reinterpret_cast<float4*>(dst + key * S::kKS)[part] = f;
  }
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Sum a lane's 8 x RN partial scores over the d-slices of its xor group,
// keeping half the rows at each level: after it, a[0 .. 8 / ds) hold the
// full scores of rows (8 / ds) * slice + i of the lane's 8.
template <int kOff, int kR, int kRN>
__device__ __forceinline__ void scatter_rows(float (&a)[8][kRN], int lane) {
  if constexpr (kOff >= 1) {
    const bool up = lane & kOff;
#pragma unroll
    for (int i = 0; i < kR / 2; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const float send = up ? a[i][j] : a[kR / 2 + i][j];
        const float keep = up ? a[kR / 2 + i][j] : a[i][j];
        a[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
      }
    scatter_rows<kOff / 2, kR / 2, kRN>(a, lane);
  }
}

// One CTA of kRows query rows [row0, row0 + kRows) against keys [0, kend),
// in K/V tiles of Shape::kKeys keys, at a head dim padded to DP.
//
// Src provides, for rows r < src.rows and keys kp < kend:
//   type KV (the K/V rows' element); int rows, D;
//   const void* base (any valid global address)
//   const Q* q_row(int r); Q* out_row(int r), Q f32 or bf16 (the query's
//     and output's element); int pos(int r) (the row's absolute
//     position: keys kp <= pos are seen)
//   const KV* k_row(int kp), v_row(int kp)   -- D contiguous elements
//   const float* k_scale(int kp), v_scale(int kp)   -- int8 rows only
//   void store_lse(int r, float lse) -- optional (attn_tile::HasLse): each
//     row's m + log l in natural logs of the scaled scores
// `copy` is copy_width of the K/V rows.  `scale` is the softmax scale.
// Every thread of the block calls it.
template <int DP, int kRowWarps, class Src>
__device__ __forceinline__ void run(const Src& src, int row0, int kend,
                                    float scale, int copy, char* smem) {
  using KV = typename Src::KV;
  using S = Shape<DP, kRowWarps, KV>;
  constexpr int kKeys = S::kKeys, kRN = S::kRN, kDS = S::kDS;
  constexpr int kRPL = S::kRPL, kNKB = S::kNKB, kNCG = S::kNCG;
  constexpr int kF4 = S::kF4, kR1 = S::kR1;
  constexpr int kQS = S::kQS, kKS = S::kKS, kPS = S::kPS;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool rowed = warp < kRowWarps;  // else the warp only copies
  const int wrow = warp * S::kWR;  // the warp's first row in the CTA
  // S: the lane's d-slice, key block and 8-row block; its softmax rows
  const int slice = lane % kDS;
  const int kb = lane / kDS % kNKB;
  const int srow = wrow + 8 * (lane / (kDS * kNKB)) + kRPL * slice;
  const int qrow = wrow + 8 * (lane / (kDS * kNKB));
  // P V: the lane's 8 output rows and column group
  const int orow = wrow + 8 * (lane / kNCG);
  const int cg = lane % kNCG;

  float* sQ = reinterpret_cast<float*>(smem);
  float* sP = sQ + S::kRows * kQS;
  float* sC = sP + S::kRows * kPS;  // each row's corr in this tile
  float* sL = sC + S::kRows;        // each row's l, at the end
  char* ring = reinterpret_cast<char*>(sL + S::kRows);
  // stage s: K at ring tile 2 s, V at 2 s + 1; then (raw rings) the widened
  // K and V, then (int8) the scales: k at [2 s], v at [2 s + 1]
  float* sKw = reinterpret_cast<float*>(ring + kStages * 2 * S::kRingTile);
  float* sVw = sKw + kKeys * kKS;
  float* sScale = sVw + kKeys * kKS;
  int rpos[kRPL];
#pragma unroll
  for (int i = 0; i < kRPL; ++i) {
    const int r = row0 + srow + i;
    rpos[i] = rowed && r < src.rows ? src.pos(r) : -1;
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

  auto load = [&](int t) {
    const int stage = t & 1;
    load_kv<S>(src, t * kKeys, kend, copy, ring + (2 * stage) * S::kRingTile,
               ring + (2 * stage + 1) * S::kRingTile,
               sScale + (2 * stage) * kKeys, sScale + (2 * stage + 1) * kKeys);
  };
  const int ntiles = (kend + kKeys - 1) / kKeys;
  if (ntiles > 0) load(0);
  attn_tile::cp_async_commit();
  // Q as f32, zeros past D and past the rows
  for (int e = tid; e < S::kRows * DP; e += S::kThreads) {
    const int r = e / DP, d = e % DP;
    const bool ok = row0 + r < src.rows && d < src.D;
    sQ[r * kQS + d] = ok ? to_f32(src.q_row(row0 + r)[d]) : 0.f;
  }

  float m[kRPL], l[kRPL];  // the softmax rows'; l over this lane's keys
#pragma unroll
  for (int i = 0; i < kRPL; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float4 o4[8][kF4 > 0 ? kF4 : 1];
  float o1[8][kR1 > 0 ? kR1 : 1];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < kF4; ++c) o4[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kR1; ++c) o1[i][c] = 0.f;
  }
  const float sl = scale * kLog2e;  // scores in log2 units: 2^x below

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);  // its stage was freed by tile t - 1
    attn_tile::cp_async_commit();
    attn_tile::cp_async_wait<1>();  // every group but the newest: tile t is in
    __syncthreads();
    const int st = t & 1;
    const float* sK;
    const float* sV;
    if constexpr (S::kWiden) {
      widen<S, KV>(ring + (2 * st) * S::kRingTile, sScale + (2 * st) * kKeys,
                   sKw);
      widen<S, KV>(ring + (2 * st + 1) * S::kRingTile,
                   sScale + (2 * st + 1) * kKeys, sVw);
      __syncthreads();
      sK = sKw;
      sV = sVw;
    } else {
      sK = reinterpret_cast<const float*>(ring + (2 * st) * S::kRingTile);
      sV = reinterpret_cast<const float*>(ring + (2 * st + 1) * S::kRingTile);
    }

    const int k0 = t * kKeys;
    if (k0 <= wmax) {  // warp-uniform: some row of this warp sees the tile
      // ---- S = Q K^T: 8 rows x kRN keys over this lane's d-slice
      float a[8][kRN];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) a[i][j] = 0.f;
#pragma unroll 2
      for (int step = 0; step < DP / (4 * kDS); ++step) {
        const int c = 4 * (kDS * step + slice);
        float4 q[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          q[i] = *reinterpret_cast<const float4*>(sQ + (qrow + i) * kQS + c);
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const float4 k =
              *reinterpret_cast<const float4*>(sK + (kb + kNKB * j) * kKS + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            a[i][j] = fmaf(q[i].x, k.x, a[i][j]);
            a[i][j] = fmaf(q[i].y, k.y, a[i][j]);
            a[i][j] = fmaf(q[i].z, k.z, a[i][j]);
            a[i][j] = fmaf(q[i].w, k.w, a[i][j]);
          }
        }
      }
      scatter_rows<kDS / 2, 8, kRN>(a, lane);
      // ---- scale, mask, online softmax of the lane's rows: one rescale a
      // row and tile; P and each row's corr to the warp's shared rows
      const bool need_mask = k0 + kKeys - 1 > wmin || k0 + kKeys > kend;
#pragma unroll
      for (int i = 0; i < kRPL; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          float v = __fmul_rn(a[i][j], sl);
          if (need_mask) {
            const int kp = k0 + kb + kNKB * j;
            v = (kp <= rpos[i] && kp < kend) ? v : -INFINITY;
          }
          a[i][j] = v;
          mx = fmaxf(mx, v);
        }
#pragma unroll
        for (int o = kDS; o < kDS * kNKB; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[i], mx);
        const float corr = attn_tile::ex2(m[i] - mn);
        m[i] = mn;
        l[i] = __fmul_rn(l[i], corr);
        float* prow = sP + (srow + i) * kPS + kb;
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const float p = attn_tile::ex2(a[i][j] - mn);
          l[i] += p;
          prow[kNKB * j] = p;
        }
        if (kb == 0) sC[srow + i] = corr;
      }
      __syncwarp();  // the warp's P and corr are written; the warp reads them
      // ---- O = O corr + P V: 8 rows x DP / kNCG columns, keys in order
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float corr = sC[orow + i];
#pragma unroll
        for (int c = 0; c < kF4; ++c) {
          o4[i][c].x = __fmul_rn(o4[i][c].x, corr);
          o4[i][c].y = __fmul_rn(o4[i][c].y, corr);
          o4[i][c].z = __fmul_rn(o4[i][c].z, corr);
          o4[i][c].w = __fmul_rn(o4[i][c].w, corr);
        }
#pragma unroll
        for (int c = 0; c < kR1; ++c) o1[i][c] = __fmul_rn(o1[i][c], corr);
      }
#pragma unroll 1
      for (int c4 = 0; c4 < kKeys / 4; ++c4) {
        float4 pr[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pr[i] = *reinterpret_cast<const float4*>(sP + (orow + i) * kPS +
                                                   4 * c4);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* vrow = sV + (4 * c4 + cc) * kKS;
          float4 v4[kF4 > 0 ? kF4 : 1];
          float v1[kR1 > 0 ? kR1 : 1];
#pragma unroll
          for (int c = 0; c < kF4; ++c)
            v4[c] = *reinterpret_cast<const float4*>(vrow + 4 * cg +
                                                     4 * kNCG * c);
#pragma unroll
          for (int c = 0; c < kR1; ++c)
            v1[c] = vrow[4 * kNCG * kF4 + cg + kNCG * c];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p = lane4(pr[i], cc);
#pragma unroll
            for (int c = 0; c < kF4; ++c) {
              o4[i][c].x = fmaf(p, v4[c].x, o4[i][c].x);
              o4[i][c].y = fmaf(p, v4[c].y, o4[i][c].y);
              o4[i][c].z = fmaf(p, v4[c].z, o4[i][c].z);
              o4[i][c].w = fmaf(p, v4[c].w, o4[i][c].w);
            }
#pragma unroll
            for (int c = 0; c < kR1; ++c) o1[i][c] = fmaf(p, v1[c], o1[i][c]);
          }
        }
      }
    }
    __syncthreads();  // this stage, P and corr may be overwritten from here on
  }
  attn_tile::cp_async_wait<0>();

  // ---- epilogue: each row's l to shared memory; out = O / max(l, 1e-30)
  if (!rowed) return;
#pragma unroll
  for (int i = 0; i < kRPL; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = kDS; o < kDS * kNKB; o <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, o);
    const int r = row0 + srow + i;
    if (kb == 0) {
      sL[srow + i] = li;
      if constexpr (attn_tile::HasLse<Src>::value) {
        // m is in log2 units of the scaled scores: back to natural logs
        if (r < src.rows)
          src.store_lse(r, (m[i] + log2f(fmaxf(li, 1e-30f))) * kLn2);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + orow + i;
    if (r >= src.rows) continue;
    const float inv = 1.f / fmaxf(sL[orow + i], 1e-30f);
    auto* dst = src.out_row(r);
#pragma unroll
    for (int c = 0; c < kF4; ++c) {
      const int d = 4 * cg + 4 * kNCG * c;
      if (d < src.D) store_f32(dst + d, o4[i][c].x * inv);
      if (d + 1 < src.D) store_f32(dst + d + 1, o4[i][c].y * inv);
      if (d + 2 < src.D) store_f32(dst + d + 2, o4[i][c].z * inv);
      if (d + 3 < src.D) store_f32(dst + d + 3, o4[i][c].w * inv);
    }
#pragma unroll
    for (int c = 0; c < kR1; ++c) {
      const int d = 4 * kNCG * kF4 + cg + kNCG * c;
      if (d < src.D) store_f32(dst + d, o1[i][c] * inv);
    }
  }
}

}  // namespace attn_f32
