// A tensor-core attention tile for sm_90a, shared by the dense flash
// attention kernel (flash_attention.cu) and the paged chunk kernel
// (paged_attention.cu).
//
// For a bf16 query it takes the place of the CUDA-core walks as the port
// of the body of repro/kernels/flash_attention.py:_flash_kernel (:33) and of
// repro/kernels/paged_attention.py:_chunk_kernel_body (:57), with its
// int8 variant _paged_chunk_kernel_q8 (:129).  The two kernels differ only
// in where a query row and a key row live, so the tile takes a source
// (`Src`) that names them and does the rest.
//
// Design.  One warpgroup (4 warps, 128 threads) owns a tile of 64 query
// rows; each warp owns 16 of them.  Rows are (position, group) pairs,
// position-major, so GQA needs no extra pass.  Q is copied once into
// shared memory as bf16 and held in registers as mma A fragments.  The
// tile walks K/V tiles of 64 keys through a two-stage ring in shared
// memory filled by cp.async (16-byte, .cg): tile t+1's copy is in flight
// while tile t is multiplied.  S = Q K^T and O += P V run on the tensor
// cores as mma.sync.m16n8k16 (bf16 in, f32 accumulate) with ldmatrix
// fragments; P is rounded to bf16 for the P V product, the running max,
// sum and accumulator stay f32, and the exponentials are the SFU's
// ex2.approx on log2-scaled scores.  D = 80 is 5 k-steps of 16 for S and
// 10 n-tiles of 8 for O: no padding to 128.  Rows in shared memory are
// padded by 16 bytes so the 8 row addresses of an ldmatrix hit distinct
// banks.  Two 16-row m-tiles per warp (128-row tiles, each K/V fragment
// used twice) were measured slower: 255 registers and spills at D = 128.
//
// D = 256 (gemma).  A warp's O accumulator is 16 x 256 f32, 128 registers
// a thread; Q held as A fragments would add 64 and S over 64 keys 32, past
// the 255 a thread may have.  So at D > 128 the tile walks K/V tiles of 32
// keys (S is 16 registers) and reloads each k-step's Q fragment from
// shared memory (Q stays there for the whole walk) instead of holding all
// of Q in registers; FlashAttention-2 cuts its hdim-256 tiles the same
// way.  Shared memory: Q 33 KB plus a two-stage ring of 32-key K/V tiles,
// 66 KB (bf16) or 34 KB of codes plus 33 KB widened (int8).
//
// Why mma.sync and not wgmma: wgmma reads its B operand from shared
// memory through a descriptor whose layouts are 32/64/128-byte swizzle
// atoms or 8x16-byte core matrices.  A D = 80 row is 160 bytes and fits
// no swizzle atom, and paged K/V rows arrive one key at a time from
// scattered pages, so the tile would need a re-layout pass per stage.
// mma.sync takes ldmatrix fragments from plainly padded rows at any
// multiple of 16 in D; moving to wgmma (and TMA) is later work.
//
// Masking.  A key row past the walk bound (`kend`: past T, or in a table
// slot at or past the live bound) is zero-filled by cp.async's src-size 0
// and never read from device memory, so a NaN there cannot meet a zero of
// P.  Masked scores are set with a select, never by adding -inf.  A warp
// whose rows see no key of a tile skips it: its update would be an exact
// no-op (corr = 1, p = 0), so the bounded and the unbounded walks stay
// bitwise equal.  The online softmax is the TPU kernel's: running m and l
// in f32, corr = exp(m_prev - m_new), and out = acc / max(l, 1e-30), so an
// all-masked row writes 0.
//
// Int8 pages.  Codes are copied as they are and widened to bf16 in shared
// memory (exact: |code| <= 127).  The k scale of a key's table slot
// multiplies that key's column of S; the v scale multiplies P's column
// before P is rounded to bf16; l sums the unscaled P.  A scale is copied
// only for a live key, through the same table entry as its page.
//
// What bounds it on an H100: a prefill tile does 4 * D flops per visible
// (row, key) pair against the bytes of q, out and the K/V tiles it reads,
// so it is bound by tensor-core operations (989 TFLOP/s bf16).  mma.sync
// reaches a fraction of that rate; the two-stage ring hides the loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace attn_tile {

constexpr int kRows = 64;      // query rows per tile, 16 per warp
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;  // the running max's floor
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static_assert(D % 16 == 0 && D <= 256, "head_dim must be a multiple of 16, <= 256");
  static constexpr int kKeys = D > 128 ? 32 : 64;  // keys per K/V tile
  static constexpr bool kQInRegs = D <= 128;  // else reloaded per k-step
  static constexpr int kStride = D + 8;     // bf16 elements per smem row
  static constexpr int kRawStride = D + 16; // bytes per raw int8 smem row
  static constexpr int kKSteps = D / 16;    // k-steps of S = Q K^T
  static constexpr int kNTiles = D / 8;     // n-tiles of O
  static constexpr int kTile = kKeys * kStride;  // bf16 elements of a K or V tile
};

// Dynamic shared memory a tile needs, in bytes.
template <int D, bool kQ8>
__host__ __device__ constexpr size_t smem_bytes() {
  using S = Shape<D>;
  size_t q = sizeof(__nv_bfloat16) * kRows * S::kStride;
  if (!kQ8) return q + sizeof(__nv_bfloat16) * kStages * 2 * S::kTile;
  return q + (size_t)kStages * 2 * S::kKeys * S::kRawStride  // raw code ring
         + sizeof(__nv_bfloat16) * 2 * S::kTile              // widened K, V
         + sizeof(float) * kStages * 2 * S::kKeys;           // scale ring
}

// Whether a source takes the rows' log-sum-exp (store_lse).
template <class Src, class = void>
struct HasLse : std::false_type {};
template <class Src>
struct HasLse<Src, std::void_t<decltype(std::declval<const Src&>().store_lse(
                       0, 0.f))>> : std::true_type {};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx: 2 ulp; 2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Widen 16 int8 codes to 16 bf16 (exact).
__device__ __forceinline__ void widen16(const int8_t* src,
                                        __nv_bfloat16* dst) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack_bf16(static_cast<float>(c[2 * i]),
                     static_cast<float>(c[2 * i + 1]));
  reinterpret_cast<int4*>(dst)[0] = make_int4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<int4*>(dst)[1] = make_int4(w[4], w[5], w[6], w[7]);
}

// One tile of 64 query rows [row0, row0 + 64) against keys [0, kend),
// walked in K/V tiles of Shape<D>::kKeys keys;
// warp w owns rows [row0 + 16 w, row0 + 16 w + 16).
//
// Src provides, for rows r < src.rows and keys kp < kend:
//   void store_lse(int r, float lse) -- optional: where present, it is
//     given each row's log-sum-exp, m + log(l) in natural-log units of
//     the scaled scores (the flash backward reads it); the output is the
//     same with or without it
//   const __nv_bfloat16* q_row(int r); __nv_bfloat16* out_row(int r);
//   int pos(int r)   -- the row's absolute position (keys <= pos are seen)
//   const KV* k_row(int kp), v_row(int kp)   -- D contiguous elements
//   const float* k_scale(int kp), v_scale(int kp)   -- int8 pages only
//   const void* base -- any valid global address (operand of a zero copy)
// Keys at or past kend are neither read nor seen.  `scale` is the softmax
// scale.  Every thread of the block calls it.
template <int D, bool kQ8, class Src>
__device__ __forceinline__ void run(const Src& src, int row0, int kend,
                                    float scale, char* smem) {
  using S = Shape<D>;
  using KV = typename Src::KV;
  constexpr int kKeys = S::kKeys;
  constexpr int kNT = kKeys / 8;   // n-tiles of S (8 keys each)
  constexpr int kKP = kKeys / 16;  // k-steps of P V (16 keys each)
  constexpr int kCpr = D * sizeof(KV) / 16;  // 16-byte chunks per K/V row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // row within an 8-row half of the warp's 16
  const int tig = lane & 3;   // column pair within an n-tile
  const int wrow = warp * 16;  // the warp's first row in the tile

  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  char* ring = smem + sizeof(__nv_bfloat16) * kRows * S::kStride;
  // bf16 pages: stage s holds K at ring[2s], V at ring[2s + 1] (bf16 tiles)
  // int8 pages: the same order of raw code tiles, then widened K and V,
  // then the scale ring (k at [2s], v at [2s + 1], kKeys floats each)
  constexpr size_t kRingTile =
      kQ8 ? (size_t)kKeys * S::kRawStride : sizeof(__nv_bfloat16) * S::kTile;
  __nv_bfloat16* sKw = reinterpret_cast<__nv_bfloat16*>(
      ring + kStages * 2 * kRingTile);
  __nv_bfloat16* sVw = sKw + S::kTile;
  float* sScale = reinterpret_cast<float*>(sVw + S::kTile);

  // ---- the positions of this thread's rows; the warp's bounds
  int rpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + wrow + gid + 8 * i;
    rpos[i] = r < src.rows ? src.pos(r) : -1;
  }
  int wmax = max(rpos[0], rpos[1]), wmin = min(rpos[0], rpos[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
  }

  // ---- copies
  for (int c = tid; c < kRows * (D / 8); c += kThreads) {
    const int r = c / (D / 8), part = c % (D / 8);
    const bool ok = row0 + r < src.rows;
    cp_async16(sQ + r * S::kStride + part * 8,
               ok ? static_cast<const void*>(src.q_row(row0 + r) + part * 8)
                  : src.base,
               ok);
  }
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kKeys;
    char* kdst = ring + (2 * stage) * kRingTile;
    char* vdst = ring + (2 * stage + 1) * kRingTile;
    for (int c = tid; c < kKeys * kCpr; c += kThreads) {
      const int key = c / kCpr, part = c % kCpr;
      const int kp = k0 + key;
      const bool ok = kp < kend;
      const size_t off = kQ8 ? (size_t)key * S::kRawStride + part * 16
                             : sizeof(__nv_bfloat16) * (key * S::kStride + part * 8);
      cp_async16(kdst + off,
                 ok ? reinterpret_cast<const char*>(src.k_row(kp)) + part * 16
                    : static_cast<const char*>(src.base),
                 ok);
      cp_async16(vdst + off,
                 ok ? reinterpret_cast<const char*>(src.v_row(kp)) + part * 16
                    : static_cast<const char*>(src.base),
                 ok);
    }
    if constexpr (kQ8) {
      if (tid < kKeys) {
        const int kp = k0 + tid;
        const bool ok = kp < kend;
        cp_async4(sScale + (2 * stage) * kKeys + tid,
                  ok ? src.k_scale(kp) : src.base, ok);
        cp_async4(sScale + (2 * stage + 1) * kKeys + tid,
                  ok ? src.v_scale(kp) : src.base, ok);
      }
    }
  };

  const int ntiles = (kend + kKeys - 1) / kKeys;
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();  // group 0: Q and K/V tile 0

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float o[S::kNTiles][4];
#pragma unroll
  for (int n = 0; n < S::kNTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[S::kQInRegs ? S::kKSteps : 1][4];
  const float sl = scale * kLog2e;  // scores in log2 units: exp2 below

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile t has landed
    __syncthreads();
    if constexpr (S::kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < S::kKSteps; ++ks)
          ldsm_x4(qf[ks], sQ + (wrow + (lane & 15)) * S::kStride + ks * 16 +
                              (lane >> 4) * 8);
      }
    }
    const __nv_bfloat16* sK;
    const __nv_bfloat16* sV;
    const float* kscl = sScale + (2 * (t & 1)) * kKeys;
    const float* vscl = kscl + kKeys;
    if constexpr (kQ8) {
      const int8_t* rk =
          reinterpret_cast<const int8_t*>(ring + (2 * (t & 1)) * kRingTile);
      const int8_t* rv = rk + kRingTile;
      for (int c = tid; c < kKeys * (D / 16); c += kThreads) {
        const int key = c / (D / 16), part = c % (D / 16);
        widen16(rk + key * S::kRawStride + part * 16,
                sKw + key * S::kStride + part * 16);
        widen16(rv + key * S::kRawStride + part * 16,
                sVw + key * S::kStride + part * 16);
      }
      __syncthreads();
      sK = sKw;
      sV = sVw;
    } else {
      sK = reinterpret_cast<const __nv_bfloat16*>(ring +
                                                  (2 * (t & 1)) * kRingTile);
      sV = reinterpret_cast<const __nv_bfloat16*>(
          ring + (2 * (t & 1) + 1) * kRingTile);
    }

    const int k0 = t * kKeys;
    if (k0 <= wmax) {  // warp-uniform: some row of this warp sees the tile
      // ---- S = Q K^T, 16 rows x kKeys keys per warp
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < S::kKSteps; ++ks) {
        uint32_t qa[4];
        if constexpr (S::kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[ks][i];
        } else {
          ldsm_x4(qa, sQ + (wrow + (lane & 15)) * S::kStride + ks * 16 +
                          (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < kKP; ++np) {
          uint32_t b[4];
          ldsm_x4(b, sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * S::kStride +
                         ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, b[0], b[1]);
          mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        }
      }
      // ---- scale, mask, online softmax
      const bool need_mask = k0 + kKeys - 1 > wmin || k0 + kKeys > kend;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tig + (e & 1);
          float v = s[j][e] * (kQ8 ? sl * kscl[col] : sl);
          if (need_mask) {
            const int kp = k0 + col;
            v = (kp <= rpos[e >> 1] && kp < kend) ? v : -INFINITY;
          }
          s[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        corr[i] = ex2(m[i] - mn);
        m[i] = mn;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < S::kNTiles; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[j][e] = kQ8 ? p * vscl[8 * j + 2 * tig + (e & 1)] : p;
        }
      }
      // ---- O += P V: P's C fragments of two n-tiles are one A fragment
#pragma unroll
      for (int kk = 0; kk < kKP; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t b[4];
          ldsm_x4_t(b, sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                S::kStride +
                            nd * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * nd], a, b[0], b[1]);
          mma_bf16(o[2 * nd + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage may be overwritten from here on
  }
  cp_async_wait<0>();

  // ---- epilogue: out = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = row0 + wrow + gid + 8 * i;
    if (r >= src.rows) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    if constexpr (HasLse<Src>::value) {
      // m is in log2 units of the scaled scores: back to natural logs
      if (tig == 0) src.store_lse(r, (m[i] + log2f(fmaxf(li, 1e-30f))) *
                                         0.6931471805599453f);
    }
    __nv_bfloat16* dst = src.out_row(r);
#pragma unroll
    for (int n = 0; n < S::kNTiles; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * tig) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

}  // namespace attn_tile
