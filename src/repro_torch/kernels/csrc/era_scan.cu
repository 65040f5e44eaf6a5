// WFE cleanup() interval scan (paper Fig. 4, Theorem 4), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/era_scan.py:
// era_scan_interval (:96, kernel _era_scan_kernel :54).  Retired block i
// is deletable iff no reservation slot s with lo[s] != INT32_MAX has
// lo[s] <= retire[i] and alloc[i] <= hi[s].  The mask is bitwise that of
// the era table's NumPy backend on every int32 input.
//
// What bounds it on an H100: the int32 lanes (16.75 TOP/s), at two and a
// half instructions for each pair of a retired row and a VALID slot: two
// compares (ISETP, the second taking the first's predicate as its AND
// input) and half a PLOP3, which ORs two pairs at once into a row's
// conflict bit (so the compiled inner loop does it).  The operands are a
// few hundred KB at most (R 65536, S 5120: 0.6 MB), so bytes never bound
// it.  Empty slots (lo == INT32_MAX) never conflict, and while serving
// most slots are empty.
//
// Design.
// * Only the slots that can conflict.  A CTA stages the slots in chunks of
//   kChunk: each warp loads a contiguous segment, counts its valid slots
//   with a ballot, and after one barrier writes them, in slot order, into
//   shared memory at its prefix offset.  The inner loop then reads one
//   broadcast (lo, hi) pair per slot and tests it against every row the
//   lane holds: no validity test, no empty slot.
// * A grid sized to the card, in one launch.  A CTA owns a tile of
//   32 * RPL retired rows (RPL rows per lane, the same rows in every warp)
//   and its kWarps warps split the compacted slots (slot k to warp
//   k % kWarps).  Their conflict bits meet in shared memory as plain byte
//   stores of 1 (any order gives the same bytes), so there is no atomic
//   and no memset launch; a barrier later every warp reads the merged
//   bits back, and warp 0 writes the mask.
// * Early exit.  A warp whose rows have all conflicted stops scanning
//   (__all_sync every kCheck slots), and a CTA whose whole tile has
//   conflicted after a chunk skips the rest: a conflicted row stays
//   conflicted, so both are exact.
// * The tile, fixed by R (launch): RPL 4 from kWideRows rows on, where
//   128-row tiles still give two CTAs per SM (264 CTAs of the 132 SMs),
//   else RPL 1 (R 4096: 128 CTAs, against 16 before this design).  Four
//   rows per lane amortise each shared load and each staged chunk over
//   four rows; one row per lane gives the small scans the most CTAs.
//   tools/era_scan_ab.py times both tiles at the threshold (R 33791
//   against R 33792); PERF.md has the figures.
//
// era_scan_round_trip is the route the era table's ``cuda`` backend takes
// from its NumPy mirrors: one host-to-device copy of the four mirrors,
// packed into one pinned buffer, the launch, one device-to-host copy of
// the mask into pinned memory and one stream synchronisation, in one call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 2048;                    // slots staged per round
constexpr int kGroups = kChunk / kThreads;      // 32-slot groups per warp
constexpr int kCheck = 64;                      // slots between exit votes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideRows = 264 * 32 * 4;  // from here on, RPL 4

template <int RPL>
__device__ __forceinline__ bool all_of(const bool (&c)[RPL]) {
  bool all = true;
#pragma unroll
  for (int j = 0; j < RPL; ++j) all &= c[j];
  return all;
}

template <int RPL>
__global__ void __launch_bounds__(kThreads)
era_scan_kernel(const int32_t* __restrict__ alloc,
                const int32_t* __restrict__ retire,
                const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                uint8_t* __restrict__ deletable, int R, int S) {
  constexpr int kTile = 32 * RPL;
  __shared__ int2 slots[kChunk];     // compacted (lo, hi) of valid slots
  __shared__ int counts[kWarps];     // valid slots per warp segment
  __shared__ uint8_t conflict[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kTile;

  int32_t a[RPL], r[RPL];
  bool c[RPL];
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int i = row0 + j * 32 + lane;
    const bool in = i < R;
    a[j] = in ? alloc[i] : 0;
    r[j] = in ? retire[i] : 0;
    c[j] = !in;  // rows past R never hold up an exit and are not written
  }
  for (int t = threadIdx.x; t < kTile; t += kThreads) conflict[t] = 0;

  for (int base = 0; base < S; base += kChunk) {
    // 1. this warp's segment of the chunk: load, and count the valid slots
    const int seg = base + warp * kGroups * 32;
    int2 v[kGroups];
    unsigned valid[kGroups];
    int n = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int s = seg + g * 32 + lane;
      const bool in = s < S;
      v[g] = make_int2(in ? lo[s] : INT32_MAX, in ? hi[s] : 0);
      valid[g] = __ballot_sync(kFull, v[g].x != INT32_MAX);
      n += __popc(valid[g]);
    }
    if (lane == 0) counts[warp] = n;
    __syncthreads();
    // 2. write the valid slots, in slot order, at the segment's offset
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = counts[w];
      off += w < warp ? cw : 0;
      total += cw;
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (v[g].x != INT32_MAX) slots[off + __popc(valid[g] & below)] = v[g];
      off += __popc(valid[g]);
    }
    __syncthreads();
    // 3. this warp's share of the valid slots against the tile's rows
    const int mine = total > warp ? (total - warp + kWarps - 1) / kWarps : 0;
    const int2* p = slots + warp;
    for (int q = 0; q < mine;) {
      if (__all_sync(kFull, all_of(c))) break;
      const int end = min(q + kCheck, mine);
#pragma unroll 8
      for (; q < end; ++q) {
        const int2 e = p[q * kWarps];
#pragma unroll
        for (int j = 0; j < RPL; ++j) c[j] |= (e.x <= r[j]) & (a[j] <= e.y);
      }
    }
    // 4. merge the warps' bits: every writer stores the same byte
#pragma unroll
    for (int j = 0; j < RPL; ++j)
      if (c[j]) conflict[j * 32 + lane] = 1;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPL; ++j) c[j] |= conflict[j * 32 + lane] != 0;
    // every warp read the same bytes after the barrier: a uniform exit
    if (__all_sync(kFull, all_of(c))) break;
  }
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int i = row0 + j * 32 + lane;
      if (i < R) deletable[i] = c[j] ? 0 : 1;
    }
  }
}

int launch(const int32_t* alloc, const int32_t* retire, const int32_t* lo,
           const int32_t* hi, uint8_t* deletable, int R, int S,
           cudaStream_t stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R >= kWideRows) {
    era_scan_kernel<4><<<(R + 127) / 128, kThreads, 0, stream>>>(
        alloc, retire, lo, hi, deletable, R, S);
  } else {
    era_scan_kernel<1><<<(R + 31) / 32, kThreads, 0, stream>>>(
        alloc, retire, lo, hi, deletable, R, S);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// alloc, retire: (R,) int32; lo, hi: (S,) int32; deletable: (R,) bool.
// Launches on ``stream`` and returns the cudaError_t of the launch.
extern "C" int era_scan_interval(const void* alloc, const void* retire,
                                 const void* lo, const void* hi,
                                 void* deletable, int R, int S,
                                 void* stream) {
  return launch(static_cast<const int32_t*>(alloc),
                static_cast<const int32_t*>(retire),
                static_cast<const int32_t*>(lo),
                static_cast<const int32_t*>(hi),
                static_cast<uint8_t*>(deletable), R, S,
                static_cast<cudaStream_t>(stream));
}

// The ``cuda`` backend's round trip.  host_in (pinned) holds
// [alloc (R) | retire (R) | lo (S) | hi (S)] int32; it is copied to
// dev_in, scanned into dev_mask, and the (R,) mask copied to host_mask
// (pinned); the call returns after synchronising ``stream``, with the
// first cudaError_t met (0 on success).
extern "C" int era_scan_round_trip(const void* host_in, void* dev_in,
                                   void* dev_mask, void* host_mask, int R,
                                   int S, void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = 2 * static_cast<size_t>(R) + 2 * static_cast<size_t>(S);
  cudaError_t err = cudaMemcpyAsync(dev_in, host_in, n * sizeof(int32_t),
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* d = static_cast<const int32_t*>(dev_in);
  const int launched = launch(d, d + R, d + 2 * static_cast<size_t>(R),
                              d + 2 * static_cast<size_t>(R) + S,
                              static_cast<uint8_t*>(dev_mask), R, S, st);
  if (launched != 0) return launched;
  err = cudaMemcpyAsync(host_mask, dev_mask, static_cast<size_t>(R),
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(st));
}
