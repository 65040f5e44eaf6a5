// WFE cleanup() interval scan (paper Fig. 4, Theorem 4), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/era_scan.py:
// era_scan_interval (:96, kernel _era_scan_kernel :54).  Retired block i
// is deletable iff no reservation slot s with lo[s] != INT32_MAX has
// lo[s] <= retire[i] and alloc[i] <= hi[s].
//
// Design.  One thread per retired block.  The block stages the (lo, hi)
// reservation vectors through shared memory in tiles of blockDim entries,
// so each slot is read from device memory once per block, and every
// thread OR-reduces its conflicts over the tile.  R and S are not padded:
// the ragged edges are masked (threads past R still help stage tiles).
//
// What bounds it on an H100: R*S compares on 4*(2R + 2S) + R bytes.  At
// serving sizes (R in the thousands, S in the hundreds) the kernel itself
// takes microseconds; the host-to-device copy of the NumPy era mirrors
// and the mask's copy back, which the wrapper pays on every scan, cost
// more than the scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
era_scan_kernel(const int32_t* __restrict__ alloc,
                const int32_t* __restrict__ retire,
                const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                uint8_t* __restrict__ deletable, int R, int S) {
  __shared__ int32_t slo[kThreads];
  __shared__ int32_t shi[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool row = i < R;
  const int32_t a = row ? alloc[i] : 0;
  const int32_t r = row ? retire[i] : 0;
  bool conflict = false;
  for (int s0 = 0; s0 < S; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    // slots past S are staged as empty (lo == INT32_MAX never conflicts)
    slo[threadIdx.x] = s < S ? lo[s] : INT32_MAX;
    shi[threadIdx.x] = s < S ? hi[s] : INT32_MAX;
    __syncthreads();
    const int n = min(kThreads, S - s0);
    for (int k = 0; k < n; ++k) {
      const int32_t l = slo[k];
      conflict |= (l != INT32_MAX) & (l <= r) & (a <= shi[k]);
    }
    __syncthreads();
  }
  if (row) deletable[i] = conflict ? 0 : 1;
}

}  // namespace

// alloc, retire: (R,) int32; lo, hi: (S,) int32; deletable: (R,) bool.
// Returns the cudaError_t of the launch.
extern "C" int era_scan_interval(const void* alloc, const void* retire,
                                 const void* lo, const void* hi,
                                 void* deletable, int R, int S,
                                 void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kThreads - 1) / kThreads;
  era_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(alloc), static_cast<const int32_t*>(retire),
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<uint8_t*>(deletable), R, S);
  return static_cast<int>(cudaGetLastError());
}
