// K1 — Markov (prev, cur) pair histogram over a (R, n) uint8 unit batch.
//
// Replaces mhc_tpu/ops/kernels/histogram_pallas.py::markov_hist_pallas
// (pallas_call at :98, body _hist_kernel :32). The TPU kernel turns the
// count into a one-hot MXU matmul because Mosaic has no scatter; on
// Hopper the count is a shared-memory atomic increment per position.
//
// Contract: counts[prev][cur] over every position j < n_valid[b] of every
// unit b, where prev is the unit's previous byte and 0 at j = 0 (the
// Markov context resets per unit). Exact int32 counts.
//
// Bound: one pass over the input (1 byte per symbol read per prev half)
// and one shared-memory atomic per symbol; skewed data (runs, zeros)
// serialises the atomics of a warp on one bin. 65,536 int32 bins are
// 256 KB, more than the 227 KB a block may hold, so the prev range is
// split over gridDim.y = 2: each block keeps a 128 KB sub-histogram of
// 128 prev rows and skips positions of the other half, then adds its
// non-zero bins to the global (256, 256) table with atomics.

#include "common.cuh"

namespace {

constexpr int kHalfRows = 128;              // prev rows per block
constexpr int kBins = kHalfRows * 256;      // 32,768 int32 = 128 KB
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
markov_hist_kernel(const uint8_t* __restrict__ units,
                   const int32_t* __restrict__ n_valid, int64_t R,
                   int64_t n, int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  const int half = blockIdx.y;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) bins[k] = 0;
  __syncthreads();

  for (int64_t b = blockIdx.x; b < R; b += gridDim.x) {
    const int64_t nv = mhc_clamp(n_valid[b], 0, n);
    const uint8_t* row = units + b * n;
    for (int64_t j = threadIdx.x; j < nv; j += blockDim.x) {
      const int cur = __ldg(row + j);
      const int prev = j ? __ldg(row + j - 1) : 0;
      if ((prev >> 7) == half)
        atomicAdd(&bins[((prev & (kHalfRows - 1)) << 8) | cur], 1);
    }
  }
  __syncthreads();

  int32_t* dst = out + (int64_t)half * kBins;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) {
    const int32_t v = bins[k];
    if (v) atomicAdd(dst + k, v);
  }
}

}  // namespace

// out: (256, 256) int32, zeroed by the caller.
extern "C" int mhc_markov_hist(const uint8_t* units, const int32_t* n_valid,
                               int64_t R, int64_t n, int32_t* out,
                               cudaStream_t stream) {
  const int smem = kBins * sizeof(int32_t);
  cudaFuncSetAttribute(markov_hist_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // one 128 KB block fits an SM: one wave of blocks over both halves
  const int64_t gx =
      std::max<int64_t>(1, std::min<int64_t>(R, mhc_num_sms() / 2));
  dim3 grid((unsigned)gx, 2);
  markov_hist_kernel<<<grid, kThreads, smem, stream>>>(units, n_valid, R, n,
                                                       out);
  return (int)cudaGetLastError();
}
