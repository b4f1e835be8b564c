// The histogram kernels over a (R, n) uint8 unit batch: K1, the Markov
// (prev, cur) pair histogram, and K2, the order-0 byte histogram.
//
// K1:
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
//
// K2 replaces mhc_tpu/ops/kernels/histogram_pallas.py::order0_hist_pallas
// (pallas_call at :167, body _hist0_kernel), which compares each byte
// with a 256-wide iota and sums the one-hot rows on the VPU because
// Mosaic has no scatter. Contract: counts[c] = #{(b, j) : j < n_valid[b],
// units[b][j] = c}, exact int32.
//
// Bound: it reads the input once (100 MB on the order-0 main path), so
// device-memory bandwidth should bound it, as long as the shared-memory
// atomics keep up. Each of a block's 8 warps counts into its own 256-bin
// sub-histogram (8 x 1 KB), which spreads the atomics of the block over
// 8 copies; a warp's atomics on one bin (runs, zeros) still serialise.
// Blocks stride over units and read 16 bytes per thread per load where a
// row allows it; at the end each block sums its 8 sub-histograms and adds
// them to the global 256 bins with one atomic per non-zero bin. Exact
// counts, so the order of the atomics does not matter.

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

constexpr int kWarps0 = 8;
constexpr int kThreads0 = kWarps0 * 32;

__device__ __forceinline__ void count_word(int* hist, uint32_t w) {
  atomicAdd(&hist[w & 0xFF], 1);
  atomicAdd(&hist[(w >> 8) & 0xFF], 1);
  atomicAdd(&hist[(w >> 16) & 0xFF], 1);
  atomicAdd(&hist[w >> 24], 1);
}

// vec: n % 16 == 0 and units 16-byte aligned (checked by the host).
__global__ void __launch_bounds__(kThreads0)
order0_hist_kernel(const uint8_t* __restrict__ units,
                   const int32_t* __restrict__ n_valid, int64_t R,
                   int64_t n, int32_t* __restrict__ out, bool vec) {
  __shared__ int bins[kWarps0 * 256];
  for (int k = threadIdx.x; k < kWarps0 * 256; k += blockDim.x) bins[k] = 0;
  __syncthreads();
  int* hist = bins + (threadIdx.x / 32) * 256;

  for (int64_t b = blockIdx.x; b < R; b += gridDim.x) {
    const int64_t nv = mhc_clamp(n_valid[b], 0, n);
    const uint8_t* row = units + b * n;
    int64_t done = 0;
    if (vec) {
      const uint4* row16 = reinterpret_cast<const uint4*>(row);
      done = nv / 16 * 16;
      for (int64_t q = threadIdx.x; q < nv / 16; q += blockDim.x) {
        const uint4 v = __ldg(row16 + q);
        count_word(hist, v.x);
        count_word(hist, v.y);
        count_word(hist, v.z);
        count_word(hist, v.w);
      }
    }
    for (int64_t j = done + threadIdx.x; j < nv; j += blockDim.x)
      atomicAdd(&hist[__ldg(row + j)], 1);
  }
  __syncthreads();

  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWarps0; ++w) v += bins[w * 256 + c];
    if (v) atomicAdd(out + c, v);
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

// out: (256,) int32, zeroed by the caller.
extern "C" int mhc_order0_hist(const uint8_t* units, const int32_t* n_valid,
                               int64_t R, int64_t n, int32_t* out,
                               cudaStream_t stream) {
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(units) % 16 == 0;
  // enough 256-thread blocks to fill every SM several times over
  const int64_t blocks =
      std::max<int64_t>(1, std::min<int64_t>(R, 8 * (int64_t)mhc_num_sms()));
  order0_hist_kernel<<<(unsigned)blocks, kThreads0, 0, stream>>>(
      units, n_valid, R, n, out, vec);
  return (int)cudaGetLastError();
}
