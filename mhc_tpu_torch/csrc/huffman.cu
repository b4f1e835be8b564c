// K11: deterministic length-limited Huffman code lengths of (rows, 256)
// counts, one 256-thread block per row (256 Markov contexts, or the one
// order-0 row).
//
// Replaces mhc_tpu/ops/huffman.py::code_lengths (:289) with
// rescale_counts_jax (:48): an XLA stage on the TPU (a vmapped two-queue
// merge in lax.fori_loops), not a Pallas kernel. The contract is the host
// builder's, rescale_counts -> code_lengths_np -> limit_lengths_np
// (:36, :68, :120), which the JAX build equals for every int32 input:
//   1. rescale: the row total in int64; shift = the least s with
//      total >> s < 2^28; w = c > 0 ? max(c >> s, 1) : 0. Unlike
//      rescale_counts_jax's fixed four-step shift (exact only for totals
//      below 2^32), this holds for any int64 total, so the device build
//      equals the host build for every input;
//   2. m = #{w > 0}: m = 0 gives all 0, m = 1 gives the symbol length 1;
//   3. leaves sorted by (w, symbol), absent symbols last; the two-queue
//      merge of m - 1 steps, ties to the leaf (lw <= iw); a leaf's length
//      is its depth below the root, internal node m - 2;
//   4. only where a length exceeds 15: the Kraft demotion loop and the
//      promotion pass on the per-length counts bl, then the new lengths
//      handed out in (clamped length, symbol) order.
// Integer arithmetic throughout: rescaled totals stay below 2^28 + 256, so
// every merge sum fits in int32.
//
// Bound. The bytes are tiny (256 KB of int32 counts in, 64 KB out: 0.0001
// ms at 3.35 TB/s), and so is the work the function needs (a sort of 256
// keys and at most 510 merge picks a row). What holds it is the merge's
// latency, a floor far above that bound, serial by nature: at
// most 2 (m - 1) = 510 picks a row, each waiting on the shared-memory
// loads the pick before it chose (~29 cycles each on an H100), with every
// row in flight at once (256 blocks of 256 threads, 4 KB of shared memory
// each, fit one wave on 132 SMs). The rest is parallel over the block:
//   - the sort gives each thread its symbol's rank by counting the keys
//     below it (256 broadcast reads of shared memory a thread);
//   - the merge and the Kraft repair run on thread 0;
//   - each thread walks from its leaf to the root for its length (the
//     chain is the code length, at most m - 1 steps, ~10 on real data);
//   - the repair's reassignment ranks again by counting.

#include "common.cuh"

namespace {

constexpr int kSyms = 256;
constexpr int kMaxLen = 15;
constexpr int64_t kMaxTotal = int64_t(1) << 28;
constexpr int32_t kInf = int32_t(1) << 30;

// #{j : (key[j], j) < (key[s], s)}: the rank of symbol s in (key, symbol)
// order. Every thread reads key[j] at the same j (a broadcast).
__device__ __forceinline__ int rank_of(const int32_t* key, int s) {
  const int32_t ks = key[s];
  int r = 0;
#pragma unroll 8
  for (int j = 0; j < kSyms; ++j) {
    const int32_t kj = key[j];
    r += (kj < ks) | ((kj == ks) & (j < s));
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kSyms)
    code_lengths_kernel(const T* __restrict__ counts,
                        uint8_t* __restrict__ out) {
  __shared__ long long warp_sums[kSyms / 32];
  __shared__ int32_t key[kSyms];
  __shared__ int32_t leaf_w[kSyms];       // weights in (w, symbol) order
  __shared__ int32_t int_w[kSyms];        // internal node weights
  __shared__ int32_t leaf_parent[kSyms];  // by sorted leaf
  __shared__ int32_t int_parent[kSyms];
  __shared__ int32_t bl[kMaxLen + 1];     // codes per clamped length

  const int s = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kSyms;
  const long long c = (long long)counts[base + s];

  // 1. rescale against the int64 row total
  long long v = c;
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((s & 31) == 0) warp_sums[s >> 5] = v;
  __syncthreads();
  long long total = 0;
  for (int k = 0; k < kSyms / 32; ++k) total += warp_sums[k];
  int shift = 0;
  while ((total >> shift) >= kMaxTotal) ++shift;
  const long long scaled = c >> shift;
  const int32_t w = c > 0 ? (int32_t)(scaled > 1 ? scaled : 1) : 0;
  const bool present = w > 0;

  // 2. the degenerate rows (m is the same in every thread)
  const int m = __syncthreads_count(present);
  if (m <= 1) {
    out[base + s] = present ? 1 : 0;
    return;
  }

  // 3. sort, merge, depths
  key[s] = present ? w : kInf;
  __syncthreads();
  const int rank = rank_of(key, s);
  leaf_w[rank] = key[s];
  __syncthreads();
  if (s == 0) {
    int i = 0, j = 0;
    for (int t = 0; t < m - 1; ++t) {
      int32_t sum = 0;
      for (int pick = 0; pick < 2; ++pick) {
        const int32_t lw = i < m ? leaf_w[i] : kInf;
        const int32_t iw = j < t ? int_w[j] : kInf;
        if (lw <= iw) {
          leaf_parent[i++] = t;
          sum += lw;
        } else {
          int_parent[j++] = t;
          sum += iw;
        }
      }
      int_w[t] = sum;
    }
  }
  __syncthreads();
  int len = 0;
  if (present) {
    int node = leaf_parent[rank];
    len = 1;
    while (node != m - 2) {
      node = int_parent[node];
      ++len;
    }
  }

  // 4. the length limit, only where a length exceeds it
  if (!__syncthreads_or(len > kMaxLen)) {
    out[base + s] = (uint8_t)len;
    return;
  }
  const int clamped = len < kMaxLen ? len : kMaxLen;
  if (s <= kMaxLen) bl[s] = 0;
  __syncthreads();
  if (present) atomicAdd(&bl[clamped], 1);
  __syncthreads();
  if (s == 0) {
    const int32_t budget = 1 << kMaxLen;
    int32_t K = 0;
    for (int l = 1; l <= kMaxLen; ++l) K += bl[l] << (kMaxLen - l);
    while (K > budget) {
      // demote one leaf from the deepest level below the limit
      int bits = kMaxLen - 1;
      while (bits > 1 && bl[bits] == 0) --bits;
      --bl[bits];
      ++bl[bits + 1];
      K -= 1 << (kMaxLen - bits - 1);
    }
    int32_t slack = budget - K;
    for (int l = kMaxLen; l > 1; --l) {
      const int32_t cost = 1 << (kMaxLen - l);
      const int32_t k = min(bl[l], slack / cost);
      bl[l] -= k;
      bl[l - 1] += k;
      slack -= k * cost;
    }
  }
  key[s] = present ? clamped : kMaxLen + 1;
  __syncthreads();
  if (present) {
    // the r-th code in (clamped length, symbol) order takes the least l
    // with bl[1] + ... + bl[l] > r
    const int r = rank_of(key, s);
    int l = 1, cum = bl[1];
    while (cum <= r) cum += bl[++l];
    len = l;
  }
  out[base + s] = (uint8_t)len;
}

}  // namespace

// counts: (rows, 256) int32 (is64 == 0) or int64 (is64 != 0), contiguous;
// out: (rows, 256) uint8. Launches on `stream`; returns cudaGetLastError().
extern "C" int mhc_code_lengths(const void* counts, int is64, int64_t rows,
                                uint8_t* out, cudaStream_t stream) {
  if (rows < 0 || rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  if (is64)
    code_lengths_kernel<long long><<<(unsigned)rows, kSyms, 0, stream>>>(
        static_cast<const long long*>(counts), out);
  else
    code_lengths_kernel<int32_t><<<(unsigned)rows, kSyms, 0, stream>>>(
        static_cast<const int32_t*>(counts), out);
  return (int)cudaGetLastError();
}
