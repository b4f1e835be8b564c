// The histogram kernels over a (R, n) uint8 unit batch: K1, the Markov
// (prev, cur) pair histogram, and K2, the order-0 byte histogram.
//
// K1 replaces mhc_tpu/ops/kernels/histogram_pallas.py::markov_hist_pallas
// (pallas_call at :98, body _hist_kernel :32), K2 replaces
// histogram_pallas.py::order0_hist_pallas (pallas_call at :167, body
// _hist0_kernel :136). Mosaic has no scatter, so the TPU kernels count
// with one-hot matrices (K1 on the MXU, K2 on the VPU); on Hopper a count
// is a shared-memory atomic add.
//
// Contracts. K1: counts[prev][cur] over every position j < n_valid[b] of
// every unit b, where prev is the unit's previous byte and 0 at j = 0
// (the Markov context resets per unit). K2: counts[c] = #{(b, j) :
// j < n_valid[b], units[b][j] = c}. Exact int64 counts, added to an
// output the caller zeroed: a batch of 2^31 bytes or more can hold one
// cell 2^31 times or more (2.25 GiB of zeros puts 2,415,931,449 in cell
// (0, 0) and in byte 0), which an int32 table would wrap.
//
// Bound. Both read the input once (105 MB on the main paths: 0.031 ms at
// 3.35 TB/s) and do one shared-memory atomic per byte. K1's atomics
// return a value, and those of a warp that hit one address then
// serialise; the corpus makes many of them do so: little-endian u32
// counters (every 4th byte 0, the 3rd and 2nd barely changing, so equal
// pairs recur at one byte phase in every lane), a 64-byte pattern
// repeated (lanes 4 apart load equal vectors), text.
//
// Both run a grid of one wave and split the flat R x n/16 16-byte vectors
// into equal shares, one per block (a unit's start resets the context
// wherever it falls), so no block is left with a last unit to itself;
// a warp loads 32 consecutive vectors at a time (coalesced). Where
// n % 16 != 0 or the batch is not 16-byte aligned, a scalar path reads
// byte by byte.
//
// K1 walks its share one vector per lane per step, the next step's vector
// loaded before this one is counted. Every block holds the whole table,
// so each byte is read once: 65,536 int32 bins (256 KB) do not fit a
// block, so they are 16-bit counters, two to a word (bin prev*256+cur is
// half cur & 1 of word bin >> 1, 128 KB), one 1024-thread block per SM.
// A lane's first prev comes from the neighbouring lane (__shfl_up_sync),
// lane 0's from the byte before its vector. Each word of a vector is
// counted with its bytes rotated by (lane >> 2) & 3, so lanes at one step
// count different byte phases: the counters' equal pairs no longer meet
// at one address in every lane (PERF.md has the times with and without,
// and of a rotation of the whole vector, no faster). The pairs come two
// at a time from __byte_perm of the bytes and the bytes shifted by one.
// A field that passes 0xFFFF is credited to the global table by the
// atomic that wrapped it, read from the value that atomicAdd returns
// (never by a second shared atomic: a repair by atomicSub races with a
// carry into the other half). An increment of a field wraps it when the
// field was 0xFFFF in the returned word `old`:
// - a low field wrapped and carried 1 into the high field: the thread
//   adds 65,536 to the low bin and -1 to the high bin, and when that carry
//   wrapped the high field too (old >> 16 == 0xFFFF, the carry leaves the
//   word) 65,536 more to the high bin;
// - a high field wrapped: the thread adds 65,536 to the high bin.
// At the end the block stores its 32,768 words, as they are, to its row
// of a global scratch (128 KB, coalesced 16-byte stores), and a second
// kernel, `markov_merge_kernel`, adds each bin's fields over the rows
// into the global table, one thread a word: the table is int64 (a
// 2.25 GiB input can put 2^31 or more into one bin), and 64-bit atomics
// from every block, one a non-zero field (twice the 32-bit pair atomics
// of an int32 table, which must not carry from one bin into the next),
// cost K1 more than a tenth of its time at 100 MB on an NVIDIA H100 80GB
// HBM3 (PERF.md), where the scratch's 17 MB are stored and read once. The global bins add
// modulo 2^64 (a credited -1 is ~0), so a bin is exact at any count below
// 2^63. Why this is exact: a field's final value is the sum of what was
// added to it (its increments, and for a high field the carries into it)
// less 65,536 for each time it wrapped. Shared atomics on one word are
// applied one at a time, each to the word that the one before it left,
// and each returns that word: so every wrap and every carry is caused by
// exactly one atomic, that atomic alone sees it in its return value, and
// it credits it once. Summed over the blocks, global bin = increments +
// carries - carries (the -1 of each carry) + 65,536 per wrap - 65,536 per
// wrap = the count. Integer adds commute, so the order of the credits'
// atomics does not matter; the merge runs after every credit (stream
// order) and owns its two bins.
//
// K2 walks its share unit segment by unit segment (one n_valid load per
// segment), 256-thread blocks, eight per SM, one 256-bin copy per warp
// (copy i at word 257 i, so one bin of neighbouring copies falls in
// neighbouring banks); each block sums its copies and adds the non-zero
// bins to the global 256 with one atomic each. A full vector's 16 atomics
// go unpredicated: predicating each costs half again. Its atomics return
// nothing, and a warp's same-address increments without a return value
// cost little, so more copies per warp (more distinct addresses) and the
// rotation that helps K1 lose here; so do two or four loads in flight
// (PERF.md). The walk alone, its atomics removed, takes about the bytes
// bound; the atomics take the rest. Its shared and per-block counts are
// 32-bit: exact while a block's share, 1/1,056 of the batch on 132 SMs,
// stays under 2^31 bytes, so for any batch a card holds.

#include "common.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kThreads1 = 1024;           // K1: one block per SM
constexpr int kWords1 = 256 * 256 / 2;    // K1: two 16-bit bins per word
constexpr int kSmem1 = kWords1 * sizeof(uint32_t);
constexpr int kMergeThreads = 256;        // K1's merge: one word a thread
constexpr int kThreads2 = 256;            // K2: eight blocks per SM
constexpr int kBlocksPerSm2 = 2048 / kThreads2;
constexpr int kCopies2 = kThreads2 / 32;  // K2: one 256-bin copy per warp
constexpr int kStride2 = 257;             // K2: words between copies

// The block's equal share [begin, end) of `total` items.
__device__ __forceinline__ void block_share(int64_t total, int64_t& begin,
                                            int64_t& end) {
  begin = total * blockIdx.x / gridDim.x;
  end = total * (blockIdx.x + 1) / gridDim.x;
}

// Row and column of a flat index over rows of `width` items, moved
// forward by a fixed step without a division per step.
struct RowCursor {
  int64_t row;
  uint32_t col, width, step_rows, step_cols;
  __device__ RowCursor(int64_t flat, uint32_t w, uint32_t step)
      : row(flat / w), col((uint32_t)(flat % w)), width(w),
        step_rows(step / w), step_cols(step % w) {}
  __device__ __forceinline__ void advance() {
    row += step_rows;
    col += step_cols;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

// Walks the block's share of the flat 16-byte vectors of the batch and
// calls f(vector, byte before it in its unit (0 at a unit's start), valid
// positions 0..16). Lane l of warp w takes vector 32 w + l of each step.
// Needs n % 16 == 0 and 16-byte alignment.
template <class F>
__device__ __forceinline__ void walk_vectors(
    const uint8_t* __restrict__ units, const int32_t* __restrict__ n_valid,
    int64_t R, int64_t n, F&& f) {
  const uint4* units16 = reinterpret_cast<const uint4*>(units);
  const uint32_t nq = (uint32_t)(n / 16);
  int64_t begin, end;
  block_share(R * nq, begin, end);
  const int lane = threadIdx.x & 31;
  const uint32_t step = blockDim.x;
  const int64_t first = begin + (threadIdx.x & ~31u);  // the warp's first
  RowCursor c(first + lane, nq, step);
  // the vector at v + lane, and for lane 0 the byte before it
  auto load = [&](int64_t v, uint4& q, uint32_t& before) {
    const int64_t i = v + lane;
    q = i < end ? __ldg(units16 + i) : make_uint4(0, 0, 0, 0);
    before = lane == 0 && i < end && i > 0 ? __ldg(units + 16 * i - 1) : 0;
  };
  uint4 q;
  uint32_t before = 0;
  if (first < end) load(first, q, before);
  for (int64_t v = first; v < end; v += step) {
    uint4 q_next;
    uint32_t before_next = 0;
    if (v + step < end) load(v + step, q_next, before_next);
    uint32_t prev = __shfl_up_sync(kFull, q.w >> 24, 1);
    if (lane == 0) prev = before;
    if (c.col == 0) prev = 0;
    int m = 0;
    if (v + lane < end) {
      const int64_t nv = mhc_clamp(__ldg(n_valid + c.row), 0, n);
      m = (int)mhc_clamp(nv - 16 * (int64_t)c.col, 0, 16);
    }
    f(q, prev, m);
    c.advance();
    q = q_next;
    before = before_next;
  }
}

// The scalar path: calls f(byte, byte before it in its unit) for each
// valid position of the block's share, one per thread per step.
template <class F>
__device__ __forceinline__ void walk_bytes(
    const uint8_t* __restrict__ units, const int32_t* __restrict__ n_valid,
    int64_t R, int64_t n, F&& f) {
  int64_t begin, end;
  block_share(R * n, begin, end);
  RowCursor c(begin + threadIdx.x, (uint32_t)n, blockDim.x);
  for (int64_t p = begin + threadIdx.x; p < end; p += blockDim.x) {
    if (c.col < mhc_clamp(__ldg(n_valid + c.row), 0, n)) {
      const uint32_t prev = c.col ? __ldg(units + p - 1) : 0;
      f((uint32_t)__ldg(units + p), prev);
    }
    c.advance();
  }
}

// Byte k of a vector.
__device__ __forceinline__ uint32_t byte_of(const uint4& q, int k) {
  const uint32_t w = k < 4 ? q.x : k < 8 ? q.y : k < 12 ? q.z : q.w;
  return (w >> (8 * (k & 3))) & 0xFFu;
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// The global table's bins, added modulo 2^64.
using Count = unsigned long long;

// Credits the wrap of bin's 16-bit field by an increment of 1, given the
// word `old` its atomicAdd returned (see the note at the top): 65,536 to
// the bin; for a low field, the carry's -1 to the high bin, or 65,535
// where that carry wrapped the high field too.
__device__ __forceinline__ void credit_wrap(Count* __restrict__ out,
                                            uint32_t bin, uint32_t old) {
  atomicAdd(out + bin, (Count)65536);
  if (!(bin & 1))
    atomicAdd(out + (bin | 1),
              (old >> 16) == 0xFFFFu ? (Count)65535 : ~(Count)0);
}

__device__ __forceinline__ void count_pair(uint32_t* words,
                                           Count* __restrict__ out,
                                           uint32_t bin) {
  const uint32_t sh = (bin & 1) << 4;
  const uint32_t old = atomicAdd(words + (bin >> 1), 1u << sh);
  if (((old >> sh) & 0xFFFFu) == 0xFFFFu) credit_wrap(out, bin, old);
}

// The 16 pairs of a full vector, each word's in lane-rotated order.
__device__ __forceinline__ void count_pairs16(uint32_t* words,
                                              Count* __restrict__ out,
                                              const uint4& q, uint32_t prev) {
  // bytes, and the bytes one position later (each byte's prev)
  const uint32_t cur[4] = {q.x, q.y, q.z, q.w};
  const uint32_t pre[4] = {q.x << 8 | prev, __funnelshift_l(q.x, q.y, 8),
                           __funnelshift_l(q.y, q.z, 8),
                           __funnelshift_l(q.z, q.w, 8)};
  const int rot = 8 * ((threadIdx.x >> 2) & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = __funnelshift_r(cur[j], cur[j], rot);
    const uint32_t p = __funnelshift_r(pre[j], pre[j], rot);
    // (prev << 8 | cur) of bytes 0, 1 and of bytes 2, 3
    const uint32_t b01 = __byte_perm(c, p, 0x5140);
    const uint32_t b23 = __byte_perm(c, p, 0x7362);
    count_pair(words, out, b01 & 0xFFFFu);
    count_pair(words, out, b01 >> 16);
    count_pair(words, out, b23 & 0xFFFFu);
    count_pair(words, out, b23 >> 16);
  }
}

// vec: n % 16 == 0 and units 16-byte aligned (checked by the host);
// partial: (gridDim.x, kWords1) words, 16-byte aligned, each row written.
__global__ void __launch_bounds__(kThreads1, 1)
markov_hist_kernel(const uint8_t* __restrict__ units,
                   const int32_t* __restrict__ n_valid, int64_t R, int64_t n,
                   Count* __restrict__ out, uint32_t* __restrict__ partial,
                   bool vec) {
  extern __shared__ uint4 smem1[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem1);
  for (int i = threadIdx.x; i < kWords1 / 4; i += blockDim.x)
    smem1[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (vec)
    walk_vectors(units, n_valid, R, n, [&](const uint4& q, uint32_t prev,
                                           int m) {
      if (m == 16) {
        count_pairs16(words, out, q, prev);
        return;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t cur = byte_of(q, k);
        if (k < m) count_pair(words, out, prev << 8 | cur);
        prev = cur;
      }
    });
  else
    walk_bytes(units, n_valid, R, n, [&](uint32_t cur, uint32_t prev) {
      count_pair(words, out, prev << 8 | cur);
    });
  __syncthreads();
  uint4* row = reinterpret_cast<uint4*>(partial + blockIdx.x * (int64_t)kWords1);
  for (int i = threadIdx.x; i < kWords1 / 4; i += blockDim.x) row[i] = smem1[i];
}

// K1's merge: word w's two fields summed over the `rows` rows of
// `partial`, added to bins 2w and 2w + 1 (which hold the credits).
__global__ void __launch_bounds__(kMergeThreads)
markov_merge_kernel(const uint32_t* __restrict__ partial, int rows,
                    Count* __restrict__ out) {
  const int w = blockIdx.x * kMergeThreads + threadIdx.x;
  Count lo = 0, hi = 0;
#pragma unroll 4
  for (int b = 0; b < rows; ++b) {
    const uint32_t x = __ldg(partial + b * (int64_t)kWords1 + w);
    lo += x & 0xFFFFu;
    hi += x >> 16;
  }
  out[2 * w] += lo;
  out[2 * w + 1] += hi;
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// The valid bytes of one vector (m of them) into a copy.
__device__ __forceinline__ void count_bytes16(int32_t* copy, const uint4& q,
                                              int m) {
  if (m == 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k) atomicAdd(copy + byte_of(q, k), 1);
    return;
  }
  for (int k = 0; k < m; ++k) atomicAdd(copy + byte_of(q, k), 1);
}

// vec: as for K1.
__global__ void __launch_bounds__(kThreads2, kBlocksPerSm2)
order0_hist_kernel(const uint8_t* __restrict__ units,
                   const int32_t* __restrict__ n_valid, int64_t R, int64_t n,
                   Count* __restrict__ out, bool vec) {
  __shared__ int32_t bins[kCopies2 * kStride2];
  for (int i = threadIdx.x; i < kCopies2 * kStride2; i += blockDim.x)
    bins[i] = 0;
  __syncthreads();
  int32_t* copy = bins + (threadIdx.x >> 5) * kStride2;
  if (vec) {
    const uint4* units16 = reinterpret_cast<const uint4*>(units);
    const int64_t nq = n / 16;
    int64_t begin, end;
    block_share(R * nq, begin, end);
    for (int64_t s = begin, row = begin / nq; s < end; ++row) {
      const int64_t r0 = row * nq, r1 = r0 + nq < end ? r0 + nq : end;
      const int64_t nv = mhc_clamp(__ldg(n_valid + row), 0, n);
      const int64_t cut = r0 + nv / 16;  // the vector n_valid cuts, if any
      for (int64_t v = s + threadIdx.x; v < cut && v < r1; v += blockDim.x)
        count_bytes16(copy, __ldg(units16 + v), 16);
      if (nv % 16 && cut >= s && cut < r1 && threadIdx.x == 0)
        count_bytes16(copy, __ldg(units16 + cut), (int)(nv % 16));
      s = r1;
    }
  } else {
    walk_bytes(units, n_valid, R, n, [&](uint32_t cur, uint32_t) {
      atomicAdd(copy + cur, 1);
    });
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < kCopies2; ++i) v += bins[i * kStride2 + c];
    if (v) atomicAdd(out + c, (Count)v);
  }
}

// One wave of `per_sm` blocks per SM, fewer where the batch has fewer
// steps of 16 bytes per thread.
unsigned grid_for(int64_t R, int64_t n, int threads, int per_sm) {
  const int64_t steps = (R * n + 16 * threads - 1) / (16 * threads);
  return (unsigned)std::max<int64_t>(
      1, std::min<int64_t>(steps, (int64_t)per_sm * mhc_num_sms()));
}

bool vectorised(const uint8_t* units, int64_t n) {
  return n % 16 == 0 && reinterpret_cast<uintptr_t>(units) % 16 == 0;
}

}  // namespace

// out: (256, 256) int64, zeroed by the caller; partial: scratch of
// (partial_rows, 32768) uint32, 16-byte aligned, partial_rows at least
// one a streaming multiprocessor (the walk's grid). Two launches: the
// walk, then the merge.
extern "C" int mhc_markov_hist(const uint8_t* units, const int32_t* n_valid,
                               int64_t R, int64_t n, int64_t* out,
                               uint32_t* partial, int64_t partial_rows,
                               cudaStream_t stream) {
  const unsigned grid = grid_for(R, n, kThreads1, 1);
  if (R < 0 || n < 0 || n > INT32_MAX || partial_rows < (int64_t)grid ||
      reinterpret_cast<uintptr_t>(partial) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(markov_hist_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem1);
  markov_hist_kernel<<<grid, kThreads1, kSmem1, stream>>>(
      units, n_valid, R, n, reinterpret_cast<Count*>(out), partial,
      vectorised(units, n));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  markov_merge_kernel<<<kWords1 / kMergeThreads, kMergeThreads, 0,
                        stream>>>(partial, (int)grid,
                                  reinterpret_cast<Count*>(out));
  return (int)cudaGetLastError();
}

// out: (256,) int64, zeroed by the caller.
extern "C" int mhc_order0_hist(const uint8_t* units, const int32_t* n_valid,
                               int64_t R, int64_t n, int64_t* out,
                               cudaStream_t stream) {
  if (R < 0 || n < 0 || n > INT32_MAX) return (int)cudaErrorInvalidValue;
  order0_hist_kernel<<<grid_for(R, n, kThreads2, kBlocksPerSm2), kThreads2,
                       0, stream>>>(units, n_valid, R, n,
                                    reinterpret_cast<Count*>(out),
                                    vectorised(units, n));
  return (int)cudaGetLastError();
}
