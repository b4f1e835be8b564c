// K11: deterministic length-limited Huffman code lengths of (rows, 256)
// counts, one 256-thread block per row (256 Markov contexts, or the one
// order-0 row); and the fused table build `code_tables_kernel`, K11's
// body followed in the same block by K13's (csrc/canonical.cuh) on the
// lengths the block holds, so that the encode's table build is one launch
// (K13 alone is a launch, most of it the host's enqueue, for work of
// under a megabyte).
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
// keys and at most 510 merge picks a row). What holds it is the merge,
// serial by nature: at most m - 1 = 255 steps of two picks a row on one
// thread, every row in flight at once (256 blocks of 256 threads, ~5 KB
// of shared memory each, fit one wave on 132 SMs). `merge` keeps the
// heads of both queues in registers, so that no pick waits on a shared
// round trip (~29 cycles); what is left is a chain of six dependent
// integer ops a step and the step's instructions, issued by one warp at
// one integer instruction every 2 cycles. The rest is parallel over the
// block:
//   - the sort gives each thread its symbol's rank by counting the keys
//     below it (broadcast reads of shared memory, four keys a load);
//   - the merge and the Kraft repair run on thread 0;
//   - each thread finds its leaf's parent, and its internal node's, by a
//     binary search over the leaves picked by each step;
//   - each thread walks from its leaf to the root for its length (the
//     chain is the code length, at most m - 1 steps, ~10 on real data);
//   - the repair's reassignment ranks again by counting.

#include "canonical.cuh"

namespace {

constexpr int kSyms = 256;
constexpr int kMaxLen = 15;
constexpr int64_t kMaxTotal = int64_t(1) << 28;
constexpr int32_t kInf = int32_t(1) << 30;

// #{j : (key[j], j) < (key[s], s)}: the rank of symbol s in (key, symbol)
// order. Every thread of a warp reads the same keys (broadcasts), four at
// a time: those of lower warps count when <= key[s] (they come first on
// a tie), those of higher warps when < key[s], each as the sign bit of
// key - threshold (keys are below 2^31 - 1, so the difference does not
// wrap), added into four independent sums: two instructions a key. Only
// the warp's own 32 keys need the index compare. `key` is 16-byte
// aligned.
__device__ __forceinline__ int rank_of(const int32_t* key, int s) {
  const int32_t ks = key[s];
  const int w0 = s & ~31;
  const int4* k4 = reinterpret_cast<const int4*>(key);
  uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
  int32_t th = ks + 1;  // lower warps: key <= ks
#pragma unroll 4
  for (int q = 0; q < w0 / 4; ++q) {
    const int4 v = k4[q];
    r0 += uint32_t(v.x - th) >> 31;
    r1 += uint32_t(v.y - th) >> 31;
    r2 += uint32_t(v.z - th) >> 31;
    r3 += uint32_t(v.w - th) >> 31;
  }
  th = ks;  // higher warps: key < ks
#pragma unroll 4
  for (int q = (w0 + 32) / 4; q < kSyms / 4; ++q) {
    const int4 v = k4[q];
    r0 += uint32_t(v.x - th) >> 31;
    r1 += uint32_t(v.y - th) >> 31;
    r2 += uint32_t(v.z - th) >> 31;
    r3 += uint32_t(v.w - th) >> 31;
  }
  int r = int(r0 + r1 + r2 + r3);
#pragma unroll 8
  for (int j = w0; j < w0 + 32; ++j) {
    const int32_t kj = key[j];
    r += (kj < ks) | ((kj == ks) & (j < s));
  }
  return r;
}

constexpr int kPad = 4;  // kInf entries past each queue: the windows' reach

// The two-queue merge of m >= 2 sorted leaf weights, ties to the leaf,
// on one thread, with no shared-memory load on its dependent chain. The
// heads of both queues live in registers: l0..l3 = leaf_w[i..i+3] and
// a0..a3 = int_w[j..j+3]. Both arrays read kInf past their queue's end
// (the caller pads leaf_w and fills int_w with kInf), so the loads need
// no bounds. A step's two picks read l0, l1, a0 and a1 only; the windows
// then shift by what each queue gave (0, 1 or 2: selects on the two
// picks), and l2, l3, a2 and a3 are loaded anew, a step ahead of their
// first use. Node t enters the internal window from the register that
// holds its sum: internal weights never decrease (each step takes the
// two smallest), so the window's head is min(entry, sum) and its second
// entry too unless node t is the only one left (kInf). The longest chain
// of a step, from its first compare to the next step's, is compare,
// select, compare, select, select, min: six dependent integer ops (3 a
// pick). On one thread a step also costs its instructions: a warp
// issues an integer instruction every 2 cycles on Hopper's 16 INT32
// lanes a scheduler, whatever its active threads, and a step's
// instructions weigh more than its chain. So nothing else happens on the
// way: the merge stores the node's weight and the leaves picked so far,
// and the parents are found from those counts after it (parent_steps),
// in parallel.
__device__ __forceinline__ void merge(const int32_t* __restrict__ leaf_w,
                                      int32_t* __restrict__ int_w,
                                      int32_t* __restrict__ leaves_by,
                                      int m) {
  int32_t l0 = leaf_w[0], l1 = leaf_w[1], l2 = leaf_w[2], l3 = leaf_w[3];
  int32_t a0 = kInf, a1 = kInf, a2 = kInf, a3 = kInf;
  const int32_t* lq = leaf_w;  // &leaf_w[i]
  const int32_t* iq = int_w;   // &int_w[j]
  int picked = 0;              // leaves picked so far (i)
  int pending = 0;             // nodes formed and not yet picked
  for (int t = 0; t < m - 1; ++t) {
    const bool p1 = l0 <= a0;  // pick 1 takes the leaf
    const int32_t lw = p1 ? l1 : l0, iw = p1 ? a0 : a1;
    const bool p2 = lw <= iw;  // pick 2 takes the leaf
    const int32_t sum = min(l0, a0) + min(lw, iw);
    const int leaves = p1 + p2;
    picked += leaves;
    int_w[t] = sum;
    leaves_by[t] = picked;
    // leaves shift by p1 + p2, nodes by 2 - p1 - p2: p2-shifted, then
    // p1-shifted
    const int32_t c0 = p2 ? l1 : l0, c1 = p2 ? l2 : l1, c2 = p2 ? l3 : l2;
    const int32_t d0 = p2 ? a0 : a1, d1 = p2 ? a1 : a2, d2 = p2 ? a2 : a3;
    l0 = p1 ? c1 : c0;
    l1 = p1 ? c2 : c1;
    lq += leaves;
    iq += 2 - leaves;
    pending += leaves - 1;
    l2 = lq[2];
    l3 = lq[3];
    a0 = min(p1 ? d0 : d1, sum);
    a1 = pending > 1 ? min(p1 ? d1 : d2, sum) : kInf;
    a2 = iq[2];
    a3 = iq[3];
  }
}

// The steps that picked sorted leaf `leaf` and internal node `node`: both
// queues are picked in order, so each is the first step t by which more
// than that many leaves (leaves_by[t]) or nodes (2 (t + 1) -
// leaves_by[t]) were picked. Two branchless binary searches over the
// merge's `steps` <= 255 counts, side by side (their loads overlap).
__device__ __forceinline__ void parent_steps(const int32_t* leaves_by,
                                             int steps, int leaf, int node,
                                             int& leaf_step,
                                             int& node_step) {
  int pl = 0, pn = 0;
#pragma unroll
  for (int span = 128; span; span >>= 1) {
    const int cl = pl + span - 1, cn = pn + span - 1;
    if (cl < steps && leaves_by[cl] <= leaf) pl += span;
    if (cn < steps && 2 * (cn + 1) - leaves_by[cn] <= node) pn += span;
  }
  leaf_step = pl;
  node_step = pn;
}

// The code length of symbol threadIdx.x in one row of 256 counts, on a
// 256-thread block; every thread of the block must call it.
template <typename T>
__device__ __forceinline__ int code_length(const T* __restrict__ counts) {
  __shared__ long long warp_sums[kSyms / 32];
  __shared__ __align__(16) int32_t key[kSyms];
  __shared__ int32_t leaf_w[kSyms + kPad];  // weights in (w, symbol) order
  __shared__ int32_t int_w[kSyms + kPad];   // internal node weights
  __shared__ int32_t leaves_by[kSyms];      // leaves picked by each step
  __shared__ int32_t int_parent[kSyms];
  __shared__ int32_t bl[kMaxLen + 1];     // codes per clamped length

  const int s = threadIdx.x;
  const long long c = (long long)counts[s];

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
  if (m <= 1) return present ? 1 : 0;

  // 3. sort, merge, depths
  key[s] = present ? w : kInf;
  __syncthreads();
  const int rank = rank_of(key, s);
  leaf_w[rank] = key[s];
  int_w[s] = kInf;
  if (s < kPad) leaf_w[kSyms + s] = int_w[kSyms + s] = kInf;
  __syncthreads();
  if (s == 0) merge(leaf_w, int_w, leaves_by, m);
  __syncthreads();
  // the root is internal node m - 2; every other node's parent is the
  // step that picked it
  int parent, node_parent;
  parent_steps(leaves_by, m - 1, rank, s, parent, node_parent);
  if (s < m - 2) int_parent[s] = node_parent;
  __syncthreads();
  int len = 0;
  if (present) {
    int node = parent;
    len = 1;
    while (node != m - 2) {
      node = int_parent[node];
      ++len;
    }
  }

  // 4. the length limit, only where a length exceeds it
  if (!__syncthreads_or(len > kMaxLen)) return len;
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
  return len;
}

template <typename T>
__global__ void __launch_bounds__(kSyms)
    code_lengths_kernel(const T* __restrict__ counts,
                        uint8_t* __restrict__ out) {
  const int64_t base = (int64_t)blockIdx.x * kSyms;
  out[base + threadIdx.x] = (uint8_t)code_length(counts + base);
}

// The fused table build: K11's lengths, then the canonical tables of the
// lengths each thread holds in a register, in one launch. Block `row`
// builds from counts row `row`, or from row 0 where `broadcast` (order-0:
// one row of counts, 256 rows of tables; the redundant builds run in the
// same wave as block 0's), and writes table row `row`; the lengths go
// out once a counts row.
template <typename T>
__global__ void __launch_bounds__(kSyms)
    code_tables_kernel(const T* __restrict__ counts, int broadcast,
                       uint8_t* __restrict__ out, mhc_canonical::Tables t) {
  const int64_t row = blockIdx.x;
  const int64_t in = broadcast ? 0 : row;
  const int len = code_length(counts + in * kSyms);
  if (in == row) out[in * kSyms + threadIdx.x] = (uint8_t)len;
  mhc_canonical::canonical_row(len, row, t);
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

// The fused table build. counts: (in_rows, 256) int32 (is64 == 0) or int64
// (is64 != 0), contiguous, in_rows == rows or 1 (one row of counts for
// every table row); lengths: (in_rows, 256) uint8; the six tables as
// mhc_canonical::Tables, each with `rows` rows.
extern "C" int mhc_code_tables(const void* counts, int is64, int64_t in_rows,
                               int64_t rows, uint8_t* lengths, int32_t* codes,
                               int32_t* lens_out, int32_t* lim, int32_t* base,
                               int32_t* first_code, int32_t* sorted_syms,
                               cudaStream_t stream) {
  if (rows < 0 || rows > INT32_MAX || (in_rows != rows && in_rows != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int broadcast = in_rows != rows;
  const mhc_canonical::Tables t{codes, lens_out, lim, base, first_code,
                                sorted_syms};
  if (is64)
    code_tables_kernel<long long><<<(unsigned)rows, kSyms, 0, stream>>>(
        static_cast<const long long*>(counts), broadcast, lengths, t);
  else
    code_tables_kernel<int32_t><<<(unsigned)rows, kSyms, 0, stream>>>(
        static_cast<const int32_t*>(counts), broadcast, lengths, t);
  return (int)cudaGetLastError();
}
