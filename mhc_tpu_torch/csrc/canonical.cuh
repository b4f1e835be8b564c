// The canonical code tables of one row of code lengths, one 256-thread
// block, one thread per symbol: the body of K13 (csrc/tables.cu, the
// tables of lengths in device memory) and of the fused table build
// code_tables (csrc/huffman.cu, the tables of the lengths K11's body has
// just left in each thread's register).
//
// Replaces mhc_tpu/ops/canonical.py::canonical_codes (:27), an XLA stage
// on the TPU, not a Pallas kernel. The port's plain version is
// ops/canonical.py::canonical_tables_plain (canonical_codes, then the
// order-0 broadcast). For a row of lengths v (uint8, 0 = absent):
//   bl[l]          #{s : v[s] == l}, l = 1..15 (bl[0] = 0)
//   first_code[l]  0 at l = 0; (first_code[l - 1] + bl[l - 1]) << 1
//   base[l]        bl[0] + ... + bl[l - 1]
//   lim[l]         (first_code[l] + bl[l]) << (15 - l), 0 at l = 0,
//                  clamped to 2^31 - 1
//   sorted_syms    the symbols in (v, symbol) order, an absent symbol keyed
//                  16: after every present one, in symbol order
//   codes[s]       first_code[min(v, 15)] + rank(s) - base[min(v, 15)] for
//                  a present symbol, rank(s) its place in sorted_syms; else 0
//   lengths[s]     v[s]
// all int32, equal to the plain version for every uint8 input, lengths
// above 15 included (they sort between 15 and absent as in the plain
// sort key, and take length 15's first code and base).
//
// Design. bl by shared atomics; first_code, base and lim in one 16-step
// serial pass on thread 0 (in int64: lim reaches 2^37 before the clamp on
// lengths that are no prefix code); each symbol's rank by counting the 256
// keys below its own (key = v' * 256 + s is unique, so the rank is one
// compare a key), read from shared memory four keys a load, every lane of
// a warp on the same address (a broadcast).
#pragma once

#include "common.cuh"

namespace mhc_canonical {

constexpr int kSyms = 256;
constexpr int kMaxLen = 15;
constexpr int kL = kMaxLen + 1;

// The six int32 output tables: (rows, 256) codes, lengths and
// sorted_syms, (rows, 16) lim, base and first_code.
struct Tables {
  int32_t* codes;
  int32_t* lens;
  int32_t* lim;
  int32_t* base;
  int32_t* first_code;
  int32_t* sorted_syms;
};

// Row `row` of every table from the lengths of a 256-thread block, thread
// s holding symbol s's length v. Every thread of the block must call it.
__device__ __forceinline__ void canonical_row(int v, int64_t row,
                                              const Tables& t) {
  __shared__ __align__(16) int key[kSyms];
  __shared__ int bl[kL];
  __shared__ int64_t first_s[kL];
  __shared__ int base_s[kL];
  const int s = threadIdx.x;
  if (s < kL) bl[s] = 0;
  key[s] = (v > 0 ? v : kL) * kSyms + s;
  __syncthreads();
  if (v >= 1 && v <= kMaxLen) atomicAdd(&bl[v], 1);
  __syncthreads();
  if (s == 0) {
    int64_t code = 0;
    int cum = 0;
    for (int l = 0; l < kL; ++l) {
      if (l > 0) code = (code + bl[l - 1]) << 1;
      first_s[l] = code;
      base_s[l] = cum;
      cum += bl[l];
    }
  }
  const int my = key[s];
  int rank = 0;
  const int4* k4 = reinterpret_cast<const int4*>(key);
#pragma unroll 16
  for (int q = 0; q < kSyms / 4; ++q) {
    const int4 k = k4[q];
    rank += (k.x < my) + (k.y < my) + (k.z < my) + (k.w < my);
  }
  __syncthreads();
  const int lc = v < kMaxLen ? v : kMaxLen;
  const int64_t o = row * kSyms;
  t.codes[o + s] = v > 0 ? (int32_t)(first_s[lc] + rank - base_s[lc]) : 0;
  t.lens[o + s] = v;
  t.sorted_syms[o + rank] = s;
  if (s < kL) {
    const int64_t lw = (first_s[s] + bl[s]) << (kMaxLen - s);
    t.lim[row * kL + s] =
        s == 0 ? 0 : (int32_t)(lw < INT32_MAX ? lw : INT32_MAX);
    t.base[row * kL + s] = base_s[s];
    t.first_code[row * kL + s] = (int32_t)first_s[s];
  }
}

}  // namespace mhc_canonical
