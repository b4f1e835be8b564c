// K13: canonical Huffman code tables from (rows, 256) code lengths, one
// 256-thread block per output row, one thread per symbol.
//
// Replaces mhc_tpu/ops/canonical.py::canonical_codes (:27), an XLA stage
// on the TPU, not a Pallas kernel. The port's plain version is
// ops/canonical.py::canonical_tables_plain (canonical_codes, then the
// order-0 broadcast). For each row of lengths v (uint8, 0 = absent):
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
// a warp on the same address (a broadcast). Order-0 has one row of lengths
// and 256 output rows (the tables are repeated over the contexts, which
// the encode and decode kernels index by the previous byte): each block
// reads row 0, so the broadcast costs no copy.
//
// Bound. Under a megabyte moved (Markov: 64 KB of lengths in, 256 x 816
// int32 out, 0.9 MB: 0.0003 ms at 3.35 TB/s) and ~65 K compares a row: its
// floor is one launch, a few microseconds, where the plain version takes
// about 40 small launches.

#include "common.cuh"

namespace {

constexpr int kSyms = 256;
constexpr int kMaxLen = 15;
constexpr int kL = kMaxLen + 1;

__global__ void __launch_bounds__(kSyms) canonical_tables_kernel(
    const uint8_t* __restrict__ lengths, int broadcast,
    int32_t* __restrict__ codes, int32_t* __restrict__ lens_out,
    int32_t* __restrict__ lim, int32_t* __restrict__ base,
    int32_t* __restrict__ first_code, int32_t* __restrict__ sorted_syms) {
  __shared__ __align__(16) int key[kSyms];
  __shared__ int bl[kL];
  __shared__ int64_t first_s[kL];
  __shared__ int base_s[kL];
  const int64_t row = blockIdx.x;
  const int s = threadIdx.x;
  const int v = lengths[(broadcast ? 0 : row) * kSyms + s];
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
  for (int t = 0; t < kSyms / 4; ++t) {
    const int4 q = k4[t];
    rank += (q.x < my) + (q.y < my) + (q.z < my) + (q.w < my);
  }
  __syncthreads();
  const int lc = v < kMaxLen ? v : kMaxLen;
  const int64_t o = row * kSyms;
  codes[o + s] =
      v > 0 ? (int32_t)(first_s[lc] + rank - base_s[lc]) : 0;
  lens_out[o + s] = v;
  sorted_syms[o + rank] = s;
  if (s < kL) {
    const int64_t lw = (first_s[s] + bl[s]) << (kMaxLen - s);
    lim[row * kL + s] =
        s == 0 ? 0 : (int32_t)(lw < INT32_MAX ? lw : INT32_MAX);
    base[row * kL + s] = base_s[s];
    first_code[row * kL + s] = (int32_t)first_s[s];
  }
}

}  // namespace

// lengths: (in_rows, 256) uint8, in_rows == rows or 1 (repeated over the
// rows); the six outputs are (rows, 256) int32 codes and lengths, (rows,
// 16) int32 lim, base and first_code, and (rows, 256) int32 sorted_syms.
extern "C" int mhc_canonical_tables(const uint8_t* lengths, int64_t in_rows,
                                    int64_t rows, int32_t* codes,
                                    int32_t* lens_out, int32_t* lim,
                                    int32_t* base, int32_t* first_code,
                                    int32_t* sorted_syms,
                                    cudaStream_t stream) {
  if (rows < 0 || rows > INT32_MAX || (in_rows != rows && in_rows != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  canonical_tables_kernel<<<(unsigned)rows, kSyms, 0, stream>>>(
      lengths, in_rows == 1 ? 1 : 0, codes, lens_out, lim, base,
      first_code, sorted_syms);
  return (int)cudaGetLastError();
}
