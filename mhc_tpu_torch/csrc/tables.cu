// K13: canonical Huffman code tables from (rows, 256) code lengths in
// device memory, one 256-thread block per output row, one thread per
// symbol: a thin kernel around csrc/canonical.cuh::canonical_row, which
// has the contract and the design. On the encode the tables come from
// the fused table build (csrc/huffman.cu::code_tables_kernel) instead;
// K13 serves the lengths that no kernel has just computed: the decode's
// (from the container), the host build's, and `engine.encode(st,
// lengths=...)`'s.
//
// Order-0 has one row of lengths and 256 output rows (the tables are
// repeated over the contexts, which the encode and decode kernels index by
// the previous byte): each block reads row 0, so the broadcast costs no
// copy.
//
// Bound. Under a megabyte moved (Markov: 64 KB of lengths in, 256 x 816
// int32 out, 0.9 MB: 0.0003 ms at 3.35 TB/s) and ~65 K compares a row: its
// floor is one launch, a few microseconds. `launch_floor_kernel`, an empty
// kernel on the same grid, measures that floor (chip_smoke.py).

#include "canonical.cuh"

namespace {

constexpr int kSyms = mhc_canonical::kSyms;

__global__ void __launch_bounds__(kSyms) canonical_tables_kernel(
    const uint8_t* __restrict__ lengths, int broadcast,
    mhc_canonical::Tables t) {
  const int64_t row = blockIdx.x;
  const int v = lengths[(broadcast ? 0 : row) * kSyms + threadIdx.x];
  mhc_canonical::canonical_row(v, row, t);
}

__global__ void __launch_bounds__(kSyms) launch_floor_kernel() {}

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
      lengths, in_rows == 1 ? 1 : 0,
      mhc_canonical::Tables{codes, lens_out, lim, base, first_code,
                            sorted_syms});
  return (int)cudaGetLastError();
}

// An empty kernel on K13's grid (rows blocks of 256 threads): the floor
// of a launch, for the measurement beside K13's time.
extern "C" int mhc_launch_floor(int64_t rows, cudaStream_t stream) {
  if (rows <= 0 || rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  launch_floor_kernel<<<(unsigned)rows, kSyms, 0, stream>>>();
  return (int)cudaGetLastError();
}
