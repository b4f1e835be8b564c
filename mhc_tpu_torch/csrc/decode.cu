// K7 — canonical Huffman decode, one unit stream per thread, in two
// instantiations: Markov (K7m, the context is the previous symbol) and
// order-0 (K7o, context 0 throughout).
//
// Replaces mhc_tpu/ops/kernels/decode_pallas.py::decode_blocks_pallas:
// its Markov pallas_call at :857 (body _decode_kernel :562, fetch mxu4)
// and its order-0 call at :845, which feeds the kernel the context-0 row
// of the fetch table only. The TPU kernel fetches each context's table
// row with one-hot MXU products and refills a lane-wide word window,
// because Mosaic has no per-lane gather; on Hopper the decode tables sit
// in shared memory and each thread keeps a 64-bit bit buffer. K7m holds
// every context's tables (sorted symbols as u8: 64 KB; lim and
// base - first_code: 16 KB each); K7o holds context 0's row alone
// (256 + 64 + 64 bytes) and never updates the context.
//
// Contract, per unit b, for t < n_valid[b]: peek 15 bits w;
// len = 1 + #{l in 1..14 : w >= lim[ctx][l]};
// sym = sorted_syms[ctx][clamp(bf[ctx][len] + (w >> (15 - len)), 0, 255)]
// with bf = base - first_code; consume len bits; ctx <- sym (Markov) or
// ctx = 0 (order-0), from ctx 0. Positions t >= n_valid[b] are written
// as 0, so callers pass 0 for literal units and they cost nothing. Words
// at index >= W read as 0. Every index into words and out is 64-bit
// (the order-0 main path has R x W = 6,400 x 7,681 words).
//
// Bound: a serial dependent chain per symbol (peek, 14 limit compares,
// two shared-memory lookups, shift), one unit per thread in blocks of
// 128. The Markov main path's 12,800 units make 100 blocks, the order-0
// main path's 6,400 units of 16 KB make 50: at most 100 (K7m) or 50
// (K7o) of the H100's 132 SMs busy, 4 warps each; at least 32 or 82 idle.
// Latency bounds both, and the idle SMs first: more, smaller blocks (or
// several threads per unit) are the first lever, before the chain.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kL = 16;                         // MAX_CODE_LEN + 1

// Shared-memory bytes of the tables of `rows` contexts: u8 sorted
// symbols, then lim and bf (32-bit) per context.
__host__ __device__ constexpr int sym_bytes(int rows) {
  return rows * 256;
}
__host__ __device__ constexpr int tab_bytes(int rows) {
  return rows * kL * 4;
}
__host__ __device__ constexpr int smem_bytes(int rows) {
  return sym_bytes(rows) + 2 * tab_bytes(rows);
}

struct Reader {
  const uint32_t* row;
  int64_t W;
  int64_t wi = 0;
  uint64_t buf = 0;  // pending bits, MSB-aligned
  int nbits = 0;

  __device__ uint32_t peek15() {
    if (nbits < 32) {
      const uint32_t w = wi < W ? __ldg(row + wi) : 0u;
      ++wi;
      buf |= (uint64_t)w << (32 - nbits);
      nbits += 32;
    }
    return (uint32_t)(buf >> 49);
  }
  __device__ void consume(int len) {
    buf <<= len;
    nbits -= len;
  }
};

template <bool kMarkov>
__global__ void __launch_bounds__(kThreads)
decode_units_kernel(const uint32_t* __restrict__ words, int64_t R,
                    int64_t W, const int32_t* __restrict__ n_valid,
                    const uint32_t* __restrict__ lim,
                    const int32_t* __restrict__ bf,
                    const uint8_t* __restrict__ syms8,
                    uint8_t* __restrict__ out, int64_t n_out) {
  constexpr int kRows = kMarkov ? 256 : 1;     // contexts held
  constexpr int kSymBytes = sym_bytes(kRows);
  constexpr int kTabBytes = tab_bytes(kRows);
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* s_sym = smem;
  uint32_t* s_lim = reinterpret_cast<uint32_t*>(smem + kSymBytes);
  int32_t* s_bf = reinterpret_cast<int32_t*>(smem + kSymBytes + kTabBytes);
  {
    const uint4* g0 = reinterpret_cast<const uint4*>(syms8);
    const uint4* g1 = reinterpret_cast<const uint4*>(lim);
    const uint4* g2 = reinterpret_cast<const uint4*>(bf);
    uint4* d0 = reinterpret_cast<uint4*>(s_sym);
    uint4* d1 = reinterpret_cast<uint4*>(s_lim);
    uint4* d2 = reinterpret_cast<uint4*>(s_bf);
    for (int i = threadIdx.x; i < kSymBytes / 16; i += blockDim.x)
      d0[i] = g0[i];
    for (int i = threadIdx.x; i < kTabBytes / 16; i += blockDim.x) {
      d1[i] = g1[i];
      d2[i] = g2[i];
    }
  }
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= R) return;
  const int64_t nv = mhc_clamp(n_valid[b], 0, n_out);
  Reader rd{words + b * W, W};
  uint8_t* orow = out + b * n_out;
  int ctx = 0;                                 // stays 0 for order-0

  auto next = [&]() -> uint32_t {
    const uint32_t w = rd.peek15();
    const uint32_t* lr = s_lim + ctx * kL;
    int len = 1;
#pragma unroll
    for (int l = 1; l < kL - 1; ++l) len += (w >= lr[l]);
    const int code = (int)(w >> (15 - len));
    const int idx = min(max(s_bf[ctx * kL + len] + code, 0), 255);
    const int sym = s_sym[(ctx << 8) | idx];
    rd.consume(len);
    if (kMarkov) ctx = sym;
    return (uint32_t)sym;
  };

  if ((n_out & 3) == 0) {
    // four symbols per 32-bit store (rows start 4-byte aligned)
    uint32_t* o32 = reinterpret_cast<uint32_t*>(orow);
    for (int64_t t4 = 0; t4 < n_out; t4 += 4) {
      uint32_t pack = 0;
      for (int k = 0; k < 4; ++k)
        if (t4 + k < nv) pack |= next() << (8 * k);
      o32[t4 >> 2] = pack;
    }
  } else {
    for (int64_t t = 0; t < n_out; ++t) orow[t] = t < nv ? next() : 0;
  }
}

template <bool kMarkov>
int launch(const uint32_t* words, int64_t R, int64_t W,
           const int32_t* n_valid, const uint32_t* lim, const int32_t* bf,
           const uint8_t* syms8, uint8_t* out, int64_t n_out,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes(kMarkov ? 256 : 1);
  cudaFuncSetAttribute(decode_units_kernel<kMarkov>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const unsigned blocks = (unsigned)((R + kThreads - 1) / kThreads);
  decode_units_kernel<kMarkov><<<blocks, kThreads, smem, stream>>>(
      words, R, W, n_valid, lim, bf, syms8, out, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// words: (R, W) uint32; lim: (256, 16) uint32; bf: (256, 16) int32
// (base - first_code); syms8: (256, 256) uint8; out: (R, n_out) uint8.
// markov = 0 reads only row 0 of each table.
extern "C" int mhc_decode_units(const uint32_t* words, int64_t R, int64_t W,
                                const int32_t* n_valid, const uint32_t* lim,
                                const int32_t* bf, const uint8_t* syms8,
                                uint8_t* out, int64_t n_out, int markov,
                                cudaStream_t stream) {
  return markov ? launch<true>(words, R, W, n_valid, lim, bf, syms8, out,
                               n_out, stream)
                : launch<false>(words, R, W, n_valid, lim, bf, syms8, out,
                                n_out, stream);
}
