// K3 — fused (prev, cur) -> (code, len) lookup and MSB-first bit packing,
// one unit stream per thread.
//
// Replaces mhc_tpu/ops/kernels/encode_pallas.py::pack_blocks_fused_sm
// (pallas_call at :711, body _fused_kernel :545). The TPU kernel reads
// step-major symbols and fetches codes with one-hot MXU contractions over
// rank tables, because Mosaic has no per-lane gather; on Hopper the
// canonical tables sit in shared memory (u16 code + u8 length per
// (prev, cur): 192 KB) and each thread reads its unit unit-major.
//
// Contract, per unit b: for j < n_valid[b], (code, len) =
// table[prev][cur] with prev the unit's previous byte (0 at j = 0); codes
// are concatenated MSB-first from bit 31 of word 0 of the unit's row;
// bits[b] = sum of len. Rows arrive zeroed: words past the stream stay 0.
// Equal word for word to bitpack.encode_blocks_merge and to the TPU
// kernel.
//
// Bound: a serial bit chain per unit. With one thread per unit, the main
// path's 12,800 units give ~97 threads per SM of the H100's 132: latency
// of the per-symbol chain (byte load, shared-memory lookup, shift), not
// bandwidth, bounds it. Spreading a unit over several threads (lengths,
// prefix sum, placement) is the known next step.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPairs = 256 * 256;
constexpr int kSmem = kPairs * (sizeof(uint16_t) + sizeof(uint8_t));

__global__ void __launch_bounds__(kThreads)
pack_units_kernel(const uint8_t* __restrict__ units,
                  const int32_t* __restrict__ n_valid, int64_t R, int64_t n,
                  const uint16_t* __restrict__ codes16,
                  const uint8_t* __restrict__ lens8,
                  uint32_t* __restrict__ words, int64_t W,
                  int32_t* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_code = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s_len = smem + kPairs * sizeof(uint16_t);
  {
    const uint4* gc = reinterpret_cast<const uint4*>(codes16);
    const uint4* gl = reinterpret_cast<const uint4*>(lens8);
    uint4* sc = reinterpret_cast<uint4*>(s_code);
    uint4* sl = reinterpret_cast<uint4*>(s_len);
    for (int i = threadIdx.x; i < kPairs * 2 / 16; i += blockDim.x)
      sc[i] = gc[i];
    for (int i = threadIdx.x; i < kPairs / 16; i += blockDim.x)
      sl[i] = gl[i];
  }
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= R) return;
  const int64_t nv = mhc_clamp(n_valid[b], 0, n);
  const uint8_t* row = units + b * n;
  uint32_t* out = words + b * W;

  uint64_t acc = 0;    // low `nacc` bits are pending, MSB first
  int nacc = 0;
  int64_t wi = 0;
  int32_t total = 0;
  int prev = 0;
  for (int64_t j = 0; j < nv; ++j) {
    const int cur = __ldg(row + j);
    const int idx = (prev << 8) | cur;
    const int len = s_len[idx];
    acc = (acc << len) | s_code[idx];
    nacc += len;
    total += len;
    if (nacc >= 32) {
      nacc -= 32;
      if (wi < W) out[wi] = (uint32_t)(acc >> nacc);
      ++wi;
    }
    prev = cur;
  }
  if (nacc > 0 && wi < W) out[wi] = (uint32_t)(acc << (32 - nacc));
  bits[b] = total;
}

}  // namespace

// words: (R, W) uint32, zeroed by the caller; bits: (R,) int32.
// codes16 / lens8: (256 * 256) canonical code and length per (prev, cur).
extern "C" int mhc_pack_units(const uint8_t* units, const int32_t* n_valid,
                              int64_t R, int64_t n, const uint16_t* codes16,
                              const uint8_t* lens8, uint32_t* words,
                              int64_t W, int32_t* bits,
                              cudaStream_t stream) {
  cudaFuncSetAttribute(pack_units_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const unsigned blocks = (unsigned)((R + kThreads - 1) / kThreads);
  pack_units_kernel<<<blocks, kThreads, kSmem, stream>>>(
      units, n_valid, R, n, codes16, lens8, words, W, bits);
  return (int)cudaGetLastError();
}
