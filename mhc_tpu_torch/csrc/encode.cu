// The encode kernels: K3 (fused lookup + pack), and the split form of the
// same contract, K5 (lookup to a cl plane) followed by K4 (pack of a cl
// plane) or by K6 (bubble-stream pack of a cl plane). A "cl plane" holds
// len << 16 | code for every symbol.
//
// K3 and K5 read the (prev, cur) table through the same ClTable, and K3,
// K4 and K6 accumulate bits through the same BitAcc (common.cuh), so K3
// equals K5 followed by K4 word for word, and compacting K6's bubble
// stream gives the same words, by construction.
//
// K3 replaces mhc_tpu/ops/kernels/encode_pallas.py::pack_blocks_fused_sm
// (pallas_call at :711, body _fused_kernel :545). The TPU kernel reads
// step-major symbols and fetches codes with one-hot MXU contractions over
// rank tables, because Mosaic has no per-lane gather; on Hopper the
// canonical tables sit in shared memory (u16 code + u8 length per
// (prev, cur): 192 KB).
//
// Contract, per unit b: for j < n_valid[b], (code, len) =
// table[prev][cur] with prev the unit's previous byte (0 at j = 0); codes
// are concatenated MSB-first from bit 31 of word 0 of the unit's row;
// bits[b] = sum of len. Rows arrive zeroed and hold at least the longest
// stream, W >= ceil(n * 15 / 32) words (mhc_pack_units rejects fewer):
// words past the stream stay 0; writes at index >= W are dropped. Equal
// word for word to
// bitpack.encode_blocks_merge and to the TPU kernel.
//
// Design: a warp per unit (PAPERS.md, arXiv 2010.10039). Encode has no
// dependence between symbols but the bit offsets, so each lane owns a
// contiguous chunk of the unit (a multiple of 16 bytes: 256 for 8 KB
// units), sums its code lengths (pass 1), takes its bit offset from a
// warp exclusive scan, and packs its chunk from there (pass 2) through
// the BitAcc K4 and K6 use. Interior words go out in aligned 16-byte
// quads; the two words a lane may share with its neighbours are merged
// with atomicOr into the zeroed row. Lanes read their chunk 16 bytes at
// a time. The 192 KB table allows one block per SM: a persistent grid of
// one block of 32 warps per SM strides over the units, neighbouring
// warps of a block on units gridDim.x apart, so a last partial round
// spreads over the SMs. Bound: the bytes it moves (units in, coded words
// out); with 32 units in flight per SM no unit's serial chain bounds it
// any more, and the word stores, scattered over the lanes' chunks, cost
// most.
//
// K5 replaces mhc_tpu/ops/kernels/lookup_pallas.py::lookup_cl_sm_pallas
// (pallas_call at :278, body _lookup_kernel). The TPU kernel is
// step-major, a Mosaic layout constraint; here the plane is unit-major,
// (R, n) like the units. One thread per 4 symbols, neighbouring threads
// on neighbouring symbols: a 4-byte load in and a 16-byte store out per
// thread. It reads 1 byte and writes 4 per symbol (500 MB at the 100 MB
// main path), so device-memory bandwidth bounds it. The 192 KB table
// allows one block per SM: 1,024 threads, one persistent block per SM.
//
// K4 replaces mhc_tpu/ops/kernels/encode_pallas.py::pack_blocks_dense
// (pallas_call at :291, body _pack_dense_kernel), whose lane window and
// group flushes exist because a TPU lane cannot store to its own
// address. Here one thread packs one unit's cl row with the BitPacker,
// in blocks of 128 (100 blocks at the Markov main path: at least 32 of
// 132 SMs get none). Neighbouring threads read rows n * 4 bytes apart, so its
// loads are not coalesced (each thread reads its row 16 bytes at a
// time): with the idle SMs, the first thing a faster K4 changes; the
// serial bit chain is as in K3.
//
// K6 replaces mhc_tpu/ops/kernels/encode_pallas.py::_run_bubble_pack
// (pallas_call at :375, body _pack_kernel; reached through
// pack_blocks_pallas and pack_blocks_to_payload). Per unit, each round
// appends two codes and hands out at most one word (two codes are at most
// 30 bits): round r writes (word, valid) to slot r of the unit's bubble
// stream, and at a round that completes no word the slot holds the
// pending bits MSB-aligned, as the TPU kernel's `word = a0` does. The TPU
// kernel wrote every round to a dense row because a lane cannot store to
// its own address; here the bubble planes are kept for the contract, and
// the compaction after the kernel (ops/bitpack.py) is what K4 avoids. One
// thread per unit, as K4: the row is read 16 bytes at a time, and the
// planes are stored round-major (slot (r, b) at r * R + b), so a warp's 32
// stores of a round fall on 128 contiguous bytes of bw and 32 of bv. It
// writes 5 bytes per round (262 MB of bubble planes for the 419 MB cl
// plane of the Markov main path), but the serial bit chain per unit on
// 100 of 132 SMs bounds it, as K4. A later PR would fill the idle SMs, as
// for K4, or drop the bubble planes for K4's direct stores.

#include "common.cuh"

namespace {

constexpr int kPackThreads = 128;
constexpr int kLookupThreads = 1024;

// Calls f(prev, cur) for the symbols j0 <= j < j1 of `row`, in order;
// vec: j0 and the row 16-byte aligned, so bytes arrive 16 at a time.
template <class F>
__device__ __forceinline__ void for_pairs(const uint8_t* __restrict__ row,
                                          int j0, int j1, bool vec, F f) {
  int prev = j0 ? __ldg(row + j0 - 1) : 0;
  if (!vec) {
    for (int j = j0; j < j1; ++j) {
      const int cur = __ldg(row + j);
      f(prev, cur);
      prev = cur;
    }
    return;
  }
  for (int j = j0; j < j1; j += 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + j));
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
    const int m = j1 - j;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < m) {
        const int cur = (q[k >> 2] >> (8 * (k & 3))) & 0xFF;
        f(prev, cur);
        prev = cur;
      }
    }
  }
}

constexpr int kPackWarps = 32;

// chunk: symbols per lane, a multiple of 16; vec: n % 16 == 0 and units
// 16-byte aligned.
__global__ void __launch_bounds__(kPackWarps * 32)
pack_units_kernel(const uint8_t* __restrict__ units,
                  const int32_t* __restrict__ n_valid, int64_t R, int n,
                  const uint16_t* __restrict__ codes16,
                  const uint8_t* __restrict__ lens8,
                  uint32_t* __restrict__ words, int64_t W,
                  int32_t* __restrict__ bits, int chunk, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ClTable tab = ClTable::load(smem, codes16, lens8);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int64_t b = (int64_t)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       b < R; b += (int64_t)gridDim.x * kPackWarps) {
    const int nv = (int)mhc_clamp(__ldg(n_valid + b), 0, n);
    const uint8_t* row = units + b * n;
    const int j0 = min(lane * chunk, nv);
    const int j1 = min(j0 + chunk, nv);
    // pass 1: the chunk's bits; a warp scan gives each lane its offset
    int nbits = 0;
    for_pairs(row, j0, j1, vec,
              [&](int prev, int cur) { nbits += tab.len[(prev << 8) | cur]; });
    int incl = nbits;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) bits[b] = incl;
    if (nbits == 0) continue;
    // pass 2: pack from the offset. The first word is shared with the
    // lanes before when the offset is not word-aligned, the last
    // (partial) one with the lanes after: both are merged by atomicOr
    // after the loop. The words between go out 16 bytes at a time where
    // an aligned quad of them is the lane's own: the lanes' chunks lie
    // far apart in the row, so each store is a write request of its own
    // (4-byte stores were most of the kernel's time: PERF.md, PR 4).
    const int off = incl - nbits;
    uint32_t* out = words + b * W;
    const int64_t first = off >> 5;
    const int64_t own = first + ((off & 31) != 0);  // first plain word
    const uint32_t quad0 = (uint32_t)(b * W) & 3;    // out's offset in a quad
    BitAcc a{};
    a.nacc = off & 31;                         // zero bits of earlier lanes
    int64_t wi = first;
    uint32_t head = 0, q0 = 0, q1 = 0, q2 = 0, q3 = 0;  // q3: the last word
    for_pairs(row, j0, j1, vec, [&](int prev, int cur) {
      uint32_t word;
      if (a.put(tab.cl(prev, cur), word)) {
        head = wi < own ? word : head;
        q0 = q1;
        q1 = q2;
        q2 = q3;
        q3 = word;
        const int64_t qs = wi - ((quad0 + wi) & 3);  // its quad's start
        if (qs < own && wi >= own && wi < W) out[wi] = word;
        if (qs >= own && qs + 3 == wi && wi < W)
          *reinterpret_cast<uint4*>(out + qs) = make_uint4(q0, q1, q2, q3);
        ++wi;
      }
    });
    // the words after the last whole quad, when their quad is the lane's
    const int64_t qs = wi - ((quad0 + wi) & 3);
    if (qs >= own) {
      if (wi - 1 >= qs && wi - 1 < W) out[wi - 1] = q3;
      if (wi - 2 >= qs && wi - 2 < W) out[wi - 2] = q2;
      if (wi - 3 >= qs && wi - 3 < W) out[wi - 3] = q1;
    }
    if (own > first && wi > first && first < W) atomicOr(out + first, head);
    if (a.nacc > 0 && wi < W) atomicOr(out + wi, a.partial());
  }
}

// vec: n % 4 == 0, units 4-byte and cl 16-byte aligned (checked by the
// host), so each group of 4 symbols is one u32 load and one 16-byte store.
__global__ void __launch_bounds__(kLookupThreads)
lookup_cl_kernel(const uint8_t* __restrict__ units,
                 const int32_t* __restrict__ n_valid, int64_t R, int64_t n,
                 const uint16_t* __restrict__ codes16,
                 const uint8_t* __restrict__ lens8,
                 uint32_t* __restrict__ cl, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ClTable tab = ClTable::load(smem, codes16, lens8);
  __syncthreads();

  const int64_t n4 = (n + 3) / 4;
  const int64_t groups = R * n4;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = g / n4;
    const int64_t j0 = (g - b * n4) * 4;
    const int64_t nv = mhc_clamp(__ldg(n_valid + b), 0, n);
    const uint8_t* row = units + b * n;
    uint32_t* orow = cl + b * n;
    int prev = j0 ? __ldg(row + j0 - 1) : 0;
    if (vec) {
      const uint32_t four = __ldg(reinterpret_cast<const uint32_t*>(row + j0));
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cur = (four >> (8 * k)) & 0xFF;
        v[k] = j0 + k < nv ? tab.cl(prev, cur) : 0u;
        prev = cur;
      }
      *reinterpret_cast<uint4*>(orow + j0) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int64_t j = j0; j < j0 + 4 && j < n; ++j) {
        const int cur = __ldg(row + j);
        orow[j] = j < nv ? tab.cl(prev, cur) : 0u;
        prev = cur;
      }
    }
  }
}

// vec: n % 4 == 0 and cl 16-byte aligned, so a row is read 16 bytes at a
// time.
__global__ void __launch_bounds__(kPackThreads)
pack_cl_kernel(const uint32_t* __restrict__ cl, int64_t R, int64_t n,
               uint32_t* __restrict__ words, int64_t W,
               int32_t* __restrict__ bits, bool vec) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= R) return;
  const uint32_t* row = cl + b * n;
  BitPacker pk{words + b * W, W};
  if (vec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int64_t q = 0; q < n / 4; ++q) {
      const uint4 v = __ldg(row4 + q);
      pk.put(v.x);
      pk.put(v.y);
      pk.put(v.z);
      pk.put(v.w);
    }
  } else {
    for (int64_t j = 0; j < n; ++j) pk.put(__ldg(row + j));
  }
  bits[b] = pk.finish();
}

// vec: n % 4 == 0 and cl 16-byte aligned, so a row is read 16 bytes (two
// rounds) at a time. bw and bv are round-major: slot (r, b) at r * R + b.
__global__ void __launch_bounds__(kPackThreads)
bubble_pack_kernel(const uint32_t* __restrict__ cl, int64_t R, int64_t n,
                   uint32_t* __restrict__ bw, uint8_t* __restrict__ bv,
                   uint32_t* __restrict__ tail, int32_t* __restrict__ bits,
                   bool vec) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= R) return;
  const uint32_t* row = cl + b * n;
  BitAcc a{};
  auto put_round = [&](int64_t r, uint32_t c0, uint32_t c1) {
    uint32_t w0 = 0, w1 = 0;
    const bool e0 = a.put(c0, w0);
    const bool e1 = a.put(c1, w1);
    bw[r * R + b] = e0 ? w0 : (e1 ? w1 : a.partial());
    bv[r * R + b] = (uint8_t)(e0 || e1);
  };
  if (vec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int64_t q = 0; q < n / 4; ++q) {
      const uint4 v = __ldg(row4 + q);
      put_round(2 * q, v.x, v.y);
      put_round(2 * q + 1, v.z, v.w);
    }
  } else {
    // an odd n's last round takes a zero-length second code
    for (int64_t r = 0; 2 * r < n; ++r)
      put_round(r, __ldg(row + 2 * r),
                2 * r + 1 < n ? __ldg(row + 2 * r + 1) : 0u);
  }
  tail[b] = a.partial();
  bits[b] = a.total;
}

}  // namespace

// words: (R, W) uint32, zeroed by the caller, W >= ceil(n * 15 / 32);
// bits: (R,) int32. codes16 / lens8: (256 * 256) canonical code and
// length per (prev, cur).
extern "C" int mhc_pack_units(const uint8_t* units, const int32_t* n_valid,
                              int64_t R, int64_t n, const uint16_t* codes16,
                              const uint8_t* lens8, uint32_t* words,
                              int64_t W, int32_t* bits,
                              cudaStream_t stream) {
  // a unit's symbols and bit offsets are counted in 32 bits; a row holds
  // the longest stream (a lane's quads are stored whole only below W)
  if (n * 15 >= INT32_MAX || W < (n * 15 + 31) / 32)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(pack_units_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kClTableSmem);
  const int chunk = (int)((n + 32 * 16 - 1) / (32 * 16) * 16);
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(units) % 16 == 0;
  const int64_t blocks = std::min<int64_t>(
      mhc_num_sms(), (R + kPackWarps - 1) / kPackWarps);
  pack_units_kernel<<<(unsigned)blocks, kPackWarps * 32, kClTableSmem,
                      stream>>>(units, n_valid, R, (int)n, codes16, lens8,
                                words, W, bits, chunk, vec);
  return (int)cudaGetLastError();
}

// cl: (R, n) uint32, every element written.
extern "C" int mhc_lookup_cl(const uint8_t* units, const int32_t* n_valid,
                             int64_t R, int64_t n, const uint16_t* codes16,
                             const uint8_t* lens8, uint32_t* cl,
                             cudaStream_t stream) {
  cudaFuncSetAttribute(lookup_cl_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kClTableSmem);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(units) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(cl) % 16 == 0;
  const int64_t groups = R * ((n + 3) / 4);
  const int64_t blocks = std::max<int64_t>(
      1, std::min<int64_t>(mhc_num_sms(),
                           (groups + kLookupThreads - 1) / kLookupThreads));
  lookup_cl_kernel<<<(unsigned)blocks, kLookupThreads, kClTableSmem,
                     stream>>>(units, n_valid, R, n, codes16, lens8, cl, vec);
  return (int)cudaGetLastError();
}

// cl: (R, n) uint32; words: (R, W) uint32, zeroed by the caller; bits:
// (R,) int32.
extern "C" int mhc_pack_cl(const uint32_t* cl, int64_t R, int64_t n,
                           uint32_t* words, int64_t W, int32_t* bits,
                           cudaStream_t stream) {
  const bool vec =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(cl) % 16 == 0;
  const unsigned blocks = (unsigned)((R + kPackThreads - 1) / kPackThreads);
  pack_cl_kernel<<<blocks, kPackThreads, 0, stream>>>(cl, R, n, words, W,
                                                       bits, vec);
  return (int)cudaGetLastError();
}

// cl: (R, n) uint32; bw: (ceil(n / 2), R) uint32 and bv: (ceil(n / 2), R)
// uint8, round-major, every slot written; tail, bits: (R,).
extern "C" int mhc_bubble_pack(const uint32_t* cl, int64_t R, int64_t n,
                               uint32_t* bw, uint8_t* bv, uint32_t* tail,
                               int32_t* bits, cudaStream_t stream) {
  const bool vec =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(cl) % 16 == 0;
  const unsigned blocks = (unsigned)((R + kPackThreads - 1) / kPackThreads);
  bubble_pack_kernel<<<blocks, kPackThreads, 0, stream>>>(cl, R, n, bw, bv,
                                                           tail, bits, vec);
  return (int)cudaGetLastError();
}
