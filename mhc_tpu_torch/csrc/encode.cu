// The encode kernels: K3 (fused lookup + pack), and the split form of the
// same contract, K5 (lookup to a cl plane) followed by K4 (pack of a cl
// plane) or by K6 (bubble-stream pack of a cl plane). A "cl plane" holds
// len << 16 | code for every symbol.
//
// K3 and K5 read the (prev, cur) table through the same ClTable
// (common.cuh), and K4 and K6 are one tile packer: K3 equals K5 followed
// by K4 word for word, and compacting K6's bubble stream gives the same
// words.
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
// a BitAcc (common.cuh). Interior words go out in aligned 16-byte
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
// address. K6 replaces encode_pallas.py::_run_bubble_pack (pallas_call at
// :375, body _pack_kernel; reached through pack_blocks_pallas and
// pack_blocks_to_payload). Per unit, each round appends two codes and
// hands out at most one word (two codes are at most 30 bits): round r
// writes (word, valid) to slot r of the unit's bubble stream, and at a
// round that completes no word the slot holds the pending bits
// MSB-aligned, as the TPU kernel's `word = a0` does. The TPU kernel wrote
// every round to a dense row because a lane cannot store to its own
// address; here the bubble planes are kept for the contract, and the
// compaction after the kernel (ops/bitpack.py) is what K4 avoids.
//
// Both are one kernel, pack_tiles_kernel: a warp per unit, walking the
// unit's cl row in tiles of 128 symbols. They read 4 bytes per symbol
// (419 MB at the 100 MB main path) and device-memory bandwidth bounds
// them, so the row is read once, every load and store contiguous across
// the warp:
// - lane l takes the 16 bytes (4 symbols, 2 rounds) at tile + 16 l: 512 B
//   per warp load, copied ahead into a per-warp ring of tiles in shared
//   memory by cp.async (a lane reads back only what it copied, so the
//   ring needs no barrier; a load to a register would stall the warp);
// - a lane joins its 4 codes (at most 60 bits), a warp scan of the
//   lanes' bit counts plus the bits pending from the tile before gives
//   its bit offset in the tile's stream, and it ORs its bits into at most
//   3 words of a staging buffer in shared memory (atomicOr: neighbouring
//   lanes share words). A tile's stream is at most 31 + 1920 bits: 61
//   words;
// - K4: the finished words leave 4 bytes per lane, contiguous across the
//   warp, at the unit's running word index; K6: a lane reads its two
//   rounds' slots back from the staging words (a completed word is stream
//   word `before >> 5`, whole there whichever lane or tile began it; an
//   incomplete one is word `after >> 5` cut to its top `after & 31` bits)
//   and stores them unit-major, 8 + 2 bytes per lane, 256 + 64 B per
//   warp;
// - the pending bits (< 32) go from tile to tile in a register: lane 0
//   ORs them into word 0 of the next tile's staging buffer. Three staging
//   buffers take turns, so one __syncwarp per tile is enough: a buffer is
//   zeroed a tile after it was read and used a tile after that.
// No table is needed, so a block is 4 warps with 10 KB of shared memory
// and many blocks share an SM; the payload route's 1,600 units of 64 KB
// are 1,600 warps, 12 per SM, each with 3 tiles in flight.
// K3 keeps its BitAcc; K4(K5(x)) == K3(x) and the compacted K6 are held
// by the checks on the card and by the replay of this algorithm in
// plain torch (tests/test_torch_tiled_pack.py).

#include "common.cuh"

namespace {

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

// The tile packer of K4 (kBubble false) and K6 (true).
constexpr int kTileWarps = 4;     // units per block
constexpr int kTileSyms = 128;    // symbols per tile: 16 bytes per lane
constexpr int kTileStages = 4;    // ring of tiles per warp, a power of two
constexpr int kStageWords = 64;   // >= the 61 stream words a tile can touch

// kVec: n % 4 == 0 and cl 16-byte aligned (for K6 also bw 8-byte and bv
// 2-byte aligned), so a lane's 4 symbols are one 16-byte copy and its two
// slots one 8-byte and one 2-byte store; otherwise scalar loads and
// stores, symbols past n read as zero-length codes.
template <bool kBubble, bool kVec>
__global__ void __launch_bounds__(kTileWarps * 32)
pack_tiles_kernel(const uint32_t* __restrict__ cl, int64_t R, int n,
                  uint32_t* __restrict__ words, int64_t W,
                  uint32_t* __restrict__ bw, uint8_t* __restrict__ bv,
                  uint32_t* __restrict__ tail, int32_t* __restrict__ bits) {
  __shared__ __align__(16) uint4 s_ring[kTileWarps][kTileStages][32];
  __shared__ uint32_t s_stage[kTileWarps][3][kStageWords];
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kTileWarps + warp;
  if (b >= R) return;  // whole warps leave; the kernel has no block barrier
  const uint32_t* row = cl + b * n;
  const int tiles = (n + kTileSyms - 1) / kTileSyms;
  const int rounds = (n + 1) / 2;
  uint32_t* out = kBubble ? bw + b * rounds : words + b * W;
  uint8_t* flags = kBubble ? bv + b * rounds : nullptr;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s_stage[warp][k][lane] = 0;
    s_stage[warp][k][lane + 32] = 0;
  }
  __syncwarp();

  const uint32_t ring_s =
      (uint32_t)__cvta_generic_to_shared(&s_ring[warp][0][lane]);
  // Starts the copy of tile t's 16 bytes of this lane; a tile past the
  // row, or a lane past n, copies nothing and reads back zeros. Commits a
  // group either way, so that group k is tile k.
  auto fetch = [&](int t) {
    if (kVec) {
      const int j = t * kTileSyms + lane * 4;
      const bool ok = t < tiles && j < n;
      cp_async16(ring_s + (t & (kTileStages - 1)) * (32 * 16),
                 row + (ok ? j : 0), ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kTileStages - 1; ++t) fetch(t);

  int wbase = 0;      // the row's word index of staging word 0
  int carry = 0;      // bits pending from the tiles before, < 32
  uint32_t pend = 0;  // those bits, MSB-aligned
  int total = 0;
  for (int t = 0; t < tiles; ++t) {
    fetch(t + kTileStages - 1);
    cp_async_wait<kTileStages - 1>();
    const int j = t * kTileSyms + lane * 4;
    uint4 v;
    if (kVec) {
      v = s_ring[warp][t & (kTileStages - 1)][lane];
    } else {
      v.x = j < n ? __ldg(row + j) : 0u;
      v.y = j + 1 < n ? __ldg(row + j + 1) : 0u;
      v.z = j + 2 < n ? __ldg(row + j + 2) : 0u;
      v.w = j + 3 < n ? __ldg(row + j + 3) : 0u;
    }
    // the lane's two rounds: codes (x, y) and (z, w), each at most 30 bits
    const int la = (int)(v.x >> 16) + (int)(v.y >> 16);
    const int lb = (int)(v.z >> 16) + (int)(v.w >> 16);
    const uint32_t pa = ((v.x & 0xFFFFu) << (v.y >> 16)) | (v.y & 0xFFFFu);
    const uint32_t pb = ((v.z & 0xFFFFu) << (v.w >> 16)) | (v.w & 0xFFFFu);
    const int len = la + lb;
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    const int tile_bits = __shfl_sync(kFull, incl, 31);
    const int off = carry + incl - len;  // bit offset in the staging words
    uint32_t* cur = s_stage[warp][t % 3];
    {
      // the lane's bits MSB-aligned in 64, then shifted to bit off & 31 of
      // three words; lane 0 (off == carry) brings the pending bits along
      const uint64_t x =
          len ? (((uint64_t)pa << lb) | pb) << (64 - len) : 0ull;
      const int s = off & 31;
      uint32_t* w = cur + (off >> 5);
      const uint32_t w0 = (uint32_t)(x >> (32 + s)) | (lane == 0 ? pend : 0u);
      if (w0) atomicOr(w, w0);
      if (s + len > 32) atomicOr(w + 1, (uint32_t)(x >> s));
      if (s + len > 64) atomicOr(w + 2, (uint32_t)(x << (32 - s)));
    }
    __syncwarp();
    const int end = carry + tile_bits;  // bits in the staging words
    const int nw = end >> 5;            // whole words among them, <= 60
    pend = cur[nw];
    if (kBubble) {
      // slot of a round from bit `before` to bit `after`: the word it
      // completes, else its pending bits
      const int mid = off + la, last = mid + lb;
      const bool va = (mid >> 5) > (off >> 5), vb = (last >> 5) > (mid >> 5);
      const uint32_t sa =
          va ? cur[off >> 5] : cur[mid >> 5] & ~(kFull >> (mid & 31));
      const uint32_t sb =
          vb ? cur[mid >> 5] : cur[last >> 5] & ~(kFull >> (last & 31));
      const int r = j >> 1;
      if (kVec) {
        if (j < n) {
          *reinterpret_cast<uint2*>(out + r) = make_uint2(sa, sb);
          *reinterpret_cast<uchar2*>(flags + r) =
              make_uchar2((unsigned char)va, (unsigned char)vb);
        }
      } else {
        if (r < rounds) {
          out[r] = sa;
          flags[r] = (uint8_t)va;
        }
        if (r + 1 < rounds) {
          out[r + 1] = sb;
          flags[r + 1] = (uint8_t)vb;
        }
      }
    } else {
      // rows arrive zeroed; writes at index >= W are dropped
      const uint32_t u0 = cur[lane], u1 = cur[lane + 32];
      if (lane < nw && wbase + lane < W) out[wbase + lane] = u0;
      if (lane + 32 < nw && wbase + lane + 32 < W) out[wbase + lane + 32] = u1;
    }
    // the buffer of the tile before: every lane read it before the barrier
    uint32_t* prev = s_stage[warp][(t + 2) % 3];
    prev[lane] = 0;
    prev[lane + 32] = 0;
    wbase += nw;
    carry = end & 31;
    total += tile_bits;
  }
  if (lane == 0) {
    if (kBubble)
      tail[b] = pend;
    else if (carry > 0 && wbase < W)
      out[wbase] = pend;
    bits[b] = total;
  }
}

// The four instances share one launch; a unit's symbols and bit offsets
// are counted in 32 bits.
template <bool kBubble>
int launch_pack_tiles(const uint32_t* cl, int64_t R, int64_t n,
                      uint32_t* words, int64_t W, uint32_t* bw, uint8_t* bv,
                      uint32_t* tail, int32_t* bits, bool vec,
                      cudaStream_t stream) {
  if (n * 15 >= INT32_MAX) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((R + kTileWarps - 1) / kTileWarps);
  auto kern = vec ? pack_tiles_kernel<kBubble, true>
                  : pack_tiles_kernel<kBubble, false>;
  kern<<<blocks, kTileWarps * 32, 0, stream>>>(cl, R, (int)n, words, W, bw,
                                               bv, tail, bits);
  return (int)cudaGetLastError();
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
  return launch_pack_tiles<false>(cl, R, n, words, W, nullptr, nullptr,
                                  nullptr, bits, vec, stream);
}

// cl: (R, n) uint32; bw: (R, ceil(n / 2)) uint32 and bv: (R, ceil(n / 2))
// uint8, unit-major, every slot written; tail, bits: (R,).
extern "C" int mhc_bubble_pack(const uint32_t* cl, int64_t R, int64_t n,
                               uint32_t* bw, uint8_t* bv, uint32_t* tail,
                               int32_t* bits, cudaStream_t stream) {
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(cl) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bw) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(bv) % 2 == 0;
  return launch_pack_tiles<true>(cl, R, n, nullptr, 0, bw, bv, tail, bits,
                                 vec, stream);
}
