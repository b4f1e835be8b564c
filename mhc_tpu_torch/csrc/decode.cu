// K7 — canonical Huffman decode, one unit stream per thread, in two
// instantiations: Markov (K7m, the context is the previous symbol) and
// order-0 (K7o, context 0 throughout); and the build kernel of their
// shared-memory decode table (`mhc_decode_lut`).
//
// Replaces mhc_tpu/ops/kernels/decode_pallas.py::decode_blocks_pallas:
// its Markov pallas_call at :857 (body _decode_kernel :562, fetch mxu4)
// and its order-0 call at :845, which feeds the kernel the context-0 row
// of the fetch table only. The TPU kernel fetches each context's table
// row with one-hot MXU products and refills a lane-wide word window,
// because Mosaic has no per-lane gather; on Hopper the decode table sits
// in shared memory and each thread keeps a 64-bit bit buffer.
//
// Contract, per unit b, for t < n_valid[b]: peek 15 bits w;
// len = 1 + #{l in 1..14 : w >= lim[ctx][l]};
// sym = sorted_syms[ctx][clamp(bf[ctx][len] + (w >> (15 - len)), 0, 255)]
// with bf = base - first_code; consume len bits; ctx <- sym (Markov) or
// ctx = 0 (order-0), from ctx 0. Positions t >= n_valid[b] are written
// as 0, so callers pass 0 for literal units and they cost nothing. Words
// at index >= W read as 0.
//
// The table (`decode_lut`, built on the device from the canonical tables
// by the rule above, then copied whole into shared memory by the decode
// kernel with cp.async):
// - K7o: a direct table over the 15-bit window, 2^15 entries of u16
//   sym | len << 8 (64 KB). One shared-memory load per symbol, no
//   compares, for every valid code: no code is longer than 15 bits.
// - K7m: a root table per context over the next 8 bits, 256 x 256 u16
//   (128 KB): sym | len << 8 when the code is at most 8 bits long, else
//   0, the escape mark. lim is monotone in l and lim[l] for l <= 8 is a
//   multiple of 2^7, so a bucket of 128 windows either has one length
//   <= 8 throughout or lengths > 8 throughout. An escape runs the rule
//   above restricted to lengths 9..15, from the context's escape row:
//   lim[9..14] as u16 pairs then bf[9..15] as s16 pairs, 7 words at a
//   stride of 7 words (odd, so 32 lanes in 32 different contexts read 32
//   different banks), and the sorted symbols as u8 (64 KB). 199 KB in
//   all, with the lanes' word rings (below): one block per SM.
//
// Bound: each unit is a serial dependent chain per symbol (table load ->
// length -> 64-bit shift -> next window -> next load); the main paths
// decode 9,627 (K7m) or 3,108 (K7o) units, fewer than one warp per
// scheduler on the H100's 132 SMs, so the time is the chain's latency
// times the symbols per unit, not bandwidth. The design strips the chain
// to one shared-memory load and a few integer ops (K7o), or the root and
// escape loads side by side and a select (K7m): 32-bit loop bookkeeping,
// no branch per symbol (a warp's lanes would diverge at nearly every
// one), the words streamed ahead into a per-lane ring in shared memory by
// cp.async (see BitReader: a lane's load to a register would stall its
// whole warp), output staged in registers and stored 16 bytes at a time.
// At most one block per SM (the table fills it), its threads sized to
// the units, units interleaved over the blocks.

#include "common.cuh"

namespace {

constexpr int kL = 16;                         // MAX_CODE_LEN + 1
constexpr int kRootBits = 8;                   // K7m's root window
// escape row: lim[9..14] as u16 pairs, then bf[9..15] as s16 pairs (7
// words, an odd stride)
constexpr int kEscStride = 7;
constexpr int kMarkovRootBytes = 256 * (1 << kRootBits) * 2;
constexpr int kSymBytes = 256 * 256;
constexpr int kEscBytes = 256 * kEscStride * 4;

__host__ __device__ constexpr int lut_bytes(bool markov) {
  return markov ? kMarkovRootBytes + kSymBytes + kEscBytes
                : (1 << 15) * 2;
}

// Entry i of the table: row i >> bits over window (i & mask) << (15 -
// bits), by the contract's rule; Markov also writes the u8 symbols and
// the escape rows.
__global__ void decode_lut_kernel(const int32_t* __restrict__ lim,
                                  const int32_t* __restrict__ base,
                                  const int32_t* __restrict__ first_code,
                                  const int32_t* __restrict__ sorted_syms,
                                  bool markov, uint8_t* __restrict__ lut) {
  const int bits = markov ? kRootBits : 15;
  const int entries = markov ? 256 << kRootBits : 1 << 15;
  uint16_t* root = reinterpret_cast<uint16_t*>(lut);
  uint8_t* syms8 = lut + kMarkovRootBytes;
  uint32_t* esc = reinterpret_cast<uint32_t*>(syms8 + kSymBytes);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < entries;
       i += gridDim.x * blockDim.x) {
    const int row = i >> bits;
    const int w = (i & ((1 << bits) - 1)) << (15 - bits);
    const int32_t* lr = lim + row * kL;
    int len = 1;
    for (int l = 1; l < kL - 1; ++l) len += (w >= lr[l]);
    const int bf = base[row * kL + len] - first_code[row * kL + len];
    const int idx = min(max(bf + (w >> (15 - len)), 0), 255);
    const int sym = sorted_syms[row * 256 + idx];
    root[i] = (uint16_t)(len <= bits ? sym | len << 8 : 0);
    if (markov) {
      syms8[i] = (uint8_t)sorted_syms[i];
      if (i < 256 * kEscStride) {
        // halves lo, hi: lim[9 + 2k], lim[10 + 2k] (k < 3), clamped to
        // 0xFFFF; then bf[9 + 2k], bf[10 + 2k] (k < 4; bf[16] = 0),
        // clamped to int16. A window is below 2^15, so the clamps change
        // no compare, and bf + code < 0 either way below -2^15.
        const int r = i / kEscStride, k = i % kEscStride;
        const int32_t* lr = lim + r * kL;
        auto half = [&](int l) -> uint32_t {
          if (k < 3) return (uint32_t)min(lr[l], 0xFFFF);
          if (l > 15) return 0u;
          const int bf = base[r * kL + l] - first_code[r * kL + l];
          return (uint32_t)(min(max(bf, -32768), 32767) & 0xFFFF);
        };
        const int l = k < 3 ? 9 + 2 * k : 9 + 2 * (k - 3);
        esc[i] = half(l) | half(l + 1) << 16;
      }
    }
  }
}

// Each lane streams its unit's words through a ring of kRing words in
// shared memory, filled with cp.async. The lanes of a warp refill their
// bit buffers at different symbols; had each lane loaded its next word
// from global memory into a register at its refill, a load in flight for
// one lane would hold up every other lane's next refill (the register's
// scoreboard is the warp's), a device-memory latency per step. The ring
// moves the loads off the registers: at the start of every group of 16
// symbols each lane asks for the next kFetch words (when the ring has
// room) and waits only for the group asked for two groups earlier. With
// at most 240 bits (8 refills) per group, a 24-word first fill keeps
// every word a refill reads landed before it is read.
constexpr int kRing = 32;
constexpr int kRingStride = kRing + 1;         // lanes' rings on odd banks
constexpr int kFirstFill = 24;
constexpr int kFetch = 8;

__device__ __forceinline__ void cp_async4(uint32_t dst, const uint32_t* src,
                                          bool valid) {
  // src-size 0 writes a zero word: words at index >= W read as 0
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// The next 64 bits of a unit's stream, MSB-aligned (`nb` >= 32 of them
// valid at every symbol), the word after them in `nxt`, and the ring.
struct BitReader {
  const uint32_t* row;
  int W;
  const uint32_t* ring;  // this lane's ring; word i at ring[i & 31]
  uint32_t ring_s;       // the same, as a shared-memory address
  int wi;                // next word to take from the ring
  int fill;              // next word to ask for
  uint32_t nxt;
  uint64_t buf;
  int nb;

  template <int kN>
  __device__ __forceinline__ void fetch() {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = fill + k;
      cp_async4(ring_s + 4 * (i & (kRing - 1)), row + (i < W ? i : 0),
                i < W);
    }
    fill += kN;
  }
  __device__ void init(const uint32_t* r, int w, const uint32_t* lane_ring) {
    row = r;
    W = w;
    ring = lane_ring;
    ring_s = (uint32_t)__cvta_generic_to_shared(lane_ring);
    cp_async_wait<0>();                        // the last unit's copies
    fill = 0;
    fetch<kFirstFill>();
    cp_async_commit();
    cp_async_wait<0>();
    buf = (uint64_t)ring[0] << 32 | ring[1];
    nb = 64;
    nxt = ring[2];
    wi = 3;
  }
  // At the start of each group of 16 symbols.
  __device__ __forceinline__ void group() {
    if (fill + kFetch - wi <= kRing) fetch<kFetch>();
    cp_async_commit();
    cp_async_wait<2>();
  }
  // Consumes len bits; returns the next window's top 32 bits. At most 15
  // bits go per symbol, so the refill only touches bits below the top 17
  // and the window is taken from the shift alone, off the refill.
  __device__ __forceinline__ uint32_t consume(int len) {
    const uint64_t sh = buf << len;
    buf = sh;
    nb -= len;
    // the refill without a branch: the lanes of a warp refill at
    // different symbols, and a divergent refill would cost the warp a
    // branch and reconvergence at nearly every symbol. `ahead` is read at
    // every symbol and kept only at a refill, when the ring holds it.
    const bool refill = nb < 32;
    const uint32_t ahead = ring[wi & (kRing - 1)];
    buf |= (uint64_t)(refill ? nxt : 0u) << ((32 - nb) & 31);
    nb += refill ? 32 : 0;
    nxt = refill ? ahead : nxt;
    wi += refill;
    return (uint32_t)(sh >> 32);
  }
};

// Threads per block: each needs its ring beside the table.
template <bool kMarkov>
constexpr int kMaxThreads = kMarkov ? 128 : 1024;

template <bool kMarkov>
__global__ void __launch_bounds__(kMaxThreads<kMarkov>)
decode_units_kernel(const uint32_t* __restrict__ words, int64_t R, int W,
                    const int32_t* __restrict__ n_valid,
                    const uint8_t* __restrict__ lut,
                    uint8_t* __restrict__ out, int n_out) {
  constexpr int kBytes = lut_bytes(kMarkov);
  extern __shared__ __align__(16) unsigned char smem[];
  {
    const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
    for (int i = threadIdx.x; i < kBytes / 16; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       s0 + 16 * i),
                   "l"(lut + 16 * i));
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  const uint16_t* s_root = reinterpret_cast<const uint16_t*>(smem);
  const uint8_t* s_sym = smem + kMarkovRootBytes;
  const uint32_t* s_esc =
      reinterpret_cast<const uint32_t*>(smem + kMarkovRootBytes + kSymBytes);
  const uint32_t* ring =
      reinterpret_cast<const uint32_t*>(smem + kBytes) +
      threadIdx.x * kRingStride;

  const bool vec = (n_out & 15) == 0;
  for (int64_t b = (int64_t)threadIdx.x * gridDim.x + blockIdx.x; b < R;
       b += (int64_t)gridDim.x * blockDim.x) {
    const int nv = (int)mhc_clamp(n_valid[b], 0, n_out);
    uint8_t* orow = out + b * n_out;
    BitReader rd;
    uint32_t top = 0;
    if (nv > 0) {
      rd.init(words + b * W, W, ring);
      top = (uint32_t)(rd.buf >> 32);
    }
    int ctx = 0;                               // stays 0 for order-0

    auto next = [&]() -> uint32_t {
      uint32_t e = kMarkov ? s_root[(ctx << kRootBits) | (top >> 24)]
                           : s_root[top >> 17];
      int len = (int)(e >> 8);
      uint32_t sym = e & 0xFFu;
      if (kMarkov) {
        // the escape (a code of 9..15 bits; w >= lim[1..8] already),
        // computed at every symbol and selected without a branch: its row
        // loads overlap the root load, and in a warp some lane escapes at
        // nearly every symbol, so a branch would cost more than it saves
        const uint32_t* r = s_esc + ctx * kEscStride;
        const uint32_t l0 = r[0], l1 = r[1], l2 = r[2];
        const uint32_t b0 = r[3], b1 = r[4], b2 = r[5], b3 = r[6];
        // all eight loads of the symbol go out together, ahead of the
        // compares (left to itself the compiler issues the root load
        // after them, on the chain)
        asm volatile("" ::: "memory");
        const uint32_t w = top >> 17;
        const uint32_t ww = w | (w << 16);
        // 16-bit lanes: w >= lim[9..14]
        const uint32_t c = __vsetgeu2(ww, l0) + __vsetgeu2(ww, l1) +
                           __vsetgeu2(ww, l2);
        const int elen = 9 + (int)(c & 0xFFFFu) + (int)(c >> 16);
        const int k = elen - 9;
        const uint64_t q = k < 4 ? ((uint64_t)b1 << 32 | b0)
                                 : ((uint64_t)b3 << 32 | b2);
        const int ebf = (int)(int16_t)(uint16_t)(q >> (16 * (k & 3)));
        const int idx = min(max(ebf + (int)(w >> (15 - elen)), 0), 255);
        const uint32_t esym = s_sym[(ctx << 8) | idx];
        const bool escape = len == 0;
        len = escape ? elen : len;
        sym = escape ? esym : sym;
      }
      top = rd.consume(len);
      if (kMarkov) ctx = (int)sym;
      return sym;
    };

    if (vec) {
      // groups of 16 symbols staged in registers and stored 16 bytes at a
      // time (rows start 16-byte aligned); a whole group without a
      // bounds check per symbol, unrolled
      uint4* o16 = reinterpret_cast<uint4*>(orow);
      int g = 0;
      for (; g < nv >> 4; ++g) {
        rd.group();
        uint32_t p[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 16; ++k) p[k >> 2] |= next() << (8 * (k & 3));
        o16[g] = make_uint4(p[0], p[1], p[2], p[3]);
      }
      if (nv & 15) {
        rd.group();
        uint32_t p0 = 0, p1 = 0, p2 = 0, p3 = 0;
#pragma unroll 1
        for (int k = 0; k < 16; ++k) {
          const uint32_t sym = k < (nv & 15) ? next() : 0u;
          p0 = __funnelshift_r(p0, p1, 8);
          p1 = __funnelshift_r(p1, p2, 8);
          p2 = __funnelshift_r(p2, p3, 8);
          p3 = (p3 >> 8) | (sym << 24);
        }
        o16[g++] = make_uint4(p0, p1, p2, p3);
      }
      for (; g < n_out >> 4; ++g) o16[g] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int t = 0; t < n_out; ++t) {
        if (t < nv && (t & 15) == 0) rd.group();
        orow[t] = t < nv ? next() : 0;
      }
    }
  }
}

template <bool kMarkov>
int launch(const uint32_t* words, int64_t R, int64_t W,
           const int32_t* n_valid, const uint8_t* lut, uint8_t* out,
           int64_t n_out, cudaStream_t stream) {
  // a unit's words and bytes are counted in 32 bits on the chain
  if (W >= INT32_MAX || n_out >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  // one block per SM at most (the table fills one), threads sized to
  // the units; units beyond blocks * threads are strided over
  const int blocks = (int)std::min<int64_t>(mhc_num_sms(), R);
  const int64_t per = (R + blocks - 1) / blocks;
  const int threads =
      (int)std::min<int64_t>(kMaxThreads<kMarkov>, (per + 31) / 32 * 32);
  const int smem = lut_bytes(kMarkov) + threads * kRingStride * 4;
  cudaFuncSetAttribute(decode_units_kernel<kMarkov>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  decode_units_kernel<kMarkov><<<blocks, threads, smem, stream>>>(
      words, R, (int)W, n_valid, lut, out, (int)n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// lim, base, first_code: (256, 16) int32; sorted_syms: (256, 256) int32;
// lut: lut_bytes(markov) bytes (decode_cuda.lut_bytes). markov = 0 reads
// only row 0 of each table.
extern "C" int mhc_decode_lut(const int32_t* lim, const int32_t* base,
                              const int32_t* first_code,
                              const int32_t* sorted_syms, int markov,
                              uint8_t* lut, cudaStream_t stream) {
  decode_lut_kernel<<<256, 256, 0, stream>>>(lim, base, first_code,
                                             sorted_syms, markov != 0, lut);
  return (int)cudaGetLastError();
}

// words: (R, W) uint32; lut: mhc_decode_lut's table for the same mode;
// out: (R, n_out) uint8, every element written.
extern "C" int mhc_decode_units(const uint32_t* words, int64_t R,
                                int64_t W, const int32_t* n_valid,
                                const uint8_t* lut, uint8_t* out,
                                int64_t n_out, int markov,
                                cudaStream_t stream) {
  return markov ? launch<true>(words, R, W, n_valid, lut, out, n_out, stream)
                : launch<false>(words, R, W, n_valid, lut, out, n_out,
                                stream);
}
