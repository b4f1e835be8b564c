// The unit-stream stages around the codec kernels, one block per unit
// (or per literal row), each thread on every blockDim-th word:
//
// K10+K8 compact_units: the dense word-aligned payload of an encode, each
//   unit's words at its offset, a literal unit's original bytes in place
//   of its coded stream. Replaces mhc_tpu/ops/bitpack.py::
//   substitute_raw_units (:178) followed by device_compact_words_slices
//   (:509) / device_compact_words (:442), XLA stages on the TPU. The host
//   applies the literal rule to the bit counts it fetches anyway and
//   hands over each unit's word offset (R + 1 of them, the total last) and
//   a literal flag, so no (R, W) plane is substituted or masked.
// K9/K12 expand_units: (R, W) int32 zero-padded big-endian stream rows
//   from a dense payload, of words (the word-aligned layout) or of bytes
//   (the unaligned order-0 container). Replaces bitpack.py::
//   device_expand_words_slices (:480) / device_expand_words_u32 (:467)
//   and device_expand_words (:652). Every row is written, literal rows
//   too: K14 reads a literal row's bytes from these rows, as the plain
//   overwrite does, and the row the decode kernel never reads costs its
//   words once more (a literal is at most decode_unit bytes).
// K14 literal_rows: a literal row's decode_unit bytes from its stream
//   words, zero past the row's W words, into the decoded rows. Replaces
//   bitpack.py::words_to_unit_bytes (:221) with the jnp.where at
//   mhc_tpu/engine.py:495 and mhc_tpu/api.py:587. It runs after K7,
//   which writes zeros over the rows it is told to skip, and touches the
//   literal rows alone.
//
// K15 compact_bubbles / bubbles_to_payload: K6's bubble stream (per unit
//   one (word, valid) slot a round of two codes, the pending tail word
//   and the bit count; csrc/encode.cu::pack_tiles_kernel) compacted, the
//   k-th valid slot of a unit to its word k and the tail to word bits >> 5
//   where bits % 32 != 0: into (R, W) zero-padded rows (compact_bubbles,
//   the "pallas" pack method's rows; replaces mhc_tpu/ops/kernels/
//   encode_pallas.py::compact_bubbles (:514) and the compaction inside
//   pack_blocks_pallas (:417)), or straight into the dense word-aligned
//   payload at each unit's word offset (bubbles_to_payload, the payload
//   route; replaces encode_pallas.py::pack_blocks_to_payload (:453)).
//   XLA scatters on the TPU. One 256-thread block per unit walks its
//   rounds in tiles of 1,024 slots, four a thread: the flags four bytes a
//   load (bv is 0 or 1, so a thread's count is a popcount), the words as
//   one 16-byte load where a flag is set, a warp scan of the counts and the
//   warps' totals give each valid word its place, the tile's words are
//   staged in shared memory in stream order and stored contiguous across
//   the block, and the running total carries to the next tile. The rows'
//   zero fill past each stream is the same pass. The payload's word
//   offsets, the exclusive sum of ceil(bits / 32) over the units before,
//   come from a one-block scan kernel launched just before, on the card
//   (no host sync): R is ~1,600-13,000 units, a few microseconds, where
//   each block summing its predecessors' counts would read R^2 / 2 words.
//   Only the streams are written: the payload's words past the total are
//   left as they were (the engine keeps the first total words).
//
// Bound: bytes, each read and written once (PERF.md §6 has this run's):
// at 100 MB Markov, K15 reads the bubble stream (262 MB: 4 B of word and
// 1 B of flag a round) and writes the rows (197 MB) or the payload (84 MB),
// K10+K8 moves ~78 MB each way, K9 the payload in and
// ~105 MB of rows out, K14 a quarter of the output each way. Each word is
// copied by one thread, neighbouring threads on neighbouring words, so a
// warp's loads and stores are whole 128-byte lines but at a unit's edges;
// offsets are 64-bit (a 64 MB chunk of wide units passes 2^31 words).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// big-endian word of 4 bytes, bytes past `n` read as 0
__device__ __forceinline__ uint32_t be_word(const uint8_t* src, int64_t n) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w |= (k < n ? (uint32_t)src[k] : 0u) << (24 - 8 * k);
  return w;
}

__global__ void __launch_bounds__(kThreads) compact_units_kernel(
    const int32_t* __restrict__ words, int64_t W, int64_t ld,
    const uint8_t* __restrict__ units, int64_t du, int vec4,
    const int32_t* __restrict__ n_valid, const int64_t* __restrict__ offs,
    const uint8_t* __restrict__ literal, int32_t* __restrict__ out) {
  const int64_t r = blockIdx.x;
  const int64_t off = offs[r];
  const int64_t len = offs[r + 1] - off;
  int32_t* dst = out + off;
  if (literal[r]) {
    const uint8_t* src = units + r * du;
    const int64_t nv = n_valid[r] < du ? (int64_t)n_valid[r] : du;
    for (int64_t i = threadIdx.x; i < len; i += kThreads) {
      uint32_t w;
      if (vec4 && 4 * i + 4 <= nv)
        w = __byte_perm(*reinterpret_cast<const uint32_t*>(src + 4 * i), 0,
                        0x0123);
      else
        w = be_word(src + 4 * i, nv - 4 * i);
      dst[i] = (int32_t)w;
    }
  } else {
    const int32_t* src = words + r * ld;
    for (int64_t i = threadIdx.x; i < len; i += kThreads)
      dst[i] = i < W ? src[i] : 0;
  }
}

__global__ void __launch_bounds__(kThreads) expand_units_kernel(
    const void* __restrict__ payload, int64_t T, int bytes,
    const int64_t* __restrict__ offs, int64_t W, int32_t* __restrict__ out) {
  const int64_t r = blockIdx.x;
  const int64_t off = offs[r];
  const int64_t len = offs[r + 1] - off;
  int32_t* dst = out + r * W;
  if (!bytes) {
    const int32_t* p = static_cast<const int32_t*>(payload);
    for (int64_t i = threadIdx.x; i < W; i += kThreads)
      dst[i] = i < len && T > 0 ? p[mhc_clamp(off + i, 0, T - 1)] : 0;
    return;
  }
  const uint8_t* p = static_cast<const uint8_t*>(payload);
  for (int64_t i = threadIdx.x; i < W; i += kThreads) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = 4 * i + k;
      if (j < len && T > 0)
        w |= (uint32_t)p[mhc_clamp(off + j, 0, T - 1)] << (24 - 8 * k);
    }
    dst[i] = (int32_t)w;
  }
}

__global__ void __launch_bounds__(kThreads) literal_rows_kernel(
    const int32_t* __restrict__ words, int64_t R, int64_t W,
    const int64_t* __restrict__ rows, int64_t du, uint8_t* __restrict__ out) {
  const int64_t r = rows[blockIdx.x];
  if (r < 0 || r >= R) return;
  const int32_t* src = words + r * W;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + r * du);
  for (int64_t i = threadIdx.x; i < du / 4; i += kThreads)
    dst[i] = __byte_perm(i < W ? (uint32_t)src[i] : 0u, 0, 0x0123);
}

constexpr int kBubbleWarps = kThreads / 32;
constexpr int kBubbleTile = 4 * kThreads;  // slots a block walks a tile

// One unit's bubble slots, `rounds` of them, on a kThreads-thread block:
// the k-th valid word to dst[k] for k < cap. Returns the unit's valid
// slots (every one, also past cap), the same in every thread; ends on a
// barrier, so the caller may overwrite what it stored. vec: bw and bv
// rows 16- and 4-byte aligned (rounds % 4 == 0).
__device__ __forceinline__ int64_t compact_slots(
    const int32_t* __restrict__ bw, const uint8_t* __restrict__ bv,
    int64_t rounds, int vec, int32_t* __restrict__ dst, int64_t cap) {
  __shared__ int32_t stage[kBubbleTile];
  __shared__ int warp_total[kBubbleWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t done = 0;  // valid slots of the tiles before
  for (int64_t t0 = 0; t0 < rounds; t0 += kBubbleTile) {
    const int64_t i0 = t0 + 4 * tid;
    uint32_t flags = 0;  // bit 8k: slot i0 + k is valid
    int32_t w[4] = {0, 0, 0, 0};
    if (vec && i0 + 4 <= rounds) {
      flags = *reinterpret_cast<const uint32_t*>(bv + i0) & 0x01010101u;
      if (flags) {
        const int4 q = *reinterpret_cast<const int4*>(bw + i0);
        w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < rounds && (bv[i0 + k] & 1)) {
          flags |= 1u << (8 * k);
          w[k] = bw[i0 + k];
        }
    }
    const int c = __popc(flags);
    int x = c;  // inclusive scan of the warp's counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    int at = x - c, tile = 0;
#pragma unroll
    for (int k = 0; k < kBubbleWarps; ++k) {
      const int t = warp_total[k];
      at += k < warp ? t : 0;
      tile += t;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (flags >> (8 * k) & 1) stage[at++] = w[k];
    __syncthreads();
    for (int i = tid; i < tile && done + i < cap; i += kThreads)
      dst[done + i] = stage[i];
    done += tile;
    __syncthreads();  // stage and warp_total serve the next tile
  }
  return done;
}

__global__ void __launch_bounds__(kThreads) compact_bubbles_kernel(
    const int32_t* __restrict__ bw, const uint8_t* __restrict__ bv,
    const int32_t* __restrict__ tail, const int32_t* __restrict__ bits,
    int64_t rounds, int vec, int64_t W, int32_t* __restrict__ out) {
  const int64_t r = blockIdx.x;
  int32_t* row = out + r * W;
  const int64_t n =
      compact_slots(bw + r * rounds, bv + r * rounds, rounds, vec, row, W);
  const int64_t b = bits[r];
  const int64_t at = (b & 31) ? b >> 5 : -1;  // the tail's word
  for (int64_t i = n + threadIdx.x; i < W; i += kThreads)
    if (i != at) row[i] = 0;
  if (threadIdx.x == 0 && at >= 0 && at < W) row[at] = tail[r];
}

// offs[r] = sum over q < r of ceil(bits[q] / 32), offs[R] the total: one
// block, kScanThreads units a step, the step's total carried.
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads) word_offsets_kernel(
    const int32_t* __restrict__ bits, int64_t R, int64_t* __restrict__ offs) {
  __shared__ int64_t warp_total[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t carry = 0;
  for (int64_t r0 = 0; r0 < R; r0 += kScanThreads) {
    const int64_t r = r0 + tid;
    const int64_t c = r < R ? ((int64_t)bits[r] + 31) >> 5 : 0;
    int64_t x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    int64_t before = carry + x - c, step = 0;
    for (int k = 0; k < kScanThreads / 32; ++k) {
      const int64_t t = warp_total[k];
      before += k < warp ? t : 0;
      step += t;
    }
    if (r < R) offs[r] = before;
    carry += step;
    __syncthreads();
  }
  if (tid == 0) offs[R] = carry;
}

__global__ void __launch_bounds__(kThreads) bubbles_to_payload_kernel(
    const int32_t* __restrict__ bw, const uint8_t* __restrict__ bv,
    const int32_t* __restrict__ tail, const int32_t* __restrict__ bits,
    int64_t rounds, int vec, const int64_t* __restrict__ offs,
    int32_t* __restrict__ out) {
  const int64_t r = blockIdx.x;
  int32_t* dst = out + offs[r];
  const int64_t b = bits[r];
  compact_slots(bw + r * rounds, bv + r * rounds, rounds, vec, dst,
                (b + 31) >> 5);
  if (threadIdx.x == 0 && (b & 31)) dst[b >> 5] = tail[r];
}

}  // namespace

// words (R, W) int32 coded rows, ld words apart, units (R, du) uint8,
// n_valid (R,) int32, offs (R + 1,) int64 word offsets, literal (R,) uint8
// flags -> out (offs[R],) int32. vec4: units rows are 4-byte aligned
// (du % 4 == 0 and an aligned base).
extern "C" int mhc_compact_units(const int32_t* words, int64_t R, int64_t W,
                                 int64_t ld, const uint8_t* units,
                                 int64_t du, int vec4,
                                 const int32_t* n_valid, const int64_t* offs,
                                 const uint8_t* literal, int32_t* out,
                                 cudaStream_t stream) {
  if (R < 0 || R > INT32_MAX || W < 0 || ld < W || du < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  compact_units_kernel<<<(unsigned)R, kThreads, 0, stream>>>(
      words, W, ld, units, du, vec4, n_valid, offs, literal, out);
  return (int)cudaGetLastError();
}

// payload (T,) int32 words (bytes == 0) or uint8 bytes (bytes == 1), offs
// (R + 1,) int64 offsets in its elements -> out (R, W) int32.
extern "C" int mhc_expand_units(const void* payload, int64_t T, int bytes,
                                const int64_t* offs, int64_t R, int64_t W,
                                int32_t* out, cudaStream_t stream) {
  if (R < 0 || R > INT32_MAX || W < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || W == 0) return (int)cudaSuccess;
  expand_units_kernel<<<(unsigned)R, kThreads, 0, stream>>>(
      payload, T, bytes, offs, W, out);
  return (int)cudaGetLastError();
}

// words (R, W) int32, rows (n_rows,) int64 literal row indices, out (R, du)
// uint8 with du % 4 == 0 and a 4-byte aligned base, written in place.
extern "C" int mhc_literal_rows(const int32_t* words, int64_t R, int64_t W,
                                const int64_t* rows, int64_t n_rows,
                                int64_t du, uint8_t* out,
                                cudaStream_t stream) {
  if (n_rows < 0 || n_rows > INT32_MAX || W < 0 || du % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  literal_rows_kernel<<<(unsigned)n_rows, kThreads, 0, stream>>>(
      words, R, W, rows, du, out);
  return (int)cudaGetLastError();
}

static int bubbles_vec(const int32_t* bw, const uint8_t* bv, int64_t rounds) {
  return rounds % 4 == 0 && reinterpret_cast<uintptr_t>(bw) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(bv) % 4 == 0;
}

// bw (R, rounds) int32 and bv (R, rounds) uint8 0/1, contiguous, tail and
// bits (R,) int32 -> out (R, W) int32, every element written.
extern "C" int mhc_compact_bubbles(const int32_t* bw, const uint8_t* bv,
                                   const int32_t* tail, const int32_t* bits,
                                   int64_t R, int64_t rounds, int64_t W,
                                   int32_t* out, cudaStream_t stream) {
  if (R < 0 || R > INT32_MAX || rounds < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  compact_bubbles_kernel<<<(unsigned)R, kThreads, 0, stream>>>(
      bw, bv, tail, bits, rounds, bubbles_vec(bw, bv, rounds), W, out);
  return (int)cudaGetLastError();
}

// The same bubble stream -> out, unit r's ceil(bits[r] / 32) words at
// offs[r]; offs (R + 1,) int64 scratch, written first by the scan (the
// total last). Two launches on `stream`: the scan, then the compaction.
extern "C" int mhc_bubbles_to_payload(const int32_t* bw, const uint8_t* bv,
                                      const int32_t* tail,
                                      const int32_t* bits, int64_t R,
                                      int64_t rounds, int64_t* offs,
                                      int32_t* out, cudaStream_t stream) {
  if (R < 0 || R > INT32_MAX || rounds < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  word_offsets_kernel<<<1, kScanThreads, 0, stream>>>(bits, R, offs);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bubbles_to_payload_kernel<<<(unsigned)R, kThreads, 0, stream>>>(
      bw, bv, tail, bits, rounds, bubbles_vec(bw, bv, rounds), offs, out);
  return (int)cudaGetLastError();
}
