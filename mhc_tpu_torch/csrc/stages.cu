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
// Bound: bytes, each read and written once (PERF.md §6 has this run's):
// at 100 MB Markov, K10+K8 moves ~78 MB each way, K9 the payload in and
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
