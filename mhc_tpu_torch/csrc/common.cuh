// Shared by the port's kernel libraries: each csrc/<name>.cu is built into
// its own shared library (ops/kernels/_build.py), so this header is
// compiled once per library.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* mhc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Streaming multiprocessors of the current device (sizes persistent grids).
static inline int mhc_num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

__device__ __forceinline__ int64_t mhc_clamp(int64_t v, int64_t lo,
                                             int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// The (prev, cur) code table in shared memory, as K3 and K5 read it:
// u16 canonical code + u8 length per pair, 192 KB.
// ---------------------------------------------------------------------------

constexpr int kPairs = 256 * 256;
constexpr int kClTableSmem = kPairs * (sizeof(uint16_t) + sizeof(uint8_t));

struct ClTable {
  uint16_t* code;
  uint8_t* len;

  // Carve the table out of `smem` and fill it from global memory with
  // 16-byte copies; the caller syncs the block afterwards.
  __device__ static ClTable load(unsigned char* smem,
                                 const uint16_t* __restrict__ codes16,
                                 const uint8_t* __restrict__ lens8) {
    ClTable t{reinterpret_cast<uint16_t*>(smem),
              smem + kPairs * sizeof(uint16_t)};
    const uint4* gc = reinterpret_cast<const uint4*>(codes16);
    const uint4* gl = reinterpret_cast<const uint4*>(lens8);
    uint4* sc = reinterpret_cast<uint4*>(t.code);
    uint4* sl = reinterpret_cast<uint4*>(t.len);
    for (int i = threadIdx.x; i < kPairs * 2 / 16; i += blockDim.x)
      sc[i] = gc[i];
    for (int i = threadIdx.x; i < kPairs / 16; i += blockDim.x)
      sl[i] = gl[i];
    return t;
  }

  // cl = len << 16 | code of the pair (prev, cur); len <= 15, code < 2^15.
  __device__ __forceinline__ uint32_t cl(int prev, int cur) const {
    const int idx = (prev << 8) | cur;
    return ((uint32_t)len[idx] << 16) | code[idx];
  }
};

// ---------------------------------------------------------------------------
// MSB-first bit accumulator of one unit stream, as K3 builds it:
// codes are concatenated from bit 31 of word 0, and each 32-bit word is
// handed out as it completes. A code is at most 15 bits and fewer than 32
// bits are pending before a put, so one put completes at most one word.
// ---------------------------------------------------------------------------

struct BitAcc {
  uint64_t acc = 0;   // low `nacc` bits are pending, MSB first
  int nacc = 0;
  int32_t total = 0;

  // Appends a code (cl = len << 16 | code); returns true, with the word in
  // `word`, when that completes a word.
  __device__ __forceinline__ bool put(uint32_t cl, uint32_t& word) {
    const int len = (int)(cl >> 16);
    acc = (acc << len) | (cl & 0xFFFFu);
    nacc += len;
    total += len;
    if (nacc < 32) return false;
    nacc -= 32;
    word = (uint32_t)(acc >> nacc);
    return true;
  }

  // The pending bits, MSB-aligned in one word; 0 when none are pending.
  __device__ __forceinline__ uint32_t partial() const {
    return (uint32_t)(acc << (32 - nacc));
  }
};

// ---------------------------------------------------------------------------
// cp.async: copies from global to shared memory that no register waits
// for. A thread commits its copies in groups and waits until at most
// kPending of its groups are still in flight.
// ---------------------------------------------------------------------------

// 16 bytes to the shared-memory address `dst`; !valid copies nothing and
// writes 16 zero bytes (src must still be an address of the allocation).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  // reads of the copied bytes must not move above the wait
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
