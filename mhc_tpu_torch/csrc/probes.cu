// P1-P3: the calibration probes of bench/ as Hopper kernels. Each one
// times a building block of the reference's kernel designs on this card,
// and computes, bit for bit, the (8, 128) array its reference computes.
//
//   P1 loop_calib_kernel<variant, n_ops> replaces bench/loop_calib.py:74
//      (body `make`, :34-70): a loop of `iters` steps over a (8, 128) u32
//      carry, one block of 1,024 threads, one thread per element, the
//      loop inside the kernel. Bodies: `chain` (n dependent
//      (c + k+1) ^ (c >> 1) a step), `scratch` (n round trips through
//      shared memory, volatile so that none is elided), `store` (the chain
//      plus a predicated global store on odd steps), `wide` (n 64-deep
//      masked sums of x, in registers; the sum is x itself, as `big` is x
//      broadcast, :38), and `dep` (n dependent c += c >> 1, a one-op
//      chain, one LEA.HI an op, run as 32 one-warp blocks: the
//      calibration of an integer op's dependent latency, which the
//      reference does not have).
//   P2 i8_matmul_kernel replaces bench/mosaic_probe.py:44 (`i8_kernel`,
//      :34-38): an int8 x int8 -> int32 product on the tensor cores,
//      mma.sync m16n8k32, one warp per 16 x 8 output tile, fragments
//      loaded straight from global memory (a simple tiling; wgmma and TMA
//      are later work).
//   P3 vpu_probe_kernel<variant> and vpu_fetch_kernel<bf16> replace
//      bench/vpu_probe.py:41 (bodies :71-220): a loop of `iters` steps
//      over a (8, 128) i32 carry in [0, 256). The eight CUDA-core bodies
//      run one thread per element of the carry (1,024 threads): the null
//      loop, three one-hot builds each with its 256-deep pick, and four
//      256-deep picks from a (256, 8) table in shared memory (the
//      reference's (256, 8, 128) table is that one broadcast over lanes,
//      :145-147). The two fetch cores are a one-hot product on the tensor
//      cores, as the reference's is on the MXU: each step builds the
//      one-hot of the carry in shared memory (256 x 1,024, int8 or bf16,
//      in four chunks of 256 columns), multiplies the (316 x 256) planes
//      by it on mma.sync (int8 m16n8k32 into s32, or bf16 m16n8k16 into
//      f32; 316 rows padded to 320, 20 warps of one 16-row tile each,
//      their A fragments held in registers for the whole loop), and sums
//      output rows 0..15 per lane; the carry crosses steps in shared
//      memory behind __syncthreads(). One block: the probes time
//      latency, as their references do on one TensorCore.
//
// Bound. Each probe is a chain of dependent steps on 1,024 lanes, so what
// bounds it is latency, not bytes (8 KB in and out) nor, but for the fetch
// cores, operations: chip_smoke.py holds P1 to its chain floor (the
// dependent integer ops of a step times their latency) and P3 to the
// larger of its operations at the card's peak rate and its dependent
// depth. Each carry passes an empty asm barrier once a step, so that the
// compiler can neither fold steps together nor hoist them out of the
// loop; each kernel writes its loop's clock64() cycles (thread 0) when
// asked, so that a check can see the loop's time without the launch's.

#include "common.cuh"

#include <cuda_bf16.h>

namespace {

// The value is materialised in a register here: no step is folded into
// the next or computed in closed form.
__device__ __forceinline__ void opaque(uint32_t& v) {
  asm volatile("" : "+r"(v));
}
__device__ __forceinline__ void opaque(int32_t& v) {
  asm volatile("" : "+r"(v));
}

// ---------------------------------------------------------------------------
// P1
// ---------------------------------------------------------------------------

enum LoopVariant : int { kChain = 0, kScratch = 1, kStore = 2, kWide = 3,
                         kDep = 4 };
constexpr int kLanes = 8 * 128;
// The one-op chain runs 32 blocks of one warp, a warp on each of 32 SMs,
// so that each op waits on the one before it and on nothing else: its
// time per op is an integer op's dependent latency. In one block of 1,024
// threads the 32 warps of an SM share its 64 INT32 lanes, and a chain of
// one-op steps runs at that throughput instead (16 cycles an op).
constexpr int kDepBlocks = 32;

template <int V, int N>
__global__ void __launch_bounds__(kLanes)
    loop_calib_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out, int iters,
                      long long* __restrict__ cycles) {
  __shared__ uint32_t scratch[kLanes];
  volatile uint32_t* scr = scratch + threadIdx.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t x0 = x[t];
  uint32_t c = x0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if constexpr (V == kChain || V == kStore) {
#pragma unroll
      for (int k = 0; k < N; ++k) c = (c + uint32_t(k + 1)) ^ (c >> 1);
      if constexpr (V == kStore) {
        if (i & 1) out[t] = c;
      }
    } else if constexpr (V == kScratch) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        *scr = c;
        c = *scr + uint32_t(k + 1);
      }
    } else if constexpr (V == kWide) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const uint32_t sel = c & 63u;
        uint32_t s = 0;
#pragma unroll
        for (int j = 0; j < 64; ++j) s += (uint32_t(j) == sel) ? x0 : 0u;
        c += s;
        opaque(c);
      }
    } else {
      // the barrier on every op keeps the compiler from analysing the
      // whole chain at once (it emits nothing: one LEA.HI an op stays);
      // without it nvcc's front end spends minutes on the 512-op chain
#pragma unroll
      for (int k = 0; k < N; ++k) {
        c += c >> 1;
        opaque(c);
      }
    }
    opaque(c);
  }
  if (cycles != nullptr && t == 0) *cycles = clock64() - t0;
  out[t] = c;
}

// ---------------------------------------------------------------------------
// Tensor-core products (mma.sync; A row-major, B column-major)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 bytes, the first in the low byte (an mma fragment register).
__device__ __forceinline__ uint32_t pack4(int8_t e0, int8_t e1, int8_t e2,
                                          int8_t e3) {
  return uint32_t(uint8_t(e0)) | uint32_t(uint8_t(e1)) << 8 |
         uint32_t(uint8_t(e2)) << 16 | uint32_t(uint8_t(e3)) << 24;
}

// ---------------------------------------------------------------------------
// P2: D (M x N, s32) = A (M x K, s8, row-major) . B (K x N, s8, row-major);
// M % 16 == N % 8 == K % 32 == 0. One warp (one block) per 16 x 8 tile of D.
// The m16n8k32 fragments (lane = 4 g + q):
//   A: a0 (row g, cols 4q..4q+3), a1 (row g+8, the same cols), a2 and a3
//      the same rows at cols 16 + 4q..;
//   B: b0 (rows 4q..4q+3, col g), b1 (rows 16 + 4q.., col g);
//   D: d0, d1 (row g, cols 2q, 2q+1), d2, d3 (row g+8, the same cols).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
    i8_matmul_kernel(const int8_t* __restrict__ A,
                     const int8_t* __restrict__ B, int32_t* __restrict__ D,
                     int N, int K) {
  const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
  const int m0 = (blockIdx.x / (N / 8)) * 16, n0 = (blockIdx.x % (N / 8)) * 8;
  int32_t d[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint32_t a[4];
    const int8_t* ar = A + (int64_t)(m0 + g) * K + k0 + 4 * q;
    a[0] = *reinterpret_cast<const uint32_t*>(ar);
    a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * K);
    a[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * K + 16);
    const int8_t* bc = B + (int64_t)(k0 + 4 * q) * N + n0 + g;
    const uint32_t b0 = pack4(bc[0], bc[N], bc[2 * N], bc[3 * N]);
    bc += 16 * (int64_t)N;
    const uint32_t b1 = pack4(bc[0], bc[N], bc[2 * N], bc[3 * N]);
    mma_s8(d, a, b0, b1);
  }
  int32_t* dr = D + (int64_t)(m0 + g) * N + n0 + 2 * q;
  dr[0] = d[0];
  dr[1] = d[1];
  dr[8 * N] = d[2];
  dr[8 * N + 1] = d[3];
}

// ---------------------------------------------------------------------------
// P3, the CUDA-core bodies: thread t holds the carry of element
// (r, l) = (t / 128, t % 128); every body but the null loop is a 256-deep
// masked sum whose one selected term is the next carry.
// ---------------------------------------------------------------------------

enum VpuVariant : int {
  kNull = 0, kOnehotI32I8 = 1, kOnehotBf16 = 2, kOnehotFact = 3,
  kPickI32 = 4, kPickI8I32 = 5, kPickI8I8 = 6, kPickF32 = 7,
  kFetchI8 = 8, kFetchBf16 = 9,
};
constexpr int kDepth = 256;
constexpr int kRows = 8;

template <int V>
__global__ void __launch_bounds__(kLanes)
    vpu_probe_kernel(const int32_t* __restrict__ x,
                     const void* __restrict__ table,
                     int32_t* __restrict__ out, int iters,
                     long long* __restrict__ cycles) {
  // the (256, 8) table: int32, float or int8 by variant
  __shared__ int32_t tab[kDepth * kRows];
  const int t = threadIdx.x, r = t >> 7;
  if constexpr (V == kPickI32 || V == kPickF32) {
    for (int i = t; i < kDepth * kRows; i += kLanes)
      tab[i] = static_cast<const int32_t*>(table)[i];
  } else if constexpr (V == kPickI8I32 || V == kPickI8I8) {
    for (int i = t; i < kDepth * kRows; i += kLanes)
      reinterpret_cast<int8_t*>(tab)[i] = static_cast<const int8_t*>(table)[i];
  }
  __syncthreads();
  const int8_t* tab8 = reinterpret_cast<const int8_t*>(tab);
  const float* tabf = reinterpret_cast<const float*>(tab);
  int32_t c = x[t];
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if constexpr (V == kNull) {
      c = (c + 1) & 255;
    } else if constexpr (V == kOnehotI32I8) {
      int32_t s = 0;
#pragma unroll 16
      for (int k = 0; k < kDepth; ++k) {
        const int8_t oh = int8_t(c == k);
        s += int32_t(oh) * k;
      }
      c = s & 255;
    } else if constexpr (V == kOnehotBf16) {
      const __nv_bfloat16 cb = __int2bfloat16_rn(c);
      const __nv_bfloat16 one = __float2bfloat16(1.0f);
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
      float s = 0.0f;
#pragma unroll 16
      for (int k = 0; k < kDepth; ++k) {
        const __nv_bfloat16 kb = __int2bfloat16_rn(k);
        const __nv_bfloat16 oh = __heq(cb, kb) ? one : zero;
        s += __bfloat162float(__hmul(oh, kb));
      }
      c = int32_t(s) & 255;
    } else if constexpr (V == kOnehotFact) {
      int8_t hi[16], lo[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        hi[j] = int8_t((c >> 4) == j);
        lo[j] = int8_t((c & 15) == j);
      }
      int32_t s = 0;
#pragma unroll
      for (int h = 0; h < 16; ++h)
#pragma unroll
        for (int l = 0; l < 16; ++l)
          s += int32_t(int8_t(hi[h] * lo[l])) * (h * 16 + l);
      c = s & 255;
    } else if constexpr (V == kPickI32) {
      int32_t s = 0;
#pragma unroll 16
      for (int k = 0; k < kDepth; ++k) s += (c == k) ? tab[k * kRows + r] : 0;
      c = s & 255;
    } else if constexpr (V == kPickI8I32) {
      int32_t s = 0;
#pragma unroll 16
      for (int k = 0; k < kDepth; ++k)
        s += int32_t(int8_t(int8_t(c == k) * tab8[k * kRows + r]));
      c = s & 255;
    } else if constexpr (V == kPickI8I8) {
      int8_t s8 = 0;
#pragma unroll 16
      for (int k = 0; k < kDepth; ++k)
        s8 = int8_t(s8 + int8_t(int8_t(c == k) * tab8[k * kRows + r]));
      c = int32_t(s8) & 255;
    } else if constexpr (V == kPickF32) {
      float s = 0.0f;
#pragma unroll 16
      for (int k = 0; k < kDepth; ++k)
        s += (c == k) ? tabf[k * kRows + r] : 0.0f;
      c = int32_t(s) & 255;
    }
    opaque(c);
  }
  if (cycles != nullptr && t == 0) *cycles = clock64() - t0;
  out[t] = c;
}

// ---------------------------------------------------------------------------
// P3, the fetch cores: next carry of lane n = sum_{j < 16} P[c_n, j]
// (+ 128 * 16 for int8), & 255, where P is the (256, 316) plane and the
// product P^T (316 x 256, padded to 320 rows) . onehot(c) (256 x 1,024)
// runs on the tensor cores. Warp w holds rows 16 w..16 w + 15 of P^T as
// A fragments in registers (int8: 8 k-steps of 4 registers; bf16: 16
// k-steps of 4) and, per chunk of 256 carry columns, multiplies them by
// every 8-column tile of the chunk's one-hot; warp 0's tile is rows 0..15,
// whose column sums are the next carry. The one-hot chunk is column-major
// in shared memory (a column's 256 k contiguous), each column padded by
// 16 bytes so that a fragment load hits 32 distinct banks.
// ---------------------------------------------------------------------------

constexpr int kPlaneCols = 316;
constexpr int kFetchWarps = 20;                 // 320 rows / 16
constexpr int kChunk = 256;                     // carry columns per chunk
constexpr int kSum = 16;                        // rows summed

template <bool kBf16>
struct Fetch {
  static constexpr int kElem = kBf16 ? 2 : 1;
  static constexpr int kStride = kDepth * kElem + 16;   // bytes a column
  static constexpr int kKStep = kBf16 ? 16 : 32;
  static constexpr int kKSteps = kDepth / kKStep;
  static constexpr int kSmem = kChunk * kStride + 2 * kLanes * 4;
};

// A fragment register `i` (0..3) of k-step `ks` for warp row tile m0.
// int8 m16n8k32: a0 (row g, k 4q..4q+3), a1 (row g+8), a2 / a3 at k + 16.
// bf16 m16n8k16: a0 (row g, k 2q, 2q+1), a1 (row g+8), a2 / a3 at k + 8.
template <bool kBf16>
__device__ __forceinline__ uint32_t plane_frag(const void* planes, int m0,
                                               int ks, int i, int g,
                                               int q) {
  const int row = m0 + g + ((i & 1) ? 8 : 0);
  if constexpr (kBf16) {
    const uint16_t* p = static_cast<const uint16_t*>(planes);
    const int k = ks * 16 + 2 * q + ((i & 2) ? 8 : 0);
    if (row >= kPlaneCols) return 0;
    return uint32_t(p[k * kPlaneCols + row]) |
           uint32_t(p[(k + 1) * kPlaneCols + row]) << 16;
  }
  const int8_t* p = static_cast<const int8_t*>(planes);
  const int k = ks * 32 + 4 * q + ((i & 2) ? 16 : 0);
  if (row >= kPlaneCols) return 0;
  return pack4(p[k * kPlaneCols + row], p[(k + 1) * kPlaneCols + row],
               p[(k + 2) * kPlaneCols + row], p[(k + 3) * kPlaneCols + row]);
}

template <bool kBf16>
__global__ void __launch_bounds__(kFetchWarps * 32, 1)
    vpu_fetch_kernel(const int32_t* __restrict__ x,
                     const void* __restrict__ planes,
                     int32_t* __restrict__ out, int iters,
                     long long* __restrict__ cycles) {
  using F = Fetch<kBf16>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* oh = smem;
  int32_t* carry = reinterpret_cast<int32_t*>(smem + kChunk * F::kStride);
  int32_t* next = carry + kLanes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  constexpr int kThreads = kFetchWarps * 32;

  uint32_t a[F::kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < F::kKSteps; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[ks][i] = plane_frag<kBf16>(planes, warp * 16, ks, i, g, q);
  for (int i = tid; i < kLanes; i += kThreads) carry[i] = x[i];
  __syncthreads();

  const long long t0 = clock64();
  for (int step = 0; step < iters; ++step) {
    for (int ch = 0; ch < kLanes / kChunk; ++ch) {
      // the chunk's one-hot, 16 bytes a store: vector v of column col
      // holds k = v * (16 / elem) .. ; one element is 1 where k == carry
      constexpr int kVecs = kDepth * F::kElem / 16;
      for (int idx = tid; idx < kChunk * kVecs; idx += kThreads) {
        const int col = idx / kVecs, v = idx % kVecs;
        const int cc = carry[ch * kChunk + col];
        uint32_t w[4] = {0, 0, 0, 0};
        if constexpr (kBf16) {
          if ((cc >> 3) == v)                 // 8 bf16 a vector; 1.0 = 0x3F80
            w[(cc & 7) >> 1] = 0x3F80u << (16 * (cc & 1));
        } else {
          if ((cc >> 4) == v)                 // 16 int8 a vector
            w[(cc & 15) >> 2] = 1u << (8 * (cc & 3));
        }
        *reinterpret_cast<uint4*>(oh + col * F::kStride + v * 16) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      __syncthreads();
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const unsigned char* bcol = oh + (nt * 8 + g) * F::kStride;
        int32_t di[4] = {0, 0, 0, 0};
        float df[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < F::kKSteps; ++ks) {
          if constexpr (kBf16) {
            const int kb = (ks * 16 + 2 * q) * 2;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bcol + kb);
            const uint32_t b1 =
                *reinterpret_cast<const uint32_t*>(bcol + kb + 16);
            mma_bf16(df, a[ks], b0, b1);
          } else {
            const int kb = ks * 32 + 4 * q;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bcol + kb);
            const uint32_t b1 =
                *reinterpret_cast<const uint32_t*>(bcol + kb + 16);
            mma_s8(di, a[ks], b0, b1);
          }
        }
        if (warp == 0) {
          // column sums of rows 0..15: this lane's two rows, then over g
          int32_t s0, s1;
          if constexpr (kBf16) {
            float f0 = df[0] + df[2], f1 = df[1] + df[3];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              f0 += __shfl_xor_sync(0xffffffffu, f0, o);
              f1 += __shfl_xor_sync(0xffffffffu, f1, o);
            }
            s0 = int32_t(f0) & 255;
            s1 = int32_t(f1) & 255;
          } else {
            s0 = di[0] + di[2];
            s1 = di[1] + di[3];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, o);
              s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            }
            s0 = (s0 + 128 * kSum) & 255;
            s1 = (s1 + 128 * kSum) & 255;
          }
          if (g == 0) {
            next[ch * kChunk + nt * 8 + 2 * q] = s0;
            next[ch * kChunk + nt * 8 + 2 * q + 1] = s1;
          }
        }
      }
      __syncthreads();
    }
    int32_t* done = next;
    next = carry;
    carry = done;
  }
  if (cycles != nullptr && tid == 0) *cycles = clock64() - t0;
  for (int i = tid; i < kLanes; i += kThreads) out[i] = carry[i];
}

template <bool kBf16>
int launch_fetch(const int32_t* x, const void* planes, int32_t* out,
                 int iters, long long* cycles, cudaStream_t stream) {
  const int bytes = Fetch<kBf16>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      vpu_fetch_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  vpu_fetch_kernel<kBf16><<<1, kFetchWarps * 32, bytes, stream>>>(
      x, planes, out, iters, cycles);
  return (int)cudaGetLastError();
}

}  // namespace

// P1: x, out (8, 128) u32; variant and n_ops one of the configurations
// below; cycles (one int64) or null.
extern "C" int mhc_loop_calib(const uint32_t* x, uint32_t* out, int variant,
                              int n_ops, int iters, long long* cycles,
                              cudaStream_t stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  // the one-op chain: one warp a block, a warp an SM (see kDepBlocks)
#define MHC_LOOP_CASE(V, N)                                              \
  if (variant == V && n_ops == N) {                                      \
    const int blocks = V == kDep ? kDepBlocks : 1;                       \
    loop_calib_kernel<V, N><<<blocks, kLanes / blocks, 0, stream>>>(     \
        x, out, iters, cycles);                                          \
    return (int)cudaGetLastError();                                      \
  }
  MHC_LOOP_CASE(kChain, 4)
  MHC_LOOP_CASE(kChain, 32)
  MHC_LOOP_CASE(kChain, 128)
  MHC_LOOP_CASE(kChain, 512)
  MHC_LOOP_CASE(kScratch, 8)
  MHC_LOOP_CASE(kStore, 32)
  MHC_LOOP_CASE(kWide, 1)
  MHC_LOOP_CASE(kWide, 4)
  MHC_LOOP_CASE(kDep, 32)
  MHC_LOOP_CASE(kDep, 512)
#undef MHC_LOOP_CASE
  return (int)cudaErrorInvalidValue;
}

// P2: D (M, N) s32 = A (M, K) s8 . B (K, N) s8, all row-major.
extern "C" int mhc_i8_matmul(const int8_t* A, const int8_t* B, int32_t* D,
                             int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 16 || N % 8 || K % 32)
    return (int)cudaErrorInvalidValue;
  i8_matmul_kernel<<<(M / 16) * (N / 8), 32, 0, stream>>>(A, B, D, N, K);
  return (int)cudaGetLastError();
}

// P3: x, out (8, 128) i32 in [0, 256); table: the (256, 8) pick table
// (int32, int8 or float by variant) or the (256, 316) fetch plane (int8 or
// bf16), else null; cycles (one int64) or null.
extern "C" int mhc_vpu_probe(const int32_t* x, const void* table,
                             int32_t* out, int variant, int iters,
                             long long* cycles, cudaStream_t stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
#define MHC_VPU_CASE(V)                                                  \
  case V:                                                                \
    vpu_probe_kernel<V><<<1, kLanes, 0, stream>>>(x, table, out, iters,  \
                                                  cycles);               \
    return (int)cudaGetLastError();
  switch (variant) {
    MHC_VPU_CASE(kNull)
    MHC_VPU_CASE(kOnehotI32I8)
    MHC_VPU_CASE(kOnehotBf16)
    MHC_VPU_CASE(kOnehotFact)
    MHC_VPU_CASE(kPickI32)
    MHC_VPU_CASE(kPickI8I32)
    MHC_VPU_CASE(kPickI8I8)
    MHC_VPU_CASE(kPickF32)
    case kFetchI8:
      return launch_fetch<false>(x, table, out, iters, cycles, stream);
    case kFetchBf16:
      return launch_fetch<true>(x, table, out, iters, cycles, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MHC_VPU_CASE
}
