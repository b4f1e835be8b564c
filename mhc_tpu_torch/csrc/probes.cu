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
//      :34-38): an int8 x int8 -> int32 product on the tensor cores by
//      wgmma (m64n128k32, both operands in shared memory, 128-byte
//      swizzled), one warpgroup a 64 x 128 tile of D, K in steps of 128
//      bytes through two stages: A by TMA, B transposed to K-major by the
//      threads (wgmma takes 8-bit operands K-major only). Bound: at the
//      reference's 256^3 its bytes (64 KB of operands in, 256 KB out:
//      0.117 us at 3.35 TB/s; its 33.6 M operations take 0.017 us at
//      1,979 TOP/s). It cannot come near half of that at this shape: a
//      launch, a TMA round trip and the first stage's loads from device
//      memory each cost a microsecond or so, on 8 CTAs of 132 SMs. At
//      large shapes the 64 x 128 tiles read A and B again from L2 for
//      every tile (B 64 times over at 4096^3), far below the tensor
//      cores' rate; larger tiles, multicast and a persistent grid are
//      later work.
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

#include <cuda.h>
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
// P2: D (M x N, s32) = A (M x K, s8, row-major) . B (K x N, s8, row-major)
// on wgmma; M % 16 == N % 8 == K % 32 == 0, A 16-byte and B 8-byte
// aligned. One warpgroup (128 threads) a CTA computes a 64 x 128 tile of
// D with wgmma m64n128k32 .s32.s8.s8, both operands in shared memory,
// K-major and 128-byte swizzled: byte (row r, k) of a tile of 128-byte
// rows lies at r * 128 + ((k / 16) ^ (r % 8)) * 16 + k % 16, its 8-row
// groups 1,024 bytes apart. K runs in steps of 128 bytes (one swizzle
// atom) through a ring of two stages:
//   - A's tile arrives by TMA (its tensor map made on the host per call),
//     completing on the stage's mbarrier; rows past M and bytes past K
//     come back zero;
//   - wgmma takes 8-bit operands K-major only, and B arrives N-major, so
//     the threads transpose it: thread (kg, cn) = (tid % 16, tid / 16)
//     loads rows 8 kg .. 8 kg + 7 of columns 16 cn .. 16 cn + 15 (16-byte
//     loads where N % 16 == 0 and B is 16-byte aligned, else 8-byte;
//     each load instruction of a warp reads 16 rows of 32 contiguous
//     bytes), transposes the 8 x 16 bytes in registers (byte_perm) and
//     stores 16 K-runs of 8 bytes (the 16 lanes of one cn fill every bank
//     of a 128-byte row once), writing zeros past K and N, then fences
//     the generic proxy's stores against wgmma's reads;
//   - B's next tile waits in registers (the first two tiles' loads are
//     issued together) and is stored while this step's wgmma group runs.
// The epilogue maps the accumulator fragment (thread t of warp w = t / 32,
// lane l: d[4 c + e] is row 16 w + l / 4 + 8 (e / 2), column 8 c +
// 2 (l % 4) + e % 2) to D, masked past M and N.
// ---------------------------------------------------------------------------

constexpr int kMmM = 64;      // rows of D a CTA: one wgmma m64
constexpr int kMmN = 128;     // columns of D a CTA: wgmma n128
constexpr int kMmK = 128;     // K bytes a stage: one 128-byte swizzle atom
constexpr int kMmStages = 2;
constexpr int kMmATile = kMmM * kMmK;                 // 8 KB
constexpr int kMmStage = kMmATile + kMmN * kMmK;      // + B's 16 KB
// the stages, 1,024-byte aligned by hand, and their mbarriers
constexpr int kMmSmem = kMmStages * kMmStage + 1024 + 8 * kMmStages;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The wgmma descriptor of a K-major, 128-byte swizzled tile at `addr`
// (1,024-byte aligned): start address >> 4, leading offset 1 (unused for
// this layout), stride 1,024 bytes between 8-row groups, layout 1
// (128-byte swizzle). Adding 2 advances the start by 32 bytes of K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(1) << 16 |
         uint64_t(1024 >> 4) << 32 | uint64_t(1) << 62;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// TMA: the box at (c0, c1) of the tensor map to shared memory, completing
// on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(bar) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// wgmma fences and waits (the asm below names them; the waits do not).
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_s8_m64n128k32(int32_t (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Four rows of four bytes (x_r holds row r) -> four columns (c_b holds
// byte b of each row, row 0 in the low byte).
__device__ __forceinline__ void transpose4x4(uint32_t x0, uint32_t x1,
                                             uint32_t x2, uint32_t x3,
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
  const uint32_t t1 = __byte_perm(x2, x3, 0x5140);
  const uint32_t t2 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// This thread's 8 x 16 bytes of B's tile at K step kt into registers:
// rows 8 kg .. 8 kg + 7, columns 16 cn .. 16 cn + 15, zero past K and N.
// The loads are only issued here; their first use is store_b_tile's.
__device__ __forceinline__ void fetch_b_tile(const int8_t* __restrict__ B,
                                             uint32_t (&w)[8][4], int N,
                                             int K, int n0, int kt,
                                             bool vec16) {
  const int kg = threadIdx.x & 15, cn = threadIdx.x >> 4;
  const int n = n0 + 16 * cn;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = kt * kMmK + 8 * kg + j;
    const int8_t* src = B + (int64_t)k * N + n;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K && n < N) {
      if (vec16) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        const uint2 lo = *reinterpret_cast<const uint2*>(src);
        const uint2 hi = n + 8 < N ? *reinterpret_cast<const uint2*>(src + 8)
                                   : make_uint2(0, 0);
        v = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
    }
    w[j][0] = v.x;
    w[j][1] = v.y;
    w[j][2] = v.z;
    w[j][3] = v.w;
  }
}

// The fetched 8 x 16 bytes, transposed (byte_perm) into the stage's B
// image (n rows of 128 K bytes, swizzled) as 16 runs of 8 K bytes.
__device__ __forceinline__ void store_b_tile(unsigned char* bt,
                                             const uint32_t (&w)[8][4]) {
  const int kg = threadIdx.x & 15, cn = threadIdx.x >> 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t lo[4], hi[4];
    transpose4x4(w[0][c], w[1][c], w[2][c], w[3][c], lo);
    transpose4x4(w[4][c], w[5][c], w[6][c], w[7][c], hi);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int nl = 16 * cn + 4 * c + b;
      const int off =
          nl * kMmK + (((kg >> 1) ^ (nl & 7)) << 4) + ((kg & 1) << 3);
      *reinterpret_cast<uint2*>(bt + off) = make_uint2(lo[b], hi[b]);
    }
  }
  // the generic proxy's stores, before wgmma (the async proxy) reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A's 64 x 128-byte box at K step kt into its stage, by TMA (one thread).
__device__ __forceinline__ void load_a_tile(const CUtensorMap* map,
                                            unsigned char* smem,
                                            uint64_t* bars, int kt, int m0) {
  const int s = kt % kMmStages;
  const uint32_t bar = smem_u32(&bars[s]);
  mbar_expect_tx(bar, kMmATile);
  tma_load_2d(smem_u32(smem + s * kMmStage), map, kt * kMmK, m0, bar);
}

__global__ void __launch_bounds__(128)
    i8_matmul_kernel(const __grid_constant__ CUtensorMap a_map,
                     const int8_t* __restrict__ B, int32_t* __restrict__ D,
                     int M, int N, int K, int vec16) {
  extern __shared__ unsigned char mm_smem_raw[];
  unsigned char* smem =
      mm_smem_raw + ((1024 - (smem_u32(mm_smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kMmStages * kMmStage);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kMmM, n0 = blockIdx.y * kMmN;
  const int k_tiles = (K + kMmK - 1) / kMmK;
  if (tid == 0) {
    for (int s = 0; s < kMmStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // B's tile for the next K step waits in registers while this step's
  // wgmma group runs; the first two tiles' loads are issued together
  uint32_t w[8][4], w0[8][4];
  if (tid == 0) load_a_tile(&a_map, smem, bars, 0, m0);
  fetch_b_tile(B, w0, N, K, n0, 0, vec16);
  if (k_tiles > 1) fetch_b_tile(B, w, N, K, n0, 1, vec16);
  store_b_tile(smem + kMmATile, w0);
  int32_t d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kMmStages;
    // B's tile of this stage is stored and fenced in every thread, and
    // the last step's wait freed the other stage
    __syncthreads();
    if (tid == 0 && kt + 1 < k_tiles)
      load_a_tile(&a_map, smem, bars, kt + 1, m0);
    mbar_wait(smem_u32(&bars[s]), (kt / kMmStages) & 1);
    const uint32_t a_addr = smem_u32(smem + s * kMmStage);
    const uint64_t da = sw128_desc(a_addr);
    const uint64_t db = sw128_desc(a_addr + kMmATile);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kMmK / 32; ++ks)
      wgmma_s8_m64n128k32(d, da + 2 * ks, db + 2 * ks);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(d);
    if (kt + 1 < k_tiles) {
      store_b_tile(smem + (s ^ 1) * kMmStage + kMmATile, w);
      if (kt + 2 < k_tiles) fetch_b_tile(B, w, N, K, n0, kt + 2, vec16);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int row = m0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int c = 0; c < kMmN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * (lane & 3);
    if (col < N) {
      if (row < M)
        *reinterpret_cast<int2*>(D + (int64_t)row * N + col) =
            make_int2(d[4 * c], d[4 * c + 1]);
      if (row + 8 < M)
        *reinterpret_cast<int2*>(D + (int64_t)(row + 8) * N + col) =
            make_int2(d[4 * c + 2], d[4 * c + 3]);
    }
  }
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

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (the library links no libcuda); null where it is missing.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

constexpr int kMaxDevices = 64;

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// P2: D (M, N) s32 = A (M, K) s8 . B (K, N) s8, all row-major;
// M % 16 == N % 8 == K % 32 == 0, A 16-byte and B 8-byte aligned.
extern "C" int mhc_i8_matmul(const int8_t* A, const int8_t* B, int32_t* D,
                             int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 16 || N % 8 || K % 32 ||
      reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(B) % 8 ||
      (N + kMmN - 1) / kMmN > 65535)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // A as a (M rows, K bytes) tensor, boxes of 64 rows x 128 bytes, 128-byte
  // swizzled as wgmma reads them; out-of-bounds bytes read as zero
  CUtensorMap a_map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {kMmK, kMmM};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(A),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // the shared-memory limit is set once a device (a racing second set is
  // harmless)
  static bool smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    e = cudaFuncSetAttribute(i8_matmul_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMmSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = true;
  }
  const dim3 grid((M + kMmM - 1) / kMmM, (N + kMmN - 1) / kMmN);
  const int vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  i8_matmul_kernel<<<grid, 128, kMmSmem, stream>>>(a_map, B, D, M, N, K,
                                                   vec16);
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
