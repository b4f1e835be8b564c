// P1-P3: the calibration probes of bench/ as Hopper kernels. Each one
// times a building block of the reference's kernel designs on this card,
// and computes, bit for bit, the (8, 128) array its reference computes.
// The reference's probe fills the vector unit of a TPU chip's one
// TensorCore; its counterpart here is the whole card: the 1,024 carries
// are independent chains, spread over the SMs.
//
//   P1 loop_calib_kernel<variant, n_ops> replaces bench/loop_calib.py:74
//      (body `make`, :34-70): a loop of `iters` steps over a (8, 128) u32
//      carry, the loop inside the kernel. Bodies: `chain` (n dependent
//      (c + k+1) ^ (c >> 1) a step), `scratch` (n round trips through
//      shared memory, volatile so that none is elided), `store` (the chain
//      plus a predicated global store on odd steps), `wide` (n 64-deep
//      masked sums of x; the sum is x itself, as `big` is x broadcast,
//      :38), and `dep` (n dependent c += c >> 1, a one-op chain, one
//      LEA.HI an op: the calibration of an integer op's dependent
//      latency, which the reference does not have). Every body but
//      `scratch` runs one-warp blocks, a warp on an SM of its own, so
//      that each op waits on the one before it and on nothing else: one
//      thread a carry (32 blocks), `wide` eight lanes a carry (256
//      blocks), each lane 8 of the 64 terms, combined by a shuffle tree.
//      `scratch` keeps one block of 1,024 threads: what it times is one
//      SM's shared-memory round trip.
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
//      over a (8, 128) i32 carry in [0, 256). The null loop runs one
//      thread a carry in one-warp blocks. The seven other CUDA-core
//      bodies (three one-hot builds each with its 256-deep pick, four
//      256-deep picks from a (256, 8) table, the reference's (256, 8,
//      128) table being that one broadcast over lanes, :145-147) run one
//      warp a carry, 8 warps a block, 128 blocks: each lane computes 8 of
//      the 256 terms (compare, select or product, add) and a shuffle tree
//      combines the 32 partial sums, so that every lane holds the next
//      carry. The two fetch cores are a one-hot product on the tensor
//      cores, as the reference's is on the MXU, 8 carry columns a CTA,
//      128 CTAs: each holds the (316 x 256) plane P^T in shared memory,
//      builds its columns' one-hot each step and multiplies on wgmma
//      (m64n8k32 int8 into s32, or m64n8k16 bf16 into f32, 5 M-tiles),
//      output rows 0..15 summed per column.
//
// Bound. Each probe is a chain of dependent steps on 1,024 lanes, so what
// bounds it is latency or operations, not bytes (8 KB in and out):
// chip_smoke.py holds each body to the largest of its operations at the
// card's peak rate for their type, its dependent chain at an integer op's
// latency, and its bytes. The split bodies keep every term the bound
// counts (no pick by one load, no product of the summed rows alone), so
// no share can pass 1. Each carry passes an empty asm barrier once a
// step, so that the compiler can neither fold steps together nor hoist
// them out of the loop; each kernel writes its loop's clock64() cycles
// (thread 0 of block 0) when asked, so that a check can see the loop's
// time without the launch's.

#include "common.cuh"

#include <cuda.h>
#include <cuda_bf16.h>

#include <type_traits>

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
constexpr int kWarp = 32;
// `wide`'s lanes a carry: 8 terms of the 64 a lane, a 3-level shuffle
// tree. Finer, the tree's dependent shuffles (~25 cycles each) cost more
// than the terms they take off a lane; coarser, a lane's 3 ops a term
// go through its warp's scheduler one at a time.
constexpr int kWideSplit = 8;

// Whatever the kernel's block, thread g works on carry g / kSplit.
template <int V>
__host__ __device__ constexpr int loop_split() {
  return V == kWide ? kWideSplit : 1;
}

template <int V, int N>
__global__ void __launch_bounds__(kLanes)
    loop_calib_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out, int iters,
                      long long* __restrict__ cycles) {
  constexpr int kSplit = loop_split<V>();
  __shared__ uint32_t scratch[kLanes];
  volatile uint32_t* scr = scratch + threadIdx.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = g / kSplit, j = g % kSplit;
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
        // this lane's terms m = j + 8 q of the 64
        const uint32_t sel = c & 63u;
        uint32_t s = 0;
#pragma unroll
        for (int q = 0; q < 64 / kSplit; ++q)
          s += (uint32_t(j + kSplit * q) == sel) ? x0 : 0u;
#pragma unroll
        for (int o = 1; o < kSplit; o <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
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
  if (cycles != nullptr && g == 0) *cycles = clock64() - t0;
  if (j == 0) out[t] = c;
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
template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
// P3, the CUDA-core bodies. Every body but the null loop is a 256-deep
// masked sum whose one selected term is the next carry. Carry t (element
// (r, l) = (t / 128, t % 128)) belongs to warp t % 8 of block t / 8, and
// lane j of that warp computes the terms k = j + 32 q, q < 8, in the
// body's own type; a butterfly of __shfl_xor_sync (lane distance 1, 2,
// 4, 8, 16) adds the 32 partial sums in that type, so every lane holds
// the sum. The sums are exact in any order: one term alone is nonzero
// (the f32 and bf16-to-f32 sums), or they are modular (int32, int8 wrap,
// then & 255). A warp a carry: 1,024 warps, 8 to an SM, two to a
// scheduler, so that one warp's shuffle waits overlap another's terms
// (8 lanes a carry would leave one warp to an SM, its 96 ops a step and
// 3 shuffles dispatched back to back). The pick table lies in shared memory
// transposed, row r's 256 entries contiguous, so a warp's 32 reads of one
// q hit 32 banks; a lane's 8 entries do not change across steps.
// ---------------------------------------------------------------------------

enum VpuVariant : int {
  kNull = 0, kOnehotI32I8 = 1, kOnehotBf16 = 2, kOnehotFact = 3,
  kPickI32 = 4, kPickI8I32 = 5, kPickI8I8 = 6, kPickF32 = 7,
  kFetchI8 = 8, kFetchBf16 = 9,
};
constexpr int kDepth = 256;
constexpr int kRows = 8;
constexpr int kPickLanes = 32;                   // lanes a carry
constexpr int kPickTerms = kDepth / kPickLanes;  // terms a lane
constexpr int kPickWarps = 8;                    // carries a block

template <int V>
__host__ __device__ constexpr int vpu_split() {
  return V == kNull ? 1 : kPickLanes;
}

// The butterfly: every lane ends with the sum of the 32 lanes' v.
__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int o = 1; o < kPickLanes; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < kPickLanes; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int8_t warp_sum(int8_t v) {
#pragma unroll
  for (int o = 1; o < kPickLanes; o <<= 1)
    v = int8_t(v + int8_t(__shfl_xor_sync(0xffffffffu, int32_t(v), o)));
  return v;
}

template <int V>
__global__ void __launch_bounds__(kPickWarps * kPickLanes)
    vpu_probe_kernel(const int32_t* __restrict__ x,
                     const void* __restrict__ table,
                     int32_t* __restrict__ out, int iters,
                     long long* __restrict__ cycles) {
  constexpr int kSplit = vpu_split<V>();
  // the (256, 8) table transposed to (8, 256): int32, float or int8
  __shared__ int32_t tab[kRows * kDepth];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = g / kSplit, j = g % kSplit, r = t >> 7;
  if constexpr (V == kPickI32 || V == kPickF32) {
    for (int i = threadIdx.x; i < kDepth * kRows; i += blockDim.x)
      tab[(i % kRows) * kDepth + i / kRows] =
          static_cast<const int32_t*>(table)[i];
  } else if constexpr (V == kPickI8I32 || V == kPickI8I8) {
    for (int i = threadIdx.x; i < kDepth * kRows; i += blockDim.x)
      reinterpret_cast<int8_t*>(tab)[(i % kRows) * kDepth + i / kRows] =
          static_cast<const int8_t*>(table)[i];
  }
  __syncthreads();
  const int32_t* row = tab + r * kDepth;
  const int8_t* row8 = reinterpret_cast<const int8_t*>(tab) + r * kDepth;
  const float* rowf = reinterpret_cast<const float*>(row);
  int32_t c = x[t];
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if constexpr (V == kNull) {
      c = (c + 1) & 255;
    } else if constexpr (V == kOnehotI32I8) {
      int32_t s = 0;
#pragma unroll
      for (int q = 0; q < kPickTerms; ++q) {
        const int k = j + kPickLanes * q;
        s += int32_t(int8_t(c == k)) * k;
      }
      c = warp_sum(s) & 255;
    } else if constexpr (V == kOnehotBf16) {
      const __nv_bfloat16 cb = __int2bfloat16_rn(c);
      const __nv_bfloat16 one = __float2bfloat16(1.0f);
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kPickTerms; ++q) {
        const __nv_bfloat16 kb = __int2bfloat16_rn(j + kPickLanes * q);
        const __nv_bfloat16 oh = __heq(cb, kb) ? one : zero;
        s += __bfloat162float(__hmul(oh, kb));
      }
      c = int32_t(warp_sum(s)) & 255;
    } else if constexpr (V == kOnehotFact) {
      // the 16 x 16 outer product's terms p = 16 h + l: this lane's share
      // p = j + 32 q has l = j % 16 and h = 2 q + j / 16
      const int8_t lo = int8_t((c & 15) == (j & 15));
      int32_t s = 0;
#pragma unroll
      for (int q = 0; q < kPickTerms; ++q) {
        const int8_t hi = int8_t((c >> 4) == 2 * q + (j >> 4));
        s += int32_t(int8_t(hi * lo)) * (j + kPickLanes * q);
      }
      c = warp_sum(s) & 255;
    } else if constexpr (V == kPickI32) {
      int32_t s = 0;
#pragma unroll
      for (int q = 0; q < kPickTerms; ++q) {
        const int k = j + kPickLanes * q;
        s += (c == k) ? row[k] : 0;
      }
      c = warp_sum(s) & 255;
    } else if constexpr (V == kPickI8I32) {
      int32_t s = 0;
#pragma unroll
      for (int q = 0; q < kPickTerms; ++q) {
        const int k = j + kPickLanes * q;
        s += int32_t(int8_t(int8_t(c == k) * row8[k]));
      }
      c = warp_sum(s) & 255;
    } else if constexpr (V == kPickI8I8) {
      int8_t s8 = 0;
#pragma unroll
      for (int q = 0; q < kPickTerms; ++q) {
        const int k = j + kPickLanes * q;
        s8 = int8_t(s8 + int8_t(int8_t(c == k) * row8[k]));
      }
      c = int32_t(warp_sum(s8)) & 255;
    } else if constexpr (V == kPickF32) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kPickTerms; ++q) {
        const int k = j + kPickLanes * q;
        s += (c == k) ? rowf[k] : 0.0f;
      }
      c = int32_t(warp_sum(s)) & 255;
    }
    opaque(c);
  }
  if (cycles != nullptr && g == 0) *cycles = clock64() - t0;
  if (j == 0) out[t] = c;
}

// ---------------------------------------------------------------------------
// P3, the fetch cores: next carry of column n = sum_{j < 16} P[c_n, j]
// (+ 128 * 16 for int8), & 255, where P is the (256, 316) plane and the
// product P^T (316 x 256, padded to 320 rows) . onehot(c) (256 x 1,024)
// runs on the tensor cores. CTA b takes carry columns 8 b .. 8 b + 7, one
// warpgroup of 128 threads:
//   - once, P^T into shared memory: 5 M-tiles of 64 rows, each row's 256
//     K elements in 128-byte K atoms (2 for int8, 4 for bf16), every
//     (M-tile, atom) block 64 rows x 128 bytes, 128-byte swizzled as
//     P2's A tile (byte (r, kb) at r * 128 + ((kb / 16) ^ (r % 8)) * 16 +
//     kb % 16), rows 316..319 zero; read from global memory a word of 4
//     rows at a time, coalesced along P's rows, and transposed in
//     registers (byte_perm) so that it is stored 16 bytes at a time (a
//     byte at a time, a warp's 32 stores to rows 4 apart would fall in
//     one bank);
//   - each step, the one-hot of the CTA's 8 carries as B: 8 rows (the
//     columns) of 256 K elements, K-major in the same atoms and swizzle,
//     one 16-byte store a thread (two for bf16), the 1 (0x01 or bf16
//     0x3F80) at K element c_n; then every M-tile on wgmma, m64n8k32 s8
//     into s32 or m64n8k16 bf16 into f32, 8 or 16 k-steps of 32 bytes,
//     each through sw128_desc as in P2 (plus 2 a k-step inside an atom);
//   - warp 0 holds output rows 0..15 of M-tile 0 (the accumulator
//     fragment of P2's epilogue at n8: d[e] is row lane / 4 + 8 (e / 2),
//     column 2 (lane % 4) + e % 2): it adds its two rows, then over the 8
//     lanes of a column by shuffles, and lanes 0..3 store the next
//     carries in shared memory behind a barrier.
// What holds the design back: each step's (320 x 256 x 8) product reads
// the whole plane from shared memory (80 KB int8, 160 KB bf16); at 128
// bytes a cycle that is ~640 (1,280) cycles a step, some 4x the tensor
// cores' time for 8 columns. More columns a CTA would not shorten a step
// and would leave SMs idle: 8 columns a CTA spread the 1,024 over 128.
// ---------------------------------------------------------------------------

constexpr int kPlaneCols = 316;
constexpr int kPlaneRows = 320;                 // P^T's rows, 5 M-tiles
constexpr int kFetchMTiles = kPlaneRows / 64;
constexpr int kFetchN = 8;                      // carry columns a CTA
constexpr int kFetchThreads = 128;              // one warpgroup
constexpr int kSum = 16;                        // rows summed
constexpr int kAtom = 128;                      // K bytes of a swizzle atom

template <bool kBf16>
struct Fetch {
  static constexpr int kElem = kBf16 ? 2 : 1;
  static constexpr int kAtoms = kDepth * kElem / kAtom;     // 2 | 4
  static constexpr int kKSteps = kDepth * kElem / 32;       // 8 | 16
  static constexpr int kABlock = 64 * kAtom;                // 8 KB
  static constexpr int kAImage = kFetchMTiles * kAtoms * kABlock;
  static constexpr int kBImage = kAtoms * kFetchN * kAtom;  // 2 | 4 KB
  // the images, 1,024-byte aligned by hand, and the carries
  static constexpr int kSmem = kAImage + kBImage + 1024 + 4 * kFetchN;
};

// Byte offset of K byte kb (0..255 * elem) of row r (0..63) in a swizzled
// image of 64- or 8-row blocks of one K atom each, `block` bytes apart.
__device__ __forceinline__ int sw128_offset(int r, int kb, int block) {
  return (kb / kAtom) * block + r * kAtom +
         ((((kb % kAtom) >> 4) ^ (r & 7)) << 4) + (kb & 15);
}

__device__ __forceinline__ void wgmma_s8_m64n8k32(int32_t (&d)[4],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16_m64n8k16(float (&d)[4],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

template <bool kBf16>
__global__ void __launch_bounds__(kFetchThreads, 1)
    vpu_fetch_kernel(const int32_t* __restrict__ x,
                     const void* __restrict__ planes,
                     int32_t* __restrict__ out, int iters,
                     long long* __restrict__ cycles) {
  using F = Fetch<kBf16>;
  using Acc = std::conditional_t<kBf16, float, int32_t>;
  extern __shared__ unsigned char fetch_smem_raw[];
  unsigned char* a_img =
      fetch_smem_raw + ((1024 - (smem_u32(fetch_smem_raw) & 1023)) & 1023);
  unsigned char* b_img = a_img + F::kAImage;
  int32_t* carry = reinterpret_cast<int32_t*>(b_img + F::kBImage);
  const int tid = threadIdx.x, lane = tid & 31;
  const int col0 = blockIdx.x * kFetchN;

  // P^T, an item (w, kc) a thread: P^T rows 4 w .. 4 w + 3 (a word of
  // each of P's rows, consecutive threads on consecutive words) at K
  // chunk kc (16 bytes), transposed in registers into 4 rows of 16 bytes
  // and stored as 16-byte vectors; word 79 is the zero padding
  constexpr int kWords = kPlaneRows / 4;
  constexpr int kChunks = kDepth * F::kElem / 16;
  for (int i = tid; i < kWords * kChunks; i += kFetchThreads) {
    const int w = i % kWords, kc = i / kWords;
    uint32_t rows[4][4];
    if constexpr (kBf16) {
      // 8 K elements: word m of row r holds elements 2 m, 2 m + 1
      uint2 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = 4 * w < kPlaneCols
                   ? *reinterpret_cast<const uint2*>(
                         static_cast<const uint16_t*>(planes) +
                         (8 * kc + e) * kPlaneCols + 4 * w)
                   : make_uint2(0, 0);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        rows[0][m] = __byte_perm(v[2 * m].x, v[2 * m + 1].x, 0x5410);
        rows[1][m] = __byte_perm(v[2 * m].x, v[2 * m + 1].x, 0x7632);
        rows[2][m] = __byte_perm(v[2 * m].y, v[2 * m + 1].y, 0x5410);
        rows[3][m] = __byte_perm(v[2 * m].y, v[2 * m + 1].y, 0x7632);
      }
    } else {
      // 16 K bytes: word m of row r holds bytes 4 m .. 4 m + 3
      uint32_t u[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        u[e] = 4 * w < kPlaneCols
                   ? *reinterpret_cast<const uint32_t*>(
                         static_cast<const uint8_t*>(planes) +
                         (16 * kc + e) * kPlaneCols + 4 * w)
                   : 0u;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t c[4];
        transpose4x4(u[4 * m], u[4 * m + 1], u[4 * m + 2], u[4 * m + 3], c);
#pragma unroll
        for (int r = 0; r < 4; ++r) rows[r][m] = c[r];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * w + r;
      *reinterpret_cast<uint4*>(
          a_img + (row / 64) * F::kAtoms * F::kABlock +
          sw128_offset(row % 64, 16 * kc, F::kABlock)) =
          make_uint4(rows[r][0], rows[r][1], rows[r][2], rows[r][3]);
    }
  }
  if (tid < kFetchN) carry[tid] = x[col0 + tid];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  uint64_t da[kFetchMTiles], db;
  for (int m = 0; m < kFetchMTiles; ++m)
    da[m] = sw128_desc(smem_u32(a_img + m * F::kAtoms * F::kABlock));
  db = sw128_desc(smem_u32(b_img));
  Acc d[kFetchMTiles][4] = {};
  const int n = tid >> 4;          // the one-hot column this thread writes
  const long long t0 = clock64();
  for (int step = 0; step < iters; ++step) {
    // the one-hot: 16-byte vector v of column n holds K bytes 16 v ..
    const int cc = carry[n];
#pragma unroll
    for (int h = 0; h < F::kElem; ++h) {
      const int v = (tid & 15) + 16 * h;
      uint32_t w[4] = {0, 0, 0, 0};
      if constexpr (kBf16) {
        if ((cc >> 3) == v) w[(cc & 7) >> 1] = 0x3F80u << (16 * (cc & 1));
      } else {
        if ((cc >> 4) == v) w[(cc & 15) >> 2] = 1u << (8 * (cc & 3));
      }
      *reinterpret_cast<uint4*>(b_img + sw128_offset(n, 16 * v, kFetchN *
                                                     kAtom)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kFetchMTiles; ++m) fence_acc(d[m]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < kFetchMTiles; ++m) {
#pragma unroll
      for (int ks = 0; ks < F::kKSteps; ++ks) {
        // a 128-byte atom holds 4 k-steps; the atoms of an M-tile's rows
        // lie kABlock apart, those of the one-hot 1,024 bytes apart
        const uint64_t a = da[m] + ((ks / 4) * F::kABlock >> 4) + 2 * (ks % 4);
        const uint64_t b = db + ((ks / 4) * kFetchN * kAtom >> 4) +
                           2 * (ks % 4);
        if constexpr (kBf16)
          wgmma_bf16_m64n8k16(d[m], a, b, ks > 0);
        else
          wgmma_s8_m64n8k32(d[m], a, b, ks > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < kFetchMTiles; ++m) fence_acc(d[m]);
    if (tid < 32) {
      // column sums of rows 0..15: this lane's two rows, then over the 8
      // lanes (lane / 4) of each column
      Acc s0 = d[0][0] + d[0][2], s1 = d[0][1] + d[0][3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (lane < 4) {
        if constexpr (kBf16) {
          carry[2 * lane] = int32_t(s0) & 255;
          carry[2 * lane + 1] = int32_t(s1) & 255;
        } else {
          carry[2 * lane] = (s0 + 128 * kSum) & 255;
          carry[2 * lane + 1] = (s1 + 128 * kSum) & 255;
        }
      }
    }
    __syncthreads();
  }
  if (cycles != nullptr && blockIdx.x == 0 && tid == 0)
    *cycles = clock64() - t0;
  if (tid < kFetchN) out[col0 + tid] = carry[tid];
}

template <bool kBf16>
int launch_fetch(const int32_t* x, const void* planes, int32_t* out,
                 int iters, long long* cycles, cudaStream_t stream) {
  const int bytes = Fetch<kBf16>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      vpu_fetch_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  vpu_fetch_kernel<kBf16><<<kLanes / kFetchN, kFetchThreads, bytes,
                            stream>>>(x, planes, out, iters, cycles);
  return (int)cudaGetLastError();
}

}  // namespace

// P1: x, out (8, 128) u32; variant and n_ops one of the configurations
// below; cycles (one int64) or null.
extern "C" int mhc_loop_calib(const uint32_t* x, uint32_t* out, int variant,
                              int n_ops, int iters, long long* cycles,
                              cudaStream_t stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  // one-warp blocks but for `scratch`, one block of 1,024 threads
#define MHC_LOOP_CASE(V, N)                                              \
  if (variant == V && n_ops == N) {                                      \
    const int threads = V == kScratch ? kLanes : kWarp;                  \
    loop_calib_kernel<V, N>                                              \
        <<<kLanes * loop_split<V>() / threads, threads, 0, stream>>>(    \
            x, out, iters, cycles);                                      \
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
  // the null loop one-warp blocks, the split bodies 8 warps a block
#define MHC_VPU_CASE(V)                                                  \
  case V: {                                                              \
    const int threads = V == kNull ? kWarp : kPickWarps * kPickLanes;    \
    vpu_probe_kernel<V><<<kLanes * vpu_split<V>() / threads, threads, 0, \
                          stream>>>(x, table, out, iters, cycles);       \
    return (int)cudaGetLastError();                                      \
  }
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
