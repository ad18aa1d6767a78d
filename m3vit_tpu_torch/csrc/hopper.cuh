// Hopper (sm_90a) building blocks shared by the flash-attention kernels K1
// (flash_attention_fwd.cu) and K2 (flash_attention_bwd.cu) and the fused-FFN
// backwards K4 and K6 (ffn_bwd.cuh): TMA tile loads completing on
// mbarriers, wgmma with f32 accumulators in registers, the shared-memory
// descriptors that match TMA's swizzle, and the host-side tensor maps over
// [batches, rows, cols] arrays.
//
// Tiles.  Every operand is a 64-row tile of a [rows, D] bf16 slice, loaded
// by TMA as NCH column chunks of CW columns each ([64, CW], one swizzle span
// per row: 128 B for D >= 64, 64 B for D = 32), each chunk swizzled by TMA
// and read back by wgmma under the same swizzle.  A tile whose rows are the
// M (or N) index and D the reduction index is "K-major"; a tile whose rows
// are the reduction index (V in P.V, dO/Q in the dk/dv products, K in dq)
// is "MN-major" and is read with wgmma's transpose bit.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;   // rows of every tile (one warpgroup's wgmma M)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  static constexpr int SWB = D >= 64 ? 128 : 64;     // swizzle span, bytes
  static constexpr int CW = SWB / 2;                 // columns per chunk
  static constexpr int NCH = D / CW;                 // chunks per tile
  static constexpr int CHUNK = ROWS * SWB;           // bytes of a chunk
  static constexpr int BYTES = ROWS * D * 2;         // bytes of a tile
  static constexpr int LAYOUT = SWB == 128 ? 1 : 2;  // descriptor: B128 / B64
  static constexpr int KSTEPS = D / 16;              // k16 steps over D
};

// ---------------------------------------------------------------- device --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 B, the period of the 128 B
// swizzle, so that TMA and wgmma see the same pattern (the launch adds 1 KB).
__device__ __forceinline__ uint8_t* align_1k(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
// Each barrier, tile and descriptor helper also takes the 32-bit shared
// address, which holds one register where a generic pointer holds two.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  mbar_expect_tx(smem_u32(bar), bytes);
}

// One plain arrival (a consumer releasing a stage of a ring).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive(smem_u32(bar));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed.  A load that never
// lands (a bad tensor map) traps after ~2^32 cycles instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// TMA: box {CW, 64, 1} of `map` at (col, row, batch) into `dst`; rows past
// the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row,
                                            int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(batch)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row,
                                            int batch) {
  tma_load_3d(smem_u32(dst), map, smem_u32(bar), col, row, batch);
}

// TMA prefetch of the box {CW, 64, 1} of `map` at (col, row, batch) into L2
// (no shared memory, no barrier).
__device__ __forceinline__ void tma_prefetch_3d(const CUtensorMap* map, int col,
                                                int row, int batch) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// The NCH chunks of the 64-row tile at (col, row, batch) into `dst`.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int col, int row,
                                              int batch) {
#pragma unroll
  for (int c = 0; c < Tile<D>::NCH; ++c)
    tma_load_3d(dst + c * Tile<D>::CHUNK, map, bar, col + c * Tile<D>::CW,
                row, batch);
}

// TMA store: the box {CW, 64, 1} of `map` at (col, row, batch) from `src`
// in shared memory (rows and columns past the tensor's end are not
// written), tracked as a bulk group of the issuing thread.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int col, int row,
                                             int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int col, int row,
                                             int batch) {
  tma_store_3d(map, smem_u32(src), col, row, batch);
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until the issuing thread's bulk groups but N have read their
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until the issuing thread's bulk groups but N have completed.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16, 16-byte aligned) into `dst`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  bulk_load(smem_u32(dst), src, bytes, smem_u32(bar));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in program order around asynchronous wgmma: reads of an
// accumulator cannot move above the wait that completes it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// One consumer warpgroup's own barrier (ids 2, 3, ...; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// A ring of `stages` shared-memory stages: full[s] takes one producer
// arrival plus the stage's TMA bytes, empty[s] one arrival per consumer
// warp.  Ends with a CTA barrier.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int stages, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Producer side of ring step `it`: waits until the stage's previous
// contents were released, then announces `bytes` of TMA traffic on its full
// barrier.  `full` and `empty` are the barrier arrays (8 bytes apart).
template <int STAGES>
__device__ __forceinline__ int produce_begin(uint32_t full, uint32_t empty,
                                             int it, uint32_t bytes) {
  const int st = it % STAGES;
  if (it >= STAGES) mbar_wait(empty + 8 * st, ((it / STAGES) - 1) & 1);
  mbar_expect_tx(full + 8 * st, bytes);
  return st;
}
// (The pointer form keeps its own body: delegating to the 32-bit form
// changed the SASS of K4 and K6.)
template <int STAGES>
__device__ __forceinline__ int produce_begin(uint64_t* full, uint64_t* empty,
                                             int it, uint32_t bytes) {
  const int st = it % STAGES;
  if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
  mbar_expect_tx(&full[st], bytes);
  return st;
}

// Moves this warpgroup's register budget to N a thread (setmaxnreg): the
// producer of a warp-specialised kernel gives registers up, its consumers
// take them.  Every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t a, int layout,
                                              uint32_t lbo, uint32_t sbo) {
  return uint64_t((a & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(layout) << 62);
}
__device__ __forceinline__ uint64_t make_desc(const void* p, int layout,
                                              uint32_t lbo, uint32_t sbo) {
  return make_desc(smem_u32(p), layout, lbo, sbo);
}

// K-major tile (rows = M or N, columns = the reduction): the k16 step `kk`
// lies in chunk kk / (CW / 16), 32 bytes further per step inside the
// swizzle span; 8-row groups are 8 swizzle spans apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  using T = Tile<D>;
  constexpr int SPC = T::CW / 16;   // k16 steps per chunk
  return make_desc(tile + (kk / SPC) * T::CHUNK + (kk % SPC) * 32, T::LAYOUT,
                   16, 8 * T::SWB);
}

// MN-major tile (rows = the reduction, the CW columns of chunk `c` = N):
// the k16 step `kk` starts 16 rows down; 8-row groups are 8 spans apart.
// N = CW is one swizzle atom wide, so the stride between atoms along N is
// never used; both offsets carry the 8-row group stride.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int c,
                                            int kk) {
  using T = Tile<D>;
  return make_desc(tile + c * T::CHUNK + kk * 16 * T::SWB, T::LAYOUT,
                   8 * T::SWB, 8 * T::SWB);
}

// MN-major operand of N = 64 * boxes columns held as consecutive [64, 64]
// boxes (rows = the reduction, 128 B swizzle), box c holding columns
// 64c .. 64c + 63: the k16 step `kk` starts 16 rows down, 8-row groups are
// 1024 B apart (SBO) and the 64-column swizzle atoms one box, 8 KB, apart
// (LBO).  With one box it is desc_mn<64>.
__device__ __forceinline__ uint64_t desc_mn_boxes(const uint8_t* box0,
                                                  int kk) {
  return make_desc(box0 + kk * 16 * 128, 1, 64 * 128, 8 * 128);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulator of a 64 x 64 product (wgmma's layout: register
// j = 4n + 2i + e holds row 16*warp + lane/4 + 8i, column 8n + 2*(lane%4)
// + e) as the A operand of the next product over those 64 columns: for the
// k16 step kk, registers 8kk .. 8kk+7 in pairs.  For bf16 this is the
// register layout wgmma takes for A.
__device__ __forceinline__ void to_a_frags(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A in registers (bf16 pairs in the
// accumulator layout), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs in the
// accumulator layout), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x CW] += A B over chunk width CW: n32 for D = 32, n64 otherwise.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n32(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory; TA / TB
// set wgmma's transpose bit of A / B (1: the operand is MN-major);
// `accumulate` 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64t(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 192] (+)= A[64 x 16] B[16 x 192], as wgmma_ss_n64t.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n192t(float (&d)[96], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers (bf16 pairs in the
// accumulator layout), B K-major in shared memory (128 rows of 128 B
// swizzle spans, 8-row groups 1024 B apart: 2 consecutive [64, 64] boxes);
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_kb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 192] (+)= A[64 x 16] B[16 x 192], A in registers (bf16 pairs in the
// accumulator layout), B K-major in shared memory (192 rows of 128 B
// swizzle spans, 8-row groups 1024 B apart: 3 consecutive [64, 64] boxes);
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_kb(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Stores rows (r, r + 8) of a [64, D] f32 accumulator, split in NCH chunks
// of CW columns, as bf16 at dst + row * stride (rows >= n skipped).
template <int D>
__device__ __forceinline__ void store_acc(
    const float (&acc)[Tile<D>::NCH][Tile<D>::CW / 2], bf16* dst,
    int64_t stride, int row0, int n, float mul0, float mul1) {
  using T = Tile<D>;
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= n) continue;
    const float mul = i ? mul1 : mul0;
    bf16* p = dst + int64_t(row) * stride + cq;
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
#pragma unroll
      for (int nb = 0; nb < T::CW / 8; ++nb)
        *reinterpret_cast<uint32_t*>(p + c * T::CW + 8 * nb) =
            pack_bf16(acc[c][4 * nb + 2 * i] * mul,
                      acc[c][4 * nb + 2 * i + 1] * mul);
  }
}

// ------------------------------------------------------------------ host --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, fetched once through the
// runtime (no link against libcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a [batches, rows, cols] bf16 array (row-major, rows of
// `cols` elements) whose box is [box_rows, box_cols], box_cols * 2 bytes
// being the swizzle span (128 B or 64 B).
inline bool make_box_map(CUtensorMap* map, const void* base, int cols,
                         int rows, int batches, int box_cols, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc || (box_cols != 64 && box_cols != 32)) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(batches)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2,
                                 cuuint64_t(cols) * 2 * cuuint64_t(rows)};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map over a [batches, rows, cols] bf16 array whose box is one
// chunk [64, CW] of a tile of head_dim D.
template <int D>
inline bool make_tile_map(CUtensorMap* map, const void* base, int cols,
                          int rows, int batches) {
  return make_box_map(map, base, cols, rows, batches, Tile<D>::CW, ROWS);
}

}  // namespace hopper
