// The fused FFN forward of K3 (expert_ffn_fwd.cu: the expert banks, and the
// dense MLP at E=1; expert_ffn_q_fwd.cu runs it on K7's dequantized banks)
// and K5 (ln_mlp_fwd.cu: the same MLP behind a LayerNorm prologue, with a
// residual epilogue), for Hopper:
//   out[e] = bf16(gelu(h[e] w1[e]^T + b1[e])) w2[e]^T + b2[e]
// with both products accumulating in f32, bias and GELU in f32 (the TPU
// kernel's erf) and the hidden activation rounded to bf16 before the second
// product.
//
// Design.  A persistent, warp-specialised kernel: one CTA an SM walks a
// strided list of (128-token tile, expert) tiles, expert-major, so that the
// ~132 tiles in flight share a few experts' weights in L2, and each CTA
// reads its expert's weights once per 128 tokens (128 FLOP a weight byte).
// - A producer warpgroup (setmaxnreg gives its registers to the consumers;
//   one thread issues) loads the tile's tokens by TMA into shared memory,
//   where they stay for the whole hidden walk, prefetches the CTA's next
//   tile into L2, and keeps a ring of weight stages filled: per 32-unit
//   hidden chunk one stage of w1 rows ([32, 64] boxes across D, 128 B
//   swizzle) with the chunk's b1, and one of w2 columns ([64, 32] boxes
//   down D, 64 B swizzle), from 3-D tensor maps (cols, rows, E), so rows
//   past Ct arrive as zeros and never as the next expert's.
// - Two consumer warpgroups, 64 token rows each, hold the [64, D] f32
//   output accumulator in registers (192 a thread at D = 384, hence
//   setmaxnreg: 240 registers each) and walk the hidden axis: S = b1 +
//   h w1_c^T with wgmma from shared memory (N = 32), GELU on S in
//   registers, rounded to bf16 and packed as wgmma's A fragments, then
//   O += a w2_c^T with A from registers.  The pre-activation and the
//   activation never touch shared memory.  Each warpgroup waits for its
//   last O before its next S (the three would not fit the register budget
//   together); the other warpgroup's products fill that gap.
// - Epilogue: + b2 in f32, rounded to bf16, one [64, 64] box of columns at
//   a time through two staging boxes a warpgroup under the 128 B swizzle,
//   each written back by a TMA store (rows past Ct are not written) while
//   the producer already loads the next tile's tokens.  K5 brings x in by
//   TMA, two boxes ahead, adds the bf16-rounded MLP output to it in f32
//   and rounds again.
// - K5's prologue: the TMA-loaded x tile is normalised in place (f32
//   statistics, two-pass variance, eps inside the rsqrt) into bf16 h under
//   the same swizzle before the first product.
// No atomics and no cross-CTA sums: two runs give the same bits.
// Widths: D in {128, 192, 384}; at 768 and 1024 the accumulator alone
// would need 384 and 512 registers a thread, and those widths take the
// two-pass route (ffn_fwd_gemm.cuh).
//
// The register budget is the hard part, and ptxas's handling of it brittle:
// code after the consumers' tile loop, descriptors or addresses hoisted out
// of the hidden loop, or a LayerNorm loop unrolled in full each pushed it
// into spills that serialised the wgmmas (PERF.md, section 6).

#pragma once

#include "ffn_common.cuh"
#include "hopper.cuh"

namespace ffnfwd {

using hopper::bf16;

constexpr int BOX = 64 * 128;              // bytes of a [64, 64] token box
constexpr int WGS = 2;                     // consumer warpgroups
constexpr int BM = 64 * WGS;               // token rows of a tile
constexpr int HC = 32;                     // hidden units of a chunk
constexpr int WBOX = 64 * HC * 2;          // bytes of a weight box
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup
// 168 registers a thread at launch (64 K over 384 threads); the producer
// gives 144 of its own back and the consumers take them:
// 2 x 128 x 240 + 128 x 24 = 64 K.
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr int SMEM_MAX = 232448;           // a block's shared memory on sm_90

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int D>
struct Cfg {
  static constexpr int NB = D / 64;         // 64-wide boxes across D
  static constexpr int OPS = D % 192 == 0 ? D / 192 : 1;   // output parts
  static constexpr int ON = D / OPS;        // a part's columns (wgmma N)
  static constexpr int STAGE = NB * WBOX;   // w1 or w2 of one chunk
  static constexpr int RING = WGS * NB * BOX;   // the token tile comes first
  static constexpr int OUT_BYTES = WGS * 2 * BOX;   // two staging boxes a WG
  static constexpr int FIT =
      (SMEM_MAX - 1024 - RING - 1024 - OUT_BYTES - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int B1 = RING + STAGES * STAGE;   // b1 of each w1 stage
  static constexpr int OUT = B1 + 1024;
  static constexpr int BAR = OUT + OUT_BYTES;
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 2 + 2 * WGS) + 1024;
  static_assert(D % 64 == 0 && ON % 64 == 0 && ON <= 256, "model width");
  static_assert(STAGES >= 3, "the ring holds one chunk and looks ahead");
  static_assert(STAGES * HC * 4 <= 1024, "b1 slots");
};

struct Args {
  const float* b1;      // [E, Hd]
  const float* b2;      // [E, D]
  bf16* out;            // [E, Ct, D]
  const float* gamma;   // K5: LayerNorm scale and shift [D]
  const float* beta;
  int E, Ct, Hd;
  float eps;
};

using ffn::gelu;

// `d` through a register the compiler cannot see into: descriptors derived
// from it by constant offsets are formed where they are used, not hoisted
// out of the hidden loop, where they would hold dozens of registers.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// Descriptor offsets (16-byte units) of the k16 step `kk` over D: in the
// token tile ([64, 64] boxes) and in w1's stage ([HC, 64] boxes).
__host__ __device__ constexpr uint64_t h_off(int kk) {
  return uint64_t((kk / 4) * BOX + (kk % 4) * 32) >> 4;
}
__host__ __device__ constexpr uint64_t w1_off(int kk) {
  return uint64_t((kk / 4) * WBOX + (kk % 4) * 32) >> 4;
}

// The 16-byte chunk c (columns 8c .. 8c + 7) of row r of a [64, 64] box
// under the 128 B swizzle.
__device__ __forceinline__ uint8_t* swz(uint8_t* box, int r, int c) {
  return box + r * 128 + ((c ^ (r % 8)) * 16);
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 ld_shared_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v));
}

// K5's prologue on this warpgroup's 64 rows of the token tile (NB boxes of
// x as TMA left them): h = bf16((x - mean) rstd gamma + beta) in place, the
// statistics in f32 as the TPU kernel's _ln_rows (two-pass variance, eps
// inside the rsqrt).  Two threads a row: with an even box count each takes
// every other box; with an odd one (D = 192) each takes one 32-column half
// of every box (16-byte chunks 4q .. 4q + 3).  (The halves for every count
// made ptxas spill at D = 384.)  Rows past the end are zeros and give h =
// beta (never stored).  The loops stay rolled: unrolled, the compiler loads
// every chunk (and every gamma and beta) ahead, into registers it does not
// have.
template <int D>
__device__ __forceinline__ void ln_in_place(uint8_t* hs, const Args& args,
                                            int wtid) {
  constexpr int NB = D / 64;
  constexpr bool HALVES = NB % 2 != 0;
  const int r = wtid / 2, q = wtid % 2;
  // boxes i0, i0 + di, ... and chunks c0 .. c1 - 1 of each
  const int i0 = HALVES ? 0 : q, di = HALVES ? 1 : 2;
  const int c0 = HALVES ? 4 * q : 0, c1 = HALVES ? 4 * q + 4 : 8;
  float sum = 0.f;
#pragma unroll 1
  for (int i = i0; i < NB; i += di)
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(swz(hs + i * BOX, r, c));
      const uint32_t* p = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) sum += bf2(p[k]).x + bf2(p[k]).y;
    }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float mu = sum / D;
  float sq = 0.f;
#pragma unroll 1
  for (int i = i0; i < NB; i += di)
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(swz(hs + i * BOX, r, c));
      const uint32_t* p = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = bf2(p[k]);
        sq += (f.x - mu) * (f.x - mu) + (f.y - mu) * (f.y - mu);
      }
    }
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  const float rs = rsqrtf(sq / D + args.eps);
#pragma unroll 1
  for (int i = i0; i < NB; i += di)
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      uint4* at = reinterpret_cast<uint4*>(swz(hs + i * BOX, r, c));
      uint4 v = *at;
      uint32_t* p = reinterpret_cast<uint32_t*>(&v);
      const int col = i * 64 + 8 * c;
      float g[8], b[8];
      *reinterpret_cast<float4*>(g) =
          *reinterpret_cast<const float4*>(args.gamma + col);
      *reinterpret_cast<float4*>(g + 4) =
          *reinterpret_cast<const float4*>(args.gamma + col + 4);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(args.beta + col);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(args.beta + col + 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = bf2(p[k]);
        p[k] = hopper::pack_bf16((f.x - mu) * rs * g[2 * k] + b[2 * k],
                                 (f.y - mu) * rs * g[2 * k + 1] + b[2 * k + 1]);
      }
      *at = v;
    }
}

template <int D, bool LN>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fwd_kernel(const __grid_constant__ CUtensorMap h_map,
               const __grid_constant__ CUtensorMap w1_map,
               const __grid_constant__ CUtensorMap w2_map,
               const __grid_constant__ CUtensorMap out_map, const Args args) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES, OPS = C::OPS, NB = C::NB, ON = C::ON;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1k(smem_raw);
  // shared addresses (32-bit: one register each) of the token tile, the
  // ring, the staging and the barriers: full[s], empty[s], then h_full (the
  // token tile has landed), h_empty (its last first product is done) and,
  // for K5, one x barrier per staging box
  const uint32_t sm = hopper::smem_u32(smem);
  const uint32_t bars = sm + C::BAR;
  const uint32_t h_full = bars + 16 * STAGES, h_empty = h_full + 8;
  const int n_tok = cdiv(args.Ct, BM), total = args.E * n_tok;
  const int n_chunks = args.Hd / HC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    uint64_t* b = reinterpret_cast<uint64_t*>(smem + C::BAR) + 2 * STAGES;
    for (int i = 0; i < 2 + 2 * WGS; ++i)
      hopper::mbar_init(&b[i], i == 1 ? CONSUMERS / 32 : 1);
  }
  hopper::ring_init(reinterpret_cast<uint64_t*>(smem + C::BAR),
                    reinterpret_cast<uint64_t*>(smem + C::BAR) + STAGES,
                    STAGES, CONSUMERS / 32);

  if (warp >= CONSUMERS / 32) {   // producer
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      int it = 0, tl = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x, ++tl) {
        const int e = t / n_tok, m0 = (t % n_tok) * BM;
        if (tl > 0) hopper::mbar_wait(h_empty, (tl - 1) & 1);
        hopper::mbar_expect_tx(h_full, WGS * NB * BOX);
        for (int b = 0; b < WGS * NB; ++b)
          hopper::tma_load_3d(sm + b * BOX, &h_map, h_full, 64 * (b % NB),
                              m0 + 64 * (b / NB), e);
        const int tn = t + gridDim.x;   // this CTA's next tile, into L2
        if (tn < total)
          for (int b = 0; b < WGS * NB; ++b)
            hopper::tma_prefetch_3d(&h_map, 64 * (b % NB),
                                    (tn % n_tok) * BM + 64 * (b / NB),
                                    tn / n_tok);
        for (int j = 0; j < n_chunks; ++j)
          for (int op = 0; op < 2; ++op, ++it) {   // w1's stage, then w2's
            const int st = hopper::produce_begin<STAGES>(
                bars, bars + 8 * STAGES, it,
                C::STAGE + (op == 0 ? HC * 4 : 0));
            const uint32_t dst = sm + C::RING + st * C::STAGE;
            if (op == 0)   // the chunk's b1, beside its w1 rows
              hopper::bulk_load(sm + C::B1 + st * HC * 4,
                                args.b1 + int64_t(e) * args.Hd + j * HC,
                                HC * 4, bars + 8 * st);
            for (int b = 0; b < NB; ++b) {
              if (op == 0)   // rows j HC .. +HC of w1, columns 64b .. +64
                hopper::tma_load_3d(dst + b * WBOX, &w1_map, bars + 8 * st,
                                    64 * b, j * HC, e);
              else           // rows 64b .. +64 of w2, columns j HC .. +HC
                hopper::tma_load_3d(dst + b * WBOX, &w2_map, bars + 8 * st,
                                    j * HC, 64 * b, e);
            }
          }
      }
    }
  } else {   // consumers
    hopper::regs_inc<CONSUMER_REGS>();
    const int wg = warp / 4, wtid = threadIdx.x % 128;
    const int r0 = 16 * (warp % 4) + lane / 4, cq = 2 * (lane % 4);
    int it = 0, tl = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x, ++tl) {
      const int e = t / n_tok, m0 = (t % n_tok) * BM;
      hopper::mbar_wait(h_full, tl & 1);
      if (LN) {
        ln_in_place<D>(smem + wg * NB * BOX, args, wtid);
        hopper::fence_proxy_async();   // wgmma reads h next
        hopper::warpgroup_sync(wg);
      }
      float o[OPS][ON / 2];   // set by the tile's first second product
      uint32_t a[HC / 16][4];
      for (int j = 0; j < n_chunks; ++j, it += 2) {
        const int s1 = it % STAGES, s2 = (it + 1) % STAGES;
        // the last O has read its w2 stage and A fragments: release them
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < OPS; ++p) hopper::fence_regs(o[p]);
#pragma unroll
        for (int k = 0; k < HC / 16; ++k) hopper::fence_regs(a[k]);
        if (lane == 0 && j > 0)
          hopper::mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));

        // S = b1 + h w1[j HC, +HC)^T over D; register 4n + 2i + c holds row
        // r0 + 8i, hidden unit j HC + 8n + cq + c, and starts as its bias
        float s[HC / 2];
        hopper::mbar_wait(bars + 8 * s1, (it / STAGES) & 1);
#pragma unroll
        for (int n = 0; n < HC / 8; ++n) {
          const float2 bb =
              ld_shared_f2(sm + C::B1 + s1 * HC * 4 + (8 * n + cq) * 4);
          s[4 * n] = s[4 * n + 2] = bb.x;
          s[4 * n + 1] = s[4 * n + 3] = bb.y;
        }
        const uint64_t dh =
            opaque(hopper::make_desc(sm + wg * NB * BOX, 1, 16, 1024));
        const uint64_t dw = opaque(
            hopper::make_desc(sm + C::RING + s1 * C::STAGE, 1, 16, 1024));
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NB; ++kk)
          hopper::wgmma_ss_n32(s, dh + h_off(kk), dw + w1_off(kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if (lane == 0) {
          hopper::mbar_arrive(bars + 8 * (STAGES + s1));
          if (j == n_chunks - 1) hopper::mbar_arrive(h_empty);
        }

        // a = bf16(gelu(S)) as A fragments
#pragma unroll
        for (int k = 0; k < HC / 2; ++k) s[k] = gelu(s[k]);
#pragma unroll
        for (int k = 0; k < HC / 16; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[k][q] = hopper::pack_bf16(s[8 * k + 2 * q], s[8 * k + 2 * q + 1]);

        // O += a w2[:, j HC, +HC)^T, part p over output columns p ON .. +ON
        hopper::mbar_wait(bars + 8 * s2, ((it + 1) / STAGES) & 1);
        uint64_t dw2[OPS];
#pragma unroll
        for (int p = 0; p < OPS; ++p)
          dw2[p] = opaque(hopper::make_desc(
              sm + C::RING + s2 * C::STAGE + p * (ON / 64) * WBOX, 2, 16,
              512));
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < HC / 16; ++k)
#pragma unroll
          for (int p = 0; p < OPS; ++p)
            hopper::wgmma_rs_kb(o[p], a[k], dw2[p] + 2 * k, j > 0 || k > 0);
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < OPS; ++p) hopper::fence_regs(o[p]);
#pragma unroll
      for (int k = 0; k < HC / 16; ++k) hopper::fence_regs(a[k]);
      if (lane == 0)
        hopper::mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));

      // epilogue, one [64, 64] box of this warpgroup's rows at a time
      // through its two staging boxes under the 128 B swizzle, each written
      // back by a TMA store (rows past Ct are not written); K5 first brings
      // the box's x in by TMA, two boxes ahead.  Register 4n + 2i + c of
      // part p holds row r0 + 8i, column p ON + 8n + cq + c.  The pointers
      // and offsets are formed here, not hoisted into registers held across
      // the hidden loop.
      const int row0 = m0 + 64 * wg;
      const float* b2e = args.b2 + int64_t(e) * D + cq;
      uint32_t stg = sm + C::OUT + wg * 2 * BOX;
      uint32_t xb = h_empty + 8 + 16 * wg;   // this WG's two x barriers
      int rq = r0 * 128 + cq * 2, rs = r0 % 8;
      const CUtensorMap* om = &out_map;
      const CUtensorMap* xm = &h_map;
      asm volatile("" : "+l"(b2e), "+r"(stg), "+r"(xb), "+r"(rq), "+r"(rs),
                   "+l"(om), "+l"(xm));
      const int ob = tl * NB;   // staging boxes this WG used before
      if (LN && wtid == 0) {
        for (int q = 0; q < 2 && q < NB; ++q) {
          const int buf = (ob + q) % 2;
          hopper::mbar_expect_tx(xb + 8 * buf, BOX);
          hopper::tma_load_3d(stg + buf * BOX, xm, xb + 8 * buf, 64 * q,
                              row0, e);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int buf = (ob + b) % 2;
        const uint32_t sb = stg + buf * BOX;
        if (LN) {
          hopper::mbar_wait(xb + 8 * buf, ((ob + b) / 2) & 1);
        } else {   // the store that last read this box is done
          if (wtid == 0) hopper::bulk_wait_read<1>();
          hopper::warpgroup_sync(wg);
        }
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const int p = 64 * b / ON, n = (64 * b % ON) / 8 + nn;
          const float2 bb =
              *reinterpret_cast<const float2*>(b2e + 64 * b + 8 * nn);
#pragma unroll
          for (int i = 0; i < 2; ++i) {   // rows r0 + 8i share r0's swizzle
            const uint32_t at = sb + rq + i * 1024 + ((nn ^ rs) * 16);
            float y0 = o[p][4 * n + 2 * i] + bb.x;
            float y1 = o[p][4 * n + 2 * i + 1] + bb.y;
            if (LN) {   // x + bf16(MLP), in f32, rounded again
              const float2 xr = bf2(ld_shared(at));
              y0 = xr.x + __bfloat162float(__float2bfloat16(y0));
              y1 = xr.y + __bfloat162float(__float2bfloat16(y1));
            }
            st_shared(at, hopper::pack_bf16(y0, y1));
          }
        }
        hopper::fence_proxy_async();   // TMA reads the box next
        hopper::warpgroup_sync(wg);
        if (wtid == 0) {
          hopper::tma_store_3d(om, sb, 64 * b, row0, e);
          hopper::bulk_commit();
          if (LN && b + 2 < NB) {   // x of the box after next
            hopper::bulk_wait_read<0>();
            hopper::mbar_expect_tx(xb + 8 * buf, BOX);
            hopper::tma_load_3d(sb, xm, xb + 8 * buf, 64 * (b + 2), row0,
                                e);
          }
        }
      }
      // the staging is read before the next tile writes it, or the CTA
      // exits (waiting after the tile loop instead made ptxas spill the
      // accumulator)
      if (wtid == 0) hopper::bulk_wait_read<0>();
    }
  }
}

using ffn::sm_count;

// h [E, Ct, D] (K5: x [Ct, D], E = 1), w1 [E, Hd, D], w2 [E, D, Hd] bf16,
// contiguous and 16-byte aligned; Hd % 32 == 0.  One CTA an SM, at most
// one a tile.
template <int D, bool LN>
cudaError_t launch(const void* h, const void* w1, const void* w2,
                   const Args& args, cudaStream_t stream) {
  using C = Cfg<D>;
  if (args.Hd % HC != 0 || args.E < 1 || args.Ct < 1)
    return cudaErrorInvalidValue;
  CUtensorMap h_map, w1_map, w2_map, out_map;
  if (!hopper::make_box_map(&h_map, h, D, args.Ct, args.E, 64, 64) ||
      !hopper::make_box_map(&w1_map, w1, D, args.Hd, args.E, 64, HC) ||
      !hopper::make_box_map(&w2_map, w2, args.Hd, D, args.E, HC, 64) ||
      !hopper::make_box_map(&out_map, args.out, D, args.Ct, args.E, 64, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = ffn::allow_smem(ffn_fwd_kernel<D, LN>, C::BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = args.E * cdiv(args.Ct, BM), sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  ffn_fwd_kernel<D, LN><<<tiles < sms ? tiles : sms, THREADS, C::BYTES,
                          stream>>>(h_map, w1_map, w2_map, out_map, args);
  return cudaGetLastError();
}

}  // namespace ffnfwd
