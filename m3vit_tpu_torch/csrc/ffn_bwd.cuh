// The fused FFN backward shared by K4 (expert_ffn_bwd.cu) and K6
// (ln_mlp_bwd.cu), for Hopper: the VJP of out = gelu(h w1^T + b1) w2^T + b2
// per expert, as five products on wgmma with the hidden activations
// crossing device memory once, in bf16:
//   1. hidden pass: S1 = h w1^T and S2 = g w2 over D, then in registers
//      a = bf16(gelu(S1 + b1)) and da = bf16(S2 gelu'(S1 + b1)) into
//      [E, Ct, Hd] scratch, with per-token-tile column sums of the
//      unrounded da (db1 partials) and of g (db2 partials);
//   2. dh = da w1 (one GEMM instance: M = tokens, N = D, K = Hd);
//   3. dw1 = da^T h and dw2 = g^T a (one launch of the other instance,
//      both A^T B products over the tokens, split over token ranges when
//      E x output tiles would leave SMs idle);
//   4. fixed-order sums of the split and per-tile partials (sum_parts).
// No atomics: every sum runs in an order fixed by the shapes, so two runs
// give the same bits.
//
// Every kernel is persistent (one CTA per SM walks a strided list of output
// tiles) and warp specialised: one producer warp keeps a ring of STAGES
// shared-memory stages filled by TMA, running on into the next tile while
// the consumers finish the last one's epilogue (each operand a set of
// [64 rows, 64 cols] bf16 boxes under the 128 B swizzle, loaded from 3-D
// tensor maps (cols, rows, E) so that rows past Ct arrive as zeros and
// never as the next expert's), and two consumer warpgroups, 64 output rows
// each, run wgmma on the stages that have landed, releasing each stage on
// its `empty` mbarrier once the products that read it have completed.  The
// f32 accumulators stay in registers.  The hidden pass stages a and da in
// shared memory under the same swizzle and writes them by TMA stores; the
// GEMMs store from registers.  Operands: h, g, da as A are K-major (the
// reduction is their row); w1 as the hidden pass's B is K-major; w2, w1 as
// dh's B and every operand of the A^T B products are MN-major, read with
// wgmma's transpose bit.
//
// What holds it back (measured on an H100, PERF.md): the hidden pass takes
// half of each call, its wgmma at about a third of the card's bf16 rate;
// without the a / da stores it took ~25% less time, and neither 128-wide
// hidden tiles (a third less L2 traffic), two CTAs an SM, nor 2-CTA
// clusters multicasting h and g made it faster.
//
// Rows of h and g past Ct are zeros, so they add nothing to S2, da, the
// column sums or g^T a; a = gelu(b1) there, which g = 0 cancels in g^T a.
// Stores of a, da and dh stop at Ct.

#pragma once

#include "ffn_common.cuh"
#include "hopper.cuh"

namespace ffnbwd {

using hopper::bf16;

// The tile shapes come from the build (ops/_build.py:FFN_BWD_TILES, the
// one place they are set; ops/expert_ffn.py:bwd_plan plans the launches
// with the same values).
#if !defined(FFN_BWD_TILE_M) || !defined(FFN_BWD_TILE_N) || \
    !defined(FFN_BWD_HIDDEN_TILE) || !defined(FFN_BWD_KSTEP)
#error "ops/_build.py defines the FFN backward's tile shapes"
#endif

constexpr int BK = FFN_BWD_KSTEP;   // reduction depth of one stage
constexpr int D_MAX = 1024;         // the widest model dimension taken
constexpr int BOX = 64 * BK * 2;    // bytes of one [64, 64] bf16 box
constexpr int WGS = 2;              // consumer warpgroups of a CTA
constexpr int BM = 64 * WGS;        // output rows of a tile: 64 a warpgroup
static_assert(BK == 64, "a stage is one 128 B swizzle span of bf16");
static_assert(FFN_BWD_TILE_M == BM, "a tile's rows: 64 a warpgroup");
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr float SQRT1_2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The ring (ring_init, produce_begin) and warpgroup_sync are hopper.cuh's.
using hopper::produce_begin;
using hopper::ring_init;
using hopper::warpgroup_sync;

// Consumer side of ring step `it` (the i-th of its tile) after its products
// were issued and committed: waits for the previous step's products, then
// releases that step's stage.  The tile's last stage is released by
// consume_last.
template <int STAGES>
__device__ __forceinline__ void consume_end(uint64_t* empty, int it, int i) {
  hopper::wgmma_wait<1>();
  if (i > 0 && threadIdx.x % 32 == 0)
    hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
}

template <int STAGES>
__device__ __forceinline__ void consume_last(uint64_t* empty, int it, int nk) {
  hopper::wgmma_wait<0>();
  if (nk > 0 && threadIdx.x % 32 == 0)
    hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
}

// d (+)= A B over one k16 step, n64 or n192 by the accumulator's size.
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
  hopper::wgmma_ss_n64t<TA, TB>(d, a, b, 1);
}
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b) {
  hopper::wgmma_ss_n192t<TA, TB>(d, a, b, 1);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(x, y);
}

// ---- 1. hidden pass ------------------------------------------------------
// Tiles of (HN hidden units, BM tokens, expert), hidden tiles fastest so
// that the tiles of one token tile run together and share its h and g in L2.
template <int HN_, int STAGES_>
struct HiddenCfg {
  static constexpr int HN = HN_, STAGES = STAGES_;
  static constexpr int H = 0;                    // h rows [BM, BK]
  static constexpr int G = WGS * BOX;            // g rows [BM, BK]
  static constexpr int W1 = 2 * WGS * BOX;       // w1 rows [HN, BK], K-major
  static constexpr int W2 = W1 + HN * BK * 2;    // w2 [BK, HN], MN-major
  static constexpr int STAGE = W2 + HN * BK * 2;
  // per warpgroup: the a boxes, then the da boxes of its 64 x HN outputs,
  // staged for TMA stores
  static constexpr int OUT = STAGES * STAGE;
  static constexpr int OUT_WG = 2 * (HN / 64) * BOX;
  static constexpr int BAR = OUT + WGS * OUT_WG;
  static constexpr int RED1 = BAR + 16 * STAGES;          // [warps, HN] f32
  static constexpr int RED2 = RED1 + 4 * WGS * HN * 4;    // [warps, D_MAX]
  static constexpr int BYTES = RED2 + 4 * WGS * D_MAX * 4 + 1024;
};

struct HiddenArgs {
  const float* b1;   // [E, Hd]
  float* pb1;        // [2 tiles, E, Hd]: one per 64 rows
  float* pb2;        // [2 tiles, E, D]
  int E, Ct, D, Hd;
};

template <class C>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_hidden_kernel(const __grid_constant__ CUtensorMap h_map,
                      const __grid_constant__ CUtensorMap g_map,
                      const __grid_constant__ CUtensorMap w1_map,
                      const __grid_constant__ CUtensorMap w2_map,
                      const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap da_map,
                      const HiddenArgs args) {
  constexpr int HN = C::HN, STAGES = C::STAGES;
  constexpr int WARPS = CONSUMERS / 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* empty = full + STAGES;
  const int E = args.E, Ct = args.Ct, D = args.D, Hd = args.Hd;
  const int n_hid = cdiv(Hd, HN), n_tok = cdiv(Ct, BM);
  const int total = n_hid * n_tok * E, nk = D / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ring_init(full, empty, STAGES, WARPS);

  if (warp == WARPS) {   // producer
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int j0 = (t % n_hid) * HN, m0 = (t / n_hid % n_tok) * BM;
        const int e = t / (n_hid * n_tok);
        for (int i = 0; i < nk; ++i, ++it) {
          const int st = produce_begin<STAGES>(full, empty, it, C::STAGE);
          uint8_t* s = smem + st * C::STAGE;
          for (int w = 0; w < WGS; ++w) {
            hopper::tma_load_3d(s + C::H + w * BOX, &h_map, &full[st], i * BK,
                                m0 + 64 * w, e);
            hopper::tma_load_3d(s + C::G + w * BOX, &g_map, &full[st], i * BK,
                                m0 + 64 * w, e);
          }
          for (int c = 0; c < HN / 64; ++c) {
            hopper::tma_load_3d(s + C::W1 + c * BOX, &w1_map, &full[st],
                                i * BK, j0 + 64 * c, e);
            hopper::tma_load_3d(s + C::W2 + c * BOX, &w2_map, &full[st],
                                j0 + 64 * c, i * BK, e);
          }
        }
      }
    }
    return;
  }

  const int wg = warp / 4, wtid = threadIdx.x % 128;
  float* red1 = reinterpret_cast<float*>(smem + C::RED1);
  float* red2 = reinterpret_cast<float*>(smem + C::RED2);
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int jt = t % n_hid, tile = t / n_hid % n_tok;
    const int j0 = jt * HN, m0 = tile * BM, e = t / (n_hid * n_tok);
    // the first hidden tile of a token tile also sums g's columns over its
    // rows (the db2 partial) from the g boxes in shared memory: warp w the
    // rows 16w .. 16w + 15 in order, lane l the column pair l of the stage
    const bool db2_tile = jt == 0;
    float s1[HN / 2], s2[HN / 2];
#pragma unroll
    for (int j = 0; j < HN / 2; ++j) s1[j] = s2[j] = 0.f;
    for (int i = 0; i < nk; ++i, ++it) {
      const int st = it % STAGES;
      const uint8_t* s = smem + st * C::STAGE;
      hopper::mbar_wait(&full[st], (it / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        mma<0, 0>(s1, hopper::desc_k<64>(s + C::H + wg * BOX, kk),
                  hopper::desc_k<64>(s + C::W1, kk));
        mma<0, 1>(s2, hopper::desc_k<64>(s + C::G + wg * BOX, kk),
                  hopper::desc_mn_boxes(s + C::W2, kk));
      }
      hopper::wgmma_commit();
      if (db2_tile) {
        const uint8_t* gb = s + C::G + wg * BOX;
        float x = 0.f, y = 0.f;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int r = 16 * (warp % 4) + q;   // row in the box
          // the 16-byte chunk of column pair `lane` under the 128 B swizzle
          const int chunk = (lane / 4) ^ (r % 8);
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  gb + r * 128 + chunk * 16 + (lane % 4) * 4));
          x += v.x;
          y += v.y;
        }
        red2[warp * D_MAX + i * BK + 2 * lane] = x;
        red2[warp * D_MAX + i * BK + 2 * lane + 1] = y;
      }
      consume_end<STAGES>(empty, it, i);
    }
    consume_last<STAGES>(empty, it, nk);
    hopper::fence_regs(s1);
    hopper::fence_regs(s2);

    // epilogue: register j = 4 nb + 2 r + c holds row 16 (warp % 4) +
    // lane/4 + 8 r, column 8 nb + 2 (lane % 4) + c of this warpgroup's
    // 64 x HN tile.  a and da go to this warpgroup's staging boxes under
    // the 128 B swizzle, once the TMA stores of its previous tile have read
    // them, and leave by TMA stores (rows past Ct are not written).
    const int rin0 = 16 * (warp % 4) + lane / 4;   // row in the box
    const int row0 = m0 + 64 * wg + rin0;
    const int cq = 2 * (lane % 4);
    uint8_t* out_a = smem + C::OUT + wg * C::OUT_WG;
    uint8_t* out_da = out_a + (HN / 64) * BOX;
    if (wtid == 0) hopper::bulk_wait_read<0>();
    warpgroup_sync(wg);
#pragma unroll
    for (int nb = 0; nb < HN / 8; ++nb) {
      const int col = j0 + 8 * nb + cq;
      const bool col_ok = col < Hd;
      const float2 bb = col_ok ? *reinterpret_cast<const float2*>(
                                     args.b1 + int64_t(e) * Hd + col)
                               : make_float2(0.f, 0.f);
      float cs[2] = {0.f, 0.f};   // column sums of da over this thread's rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        float av[2], dv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x = s1[4 * nb + 2 * r + c] + (c ? bb.y : bb.x);
          const float cdf = 0.5f * (1.f + erff(x * SQRT1_2));
          const float pdf = INV_SQRT_2PI * expf(-0.5f * x * x);
          av[c] = x * cdf;
          dv[c] = s2[4 * nb + 2 * r + c] * (cdf + x * pdf);
        }
        const int rin = rin0 + 8 * r;
        const int byte = (nb / 8) * BOX + rin * 128 +
                         (((nb % 8) ^ (rin % 8)) * 16) + cq * 2;
        *reinterpret_cast<uint32_t*>(out_a + byte) =
            hopper::pack_bf16(av[0], av[1]);
        *reinterpret_cast<uint32_t*>(out_da + byte) =
            hopper::pack_bf16(dv[0], dv[1]);
        if (row < Ct && col_ok) {
          cs[0] += dv[0];
          cs[1] += dv[1];
        }
      }
      // over the 8 row groups of the warp (lanes of one column pair)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], o);
        if (lane < 4) red1[warp * HN + 8 * nb + cq + c] = cs[c];
      }
    }
    hopper::fence_proxy_async();   // the staging is read by TMA next
    warpgroup_sync(wg);
    if (wtid == 0) {
      for (int c = 0; c < HN / 64; ++c) {
        hopper::tma_store_3d(&a_map, out_a + c * BOX, j0 + 64 * c,
                             m0 + 64 * wg, e);
        hopper::tma_store_3d(&da_map, out_da + c * BOX, j0 + 64 * c,
                             m0 + 64 * wg, e);
      }
      hopper::bulk_commit();
    }
    // this warpgroup's db1 and db2 partials of its 64 rows: its 4 warps'
    // sums in warp (row) order
    const int64_t sub = (2 * int64_t(tile) + wg) * E + e;
    for (int c = wtid; c < HN; c += 128)
      if (j0 + c < Hd) {
        float sum = 0.f;
        for (int w = 4 * wg; w < 4 * wg + 4; ++w) sum += red1[w * HN + c];
        args.pb1[sub * Hd + j0 + c] = sum;
      }
    if (db2_tile)
      for (int c = wtid; c < D; c += 128) {
        float sum = 0.f;
        for (int w = 4 * wg; w < 4 * wg + 4; ++w) sum += red2[w * D_MAX + c];
        args.pb2[sub * D + c] = sum;
      }
    warpgroup_sync(wg);   // its red1 / red2 rows are free for the next tile
  }
  if (wtid == 0) hopper::bulk_wait<0>();
}

// ---- 2./3. the GEMM template ---------------------------------------------
// C[M, N] = A B per (problem p, expert e, token split s), over the K
// columns (TA = 0: A [M, K] K-major, rows = tokens) or the K rows (TA = 1:
// A^T with A stored [K, M]) of A, and over the K rows (TB = 1: B stored
// [K, N], MN-major) or the K columns (TB = 0: B stored [N, K], K-major, the
// torch layout of a weight [out, in]) of B.  Tiles of BM x BN: N tiles
// fastest, then M tiles, then (e, s); problem 0's tiles, then problem 1's.
// Split s reduces over the k-steps [nk s / ks, nk (s + 1) / ks) and writes
// out[p] + s * E * M * N.  The epilogue stores the f32 sums as they are
// (the backward's products), or adds the bias [E, N] first and then either
// applies the GELU (the two-pass forward's hidden pass) or not (its output
// pass), the latter optionally adding the bf16-rounded result to a residual
// [E, M, N] in f32 (K5's, ffn_fwd_gemm.cuh).  Rows and columns past M and N
// are loaded as zeros and never stored.
enum Epilogue { EPI_STORE, EPI_BIAS_GELU, EPI_BIAS, EPI_BIAS_RESIDUAL };

struct GemmProblem {
  void* out;   // [ks, E, M, N] of Out
  int M, N;
};
struct GemmArgs {
  GemmProblem p[2];
  int problems, E, K, ks;
  const float* bias;       // [E, N] f32: EPI_BIAS*
  const bf16* residual;    // [E, M, N]: EPI_BIAS_RESIDUAL
};

template <int BN_, int STAGES_>
struct GemmCfg {
  static constexpr int BN = BN_, STAGES = STAGES_;
  static constexpr int A = 0;               // WGS boxes: one per warpgroup
  static constexpr int B = WGS * BOX;       // BN / 64 boxes of 64 columns
  static constexpr int STAGE = (WGS + BN / 64) * BOX;
  static constexpr int BAR = STAGES * STAGE;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;
};

// Tiles of one problem of a GEMM launch.
template <class C>
__host__ __device__ __forceinline__ int gemm_tiles(const GemmProblem& P,
                                                   const GemmArgs& args) {
  return cdiv(P.M, BM) * cdiv(P.N, C::BN) * args.E * args.ks;
}

template <class C>
__host__ __device__ __forceinline__ int gemm_tiles(const GemmArgs& args) {
  return gemm_tiles<C>(args.p[0], args) +
         (args.problems > 1 ? gemm_tiles<C>(args.p[1], args) : 0);
}

// Where tile t of a GEMM launch lies.
template <class C>
struct GemmTile {
  int p, m0, n0, e, s, k_begin, nk;
  __device__ __forceinline__ GemmTile(const GemmArgs& args, int t) {
    const int first = gemm_tiles<C>(args.p[0], args);
    p = t >= first;
    if (p) t -= first;
    const GemmProblem P = p ? args.p[1] : args.p[0];
    const int n_tiles = cdiv(P.N, C::BN), per = cdiv(P.M, BM) * n_tiles;
    const int in = t % per, es = t / per;
    m0 = (in / n_tiles) * BM;
    n0 = (in % n_tiles) * C::BN;
    e = es / args.ks;
    s = es % args.ks;
    const int nk_all = cdiv(args.K, BK);
    k_begin = int(int64_t(nk_all) * s / args.ks);
    nk = int(int64_t(nk_all) * (s + 1) / args.ks) - k_begin;
  }
};

template <int TA, int TB, int EPI, class C, typename Out>
__global__ void __launch_bounds__(THREADS, 1)
ffn_gemm_kernel(const __grid_constant__ CUtensorMap a0_map,
                const __grid_constant__ CUtensorMap b0_map,
                const __grid_constant__ CUtensorMap a1_map,
                const __grid_constant__ CUtensorMap b1_map,
                const GemmArgs args) {
  constexpr int BN = C::BN, STAGES = C::STAGES, WARPS = CONSUMERS / 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* empty = full + STAGES;
  const int total = gemm_tiles<C>(args);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ring_init(full, empty, STAGES, WARPS);

  if (warp == WARPS) {   // producer
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const GemmTile<C> T(args, t);
        const CUtensorMap* a_map = T.p ? &a1_map : &a0_map;
        const CUtensorMap* b_map = T.p ? &b1_map : &b0_map;
        for (int i = 0; i < T.nk; ++i, ++it) {
          const int st = produce_begin<STAGES>(full, empty, it, C::STAGE);
          uint8_t* s = smem + st * C::STAGE;
          const int k = (T.k_begin + i) * BK;
          for (int w = 0; w < WGS; ++w) {
            if (TA)
              hopper::tma_load_3d(s + C::A + w * BOX, a_map, &full[st],
                                  T.m0 + 64 * w, k, T.e);
            else
              hopper::tma_load_3d(s + C::A + w * BOX, a_map, &full[st], k,
                                  T.m0 + 64 * w, T.e);
          }
          for (int c = 0; c < BN / 64; ++c) {
            if (TB)
              hopper::tma_load_3d(s + C::B + c * BOX, b_map, &full[st],
                                  T.n0 + 64 * c, k, T.e);
            else   // BN rows of B, one after another: a [BN, 64] K-major tile
              hopper::tma_load_3d(s + C::B + c * BOX, b_map, &full[st], k,
                                  T.n0 + 64 * c, T.e);
          }
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const GemmTile<C> T(args, t);
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    for (int i = 0; i < T.nk; ++i, ++it) {
      const int st = it % STAGES;
      const uint8_t* s = smem + st * C::STAGE;
      hopper::mbar_wait(&full[st], (it / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint8_t* a = s + C::A + wg * BOX;
        mma<TA, TB>(acc,
                    TA ? hopper::desc_mn<64>(a, 0, kk)
                       : hopper::desc_k<64>(a, kk),
                    TB ? hopper::desc_mn_boxes(s + C::B, kk)
                       : hopper::desc_k<64>(s + C::B, kk));
      }
      hopper::wgmma_commit();
      consume_end<STAGES>(empty, it, i);
    }
    consume_last<STAGES>(empty, it, T.nk);
    hopper::fence_regs(acc);

    const GemmProblem P = T.p ? args.p[1] : args.p[0];
    const int64_t slab = (int64_t(T.s) * args.E + T.e) * int64_t(P.M) * P.N;
    Out* out = static_cast<Out*>(P.out) + slab;
    const int row0 = T.m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
    const int cq = 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= P.M) continue;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int col = T.n0 + 8 * nb + cq;
        if (col >= P.N) continue;
        float x = acc[4 * nb + 2 * r], y = acc[4 * nb + 2 * r + 1];
        if constexpr (EPI != EPI_STORE) {
          const float2 b = *reinterpret_cast<const float2*>(
              args.bias + int64_t(T.e) * P.N + col);
          x += b.x;
          y += b.y;
        }
        if constexpr (EPI == EPI_BIAS_GELU) {
          x = ffn::gelu(x);
          y = ffn::gelu(y);
        }
        if constexpr (EPI == EPI_BIAS_RESIDUAL) {   // x + bf16(MLP), in f32
          const float2 xr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  args.residual + slab + int64_t(row) * P.N + col));
          x = xr.x + __bfloat162float(__float2bfloat16(x));
          y = xr.y + __bfloat162float(__float2bfloat16(y));
        }
        store2(out + int64_t(row) * P.N + col, x, y);
      }
    }
  }
}

// ---- 4. fixed-order sums ---------------------------------------------------
// out[i] = sum over s < ks of parts[s * n + i] for up to MAX_SEGS (parts,
// out, n, ks) segments in one launch (blockIdx.y); n % 4 == 0 and 16-byte
// aligned arrays.  A block takes 32 float4 columns; its 8 thread rows sum
// the splits [ks q / 8, ks (q + 1) / 8) in order, and those 8 sums are
// added in row order: a fixed order, deep partial stacks (the per-tile
// bias partials) spread over 8 threads.
constexpr int MAX_SEGS = 6;
struct SumSeg {
  const float* parts;
  float* out;
  int64_t n;
  int ks;
};
struct SumArgs {
  SumSeg seg[MAX_SEGS];
  int count;
};

__global__ void __launch_bounds__(256) sum_parts_kernel(const SumArgs args) {
  SumSeg sg = args.seg[0];
#pragma unroll
  for (int i = 1; i < MAX_SEGS; ++i)   // constant indices: no local copy
    if (int(blockIdx.y) == i) sg = args.seg[i];
  __shared__ float4 part[8][32];
  const int c = threadIdx.x % 32, q = threadIdx.x / 32;
  const int64_t n4 = sg.n / 4;
  const float4* parts = reinterpret_cast<const float4*>(sg.parts);
  for (int64_t i0 = int64_t(blockIdx.x) * 32; i0 < n4;
       i0 += int64_t(gridDim.x) * 32) {
    const int64_t i = i0 + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n4)
      for (int s = sg.ks * q / 8; s < sg.ks * (q + 1) / 8; ++s) {
        const float4 v = parts[int64_t(s) * n4 + i];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    part[q][c] = acc;
    __syncthreads();
    if (q == 0 && i < n4) {
      float4 sum = part[0][c];
      for (int r = 1; r < 8; ++r) {
        sum.x += part[r][c].x;
        sum.y += part[r][c].y;
        sum.z += part[r][c].z;
        sum.w += part[r][c].w;
      }
      reinterpret_cast<float4*>(sg.out)[i] = sum;
    }
    __syncthreads();
  }
}

inline cudaError_t sum_parts(const SumArgs& args, int sms,
                             cudaStream_t stream) {
  if (args.count == 0) return cudaSuccess;
  int64_t most = 0;
  for (int i = 0; i < args.count; ++i)
    most = args.seg[i].n > most ? args.seg[i].n : most;
  const int64_t blocks = (most / 4 + 31) / 32;
  const int bx = int(blocks < 8 * sms ? blocks : 8 * sms);
  sum_parts_kernel<<<dim3(bx, args.count), 256, 0, stream>>>(args);
  return cudaGetLastError();
}

// ---- host side ------------------------------------------------------------
// The configurations launched (chosen on an H100 among hidden tiles of 64
// and 128 units, GEMM tiles 128 x 128 and 128 x 192, one or two
// warpgroups a CTA and one or two CTAs an SM: PERF.md): 64 hidden
// units x 128 tokens with a 3-stage ring (the a / da staging leaves no
// room for more), and 128 x 192 GEMM tiles with a 4-stage ring.  The
// tile shapes are the build's FFN_BWD_HIDDEN_TILE and FFN_BWD_TILE_N.
using Hidden = HiddenCfg<FFN_BWD_HIDDEN_TILE, 3>;
using Gemm = GemmCfg<FFN_BWD_TILE_N, 4>;

// The grids of the three tile passes, planned by the caller
// (ops/expert_ffn.py:bwd_plan) and launched as given.  Each kernel is
// persistent, so any grid of at least one CTA covers its tiles.
struct Grids {
  int hidden, dh, weights;
  bool valid() const { return hidden > 0 && dh > 0 && weights > 0; }
};

// Bytes of the scratch the five passes need beyond the outputs: a and da
// [E, Ct, Hd] bf16, the db1/db2 partials [tiles, E, Hd] / [tiles, E, D]
// f32, and with ks > 1 the dw1/dw2 partials [ks, E, Hd, D] f32 each.
inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

struct CoreScratch {
  bf16 *a, *da;
  float *pb1, *pb2, *pw1, *pw2;
  size_t bytes;
};

inline CoreScratch carve_core(uint8_t* base, int E, int Ct, int D, int Hd,
                              int ks) {
  CoreScratch c{};
  size_t off = 0;
  auto take = [&](size_t n) {
    uint8_t* p = base ? base + off : nullptr;
    off += align256(n);
    return p;
  };
  const size_t act = size_t(E) * Ct * Hd * 2;
  const size_t tiles = 2 * cdiv(Ct, BM);   // the db1/db2 partials' rows
  c.a = reinterpret_cast<bf16*>(take(act));
  c.da = reinterpret_cast<bf16*>(take(act));
  c.pb1 = reinterpret_cast<float*>(take(tiles * E * Hd * 4));
  c.pb2 = reinterpret_cast<float*>(take(tiles * E * D * 4));
  const size_t pw = ks > 1 ? size_t(ks) * E * Hd * D * 4 : 0;
  c.pw1 = reinterpret_cast<float*>(take(pw));
  c.pw2 = reinterpret_cast<float*>(take(pw));
  c.bytes = off;
  return c;
}

template <class C, int TA, typename Out, int TB = 1, int EPI = EPI_STORE>
cudaError_t launch_gemm(const CUtensorMap& a0, const CUtensorMap& b0,
                        const CUtensorMap& a1, const CUtensorMap& b1,
                        const GemmArgs& args, int grid, cudaStream_t stream) {
  cudaError_t err = ffn::allow_smem(ffn_gemm_kernel<TA, TB, EPI, C, Out>,
                                    C::BYTES);
  if (err != cudaSuccess) return err;
  ffn_gemm_kernel<TA, TB, EPI, C, Out><<<grid, THREADS, C::BYTES, stream>>>(
      a0, b0, a1, b1, args);
  return cudaGetLastError();
}

// Launches passes 1-3 on h, g [E, Ct, D] bf16 (any Ct), w1
// [E, Hd, D], w2 [E, D, Hd] bf16, b1 [E, Hd] f32 on `grid`: dh
// [E, Ct, D] as DhOut; adds to `sums` the segments of pass 4 that give
// dw1, db1, dw2 and db2 (f32), for the caller to launch.
template <typename DhOut>
cudaError_t launch_core(const bf16* h, const bf16* g, const bf16* w1,
                        const float* b1, const bf16* w2, DhOut* dh,
                        float* dw1, float* db1, float* dw2, float* db2,
                        const CoreScratch& sc, int E, int Ct, int D, int Hd,
                        int ks, const Grids& grid, SumArgs* sums,
                        cudaStream_t stream) {
  CUtensorMap h_map, g_map, w1_map, w2_map, a_map, da_map;
  if (!hopper::make_tile_map<64>(&h_map, h, D, Ct, E) ||
      !hopper::make_tile_map<64>(&g_map, g, D, Ct, E) ||
      !hopper::make_tile_map<64>(&w1_map, w1, D, Hd, E) ||
      !hopper::make_tile_map<64>(&w2_map, w2, Hd, D, E) ||
      !hopper::make_tile_map<64>(&a_map, sc.a, Hd, Ct, E) ||
      !hopper::make_tile_map<64>(&da_map, sc.da, Hd, Ct, E))
    return cudaErrorInvalidValue;
  cudaError_t err =
      ffn::allow_smem(ffn_bwd_hidden_kernel<Hidden>, Hidden::BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(Ct, BM);
  ffn_bwd_hidden_kernel<Hidden><<<grid.hidden, THREADS, Hidden::BYTES,
                                  stream>>>(
      h_map, g_map, w1_map, w2_map, a_map, da_map,
      HiddenArgs{b1, sc.pb1, sc.pb2, E, Ct, D, Hd});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // dh = da w1: M = tokens, N = D, K = Hd
  const GemmArgs dh_args{{{dh, Ct, D}, {dh, Ct, D}}, 1, E, Hd, 1};
  // dw1 = da^T h [Hd, D] and dw2 = g^T a [D, Hd]: K = tokens
  const GemmArgs w_args{{{ks > 1 ? sc.pw1 : dw1, Hd, D},
                         {ks > 1 ? sc.pw2 : dw2, D, Hd}},
                        2, E, Ct, ks};
  err = launch_gemm<Gemm, 0, DhOut>(da_map, w1_map, da_map, w1_map, dh_args,
                                    grid.dh, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<Gemm, 1, float>(da_map, h_map, g_map, a_map, w_args,
                                    grid.weights, stream);
  if (err != cudaSuccess) return err;

  const int64_t nw = int64_t(E) * Hd * D;
  if (ks > 1) {
    sums->seg[sums->count++] = {sc.pw1, dw1, nw, ks};
    sums->seg[sums->count++] = {sc.pw2, dw2, nw, ks};
  }
  sums->seg[sums->count++] = {sc.pb1, db1, int64_t(E) * Hd, 2 * tiles};
  sums->seg[sums->count++] = {sc.pb2, db2, int64_t(E) * D, 2 * tiles};
  return cudaSuccess;
}

}  // namespace ffnbwd
