// Fused per-expert FFN backward for Hopper (sm_90a), the VJP of
//   out[e] = gelu(h[e] @ w1[e]^T + b1[e]) @ w2[e]^T + b2[e].
//
// Replaces the TPU kernel m3vit_tpu/ops/expert_ffn.py:_ffn_bwd_kernel (the
// pallas_call in _ffn_backward, reached through fused_expert_ffn's VJP for
// the MoE expert banks and, at E=1, for the dense MLPs).  Weights come in
// the torch layout [E, out, in]: w1 [E, Hd, D], w2 [E, D, Hd]; b1 is f32.
// From the upstream gradient g it recomputes (remat) a_pre = h w1^T + b1
// in f32, cdf, pdf and a = gelu(a_pre) rounded to bf16, then
//   da = (g w2) * gelu'(a_pre)   rounded to bf16 (db1 sums it unrounded)
//   dh = da w1 (bf16 out),  dw1 = da^T h,  db1 = sum da,
//   dw2 = g^T a,            db2 = sum g     (all four f32 out)
// with every product on bf16 operands accumulating in f32.  cdf uses the
// exact erf (CUDA erff); the TPU kernel used the Abramowitz-Stegun 7.1.26
// rational form (|error| < 1.5e-7), so gelu' differs by at most ~1.5e-7,
// far below the bf16 rounding of da (2^-9 relative).
//
// What bounds it: at the flagship expert shape (h [16, 2568, 384], hidden
// 384) the backward needs 5 products of 2*C*D*Hd per expert, 60.6 GFLOP, on
// ~110 MB; the dense MLP (h [1, 8200, 384], hidden 1536) 48.4 GFLOP on
// ~20 MB.  Both sit far above the bf16 ridge: the tensor cores bound them,
// provided the [tokens, Hd] hidden activations never reach device memory.
//
// Design.  On the TPU the weight gradients accumulate in VMEM across the
// sequential token grid; here blocks run in parallel in no order, so the
// work is split deterministically (no atomics), and every pass recomputes
// what it needs of the hidden activations in shared memory:
//   1. dh pass: one CTA per (32-token tile, expert) walks Hd in 64-wide
//      chunks: a_pre and g w2 chunks, da, then dh += da w1 chunk in WMMA
//      accumulators (registers).
//   2. dw1/db1 pass: one CTA per (64-hidden tile, expert, token split)
//      keeps its w1 rows and w2 columns in shared memory, walks its token
//      range in 32-token tiles and accumulates dw1 rows += da^T h in
//      registers, db1 in a register per hidden unit.
//   3. dw2/db2 pass: one CTA per (64-hidden tile, expert, token split)
//      accumulates dw2 columns += g^T a (and, in the first hidden tile,
//      db2).
//   4. When the token range is split (to fill the card), the splits' f32
//      partials are summed in a fixed order by one last pass.
// That is 8 products of 2*C*D*Hd instead of 5: the price of keeping the
// hidden activations out of device memory without a sequential grid.
// Products run through WMMA bf16 16x16x16; no cp.async/TMA pipelining and
// no wgmma yet: simple and right first.  The token axis is only 8-aligned
// (capacity 2568 in training): rows past the end are zero-filled on load
// (zero h and g give zero da and zero g^T a) and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TM = 32;       // tokens per tile
constexpr int HC = 64;       // hidden units per chunk / tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float SQRT1_2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

template <int D>
struct Smem {
  static constexpr int LDH = D + 8;    // bf16 stride: h, g tiles, w1 rows
  static constexpr int LDW2 = HC + 8;  // bf16 stride: w2 columns [D, HC]
  static constexpr int LDA = HC + 4;   // f32 stride: [TM, HC] chunks
  static constexpr int LDB = HC + 8;   // bf16 stride: [TM, HC] chunks
  static constexpr int LDST = D + 4;   // f32 stride: dh staging
  static constexpr size_t tok = size_t(TM) * LDH * sizeof(bf16);
  static constexpr size_t w1 = size_t(HC) * LDH * sizeof(bf16);
  static constexpr size_t w2 = size_t(D) * LDW2 * sizeof(bf16);
  static constexpr size_t af = size_t(TM) * LDA * sizeof(float);
  static constexpr size_t ab = size_t(TM) * LDB * sizeof(bf16);
  // h, g, w1, w2, a_pre, g w2, da
  static constexpr size_t bytes = 2 * tok + w1 + w2 + 2 * af + ab;
  static_assert(size_t(TM) * LDST * sizeof(float) <= 2 * tok + w1,
                "dh staging does not fit");
};

// Copies a [rows, cols] bf16 tile (row stride `lds` in the source, `ldd` in
// shared memory) 16 bytes per thread per step; rows >= rows_valid are zero.
__device__ __forceinline__ void copy_tile(bf16* dst, int ldd, const bf16* src,
                                          int64_t lds, int rows,
                                          int rows_valid, int cols, int tid) {
  const int cpr = cols / 8;
  for (int i = tid; i < rows * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      v = *reinterpret_cast<const uint4*>(src + int64_t(r) * lds + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
  }
}

// Warp w's 16x16 block (row block w>>2, hidden block w&3) of the [TM, HC]
// pre-activation h w1_chunk^T (into Af) and, when Gs is given, of g w2_chunk
// (into Gf); f32 accumulation over D.
template <int D>
__device__ __forceinline__ void hidden_products(const bf16* Hs, const bf16* Gs,
                                                const bf16* W1s,
                                                const bf16* W2s, float* Af,
                                                float* Gf, int warp) {
  using S = Smem<D>;
  const int rb = warp >> 2, cb = warp & 3;
  Acc pa, pg;
  wmma::fill_fragment(pa, 0.f);
  wmma::fill_fragment(pg, 0.f);
#pragma unroll 4
  for (int kk = 0; kk < D / 16; ++kk) {
    ARow a;
    BCol b1;
    wmma::load_matrix_sync(a, Hs + rb * 16 * S::LDH + kk * 16, S::LDH);
    wmma::load_matrix_sync(b1, W1s + cb * 16 * S::LDH + kk * 16, S::LDH);
    wmma::mma_sync(pa, a, b1, pa);
    if (Gs != nullptr) {
      BRow b2;
      wmma::load_matrix_sync(a, Gs + rb * 16 * S::LDH + kk * 16, S::LDH);
      wmma::load_matrix_sync(b2, W2s + kk * 16 * S::LDW2 + cb * 16, S::LDW2);
      wmma::mma_sync(pg, a, b2, pg);
    }
  }
  wmma::store_matrix_sync(Af + rb * 16 * S::LDA + cb * 16, pa, S::LDA,
                          wmma::mem_row_major);
  if (Gs != nullptr)
    wmma::store_matrix_sync(Gf + rb * 16 * S::LDA + cb * 16, pg, S::LDA,
                            wmma::mem_row_major);
}

// da = (g w2) * gelu'(a_pre + b1) over a [TM, HC] chunk: f32 into Af (in
// place) and bf16 into Db.
template <int D>
__device__ __forceinline__ void grad_pre(float* Af, const float* Gf, bf16* Db,
                                         const float* b1c, int tid) {
  using S = Smem<D>;
  for (int i = tid; i < TM * HC; i += THREADS) {
    const int r = i / HC, c = i % HC;
    const float x = Af[r * S::LDA + c] + b1c[c];
    const float cdf = 0.5f * (1.f + erff(x * SQRT1_2));
    const float pdf = INV_SQRT_2PI * expf(-0.5f * x * x);
    const float da = Gf[r * S::LDA + c] * (cdf + x * pdf);
    Af[r * S::LDA + c] = da;
    Db[r * S::LDB + c] = __float2bfloat16(da);
  }
}

// ---- pass 1: dh ----------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dh_kernel(const bf16* __restrict__ hin, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ gin, bf16* __restrict__ dh, int Ct,
                  int Hd) {
  using S = Smem<D>;
  constexpr int NF = D / 64;  // dh fragments per warp (16 x D/4)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Hs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + S::tok);
  bf16* W1s = reinterpret_cast<bf16*>(smem + 2 * S::tok);
  bf16* W2s = reinterpret_cast<bf16*>(smem + 2 * S::tok + S::w1);
  float* Af = reinterpret_cast<float*>(smem + 2 * S::tok + S::w1 + S::w2);
  float* Gf = reinterpret_cast<float*>(smem + 2 * S::tok + S::w1 + S::w2 +
                                       S::af);
  bf16* Db = reinterpret_cast<bf16*>(smem + 2 * S::tok + S::w1 + S::w2 +
                                     2 * S::af);
  float* St = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.x * TM, e = blockIdx.y;
  const int rb = warp >> 2, cq = warp & 3;
  const bf16* w1e = w1 + int64_t(e) * Hd * D;
  const bf16* w2e = w2 + int64_t(e) * D * Hd;
  const float* b1e = b1 + int64_t(e) * Hd;

  copy_tile(Hs, S::LDH, hin + (int64_t(e) * Ct + m0) * D, D, TM, Ct - m0, D,
            tid);
  copy_tile(Gs, S::LDH, gin + (int64_t(e) * Ct + m0) * D, D, TM, Ct - m0, D,
            tid);

  Acc acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int j0 = 0; j0 < Hd; j0 += HC) {
    __syncthreads();  // the previous chunk's readers are done
    copy_tile(W1s, S::LDH, w1e + int64_t(j0) * D, D, HC, HC, D, tid);
    copy_tile(W2s, S::LDW2, w2e + j0, Hd, D, D, HC, tid);
    __syncthreads();
    hidden_products<D>(Hs, Gs, W1s, W2s, Af, Gf, warp);
    __syncthreads();
    grad_pre<D>(Af, Gf, Db, b1e + j0, tid);
    __syncthreads();
    // dh[TM, D] += da[TM, HC] w1_chunk[HC, D]
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      ARow a;
      wmma::load_matrix_sync(a, Db + rb * 16 * S::LDB + kk * 16, S::LDB);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        BRow b;
        wmma::load_matrix_sync(
            b, W1s + kk * 16 * S::LDH + cq * (D / 4) + f * 16, S::LDH);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }

  __syncthreads();  // the staging overwrites the h, g and w1 tiles
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(St + rb * 16 * S::LDST + cq * (D / 4) + f * 16,
                            acc[f], S::LDST, wmma::mem_row_major);
  __syncthreads();
  bf16* dst = dh + (int64_t(e) * Ct + m0) * D;
  const int rows = min(TM, Ct - m0);
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[int64_t(r) * D + c] = __float2bfloat16(St[r * S::LDST + c]);
  }
}

// Token tiles [t0, t1) of split `s` of `ks` over ceil(Ct / TM) tiles.
__device__ __forceinline__ void split_range(int Ct, int s, int ks, int* t0,
                                            int* t1) {
  const int tiles = (Ct + TM - 1) / TM;
  *t0 = int(int64_t(tiles) * s / ks);
  *t1 = int(int64_t(tiles) * (s + 1) / ks);
}

// ---- pass 2: dw1, db1 ----------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dw1_kernel(const bf16* __restrict__ hin, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ gin, float* __restrict__ pw1,
                   float* __restrict__ pb1, int E, int Ct, int Hd, int ks) {
  using S = Smem<D>;
  constexpr int NF = D / 32;  // dw1 fragments per warp (16 x D/2)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Hs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + S::tok);
  bf16* W1s = reinterpret_cast<bf16*>(smem + 2 * S::tok);
  bf16* W2s = reinterpret_cast<bf16*>(smem + 2 * S::tok + S::w1);
  float* Af = reinterpret_cast<float*>(smem + 2 * S::tok + S::w1 + S::w2);
  float* Gf = reinterpret_cast<float*>(smem + 2 * S::tok + S::w1 + S::w2 +
                                       S::af);
  bf16* Db = reinterpret_cast<bf16*>(smem + 2 * S::tok + S::w1 + S::w2 +
                                     2 * S::af);

  const int tid = threadIdx.x, warp = tid / 32;
  const int j0 = blockIdx.x * HC, e = blockIdx.y, s = blockIdx.z;
  const int rb = warp & 3, ch = warp >> 2;
  const bf16* he = hin + int64_t(e) * Ct * D;
  const bf16* ge = gin + int64_t(e) * Ct * D;
  copy_tile(W1s, S::LDH, w1 + (int64_t(e) * Hd + j0) * D, D, HC, HC, D, tid);
  copy_tile(W2s, S::LDW2, w2 + int64_t(e) * D * Hd + j0, Hd, D, D, HC, tid);
  const float* b1c = b1 + int64_t(e) * Hd + j0;

  Acc acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
  float db1 = 0.f;  // thread tid < HC: hidden unit j0 + tid

  int t0, t1;
  split_range(Ct, s, ks, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int m0 = t * TM;
    __syncthreads();  // the previous tile's readers are done
    copy_tile(Hs, S::LDH, he + int64_t(m0) * D, D, TM, Ct - m0, D, tid);
    copy_tile(Gs, S::LDH, ge + int64_t(m0) * D, D, TM, Ct - m0, D, tid);
    __syncthreads();
    hidden_products<D>(Hs, Gs, W1s, W2s, Af, Gf, warp);
    __syncthreads();
    grad_pre<D>(Af, Gf, Db, b1c, tid);
    __syncthreads();
    if (tid < HC)
      for (int r = 0; r < TM; ++r) db1 += Af[r * S::LDA + tid];
    // dw1[HC, D] += da^T[HC, TM] h[TM, D]
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk) {
      ACol a;
      wmma::load_matrix_sync(a, Db + kk * 16 * S::LDB + rb * 16, S::LDB);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        BRow b;
        wmma::load_matrix_sync(
            b, Hs + kk * 16 * S::LDH + ch * (D / 2) + f * 16, S::LDH);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }

  float* dst = pw1 + ((int64_t(s) * E + e) * Hd + j0 + rb * 16) * D +
               ch * (D / 2);
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(dst + f * 16, acc[f], D, wmma::mem_row_major);
  if (tid < HC) pb1[(int64_t(s) * E + e) * Hd + j0 + tid] = db1;
}

// ---- pass 3: dw2, db2 ----------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dw2_kernel(const bf16* __restrict__ hin, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ gin,
                   float* __restrict__ pw2, float* __restrict__ pb2, int E,
                   int Ct, int Hd, int ks) {
  using S = Smem<D>;
  constexpr int RB = D / 128;  // 16-row blocks of dw2 per warp
  constexpr int DB = (D + THREADS - 1) / THREADS;  // db2 columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Hs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + S::tok);
  bf16* W1s = reinterpret_cast<bf16*>(smem + 2 * S::tok);
  float* Af = reinterpret_cast<float*>(smem + 2 * S::tok + S::w1);
  bf16* Ab = reinterpret_cast<bf16*>(smem + 2 * S::tok + S::w1 + S::af);

  const int tid = threadIdx.x, warp = tid / 32;
  const int j0 = blockIdx.x * HC, e = blockIdx.y, s = blockIdx.z;
  const bool first = blockIdx.x == 0;  // this tile also sums db2
  const bf16* he = hin + int64_t(e) * Ct * D;
  const bf16* ge = gin + int64_t(e) * Ct * D;
  copy_tile(W1s, S::LDH, w1 + (int64_t(e) * Hd + j0) * D, D, HC, HC, D, tid);
  const float* b1c = b1 + int64_t(e) * Hd + j0;

  Acc acc[RB][4];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) wmma::fill_fragment(acc[i][cb], 0.f);
  float db2[DB];
#pragma unroll
  for (int i = 0; i < DB; ++i) db2[i] = 0.f;

  int t0, t1;
  split_range(Ct, s, ks, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int m0 = t * TM;
    __syncthreads();  // the previous tile's readers are done
    copy_tile(Hs, S::LDH, he + int64_t(m0) * D, D, TM, Ct - m0, D, tid);
    copy_tile(Gs, S::LDH, ge + int64_t(m0) * D, D, TM, Ct - m0, D, tid);
    __syncthreads();
    hidden_products<D>(Hs, nullptr, W1s, nullptr, Af, nullptr, warp);
    __syncthreads();
    // a = gelu(a_pre + b1) rounded to bf16
    for (int i = tid; i < TM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      const float x = Af[r * S::LDA + c] + b1c[c];
      Ab[r * S::LDB + c] =
          __float2bfloat16(0.5f * x * (1.f + erff(x * SQRT1_2)));
    }
    __syncthreads();
    if (first) {
#pragma unroll
      for (int i = 0; i < DB; ++i) {
        const int c = tid + i * THREADS;
        if (c < D)
          for (int r = 0; r < TM; ++r)
            db2[i] += __bfloat162float(Gs[r * S::LDH + c]);
      }
    }
    // dw2[D, HC] += g^T[D, TM] a[TM, HC]
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk) {
      BRow b[4];
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
        wmma::load_matrix_sync(b[cb], Ab + kk * 16 * S::LDB + cb * 16, S::LDB);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        ACol a;
        wmma::load_matrix_sync(a, Gs + kk * 16 * S::LDH + (warp + 8 * i) * 16,
                               S::LDH);
#pragma unroll
        for (int cb = 0; cb < 4; ++cb)
          wmma::mma_sync(acc[i][cb], a, b[cb], acc[i][cb]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
      wmma::store_matrix_sync(
          pw2 + ((int64_t(s) * E + e) * D + (warp + 8 * i) * 16) * Hd + j0 +
              cb * 16,
          acc[i][cb], Hd, wmma::mem_row_major);
  if (first) {
#pragma unroll
    for (int i = 0; i < DB; ++i) {
      const int c = tid + i * THREADS;
      if (c < D) pb2[(int64_t(s) * E + e) * D + c] = db2[i];
    }
  }
}

// ---- pass 4: out[i] = sum over splits of parts[s][i], in split order -----
__global__ void sum_splits_kernel(const float* __restrict__ parts,
                                  float* __restrict__ out, int64_t n, int ks) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < ks; ++s) acc += parts[int64_t(s) * n + i];
    out[i] = acc;
  }
}

cudaError_t sum_splits(const void* parts, void* out, int64_t n, int ks,
                       cudaStream_t stream) {
  const int64_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  sum_splits_kernel<<<unsigned(blocks), 256, 0, stream>>>(
      static_cast<const float*>(parts), static_cast<float*>(out), n, ks);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <int D>
cudaError_t launch(const void* h, const void* w1, const void* b1,
                   const void* w2, const void* g, void* dh, void* dw1,
                   void* db1, void* dw2, void* db2, void* pw1, void* pb1,
                   void* pw2, void* pb2, int E, int Ct, int Hd, int ks,
                   cudaStream_t stream) {
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const bf16* gp = static_cast<const bf16*>(g);
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err;
  if ((err = allow_smem(ffn_bwd_dh_kernel<D>, bytes)) != cudaSuccess ||
      (err = allow_smem(ffn_bwd_dw1_kernel<D>, bytes)) != cudaSuccess ||
      (err = allow_smem(ffn_bwd_dw2_kernel<D>, bytes)) != cudaSuccess)
    return err;
  ffn_bwd_dh_kernel<D><<<dim3((Ct + TM - 1) / TM, E), THREADS, bytes,
                         stream>>>(hp, w1p, b1p, w2p, gp,
                                   static_cast<bf16*>(dh), Ct, Hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(Hd / HC, E, ks);
  ffn_bwd_dw1_kernel<D><<<grid, THREADS, bytes, stream>>>(
      hp, w1p, b1p, w2p, gp, static_cast<float*>(pw1),
      static_cast<float*>(pb1), E, Ct, Hd, ks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ffn_bwd_dw2_kernel<D><<<grid, THREADS, bytes, stream>>>(
      hp, w1p, b1p, gp, static_cast<float*>(pw2), static_cast<float*>(pb2),
      E, Ct, Hd, ks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ks > 1) {
    const int64_t nw = int64_t(E) * Hd * D;
    if ((err = sum_splits(pw1, dw1, nw, ks, stream)) != cudaSuccess) return err;
    if ((err = sum_splits(pb1, db1, int64_t(E) * Hd, ks, stream)) !=
        cudaSuccess)
      return err;
    if ((err = sum_splits(pw2, dw2, nw, ks, stream)) != cudaSuccess) return err;
    if ((err = sum_splits(pb2, db2, int64_t(E) * D, ks, stream)) !=
        cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

}  // namespace

// h, g [E, Ct, D] bf16, w1 [E, Hd, D] bf16, b1 [E, Hd] f32, w2 [E, D, Hd]
// bf16; outputs dh [E, Ct, D] bf16, dw1 [E, Hd, D], db1 [E, Hd],
// dw2 [E, D, Hd], db2 [E, D] f32; pw1/pb1/pw2/pb2 are [ks, ...] f32 partials
// of those four (the outputs themselves when ks == 1).  All contiguous;
// Hd % 64 == 0.  Returns a cudaError_t; cudaErrorInvalidValue for a width
// not built.
extern "C" int expert_ffn_bwd(const void* h, const void* w1, const void* b1,
                              const void* w2, const void* g, void* dh,
                              void* dw1, void* db1, void* dw2, void* db2,
                              void* pw1, void* pb1, void* pw2, void* pb2,
                              int E, int Ct, int D, int Hd, int ks,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd % HC != 0 || ks < 1) return int(cudaErrorInvalidValue);
  switch (D) {
    case 128:
      return launch<128>(h, w1, b1, w2, g, dh, dw1, db1, dw2, db2, pw1, pb1,
                         pw2, pb2, E, Ct, Hd, ks, s);
    case 384:
      return launch<384>(h, w1, b1, w2, g, dh, dw1, db1, dw2, db2, pw1, pb1,
                         pw2, pb2, E, Ct, Hd, ks, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
