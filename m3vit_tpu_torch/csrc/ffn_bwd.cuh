// The fused FFN backward shared by K4 (expert_ffn_bwd.cu) and K6
// (ln_mlp_bwd.cu): the VJP of out = gelu(h w1^T + b1) w2^T + b2 with the
// hidden activations recomputed in shared memory (remat), as
//   da = (g w2) * gelu'(a_pre)   rounded to bf16 (db1 sums it unrounded)
//   dh = da w1,  dw1 = da^T h,  db1 = sum da,  dw2 = g^T a,  db2 = sum g.
// Blocks run in no order, so the weight gradients are summed over token
// splits into per-split f32 partials, and those in a fixed order by
// sum_splits (no atomics: deterministic).  How a token tile h reaches
// shared memory is the kernel's own: K4 copies it, K6 recomputes it as
// bf16(LN(x)).  The token axis is only 8-aligned: rows past the end are
// zero in h and g, so they add nothing to da, g^T a or the sums.

#pragma once

#include "ffn_common.cuh"

namespace ffn {

constexpr int TM = 32;  // tokens per tile

template <int D>
struct BwdSmem {
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

  struct Ptrs {
    bf16 *Hs, *Gs, *W1s, *W2s;
    float *Af, *Gf;
    bf16* Db;
  };
  static __device__ Ptrs at(unsigned char* s) {
    return {reinterpret_cast<bf16*>(s), reinterpret_cast<bf16*>(s + tok),
            reinterpret_cast<bf16*>(s + 2 * tok),
            reinterpret_cast<bf16*>(s + 2 * tok + w1),
            reinterpret_cast<float*>(s + 2 * tok + w1 + w2),
            reinterpret_cast<float*>(s + 2 * tok + w1 + w2 + af),
            reinterpret_cast<bf16*>(s + 2 * tok + w1 + w2 + 2 * af)};
  }
};

// Warp w's 16x16 block (row block w>>2, hidden block w&3) of the [TM, HC]
// pre-activation h w1_chunk^T (into Af) and, when Gs is given, of g w2_chunk
// (into Gf); f32 accumulation over D.
template <int D>
__device__ __forceinline__ void hidden_products(const bf16* Hs, const bf16* Gs,
                                                const bf16* W1s,
                                                const bf16* W2s, float* Af,
                                                float* Gf, int warp) {
  using S = BwdSmem<D>;
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
  using S = BwdSmem<D>;
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

// The dh pass's hidden loop for one token tile whose h and g are in
// shared memory: acc[TM, D] = da w1 summed over the hidden chunks, warp w
// holding row block w>>2 and column quarter w&3 (D/64 fragments).  Ends
// with every warp past its last shared-memory read.
template <int D>
__device__ __forceinline__ void dh_loop(unsigned char* smem, const bf16* w1e,
                                        const float* b1e, const bf16* w2e,
                                        int Hd, Acc (&acc)[D / 64]) {
  using S = BwdSmem<D>;
  const auto p = S::at(smem);
  const int tid = threadIdx.x, warp = tid / 32;
  const int rb = warp >> 2, cq = warp & 3;
#pragma unroll
  for (int f = 0; f < D / 64; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int j0 = 0; j0 < Hd; j0 += HC) {
    __syncthreads();  // the previous chunk's readers are done
    copy_tile(p.W1s, S::LDH, w1e + int64_t(j0) * D, D, HC, HC, D, tid);
    copy_tile(p.W2s, S::LDW2, w2e + j0, Hd, D, D, HC, tid);
    __syncthreads();
    hidden_products<D>(p.Hs, p.Gs, p.W1s, p.W2s, p.Af, p.Gf, warp);
    __syncthreads();
    grad_pre<D>(p.Af, p.Gf, p.Db, b1e + j0, tid);
    __syncthreads();
    // dh[TM, D] += da[TM, HC] w1_chunk[HC, D]
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      ARow a;
      wmma::load_matrix_sync(a, p.Db + rb * 16 * S::LDB + kk * 16, S::LDB);
#pragma unroll
      for (int f = 0; f < D / 64; ++f) {
        BRow b;
        wmma::load_matrix_sync(
            b, p.W1s + kk * 16 * S::LDH + cq * (D / 4) + f * 16, S::LDH);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }
  __syncthreads();  // the staging may now overwrite the h, g and w1 tiles
}

// Stages the dh pass's accumulator as f32 [TM, D] (stride LDST) over the
// h, g and w1 tiles and returns it, visible to the whole CTA.
template <int D>
__device__ __forceinline__ float* stage_dh(unsigned char* smem,
                                           Acc (&acc)[D / 64]) {
  using S = BwdSmem<D>;
  float* St = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32, rb = warp >> 2, cq = warp & 3;
#pragma unroll
  for (int f = 0; f < D / 64; ++f)
    wmma::store_matrix_sync(St + rb * 16 * S::LDST + cq * (D / 4) + f * 16,
                            acc[f], S::LDST, wmma::mem_row_major);
  __syncthreads();
  return St;
}

// Token tiles [t0, t1) of split `s` of `ks` over ceil(Ct / TM) tiles.
__device__ __forceinline__ void split_range(int Ct, int s, int ks, int* t0,
                                            int* t1) {
  const int tiles = (Ct + TM - 1) / TM;
  *t0 = int(int64_t(tiles) * s / ks);
  *t1 = int(int64_t(tiles) * (s + 1) / ks);
}

// h tile of expert e from a token array [E, Ct, D] (K4).
template <int D>
struct CopyTokens {
  const bf16* h;
  int Ct;
  __device__ __forceinline__ void operator()(bf16* Hs, int e, int m0,
                                             int tid) const {
    copy_tile(Hs, BwdSmem<D>::LDH, h + (int64_t(e) * Ct + m0) * D, D, TM,
              Ct - m0, D, tid);
  }
};

// ---- dw1, db1: one CTA per (64-hidden tile, expert, token split) --------
// keeps its w1 rows and w2 columns in shared memory, walks its token range
// in TM-token tiles and accumulates dw1 rows += da^T h in registers, db1
// in a register per hidden unit.
template <int D, class TokLoad>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dw1_kernel(TokLoad load_h, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ gin, float* __restrict__ pw1,
                   float* __restrict__ pb1, int E, int Ct, int Hd, int ks) {
  using S = BwdSmem<D>;
  constexpr int NF = D / 32;  // dw1 fragments per warp (16 x D/2)
  extern __shared__ __align__(128) unsigned char smem[];
  const auto p = S::at(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int j0 = blockIdx.x * HC, e = blockIdx.y, s = blockIdx.z;
  const int rb = warp & 3, ch = warp >> 2;
  const bf16* ge = gin + int64_t(e) * Ct * D;
  copy_tile(p.W1s, S::LDH, w1 + (int64_t(e) * Hd + j0) * D, D, HC, HC, D,
            tid);
  copy_tile(p.W2s, S::LDW2, w2 + int64_t(e) * D * Hd + j0, Hd, D, D, HC, tid);
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
    load_h(p.Hs, e, m0, tid);
    copy_tile(p.Gs, S::LDH, ge + int64_t(m0) * D, D, TM, Ct - m0, D, tid);
    __syncthreads();
    hidden_products<D>(p.Hs, p.Gs, p.W1s, p.W2s, p.Af, p.Gf, warp);
    __syncthreads();
    grad_pre<D>(p.Af, p.Gf, p.Db, b1c, tid);
    __syncthreads();
    if (tid < HC)
      for (int r = 0; r < TM; ++r) db1 += p.Af[r * S::LDA + tid];
    // dw1[HC, D] += da^T[HC, TM] h[TM, D]
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk) {
      ACol a;
      wmma::load_matrix_sync(a, p.Db + kk * 16 * S::LDB + rb * 16, S::LDB);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        BRow b;
        wmma::load_matrix_sync(
            b, p.Hs + kk * 16 * S::LDH + ch * (D / 2) + f * 16, S::LDH);
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

// ---- dw2, db2: one CTA per (64-hidden tile, expert, token split) --------
// accumulates dw2 columns += g^T a (and, in the first hidden tile, db2).
template <int D, class TokLoad>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dw2_kernel(TokLoad load_h, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ gin,
                   float* __restrict__ pw2, float* __restrict__ pb2, int E,
                   int Ct, int Hd, int ks) {
  using S = BwdSmem<D>;
  constexpr int RB = D / 128;  // 16-row blocks of dw2 per warp
  constexpr int DB = (D + THREADS - 1) / THREADS;  // db2 columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const auto p = S::at(smem);
  // this pass needs no w2 or g w2: the a_pre and activation chunks sit
  // where the w2 columns would
  float* Af = reinterpret_cast<float*>(smem + 2 * S::tok + S::w1);
  bf16* Ab = reinterpret_cast<bf16*>(smem + 2 * S::tok + S::w1 + S::af);

  const int tid = threadIdx.x, warp = tid / 32;
  const int j0 = blockIdx.x * HC, e = blockIdx.y, s = blockIdx.z;
  const bool first = blockIdx.x == 0;  // this tile also sums db2
  const bf16* ge = gin + int64_t(e) * Ct * D;
  copy_tile(p.W1s, S::LDH, w1 + (int64_t(e) * Hd + j0) * D, D, HC, HC, D,
            tid);
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
    load_h(p.Hs, e, m0, tid);
    copy_tile(p.Gs, S::LDH, ge + int64_t(m0) * D, D, TM, Ct - m0, D, tid);
    __syncthreads();
    hidden_products<D>(p.Hs, nullptr, p.W1s, nullptr, Af, nullptr, warp);
    __syncthreads();
    // a = gelu(a_pre + b1) rounded to bf16
    for (int i = tid; i < TM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      Ab[r * S::LDB + c] = __float2bfloat16(gelu(Af[r * S::LDA + c] + b1c[c]));
    }
    __syncthreads();
    if (first) {
#pragma unroll
      for (int i = 0; i < DB; ++i) {
        const int c = tid + i * THREADS;
        if (c < D)
          for (int r = 0; r < TM; ++r)
            db2[i] += __bfloat162float(p.Gs[r * S::LDH + c]);
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
        wmma::load_matrix_sync(
            a, p.Gs + kk * 16 * S::LDH + (warp + 8 * i) * 16, S::LDH);
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

// Launches the dw1/db1 and dw2/db2 passes over (Hd / HC, E, ks) blocks and,
// when ks > 1, the fixed-order sums of their partials into dw1, db1, dw2
// and db2 (with ks == 1 the partials are the outputs themselves).
template <int D, class TokLoad>
cudaError_t launch_weight_grads(TokLoad load_h, const bf16* w1,
                                const float* b1, const bf16* w2,
                                const bf16* g, void* dw1, void* db1,
                                void* dw2, void* db2, void* pw1, void* pb1,
                                void* pw2, void* pb2, int E, int Ct, int Hd,
                                int ks, cudaStream_t stream) {
  const size_t bytes = BwdSmem<D>::bytes;
  cudaError_t err;
  if ((err = allow_smem(ffn_bwd_dw1_kernel<D, TokLoad>, bytes)) !=
          cudaSuccess ||
      (err = allow_smem(ffn_bwd_dw2_kernel<D, TokLoad>, bytes)) !=
          cudaSuccess)
    return err;
  const dim3 grid(Hd / HC, E, ks);
  ffn_bwd_dw1_kernel<D, TokLoad><<<grid, THREADS, bytes, stream>>>(
      load_h, w1, b1, w2, g, static_cast<float*>(pw1),
      static_cast<float*>(pb1), E, Ct, Hd, ks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ffn_bwd_dw2_kernel<D, TokLoad><<<grid, THREADS, bytes, stream>>>(
      load_h, w1, b1, g, static_cast<float*>(pw2), static_cast<float*>(pb2),
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

}  // namespace ffn
