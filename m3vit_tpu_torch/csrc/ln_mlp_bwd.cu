// Fused dense-block MLP sublayer backward for Hopper (sm_90a), the VJP of
//   out = x + (gelu(h @ w1^T + b1) @ w2^T + b2),  h = bf16(LN(x; gamma, beta))
//
// Replaces the TPU kernel m3vit_tpu/ops/ln_mlp.py:_bwd_kernel (the
// pallas_call in _ln_mlp_backward, the VJP of fused_ln_mlp_residual).  From
// the upstream gradient gr it recomputes (remat) the LayerNorm and the
// hidden activations, nothing of the forward being saved but x:
//   da = (gr w2) * gelu'(a_pre)  rounded to bf16 (db1 sums it unrounded)
//   dh = da w1 in f32, the full D-wide row
//   dx = bf16(gr + rstd * (dh*gamma - mean(dh*gamma)
//                          - xhat * mean(dh*gamma*xhat)))
//   dgamma = sum dh * xhat,  dbeta = sum dh,  dw1 = da^T h,  db1 = sum da,
//   dw2 = gr^T a,  db2 = sum gr                       (all f32 out)
// with the TPU kernel's rounding points and every product on bf16 operands
// accumulating in f32.  The GELU uses the exact erf (CUDA erff; the TPU
// kernel's Abramowitz-Stegun form is within 1.5e-7 of it).
//
// What bounds it: at the flagship's dense blocks ([8200, 384] x hidden
// 1536) the VJP needs 5 products of 2 S D Hd, 48.4 GFLOP, on ~12 MB: the
// tensor cores bound it.
//
// Design.  The TPU kernel walks the tokens as a sequential grid and adds
// each block's weight gradients into resident outputs; CUDA blocks run in
// no order, so this follows K4 (ffn_bwd.cuh), with the token tiles' h
// recomputed as bf16(LN(x)) wherever K4 would read h:
//   1. dx pass: one CTA per 32-token tile normalises its rows (keeping each
//      row's mean and rstd), walks Hd in 64-wide chunks to accumulate the
//      full-row f32 dh in WMMA fragments, then runs the per-row LayerNorm
//      backward (two row means by warp shuffles) and adds gr; it also
//      writes the tile's column sums of dh*xhat and dh (dgamma, dbeta
//      partials), summed over rows in a fixed order.
//   2. the weight-gradient passes of K4 at E=1 over token splits, and the
//      fixed-order sums of their partials;
//   3. the fixed-order sum of the dx pass's per-tile dgamma/dbeta partials.
// No atomics anywhere: the result does not depend on scheduling.  8
// products of 2 S D Hd instead of 5, the price of keeping the [S, Hd]
// hidden activations out of device memory; no wgmma or TMA yet.

#include "ffn_bwd.cuh"

namespace {

using namespace ffn;

// h tile = bf16(LN(x)) rows m0..m0+TM of x [S, D].
template <int D>
struct LnTokens {
  const bf16* x;
  const float* gamma;
  const float* beta;
  float eps;
  int S;
  __device__ __forceinline__ void operator()(bf16* Hs, int, int m0,
                                             int tid) const {
    ln_tile<D>(Hs, BwdSmem<D>::LDH, x + int64_t(m0) * D, TM, S - m0, gamma,
               beta, eps, nullptr, nullptr, tid);
  }
};

template <int D>
struct DxSmem {
  using B = BwdSmem<D>;
  // after the hidden loop: dh staging, then xhat, both f32 [TM, LDST]
  static constexpr size_t st = size_t(TM) * B::LDST * sizeof(float);
  static_assert(2 * st <= B::bytes, "dh and xhat staging do not fit");
  static constexpr size_t stats = B::bytes;  // mean[TM], rstd[TM]
  static constexpr size_t bytes = B::bytes + 2 * TM * sizeof(float);
};

// ---- pass 1: dx and the dgamma/dbeta partials ----------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_bwd_dx_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const bf16* __restrict__ gr,
                     bf16* __restrict__ dx, float* __restrict__ pgb, int S,
                     int Hd, float eps) {
  using B = BwdSmem<D>;
  using X = DxSmem<D>;
  constexpr int PL = D / 64;  // column pairs per lane
  extern __shared__ __align__(128) unsigned char smem[];
  const auto p = B::at(smem);
  float* mean = reinterpret_cast<float*>(smem + X::stats);
  float* rstd = mean + TM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * TM;
  const int rows = min(TM, S - m0);
  const bf16* xt = x + int64_t(m0) * D;
  const bf16* gt = gr + int64_t(m0) * D;

  ln_tile<D>(p.Hs, B::LDH, xt, TM, rows, gamma, beta, eps, mean, rstd, tid);
  copy_tile(p.Gs, B::LDH, gt, D, TM, rows, D, tid);
  Acc acc[D / 64];
  dh_loop<D>(smem, w1, b1, w2, Hd, acc);
  const float* St = stage_dh<D>(smem, acc);
  float* Xh = reinterpret_cast<float*>(smem + X::st);

  // LayerNorm backward per row (one warp per row)
  for (int r = warp; r < TM; r += WARPS) {
    if (r >= rows) {
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int c = 2 * (lane + 32 * i);
        Xh[r * B::LDST + c] = Xh[r * B::LDST + c + 1] = 0.f;
      }
      continue;
    }
    const float mu = mean[r], rs = rstd[r];
    float xh[2 * PL], dhg[2 * PL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = 2 * (lane + 32 * i);
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xt + int64_t(r) * D + c));
      xh[2 * i] = (xv.x - mu) * rs;
      xh[2 * i + 1] = (xv.y - mu) * rs;
      dhg[2 * i] = St[r * B::LDST + c] * gamma[c];
      dhg[2 * i + 1] = St[r * B::LDST + c + 1] * gamma[c + 1];
      s1 += dhg[2 * i] + dhg[2 * i + 1];
      s2 += dhg[2 * i] * xh[2 * i] + dhg[2 * i + 1] * xh[2 * i + 1];
      Xh[r * B::LDST + c] = xh[2 * i];
      Xh[r * B::LDST + c + 1] = xh[2 * i + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / D, m2 = s2 / D;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = 2 * (lane + 32 * i);
      const float2 gv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(gt + int64_t(r) * D + c));
      *reinterpret_cast<__nv_bfloat162*>(dx + int64_t(m0 + r) * D + c) =
          __floats2bfloat162_rn(
              gv.x + rs * (dhg[2 * i] - m1 - xh[2 * i] * m2),
              gv.y + rs * (dhg[2 * i + 1] - m1 - xh[2 * i + 1] * m2));
    }
  }
  __syncthreads();

  // this tile's dgamma / dbeta partials: column sums over its rows, in
  // row order
  float* dst = pgb + int64_t(blockIdx.x) * 2 * D;
  for (int c = tid; c < D; c += THREADS) {
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < TM; ++r) {
      const float d = St[r * B::LDST + c];
      dg += d * Xh[r * B::LDST + c];
      db += d;
    }
    dst[c] = dg;
    dst[D + c] = db;
  }
}

template <int D>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   const void* w1, const void* b1, const void* w2,
                   const void* gr, void* dx, void* dgb, void* dw1, void* db1,
                   void* dw2, void* db2, void* pgb, void* pw1, void* pb1,
                   void* pw2, void* pb2, int S, int Hd, int ks, float eps,
                   cudaStream_t stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const bf16* grp = static_cast<const bf16*>(gr);
  const int tiles = (S + TM - 1) / TM;
  cudaError_t err = allow_smem(ln_mlp_bwd_dx_kernel<D>, DxSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  ln_mlp_bwd_dx_kernel<D><<<tiles, THREADS, DxSmem<D>::bytes, stream>>>(
      xp, gp, bp, w1p, b1p, w2p, grp, static_cast<bf16*>(dx),
      static_cast<float*>(pgb), S, Hd, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_weight_grads<D>(LnTokens<D>{xp, gp, bp, eps, S}, w1p, b1p,
                                    w2p, grp, dw1, db1, dw2, db2, pw1, pb1,
                                    pw2, pb2, 1, S, Hd, ks, stream)) !=
      cudaSuccess)
    return err;
  return sum_splits(pgb, dgb, 2 * D, tiles, stream);
}

}  // namespace

// x, gr, dx [S, D] bf16; gamma, beta [D] f32; w1 [Hd, D] bf16, b1 [Hd] f32,
// w2 [D, Hd] bf16; outputs dgb [2, D] (dgamma, dbeta), dw1 [Hd, D],
// db1 [Hd], dw2 [D, Hd], db2 [D] f32; pgb [ceil(S/32), 2, D] f32 scratch
// for the per-tile dgamma/dbeta partials; pw1/pb1/pw2/pb2 are [ks, ...]
// f32 partials of the weight gradients (the outputs themselves when
// ks == 1).  All contiguous; Hd % 64 == 0.  Returns a cudaError_t;
// cudaErrorInvalidValue for a width not built.
extern "C" int ln_mlp_bwd(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* gr, void* dx, void* dgb, void* dw1,
                          void* db1, void* dw2, void* db2, void* pgb,
                          void* pw1, void* pb1, void* pw2, void* pb2, int S,
                          int D, int Hd, int ks, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd % HC != 0 || ks < 1) return int(cudaErrorInvalidValue);
  switch (D) {
    case 128:
      return launch<128>(x, gamma, beta, w1, b1, w2, gr, dx, dgb, dw1, db1,
                         dw2, db2, pgb, pw1, pb1, pw2, pb2, S, Hd, ks, eps, s);
    case 384:
      return launch<384>(x, gamma, beta, w1, b1, w2, gr, dx, dgb, dw1, db1,
                         dw2, db2, pgb, pw1, pb1, pw2, pb2, S, Hd, ks, eps, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
