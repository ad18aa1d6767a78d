// Fused dense-block MLP sublayer backward for Hopper (sm_90a), the VJP of
//   out = x + (gelu(h @ w1^T + b1) @ w2^T + b2),  h = bf16(LN(x; gamma, beta))
//
// Replaces the TPU kernel m3vit_tpu/ops/ln_mlp.py:_bwd_kernel (the
// pallas_call in _ln_mlp_backward, the VJP of fused_ln_mlp_residual).  From
// the upstream gradient gr it recomputes the LayerNorm and the hidden
// activations, nothing of the forward being saved but x:
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
// Design: a LayerNorm pre-pass, K4's five-product passes at E=1, and a dx
// pass, all on the same stream:
//   1. pre-pass: one CTA per 64 rows writes h = bf16(LN(x)) [S, D] with
//      ln_tile's f32 statistics (ffn_common.cuh) and each row's mean and
//      rstd (plain stores; the next launches read h by TMA);
//   2. K4's hidden pass, dh GEMM (f32 out), dw1/dw2 GEMM and fixed-order
//      sums (ffn_bwd.cuh) with h from the pre-pass and g = gr;
//   3. dx pass: one CTA per 64 rows, one warp per row, runs the per-row
//      LayerNorm backward on the f32 dh, adds gr and writes the tile's
//      column sums of dh*xhat and dh (dgamma, dbeta partials), which a last
//      fixed-order sum adds up.
// No atomics anywhere: the result does not depend on scheduling.

#include <type_traits>

#include "ffn_bwd.cuh"

using namespace ffnbwd;

namespace {

constexpr int TR = ffn::LN_ROWS;   // rows per CTA of the pre-pass and dx pass
using ffn::ln_prepass_kernel;

// dx and this tile's dgamma / dbeta partials [2, D], each column summed
// over the tile's rows warp by warp, then over the warps in order (dgamma's
// partials first, then dbeta's, through one [warps, D] buffer: 32 KB of
// static shared memory at D = 1024).  gamma is read where it is used, not
// held in registers beside the row's 4 D / 64 values and the 4 D / 64
// column sums a lane carries.
template <int D>
__global__ void __launch_bounds__(ffn::THREADS)
ln_dx_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
             const bf16* __restrict__ gr, const float* __restrict__ dh,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             bf16* __restrict__ dx, float* __restrict__ pgb, int S) {
  constexpr int PL = D / 64;  // column pairs per lane
  __shared__ float red[ffn::WARPS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * TR;
  float pg[2 * PL], pb[2 * PL];
#pragma unroll
  for (int i = 0; i < 2 * PL; ++i) pg[i] = pb[i] = 0.f;
  for (int r = warp; r < TR && m0 + r < S; r += ffn::WARPS) {
    const int64_t row = m0 + r;
    const float mu = mean[row], rs = rstd[row];
    float xh[2 * PL], d[2 * PL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = 2 * (lane + 32 * i);
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(x + row * D + c));
      const float2 dv = *reinterpret_cast<const float2*>(dh + row * D + c);
      const float2 gm = __ldg(reinterpret_cast<const float2*>(gamma + c));
      xh[2 * i] = (xv.x - mu) * rs;
      xh[2 * i + 1] = (xv.y - mu) * rs;
      d[2 * i] = dv.x;
      d[2 * i + 1] = dv.y;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float dhg = d[2 * i + k] * (k ? gm.y : gm.x);
        s1 += dhg;
        s2 += dhg * xh[2 * i + k];
        pg[2 * i + k] += d[2 * i + k] * xh[2 * i + k];
        pb[2 * i + k] += d[2 * i + k];
      }
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
          *reinterpret_cast<const __nv_bfloat162*>(gr + row * D + c));
      const float2 gm = __ldg(reinterpret_cast<const float2*>(gamma + c));
      *reinterpret_cast<__nv_bfloat162*>(dx + row * D + c) =
          __floats2bfloat162_rn(
              gv.x + rs * (d[2 * i] * gm.x - m1 - xh[2 * i] * m2),
              gv.y + rs * (d[2 * i + 1] * gm.y - m1 - xh[2 * i + 1] * m2));
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = 2 * (lane + 32 * i);
      red[warp][c] = k ? pb[2 * i] : pg[2 * i];
      red[warp][c + 1] = k ? pb[2 * i + 1] : pg[2 * i + 1];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += ffn::THREADS) {
      float sum = 0.f;
      for (int w = 0; w < ffn::WARPS; ++w) sum += red[w][c];
      pgb[(int64_t(blockIdx.x) * 2 + k) * D + c] = sum;
    }
    __syncthreads();   // red is written again (or the CTA ends)
  }
}

struct LnScratch {
  bf16* h;
  float *mean, *rstd, *dh, *pgb;
  CoreScratch core;
  size_t bytes;
};

LnScratch carve(uint8_t* base, int S, int D, int Hd, int ks) {
  LnScratch c{};
  size_t off = 0;
  auto take = [&](size_t n) {
    uint8_t* p = base ? base + off : nullptr;
    off += align256(n);
    return p;
  };
  c.h = reinterpret_cast<bf16*>(take(size_t(S) * D * 2));
  c.mean = reinterpret_cast<float*>(take(size_t(S) * 4));
  c.rstd = reinterpret_cast<float*>(take(size_t(S) * 4));
  c.dh = reinterpret_cast<float*>(take(size_t(S) * D * 4));
  c.pgb = reinterpret_cast<float*>(take(size_t(cdiv(S, TR)) * 2 * D * 4));
  c.core = carve_core(base ? base + off : nullptr, 1, S, D, Hd, ks);
  c.bytes = off + c.core.bytes;
  return c;
}

template <int D>
cudaError_t launch(const bf16* x, const float* gamma, const float* beta,
                   const bf16* w1, const float* b1, const bf16* w2,
                   const bf16* gr, bf16* dx, float* dgb, float* dw1,
                   float* db1, float* dw2, float* db2, const LnScratch& sc,
                   int S, int Hd, int ks, const Grids& grid, int sms,
                   float eps, cudaStream_t stream) {
  const int tiles = cdiv(S, TR);
  ln_prepass_kernel<D><<<tiles, ffn::THREADS, 0, stream>>>(
      x, gamma, beta, sc.h, sc.mean, sc.rstd, S, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  SumArgs sums{};
  if ((err = launch_core(sc.h, gr, w1, b1, w2, sc.dh, dw1, db1, dw2, db2,
                         sc.core, 1, S, D, Hd, ks, grid, &sums, stream)) !=
      cudaSuccess)
    return err;
  ln_dx_kernel<D><<<tiles, ffn::THREADS, 0, stream>>>(
      x, gamma, gr, sc.dh, sc.mean, sc.rstd, dx, sc.pgb, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sums.seg[sums.count++] = {sc.pgb, dgb, 2 * D, tiles};
  return sum_parts(sums, sms, stream);
}

}  // namespace

// Bytes of the scratch ln_mlp_bwd needs for these shapes and splits.
extern "C" long long ln_mlp_bwd_scratch(int S, int D, int Hd, int ks) {
  return (long long)carve(nullptr, S, D, Hd, ks).bytes;
}

// x, gr, dx [S, D] bf16; gamma, beta [D] f32; w1 [Hd, D] bf16, b1 [Hd] f32,
// w2 [D, Hd] bf16; outputs dgb [2, D] (dgamma, dbeta), dw1 [Hd, D],
// db1 [Hd], dw2 [D, Hd], db2 [D] f32; `scratch` holds ln_mlp_bwd_scratch
// bytes; ks splits the weight gradients' token range; the hidden pass, dh
// and the weight gradients launch on the grids given; sms is the SM count
// (the sums' grid).  All contiguous and 16-byte aligned;
// D in {128, 192, 384, 768, 1024}, Hd % 64 == 0.  Returns a
// cudaError_t; cudaErrorInvalidValue for a shape not taken.
extern "C" int ln_mlp_bwd(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* gr, void* dx, void* dgb, void* dw1,
                          void* db1, void* dw2, void* db2, void* scratch,
                          int S, int D, int Hd, int ks, int hidden_grid,
                          int dh_grid, int weights_grid, int sms, float eps,
                          void* stream) {
  const Grids grid{hidden_grid, dh_grid, weights_grid};
  if (Hd % 64 != 0 || ks < 1 || S < 1 || sms < 1 || !grid.valid())
    return int(cudaErrorInvalidValue);
  const LnScratch sc = carve(static_cast<uint8_t*>(scratch), S, D, Hd, ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto tag) {
    constexpr int DD = decltype(tag)::value;
    return launch<DD>(
        static_cast<const bf16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const bf16*>(gr), static_cast<bf16*>(dx),
        static_cast<float*>(dgb), static_cast<float*>(dw1),
        static_cast<float*>(db1), static_cast<float*>(dw2),
        static_cast<float*>(db2), sc, S, Hd, ks, grid, sms, eps, s);
  };
  switch (D) {
    case 128:
      return int(args(std::integral_constant<int, 128>{}));
    case 192:
      return int(args(std::integral_constant<int, 192>{}));
    case 384:
      return int(args(std::integral_constant<int, 384>{}));
    case 768:
      return int(args(std::integral_constant<int, 768>{}));
    case 1024:
      return int(args(std::integral_constant<int, 1024>{}));
    default:
      return int(cudaErrorInvalidValue);
  }
}
