// Pieces shared by the fused FFN kernels (expert_ffn_fwd/bwd,
// expert_ffn_q_fwd, ln_mlp_fwd/bwd): the LayerNorm passes' CTA shape, the
// f32 LayerNorm prologue and its pre-pass kernel, the forward's GELU, the
// SM count and the dynamic shared-memory opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ffn {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float SQRT1_2 = 0.70710678118654752f;
constexpr int LN_ROWS = 64;   // rows per CTA of the LayerNorm passes

// GELU with the TPU kernel's erf (m3vit_tpu/ops/expert_ffn.py:_erf_approx,
// Abramowitz-Stegun 7.1.26, |error| < 1.5e-7) on the hardware reciprocal
// and exp2: 0.5 x (1 + sign(x) erf(|x| / sqrt 2)), in f32.  Both forward
// routes (ffn_fwd_wgmma.cuh, ffn_fwd_gemm.cuh) apply it.
__device__ __forceinline__ float gelu(float x) {
  const float z = fabsf(x) * SQRT1_2;
  const float t = __fdividef(1.f, fmaf(0.3275911f, z, 1.f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f),
                               1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float erf_z = 1.f - poly * __expf(-z * z);
  const float half = 0.5f * x;
  return x >= 0.f ? half + half * erf_z : half - half * erf_z;
}

// LayerNorm of `rows` token rows of x [.., D] (row stride D) into a bf16
// shared tile: h = bf16((x - mean) * rstd * gamma + beta), the statistics
// in f32 as the TPU kernel's _ln_rows (two-pass variance, eps inside the
// rsqrt).  One warp per row, two columns per lane per step; rows >=
// rows_valid are zero.  When `mean`/`rstd` are given they receive each
// row's statistics (0 and 1 for rows past the end).
template <int D>
__device__ __forceinline__ void ln_tile(bf16* dst, int ldd, const bf16* x,
                                        int rows, int rows_valid,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        float eps, float* mean, float* rstd,
                                        int tid) {
  constexpr int PL = D / 64;  // column pairs per lane
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += WARPS) {
    bf16* drow = dst + r * ldd;
    if (r >= rows_valid) {
#pragma unroll
      for (int i = 0; i < PL; ++i)
        *reinterpret_cast<__nv_bfloat162*>(drow + 2 * (lane + 32 * i)) =
            __floats2bfloat162_rn(0.f, 0.f);
      if (mean != nullptr && lane == 0) {
        mean[r] = 0.f;
        rstd[r] = 1.f;
      }
      continue;
    }
    float2 v[PL];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      v[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          x + int64_t(r) * D + 2 * (lane + 32 * i)));
      s += v[i].x + v[i].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      v[i].x -= mu;
      v[i].y -= mu;
      q += v[i].x * v[i].x + v[i].y * v[i].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rs = rsqrtf(q / D + eps);
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = 2 * (lane + 32 * i);
      *reinterpret_cast<__nv_bfloat162*>(drow + c) = __floats2bfloat162_rn(
          v[i].x * rs * gamma[c] + beta[c],
          v[i].y * rs * gamma[c + 1] + beta[c + 1]);
    }
    if (mean != nullptr && lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// h = bf16(LN(x)) [S, D] for LN_ROWS rows a CTA, with each row's mean and
// rstd when `mean` is given (K6's pre-pass; K5's two-pass route without
// them).  Plain stores: the next launches read h by TMA.
template <int D>
__global__ void __launch_bounds__(THREADS)
ln_prepass_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ h,
                  float* __restrict__ mean, float* __restrict__ rstd, int S,
                  float eps) {
  const int m0 = blockIdx.x * LN_ROWS, rows = min(LN_ROWS, S - m0);
  ln_tile<D>(h + int64_t(m0) * D, D, x + int64_t(m0) * D, rows, rows, gamma,
             beta, eps, mean ? mean + m0 : nullptr,
             rstd ? rstd + m0 : nullptr, threadIdx.x);
}

// The SM count of the current device, read once per device.
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace ffn
