// Pieces shared by the fused FFN kernels (expert_ffn_fwd/bwd,
// expert_ffn_q_fwd, ln_mlp_fwd/bwd): the LayerNorm passes' CTA shape and
// f32 LayerNorm prologue, and the dynamic shared-memory opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ffn {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float SQRT1_2 = 0.70710678118654752f;

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

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace ffn
