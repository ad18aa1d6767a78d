// Pieces shared by the fused FFN kernels (expert_ffn_fwd/bwd,
// expert_ffn_q_fwd, ln_mlp_fwd/bwd): the CTA shape, 16-byte tile copies,
// the f32 LayerNorm prologue and the fixed-order sum of split partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace ffn {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HC = 64;  // hidden units per chunk / tile
constexpr float SQRT1_2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

// Exact-erf GELU in f32 (the TPU kernels use the Abramowitz-Stegun 7.1.26
// erf, |error| < 1.5e-7, far below the bf16 rounding that follows).
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * SQRT1_2));
}

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

// out[i] = sum over splits s of parts[s * n + i], in split order: the
// deterministic reduction of per-split f32 partials.
__global__ void sum_splits_kernel(const float* __restrict__ parts,
                                  float* __restrict__ out, int64_t n, int ks) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < ks; ++s) acc += parts[int64_t(s) * n + i];
    out[i] = acc;
  }
}

inline cudaError_t sum_splits(const void* parts, void* out, int64_t n, int ks,
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

}  // namespace ffn
