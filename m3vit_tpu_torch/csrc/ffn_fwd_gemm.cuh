// The two-pass FFN forward of K3, K5 and K7 for the model widths whose
// [64, D] f32 output accumulator does not fit a consumer warpgroup's
// registers in the fused forward (ffn_fwd_wgmma.cuh): D = 768 and 1024
// (384 and 512 registers a thread against a limit of 255).  Per expert:
//   1. hidden pass: a = bf16(gelu(h w1^T + b1)) into an [E, Ct, Hd] bf16
//      scratch;
//   2. output pass: out = bf16(a w2^T + b2), or for K5
//      out = bf16(x + bf16(a w2^T + b2)) with the residual added in f32;
// both on the persistent TMA/mbarrier wgmma GEMM of the fused backward
// (ffn_bwd.cuh: two consumer warpgroups of 64 rows, 128 x 192 output
// tiles, a 4-stage ring of 64-deep K steps; the weights' torch layout
// [out, in] read K-major), with the fused forward's numerics: f32 sums,
// bias and the TPU kernel's erf GELU in f32, the hidden activation
// rounded to bf16 before the second product.  K5's LayerNorm runs first as
// the backward's pre-pass (ffn_common.cuh:ln_prepass_kernel) into a bf16
// [S, D] scratch.
//
// What it costs: the hidden activation crosses device memory once each
// way, 2 E Ct Hd bytes a way (63 MB at ViT-base's expert training shape,
// ~19 us at 3.35 TB/s against a ~98 us tensor-core bound), where the fused
// forward keeps it in registers.  A fused design for these widths (output
// columns split across the warpgroups, or across a 2-CTA cluster) is left
// for a later redesign.  No atomics: two runs give the same bits.

#pragma once

#include "ffn_bwd.cuh"

namespace ffn2p {

using ffnbwd::align256;
using ffnbwd::bf16;
using ffnbwd::cdiv;
using ffnbwd::GemmArgs;
using Gemm = ffnbwd::Gemm;

// The model widths that take this route.
__host__ __device__ constexpr bool wide(int D) { return D == 768 || D == 1024; }

// Bytes of the hidden activation a [E, Ct, Hd] bf16 this route needs.
inline size_t hidden_bytes(int E, int Ct, int Hd) {
  return align256(size_t(E) * Ct * Hd * 2);
}

inline int grid_for(const GemmArgs& args) {
  const int tiles = ffnbwd::gemm_tiles<Gemm>(args), sms = ffn::sm_count();
  return tiles < sms ? tiles : sms;
}

// h [E, Ct, D], w1 [E, Hd, D], w2 [E, D, Hd] bf16, b1 [E, Hd], b2 [E, D]
// f32, out [E, Ct, D] bf16; `residual` [E, Ct, D] bf16 or null; `a` holds
// hidden_bytes(E, Ct, Hd).  All contiguous and 16-byte aligned; D % 64 ==
// 0 and Hd % 64 == 0.
inline cudaError_t launch(const bf16* h, const bf16* w1, const float* b1,
                          const bf16* w2, const float* b2, bf16* out,
                          const bf16* residual, bf16* a, int E, int Ct,
                          int D, int Hd, cudaStream_t stream) {
  if (D % 64 || Hd % 64 || E < 1 || Ct < 1 || ffn::sm_count() < 1)
    return cudaErrorInvalidValue;
  CUtensorMap h_map, w1_map, a_map, w2_map;
  if (!hopper::make_tile_map<64>(&h_map, h, D, Ct, E) ||
      !hopper::make_tile_map<64>(&w1_map, w1, D, Hd, E) ||
      !hopper::make_tile_map<64>(&a_map, a, Hd, Ct, E) ||
      !hopper::make_tile_map<64>(&w2_map, w2, Hd, D, E))
    return cudaErrorInvalidValue;
  // a = bf16(gelu(h w1^T + b1)): M = tokens, N = Hd, K = D
  const GemmArgs hid{{{a, Ct, Hd}, {a, Ct, Hd}}, 1, E, D, 1, b1, nullptr};
  cudaError_t err =
      ffnbwd::launch_gemm<Gemm, 0, bf16, 0, ffnbwd::EPI_BIAS_GELU>(
          h_map, w1_map, h_map, w1_map, hid, grid_for(hid), stream);
  if (err != cudaSuccess) return err;
  // out = a w2^T + b2 (+ the residual): M = tokens, N = D, K = Hd
  const GemmArgs o{{{out, Ct, D}, {out, Ct, D}}, 1, E, Hd, 1, b2, residual};
  return residual
             ? ffnbwd::launch_gemm<Gemm, 0, bf16, 0,
                                   ffnbwd::EPI_BIAS_RESIDUAL>(
                   a_map, w2_map, a_map, w2_map, o, grid_for(o), stream)
             : ffnbwd::launch_gemm<Gemm, 0, bf16, 0, ffnbwd::EPI_BIAS>(
                   a_map, w2_map, a_map, w2_map, o, grid_for(o), stream);
}

}  // namespace ffn2p
