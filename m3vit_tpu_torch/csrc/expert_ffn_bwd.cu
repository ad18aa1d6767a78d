// Fused per-expert FFN backward for Hopper (sm_90a), the VJP of
//   out[e] = gelu(h[e] @ w1[e]^T + b1[e]) @ w2[e]^T + b2[e].
//
// Replaces the TPU kernel m3vit_tpu/ops/expert_ffn.py:_ffn_bwd_kernel (the
// pallas_call in _ffn_backward, reached through fused_expert_ffn's VJP for
// the MoE expert banks and, at E=1, for the dense MLPs).  Weights come in
// the torch layout [E, out, in]: w1 [E, Hd, D], w2 [E, D, Hd]; b1 is f32.
// From the upstream gradient g it recomputes a_pre = h w1^T + b1 in f32
// and forms
//   a  = bf16(gelu(a_pre)),  da = bf16((g w2) * gelu'(a_pre))
//   dh = da w1 (bf16 out),  dw1 = da^T h,  db1 = sum da (unrounded),
//   dw2 = g^T a,            db2 = sum g     (all four f32 out)
// with every product on bf16 operands accumulating in f32.  cdf uses the
// exact erf (CUDA erff); the TPU kernel used the Abramowitz-Stegun 7.1.26
// rational form (|error| < 1.5e-7), far below the bf16 rounding of da.
//
// What bounds it: at the flagship expert shape (h [16, 2568, 384], hidden
// 384) the five products, 2*C*D*Hd each per expert, are 60.6 GFLOP on
// ~110 MB of inputs and outputs; the dense MLP (h [1, 8200, 384], hidden
// 1536) 48.4 GFLOP on ~20 MB.  Both sit far above the bf16 ridge: the
// tensor cores bound them.
//
// Design (ffn_bwd.cuh): a hidden pass computes h w1^T and g w2 with wgmma
// and writes a and da once, in bf16, to [E, Ct, Hd] scratch; dh, dw1 and
// dw2 are then plain GEMMs on a TMA/mbarrier ring (dw1 and dw2 in one
// launch, split over token ranges where E x output tiles leave SMs idle); the
// weight-gradient partials and the per-token-tile bias partials are summed
// in a fixed order.  Five products instead of the eight a design without
// the scratch needs; no atomics, so two runs give the same bits.  The
// passes are shared with K6 (ln_mlp_bwd.cu).

#include "ffn_bwd.cuh"

using namespace ffnbwd;

// Bytes of the scratch expert_ffn_bwd needs for these shapes and splits.
extern "C" long long expert_ffn_bwd_scratch(int E, int Ct, int D, int Hd,
                                            int ks) {
  return (long long)carve_core(nullptr, E, Ct, D, Hd, ks).bytes;
}

// h, g [E, Ct, D] bf16, w1 [E, Hd, D] bf16, b1 [E, Hd] f32, w2 [E, D, Hd]
// bf16; outputs dh [E, Ct, D] bf16, dw1 [E, Hd, D], db1 [E, Hd],
// dw2 [E, D, Hd], db2 [E, D] f32; `scratch` holds expert_ffn_bwd_scratch
// bytes; ks splits the weight gradients' token range; the hidden pass, dh
// and the weight gradients launch on the grids given; sms is the SM count
// (the sums' grid).  All contiguous and 16-byte aligned;
// D in {128, 192, 384, 768, 1024}, Hd % 64 == 0.  Returns a cudaError_t;
// cudaErrorInvalidValue for a shape not taken or a tensor map the CUDA
// driver refuses.
extern "C" int expert_ffn_bwd(const void* h, const void* w1, const void* b1,
                              const void* w2, const void* g, void* dh,
                              void* dw1, void* db1, void* dw2, void* db2,
                              void* scratch, int E, int Ct, int D, int Hd,
                              int ks, int hidden_grid, int dh_grid,
                              int weights_grid, int sms, void* stream) {
  const Grids grid{hidden_grid, dh_grid, weights_grid};
  if ((D != 128 && D != 192 && D != 384 && D != 768 && D != 1024) ||
      Hd % 64 != 0 || ks < 1 || E < 1 ||
      Ct < 1 || sms < 1 || !grid.valid())
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CoreScratch sc =
      carve_core(static_cast<uint8_t*>(scratch), E, Ct, D, Hd, ks);
  SumArgs sums{};
  const cudaError_t err = launch_core(
      static_cast<const bf16*>(h), static_cast<const bf16*>(g),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<bf16*>(dh),
      static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2), sc, E, Ct, D, Hd,
      ks, grid, &sums, s);
  if (err != cudaSuccess) return int(err);
  return int(sum_parts(sums, sms, s));
}
