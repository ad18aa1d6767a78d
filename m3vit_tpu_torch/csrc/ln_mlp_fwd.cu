// Fused dense-block MLP sublayer forward for Hopper (sm_90a):
//   out = x + (gelu(LN(x; gamma, beta) @ w1^T + b1) @ w2^T + b2)
//
// Replaces the TPU kernel m3vit_tpu/ops/ln_mlp.py:_fwd_kernel (the
// pallas_call in _ln_mlp_forward, reached through fused_ln_mlp_residual by
// the dense blocks of a model built with use_pallas_ln_mlp; the port's knob
// is ln_mlp).  x [S, D] bf16 tokens, w1 [Hd, D] and w2 [D, Hd] bf16 in the
// torch layout, gamma, beta, b1, b2 f32.  Rounding points are the TPU
// kernel's: LayerNorm statistics in f32 (eps inside the rsqrt), the
// normalised tokens rounded to bf16 before the first product, the hidden
// activation (exact-erf GELU) rounded to bf16 before the second, the MLP
// output rounded to bf16 *before* the residual add, which is done in f32
// and rounded again: bitwise the unfused LayerNorm -> K3 -> bf16 add, as
// far as the f32 sums agree.
//
// What bounds it: at the flagship's dense blocks ([8200, 384] x hidden
// 1536) one launch does 19.3 GFLOP (4 S D Hd) on ~8 MB: the tensor cores
// bound it, and the fusion's point is that neither the normalised tokens
// nor the MLP output makes a round trip through device memory (the TPU
// kernel's reason too).  Design: K3's kernel at E=1 (ffn_fwd_wgmma.cuh:
// TMA/mbarrier weight ring, wgmma, a [64, D] f32 accumulator per consumer
// warpgroup over 128-token tiles) whose consumers normalise the TMA-loaded
// x tile in place before the first product, and whose epilogue adds the
// bf16-rounded MLP output to x, re-read from L2.

#include "ffn_fwd_wgmma.cuh"

// x [S, D] bf16, gamma/beta [D] f32, w1 [Hd, D] bf16, b1 [Hd] f32,
// w2 [D, Hd] bf16, b2 [D] f32, out [S, D] bf16, all contiguous and 16-byte
// aligned; Hd % 64 == 0.  Returns a cudaError_t; cudaErrorInvalidValue for
// a width not built or a tensor map the CUDA driver refuses.
extern "C" int ln_mlp_fwd(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, int S, int D, int Hd,
                          float eps, void* stream) {
  using namespace ffnfwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args args{static_cast<const float*>(b1), static_cast<const float*>(b2),
                  static_cast<bf16*>(out), static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), 1, S, Hd, eps};
  switch (D) {
    case 128: return int(launch<128, true>(x, w1, w2, args, s));
    case 384: return int(launch<384, true>(x, w1, w2, args, s));
    default: return int(cudaErrorInvalidValue);
  }
}
