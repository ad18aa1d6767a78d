// Fused per-expert FFN forward for Hopper (sm_90a):
//   out[e] = gelu(h[e] @ w1[e]^T + b1[e]) @ w2[e]^T + b2[e]
//
// Replaces the TPU kernel m3vit_tpu/ops/expert_ffn.py:_ffn_kernel (the
// pallas_call in _ffn_forward, reached through fused_expert_ffn for the MoE
// expert banks and through fused_dense_mlp at E=1 for the dense MLPs).
// Weights come in the torch layout [E, out, in]: w1 [E, Hd, D],
// w2 [E, D, Hd]; biases are f32.  GELU is the exact erf form in f32 (CUDA
// erff, within the Abramowitz-Stegun bound the TPU kernel used), the hidden
// activation is rounded to bf16 before the second product, and both
// products accumulate in f32.
//
// What bounds it: at the flagship expert shape ([16, 4104, 384] x 384) one
// launch does 38.7 GFLOP on ~110 MB (~350 FLOP per byte), and the dense MLP
// ([1, 8200, 384] x 1536) 19.3 GFLOP on ~15 MB: both sit above the H100's
// bf16 ridge, so the tensor cores bound them, provided the [tokens, Hd]
// hidden activation never goes to device memory.  Each CTA streams its
// expert's weights from L2 once per 128-token tile (M = 128 FLOP per weight
// byte), which keeps L2 traffic about half that of 64-token tiles.
//
// Design (ffn_fwd_wgmma.cuh, shared with K5): a persistent warp-specialised
// kernel; a producer warpgroup keeps a TMA/mbarrier ring of weight boxes
// filled, two consumer warpgroups hold a [64, D] f32 accumulator each and
// run S = h w1^T (wgmma from shared memory), GELU in registers and
// O += a w2^T (wgmma with a from registers) over 64-unit hidden chunks.
// The token axis is only 8-aligned (capacity 4104, 2568, 520, ...): TMA
// fills rows past Ct with zeros, and they are never stored.

// Widths: D in {128, 192, 384} run the fused forward above; D in {768,
// 1024}, whose [64, D] f32 accumulator does not fit a warpgroup's
// registers, run the two-pass route (ffn_fwd_gemm.cuh): the hidden
// activation goes through a bf16 scratch the wrapper allocates per call.

#include "ffn_fwd_gemm.cuh"
#include "ffn_fwd_wgmma.cuh"

// Bytes of scratch expert_ffn_fwd needs: none on the fused route, the
// hidden activation [E, Ct, Hd] bf16 on the two-pass route.
extern "C" long long expert_ffn_fwd_scratch(int E, int Ct, int D, int Hd) {
  return ffn2p::wide(D) ? (long long)ffn2p::hidden_bytes(E, Ct, Hd) : 0;
}

// h [E, Ct, D] bf16, w1 [E, Hd, D] bf16, b1 [E, Hd] f32, w2 [E, D, Hd] bf16,
// b2 [E, D] f32, out [E, Ct, D] bf16, scratch of expert_ffn_fwd_scratch
// bytes (null when that is 0), all contiguous and 16-byte aligned;
// Hd % 64 == 0.  Returns a cudaError_t; cudaErrorInvalidValue for a width
// not built or a tensor map the CUDA driver refuses.
extern "C" int expert_ffn_fwd(const void* h, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out,
                              void* scratch, int E, int Ct, int D, int Hd,
                              void* stream) {
  using namespace ffnfwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ffn2p::wide(D))
    return int(ffn2p::launch(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<bf16*>(out), nullptr,
        static_cast<bf16*>(scratch), E, Ct, D, Hd, s));
  const Args args{static_cast<const float*>(b1), static_cast<const float*>(b2),
                  static_cast<bf16*>(out), nullptr, nullptr, E, Ct, Hd, 0.f};
  switch (D) {
    case 128: return int(launch<128, false>(h, w1, w2, args, s));
    case 192: return int(launch<192, false>(h, w1, w2, args, s));
    case 384: return int(launch<384, false>(h, w1, w2, args, s));
    default: return int(cudaErrorInvalidValue);
  }
}
