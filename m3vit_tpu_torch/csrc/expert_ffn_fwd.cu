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
// hidden activation never goes to device memory.  Design: one CTA per
// (64-token tile, expert) keeps its [64, D] token tile in shared memory and
// its [64, D] f32 output accumulator in registers (WMMA fragments, 8 warps
// of 16 rows x D/2 columns), and walks Hd in 64-wide chunks: a = h w1^T
// chunk (+ b1, GELU) goes to shared memory only, then acc += a w2^T chunk.
// Products run through WMMA bf16 16x16x16.  No cp.async/TMA double
// buffering and no wgmma yet: simple and right first.  The hidden loop is
// shared with K5 and K7 (ffn_fwd.cuh).
//
// The token axis is only 8-aligned (capacity 4104, 520, ...): rows past the
// end are zero-filled on load and never stored, with no padding copy.

#include "ffn_fwd.cuh"

namespace {

using namespace ffn;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
expert_ffn_fwd_kernel(const bf16* __restrict__ hin,
                      const bf16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2,
                      const float* __restrict__ b2, bf16* __restrict__ out,
                      int Ct, int Hd) {
  using S = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, e = blockIdx.y;

  copy_tile(S::tokens(smem), S::LDH, hin + (int64_t(e) * Ct + m0) * D, D, BM,
            Ct - m0, D, tid);
  Acc acc[D / 32];
  hidden_loop<D>(smem, Hd, b1 + int64_t(e) * Hd,
                 LoadWBf16<D>{w1 + int64_t(e) * Hd * D,
                              w2 + int64_t(e) * D * Hd, Hd},
                 acc);
  const float* St = stage<D>(smem, acc);

  const float* b2e = b2 + int64_t(e) * D;
  bf16* oute = out + (int64_t(e) * Ct + m0) * D;
  const int rows = min(BM, Ct - m0);
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    oute[int64_t(r) * D + c] = __float2bfloat16(St[r * S::LDST + c] + b2e[c]);
  }
}

template <int D>
cudaError_t launch(const void* h, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int E, int Ct,
                   int Hd, cudaStream_t stream) {
  const size_t bytes = FwdSmem<D>::bytes;
  cudaError_t err = allow_smem(expert_ffn_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Ct + BM - 1) / BM, E);
  expert_ffn_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), Ct, Hd);
  return cudaGetLastError();
}

}  // namespace

// h [E, Ct, D] bf16, w1 [E, Hd, D] bf16, b1 [E, Hd] f32, w2 [E, D, Hd] bf16,
// b2 [E, D] f32, out [E, Ct, D] bf16, all contiguous; Hd % 64 == 0.
// Returns a cudaError_t; cudaErrorInvalidValue for a width not built.
extern "C" int expert_ffn_fwd(const void* h, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out, int E,
                              int Ct, int D, int Hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd % HC != 0) return int(cudaErrorInvalidValue);
  switch (D) {
    case 128: return launch<128>(h, w1, b1, w2, b2, out, E, Ct, Hd, s);
    case 384: return launch<384>(h, w1, b1, w2, b2, out, E, Ct, Hd, s);
    default: return int(cudaErrorInvalidValue);
  }
}
