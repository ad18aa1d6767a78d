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
// kernel's reason too).  Design: K3 at E=1 (ffn_fwd.cuh: one CTA per
// 64-token tile holding whole D-wide rows, the [64, D] f32 accumulator in
// WMMA fragments, the hidden axis in 64-wide chunks) with a LayerNorm
// prologue (one warp per row writes bf16 h into the token tile) and a
// residual epilogue that re-reads x from L2.

#include "ffn_fwd.cuh"

namespace {

using namespace ffn;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, bf16* __restrict__ out, int S,
                  int Hd, float eps) {
  using Sm = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const bf16* xt = x + int64_t(m0) * D;

  ln_tile<D>(Sm::tokens(smem), Sm::LDH, xt, BM, S - m0, gamma, beta, eps,
             nullptr, nullptr, tid);
  Acc acc[D / 32];
  hidden_loop<D>(smem, Hd, b1, LoadWBf16<D>{w1, w2, Hd}, acc);
  const float* St = stage<D>(smem, acc);

  bf16* ot = out + int64_t(m0) * D;
  const int rows = min(BM, S - m0);
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const float o = __bfloat162float(
        __float2bfloat16(St[r * Sm::LDST + c] + b2[c]));
    ot[int64_t(r) * D + c] =
        __float2bfloat16(__bfloat162float(xt[int64_t(r) * D + c]) + o);
  }
}

template <int D>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int S, int Hd, float eps,
                   cudaStream_t stream) {
  const size_t bytes = FwdSmem<D>::bytes;
  cudaError_t err = allow_smem(ln_mlp_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  ln_mlp_fwd_kernel<D><<<(S + BM - 1) / BM, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), S, Hd, eps);
  return cudaGetLastError();
}

}  // namespace

// x [S, D] bf16, gamma/beta [D] f32, w1 [Hd, D] bf16, b1 [Hd] f32,
// w2 [D, Hd] bf16, b2 [D] f32, out [S, D] bf16, all contiguous;
// Hd % 64 == 0.  Returns a cudaError_t; cudaErrorInvalidValue for a width
// not built.
extern "C" int ln_mlp_fwd(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, int S, int D, int Hd,
                          float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd % HC != 0) return int(cudaErrorInvalidValue);
  switch (D) {
    case 128:
      return launch<128>(x, gamma, beta, w1, b1, w2, b2, out, S, Hd, eps, s);
    case 384:
      return launch<384>(x, gamma, beta, w1, b1, w2, b2, out, S, Hd, eps, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
