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

// Widths: D in {128, 192, 384} run the fused kernel above; D in {768,
// 1024} the two-pass route (ffn_fwd_gemm.cuh): the LayerNorm pre-pass
// writes h = bf16(LN(x)) [S, D] to a scratch, the hidden pass a [S, Hd]
// bf16 to another, and the output pass adds x in f32 in its epilogue.

#include "ffn_fwd_gemm.cuh"
#include "ffn_fwd_wgmma.cuh"

namespace {

// The two-pass route's scratch: h [S, D], then a [S, Hd], bf16.
size_t h_bytes(int S, int D) { return ffn2p::align256(size_t(S) * D * 2); }

template <int D>
cudaError_t launch_two_pass(const void* x, const float* gamma,
                            const float* beta, const void* w1,
                            const float* b1, const void* w2, const float* b2,
                            void* out, void* scratch, int S, int Hd,
                            float eps, cudaStream_t s) {
  using ffn2p::bf16;
  bf16* h = static_cast<bf16*>(scratch);
  bf16* a = reinterpret_cast<bf16*>(static_cast<uint8_t*>(scratch) +
                                    h_bytes(S, D));
  ffn::ln_prepass_kernel<D><<<ffn2p::cdiv(S, ffn::LN_ROWS), ffn::THREADS, 0,
                              s>>>(static_cast<const bf16*>(x), gamma, beta,
                                   h, nullptr, nullptr, S, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ffn2p::launch(h, static_cast<const bf16*>(w1), b1,
                       static_cast<const bf16*>(w2), b2,
                       static_cast<bf16*>(out), static_cast<const bf16*>(x),
                       a, 1, S, D, Hd, s);
}

}  // namespace

// Bytes of scratch ln_mlp_fwd needs: none on the fused route; h and the
// hidden activation on the two-pass route.
extern "C" long long ln_mlp_fwd_scratch(int S, int D, int Hd) {
  return ffn2p::wide(D)
             ? (long long)(h_bytes(S, D) + ffn2p::hidden_bytes(1, S, Hd))
             : 0;
}

// x [S, D] bf16, gamma/beta [D] f32, w1 [Hd, D] bf16, b1 [Hd] f32,
// w2 [D, Hd] bf16, b2 [D] f32, out [S, D] bf16, scratch of
// ln_mlp_fwd_scratch bytes (null when that is 0), all contiguous and
// 16-byte aligned; Hd % 64 == 0.  Returns a cudaError_t;
// cudaErrorInvalidValue for a width not built or a tensor map the CUDA
// driver refuses.
extern "C" int ln_mlp_fwd(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, void* scratch, int S,
                          int D, int Hd, float eps, void* stream) {
  using namespace ffnfwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *g = static_cast<const float*>(gamma),
              *be = static_cast<const float*>(beta),
              *fb1 = static_cast<const float*>(b1),
              *fb2 = static_cast<const float*>(b2);
  if (D == 768)
    return int(launch_two_pass<768>(x, g, be, w1, fb1, w2, fb2, out, scratch,
                                    S, Hd, eps, s));
  if (D == 1024)
    return int(launch_two_pass<1024>(x, g, be, w1, fb1, w2, fb2, out,
                                     scratch, S, Hd, eps, s));
  const Args args{fb1, fb2, static_cast<bf16*>(out), g, be, 1, S, Hd, eps};
  switch (D) {
    case 128: return int(launch<128, true>(x, w1, w2, args, s));
    case 192: return int(launch<192, true>(x, w1, w2, args, s));
    case 384: return int(launch<384, true>(x, w1, w2, args, s));
    default: return int(cudaErrorInvalidValue);
  }
}
