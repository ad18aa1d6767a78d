// Fused per-expert FFN backward for Hopper (sm_90a), the VJP of
//   out[e] = gelu(h[e] @ w1[e]^T + b1[e]) @ w2[e]^T + b2[e].
//
// Replaces the TPU kernel m3vit_tpu/ops/expert_ffn.py:_ffn_bwd_kernel (the
// pallas_call in _ffn_backward, reached through fused_expert_ffn's VJP for
// the MoE expert banks and, at E=1, for the dense MLPs).  Weights come in
// the torch layout [E, out, in]: w1 [E, Hd, D], w2 [E, D, Hd]; b1 is f32.
// From the upstream gradient g it recomputes (remat) a_pre = h w1^T + b1
// in f32, cdf, pdf and a = gelu(a_pre) rounded to bf16, then
//   da = (g w2) * gelu'(a_pre)   rounded to bf16 (db1 sums it unrounded)
//   dh = da w1 (bf16 out),  dw1 = da^T h,  db1 = sum da,
//   dw2 = g^T a,            db2 = sum g     (all four f32 out)
// with every product on bf16 operands accumulating in f32.  cdf uses the
// exact erf (CUDA erff); the TPU kernel used the Abramowitz-Stegun 7.1.26
// rational form (|error| < 1.5e-7), so gelu' differs by at most ~1.5e-7,
// far below the bf16 rounding of da (2^-9 relative).
//
// What bounds it: at the flagship expert shape (h [16, 2568, 384], hidden
// 384) the backward needs 5 products of 2*C*D*Hd per expert, 60.6 GFLOP, on
// ~110 MB; the dense MLP (h [1, 8200, 384], hidden 1536) 48.4 GFLOP on
// ~20 MB.  Both sit far above the bf16 ridge: the tensor cores bound them,
// provided the [tokens, Hd] hidden activations never reach device memory.
//
// Design.  On the TPU the weight gradients accumulate in VMEM across the
// sequential token grid; here blocks run in parallel in no order, so the
// work is split deterministically (no atomics), and every pass recomputes
// what it needs of the hidden activations in shared memory:
//   1. dh pass: one CTA per (32-token tile, expert) walks Hd in 64-wide
//      chunks: a_pre and g w2 chunks, da, then dh += da w1 chunk in WMMA
//      accumulators (registers).
//   2. dw1/db1 pass: one CTA per (64-hidden tile, expert, token split)
//      keeps its w1 rows and w2 columns in shared memory, walks its token
//      range in 32-token tiles and accumulates dw1 rows += da^T h in
//      registers, db1 in a register per hidden unit.
//   3. dw2/db2 pass: one CTA per (64-hidden tile, expert, token split)
//      accumulates dw2 columns += g^T a (and, in the first hidden tile,
//      db2).
//   4. When the token range is split (to fill the card), the splits' f32
//      partials are summed in a fixed order by one last pass.
// That is 8 products of 2*C*D*Hd instead of 5: the price of keeping the
// hidden activations out of device memory without a sequential grid.
// Products run through WMMA bf16 16x16x16; no cp.async/TMA pipelining and
// no wgmma yet: simple and right first.  The token axis is only 8-aligned
// (capacity 2568 in training): rows past the end are zero-filled on load
// (zero h and g give zero da and zero g^T a) and never stored.  The passes
// are shared with K6 (ffn_bwd.cuh).

#include "ffn_bwd.cuh"

namespace {

using namespace ffn;

// ---- pass 1: dh ----------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dh_kernel(const bf16* __restrict__ hin, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ gin, bf16* __restrict__ dh, int Ct,
                  int Hd) {
  using S = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const auto p = S::at(smem);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM, e = blockIdx.y;

  copy_tile(p.Hs, S::LDH, hin + (int64_t(e) * Ct + m0) * D, D, TM, Ct - m0,
            D, tid);
  copy_tile(p.Gs, S::LDH, gin + (int64_t(e) * Ct + m0) * D, D, TM, Ct - m0,
            D, tid);
  Acc acc[D / 64];
  dh_loop<D>(smem, w1 + int64_t(e) * Hd * D, b1 + int64_t(e) * Hd,
             w2 + int64_t(e) * D * Hd, Hd, acc);
  const float* St = stage_dh<D>(smem, acc);
  bf16* dst = dh + (int64_t(e) * Ct + m0) * D;
  const int rows = min(TM, Ct - m0);
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[int64_t(r) * D + c] = __float2bfloat16(St[r * S::LDST + c]);
  }
}

template <int D>
cudaError_t launch(const void* h, const void* w1, const void* b1,
                   const void* w2, const void* g, void* dh, void* dw1,
                   void* db1, void* dw2, void* db2, void* pw1, void* pb1,
                   void* pw2, void* pb2, int E, int Ct, int Hd, int ks,
                   cudaStream_t stream) {
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const bf16* gp = static_cast<const bf16*>(g);
  const size_t bytes = BwdSmem<D>::bytes;
  cudaError_t err = allow_smem(ffn_bwd_dh_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  ffn_bwd_dh_kernel<D><<<dim3((Ct + TM - 1) / TM, E), THREADS, bytes,
                         stream>>>(hp, w1p, b1p, w2p, gp,
                                   static_cast<bf16*>(dh), Ct, Hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_weight_grads<D>(CopyTokens<D>{hp, Ct}, w1p, b1p, w2p, gp, dw1,
                                db1, dw2, db2, pw1, pb1, pw2, pb2, E, Ct, Hd,
                                ks, stream);
}

}  // namespace

// h, g [E, Ct, D] bf16, w1 [E, Hd, D] bf16, b1 [E, Hd] f32, w2 [E, D, Hd]
// bf16; outputs dh [E, Ct, D] bf16, dw1 [E, Hd, D], db1 [E, Hd],
// dw2 [E, D, Hd], db2 [E, D] f32; pw1/pb1/pw2/pb2 are [ks, ...] f32 partials
// of those four (the outputs themselves when ks == 1).  All contiguous;
// Hd % 64 == 0.  Returns a cudaError_t; cudaErrorInvalidValue for a width
// not built.
extern "C" int expert_ffn_bwd(const void* h, const void* w1, const void* b1,
                              const void* w2, const void* g, void* dh,
                              void* dw1, void* db1, void* dw2, void* db2,
                              void* pw1, void* pb1, void* pw2, void* pb2,
                              int E, int Ct, int D, int Hd, int ks,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd % HC != 0 || ks < 1) return int(cudaErrorInvalidValue);
  switch (D) {
    case 128:
      return launch<128>(h, w1, b1, w2, g, dh, dw1, db1, dw2, db2, pw1, pb1,
                         pw2, pb2, E, Ct, Hd, ks, s);
    case 384:
      return launch<384>(h, w1, b1, w2, g, dh, dw1, db1, dw2, db2, pw1, pb1,
                         pw2, pb2, E, Ct, Hd, ks, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
