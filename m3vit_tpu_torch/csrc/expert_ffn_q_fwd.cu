// Fused per-expert FFN forward on weight-only int8 expert banks, for
// Hopper (sm_90a):
//   out[e] = gelu(h[e] @ W1[e]^T + b1[e]) @ W2[e]^T + b2[e],
//   W1[e][j, :] = bf16(q1[e][j, :] * s1[e][j]),
//   W2[e][i, :] = bf16(q2[e][i, :] * s2[e][i])
//
// Replaces the TPU kernel m3vit_tpu/ops/expert_ffn.py:_ffn_q_kernel (the
// pallas_call in quantized_expert_ffn, reached by the MoE blocks of a model
// built with expert_weights_int8).  Inference only: there is no backward.
// Weights come in the torch layout [E, out, in]: q1 [E, Hd, D] and
// q2 [E, D, Hd] int8, with one f32 scale per (expert, out channel), that is
// per row of either bank: s1 [E, Hd], s2 [E, D].  Each weight is
// dequantized in f32 and rounded to bf16 before its product, as the TPU
// kernel and the plain version round it; then the products, the exact-erf
// GELU and the roundings are K3's (ffn_fwd.cuh).
//
// What bounds it: at the flagship's bucket-8 serving shape
// ([16, 4104, 384] x 384) one launch does 38.7 GFLOP on ~105 MB: the
// tensor cores bound it, as they bound K3.  At bucket 1 ([16, 520, 384])
// it does 4.9 GFLOP on ~17.5 MB, near the H100's bf16 ridge, where the
// int8 banks' half-size reads start to count.  Design: K3's CTA (one per
// 64-token tile and expert, the [64, D] f32 output accumulator in WMMA
// fragments) with the weight chunks read as int8, 16 bytes per thread, and
// dequantized on their way into shared memory, so device memory only ever
// holds the int8 banks.  Every token tile of an expert dequantizes the same
// chunks again (the TPU kernel does too); scaling the f32 accumulator
// instead, or dequantizing once per expert into a persistent CTA's shared
// memory, is later work.

#include "ffn_fwd.cuh"

namespace {

using namespace ffn;

// 16 int8 values times `scale`, each rounded to bf16, into dst[0..15].
__device__ __forceinline__ void dequant16(bf16* dst, const int8_t* src,
                                          float scale) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const int8_t* q = reinterpret_cast<const int8_t*>(&v);
  __align__(16) bf16 o[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = __float2bfloat16(float(q[k]) * scale);
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(o)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(o)[1];
}

template <int D>
struct LoadWInt8 {
  const int8_t* q1e;  // [Hd, D]
  const float* s1e;   // [Hd]
  const int8_t* q2e;  // [D, Hd]
  const float* s2e;   // [D]
  int Hd;
  __device__ __forceinline__ void operator()(int j0, bf16* W1s,
                                             bf16* W2s) const {
    using S = FwdSmem<D>;
    const int tid = threadIdx.x;
    constexpr int C1 = D / 16;   // 16-byte pieces per w1 row
    for (int i = tid; i < HC * C1; i += THREADS) {
      const int r = i / C1, c = (i % C1) * 16;
      dequant16(W1s + r * S::LDH + c, q1e + int64_t(j0 + r) * D + c,
                s1e[j0 + r]);
    }
    constexpr int C2 = HC / 16;  // 16-byte pieces per w2 row chunk
    for (int i = tid; i < D * C2; i += THREADS) {
      const int r = i / C2, c = (i % C2) * 16;
      dequant16(W2s + r * S::LDW2 + c, q2e + int64_t(r) * Hd + j0 + c,
                s2e[r]);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
expert_ffn_q_fwd_kernel(const bf16* __restrict__ hin,
                        const int8_t* __restrict__ q1,
                        const float* __restrict__ s1,
                        const float* __restrict__ b1,
                        const int8_t* __restrict__ q2,
                        const float* __restrict__ s2,
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
                 LoadWInt8<D>{q1 + int64_t(e) * Hd * D, s1 + int64_t(e) * Hd,
                              q2 + int64_t(e) * D * Hd, s2 + int64_t(e) * D,
                              Hd},
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
cudaError_t launch(const void* h, const void* q1, const void* s1,
                   const void* b1, const void* q2, const void* s2,
                   const void* b2, void* out, int E, int Ct, int Hd,
                   cudaStream_t stream) {
  const size_t bytes = FwdSmem<D>::bytes;
  cudaError_t err = allow_smem(expert_ffn_q_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Ct + BM - 1) / BM, E);
  expert_ffn_q_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(h), static_cast<const int8_t*>(q1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(q2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), Ct, Hd);
  return cudaGetLastError();
}

}  // namespace

// h [E, Ct, D] bf16, q1 [E, Hd, D] int8, s1 [E, Hd] f32, b1 [E, Hd] f32,
// q2 [E, D, Hd] int8, s2 [E, D] f32, b2 [E, D] f32, out [E, Ct, D] bf16, all
// contiguous; Hd % 64 == 0.  Returns a cudaError_t; cudaErrorInvalidValue
// for a width not built.
extern "C" int expert_ffn_q_fwd(const void* h, const void* q1, const void* s1,
                                const void* b1, const void* q2, const void* s2,
                                const void* b2, void* out, int E, int Ct,
                                int D, int Hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd % HC != 0) return int(cudaErrorInvalidValue);
  switch (D) {
    case 128:
      return launch<128>(h, q1, s1, b1, q2, s2, b2, out, E, Ct, Hd, s);
    case 384:
      return launch<384>(h, q1, s1, b1, q2, s2, b2, out, E, Ct, Hd, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
