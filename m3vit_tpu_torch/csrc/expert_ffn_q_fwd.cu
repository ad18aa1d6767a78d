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
// dequantized in f32 and rounded to bf16 (to nearest even) before its
// product, as the TPU kernel and the plain version round it.
//
// What bounds it: at the flagship's bucket-8 serving shape
// ([16, 4104, 384] x 384) one call does 38.7 GFLOP on ~105 MB: the tensor
// cores bound it, as they bound K3.  At bucket 1 ([16, 520, 384]) it does
// 4.9 GFLOP on ~17.5 MB, near the H100's bf16 ridge.
//
// Design: two launches on the caller's stream, one C call.
// 1. dequant_banks_kernel widens both banks of every expert once, 16 int8
//    values a thread (one 16-byte load, two 16-byte stores), into a bf16
//    scratch the wrapper allocates for the call and frees after it: 4.7 MB
//    read and 9.4 MB written at the flagship, a few microseconds at the
//    card's memory rate, and the bf16 banks stay in the 50 MB L2 for:
// 2. K3's persistent wgmma forward (ffn_fwd_wgmma.cuh), unchanged, on the
//    scratch banks: its numerics and its bits, which expert_ffn_fwd gives
//    on the same bf16 banks.
// At D in {768, 1024} step 2 is the two-pass route (ffn_fwd_gemm.cuh) on
// the bf16 banks, its hidden activation in the same scratch after them.
// The first design dequantized every chunk again in each 64-token tile
// (65 times an expert at bucket 8) on the SMs that ran the products;
// widening inside K3's ring would need registers its consumers do not have.

#include "ffn_fwd_gemm.cuh"
#include "ffn_fwd_wgmma.cuh"

namespace {

using hopper::bf16;

constexpr int DQ_THREADS = 256;

// One 16-value group a thread: groups [0, n1) are q1's, [n1, 2 n1) q2's
// (both banks hold n1 = E Hd D / 16 groups).  A row of q1 is D long and one
// of q2 Hd, both multiples of 16, so a group lies in one row and takes that
// row's scale.
__global__ void __launch_bounds__(DQ_THREADS)
dequant_banks_kernel(const int8_t* __restrict__ q1,
                     const float* __restrict__ s1,
                     const int8_t* __restrict__ q2,
                     const float* __restrict__ s2, bf16* __restrict__ w1,
                     bf16* __restrict__ w2, int64_t n1, int D, int Hd) {
  int64_t g = int64_t(blockIdx.x) * DQ_THREADS + threadIdx.x;
  if (g >= 2 * n1) return;
  const bool second = g >= n1;
  if (second) g -= n1;
  const int8_t* q = second ? q2 : q1;
  bf16* w = second ? w2 : w1;
  const float scale = (second ? s2 : s1)[g * 16 / (second ? Hd : D)];
  const uint4 v = reinterpret_cast<const uint4*>(q)[g];
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  uint4 o[2];
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    p[k] = __floats2bfloat162_rn(float(b[2 * k]) * scale,
                                 float(b[2 * k + 1]) * scale);
  reinterpret_cast<uint4*>(w)[2 * g] = o[0];
  reinterpret_cast<uint4*>(w)[2 * g + 1] = o[1];
}

// The scratch holds the bf16 banks: w1 [E, Hd, D], then w2 [E, D, Hd].
inline int64_t bank_elems(int E, int D, int Hd) {
  return int64_t(E) * Hd * D;
}

cudaError_t dequant(const void* q1, const void* s1, const void* q2,
                    const void* s2, void* scratch, int E, int D, int Hd,
                    cudaStream_t stream) {
  if (E < 1 || D % 16 != 0 || Hd % 16 != 0) return cudaErrorInvalidValue;
  const int64_t n1 = bank_elems(E, D, Hd) / 16;
  bf16* w1 = static_cast<bf16*>(scratch);
  const int64_t blocks = (2 * n1 + DQ_THREADS - 1) / DQ_THREADS;
  dequant_banks_kernel<<<unsigned(blocks), DQ_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(q1), static_cast<const float*>(s1),
      static_cast<const int8_t*>(q2), static_cast<const float*>(s2), w1,
      w1 + bank_elems(E, D, Hd), n1, D, Hd);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the bf16 banks, both, in the scratch.
inline size_t banks_bytes(int E, int D, int Hd) {
  return ffn2p::align256(2 * size_t(bank_elems(E, D, Hd)) * sizeof(bf16));
}

// Bytes of scratch expert_ffn_q_fwd takes: both banks in bf16, and on the
// two-pass route (D in {768, 1024}) the hidden activation [E, Ct, Hd] bf16
// after them.  expert_ffn_q_dequant takes the banks' part (Ct = 0).
extern "C" long long expert_ffn_q_fwd_scratch(int E, int Ct, int D, int Hd) {
  return (long long)(banks_bytes(E, D, Hd) +
                     (ffn2p::wide(D) ? ffn2p::hidden_bytes(E, Ct, Hd) : 0));
}

// q1 [E, Hd, D] int8, s1 [E, Hd] f32, q2 [E, D, Hd] int8, s2 [E, D] f32,
// scratch of expert_ffn_q_fwd_scratch bytes; the int8 banks and the scratch
// 16-byte aligned.  The dequantizing pass alone: the scratch receives
// bf16 w1 [E, Hd, D] followed by bf16 w2 [E, D, Hd].  Returns a
// cudaError_t.
extern "C" int expert_ffn_q_dequant(const void* q1, const void* s1,
                                    const void* q2, const void* s2,
                                    void* scratch, int E, int D, int Hd,
                                    void* stream) {
  return int(dequant(q1, s1, q2, s2, scratch, E, D, Hd,
                     static_cast<cudaStream_t>(stream)));
}

// h [E, Ct, D] bf16, q1 [E, Hd, D] int8, s1 [E, Hd] f32, b1 [E, Hd] f32,
// q2 [E, D, Hd] int8, s2 [E, D] f32, b2 [E, D] f32, out [E, Ct, D] bf16,
// scratch of expert_ffn_q_fwd_scratch bytes, all contiguous and 16-byte
// aligned; Hd % 32 == 0.  Returns a cudaError_t; cudaErrorInvalidValue for
// a width not built or a tensor map the CUDA driver refuses.
extern "C" int expert_ffn_q_fwd(const void* h, const void* q1, const void* s1,
                                const void* b1, const void* q2, const void* s2,
                                const void* b2, void* out, void* scratch,
                                int E, int Ct, int D, int Hd, void* stream) {
  using namespace ffnfwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128 && D != 192 && D != 384 && !ffn2p::wide(D))
    return int(cudaErrorInvalidValue);
  cudaError_t err = dequant(q1, s1, q2, s2, scratch, E, D, Hd, s);
  if (err != cudaSuccess) return int(err);
  const bf16* w1 = static_cast<const bf16*>(scratch);
  const bf16* w2 = w1 + bank_elems(E, D, Hd);
  if (ffn2p::wide(D))
    return int(ffn2p::launch(
        static_cast<const bf16*>(h), w1, static_cast<const float*>(b1), w2,
        static_cast<const float*>(b2), static_cast<bf16*>(out), nullptr,
        reinterpret_cast<bf16*>(static_cast<uint8_t*>(scratch) +
                                banks_bytes(E, D, Hd)),
        E, Ct, D, Hd, s));
  const Args args{static_cast<const float*>(b1), static_cast<const float*>(b2),
                  static_cast<bf16*>(out), nullptr, nullptr, E, Ct, Hd, 0.f};
  switch (D) {
    case 128: return int(launch<128, false>(h, w1, w2, args, s));
    case 192: return int(launch<192, false>(h, w1, w2, args, s));
    default: return int(launch<384, false>(h, w1, w2, args, s));
  }
}
