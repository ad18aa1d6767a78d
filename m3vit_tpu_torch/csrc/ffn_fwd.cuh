// The WMMA fused FFN forward of K7 (expert_ffn_q_fwd.cu), the first design
// K3 and K5 also used until they moved to wgmma (ffn_fwd_wgmma.cuh): one
// CTA holds a [64, D] token tile in shared memory and its [64, D] f32
// output accumulator in registers (WMMA fragments, 8 warps of 16 rows x D/2
// columns), and walks the hidden axis in 64-wide chunks: a = gelu(h w1^T
// chunk + b1) goes to shared memory only (rounded to bf16), then acc += a
// w2^T chunk.  How the weight chunks reach shared memory, and what the
// epilogue does with the accumulator, is the kernel's own.

#pragma once

#include "ffn_common.cuh"

namespace ffn {

constexpr int BM = 64;  // tokens per CTA

template <int D>
struct FwdSmem {
  static constexpr int LDH = D + 8;    // bf16 stride: token tile, w1 chunk
  static constexpr int LDW2 = HC + 8;  // bf16 stride: w2 chunk [D, HC]
  static constexpr int LDA = HC + 4;   // f32 stride: pre-activation chunk
  static constexpr int LDB = HC + 8;   // bf16 stride: activation chunk
  static constexpr int LDST = D + 4;   // f32 stride: output staging
  static constexpr size_t h = size_t(BM) * LDH * sizeof(bf16);
  static constexpr size_t w1 = size_t(HC) * LDH * sizeof(bf16);
  static constexpr size_t w2 = size_t(D) * LDW2 * sizeof(bf16);
  static constexpr size_t af = size_t(BM) * LDA * sizeof(float);
  static constexpr size_t ab = size_t(BM) * LDB * sizeof(bf16);
  static constexpr size_t bytes = h + w1 + w2 + af + ab;
  // the output staging reuses the token tile and weight chunks
  static_assert(size_t(BM) * LDST * sizeof(float) <= h + w1 + w2,
                "staging does not fit");

  static __device__ bf16* tokens(unsigned char* s) {
    return reinterpret_cast<bf16*>(s);
  }
  static __device__ bf16* w1s(unsigned char* s) {
    return reinterpret_cast<bf16*>(s + h);
  }
  static __device__ bf16* w2s(unsigned char* s) {
    return reinterpret_cast<bf16*>(s + h + w1);
  }
  static __device__ float* staging(unsigned char* s) {
    return reinterpret_cast<float*>(s);
  }
};

// acc[64, D] = sum over hidden chunks of gelu(Hs w1_c^T + b1_c) w2_c^T, with
// the pre-activation in f32 and the activation rounded to bf16 before the
// second product.  load_w(j0, W1s, W2s) fills W1s [HC, D] (stride LDH)
// with rows j0..j0+HC of w1 and W2s [D, HC] (stride LDW2) with those
// columns of w2.  Hs must be filled before the call; ends with the
// accumulator in `acc` and every warp past its last shared-memory read.
template <int D, class LoadW>
__device__ __forceinline__ void hidden_loop(unsigned char* smem, int Hd,
                                            const float* __restrict__ b1e,
                                            LoadW load_w, Acc (&acc)[D / 32]) {
  using S = FwdSmem<D>;
  constexpr int NF = D / 32;
  const bf16* Hs = S::tokens(smem);
  bf16* W1s = S::w1s(smem);
  bf16* W2s = S::w2s(smem);
  float* Af = reinterpret_cast<float*>(smem + S::h + S::w1 + S::w2);
  bf16* Ab = reinterpret_cast<bf16*>(smem + S::h + S::w1 + S::w2 + S::af);
  const int tid = threadIdx.x, warp = tid / 32;
  const int rb = warp & 3;    // 16-row block of the tile
  const int ch = warp >> 2;   // column half: phase 1 blocks, phase 2 output

#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int j0 = 0; j0 < Hd; j0 += HC) {
    __syncthreads();  // the previous chunk's readers are done
    load_w(j0, W1s, W2s);
    __syncthreads();

    // phase 1: pre-activation chunk [64, HC] = h w1[j0:j0+HC]^T
    {
      Acc p0, p1;
      wmma::fill_fragment(p0, 0.f);
      wmma::fill_fragment(p1, 0.f);
      const int cb = ch * 2;
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        ARow a;
        BCol b0, b1f;
        wmma::load_matrix_sync(a, Hs + rb * 16 * S::LDH + kk * 16, S::LDH);
        wmma::load_matrix_sync(b0, W1s + (cb * 16) * S::LDH + kk * 16, S::LDH);
        wmma::load_matrix_sync(b1f, W1s + (cb * 16 + 16) * S::LDH + kk * 16,
                               S::LDH);
        wmma::mma_sync(p0, a, b0, p0);
        wmma::mma_sync(p1, a, b1f, p1);
      }
      wmma::store_matrix_sync(Af + rb * 16 * S::LDA + cb * 16, p0, S::LDA,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(Af + rb * 16 * S::LDA + cb * 16 + 16, p1,
                              S::LDA, wmma::mem_row_major);
    }
    __syncthreads();

    // bias + exact GELU in f32, rounded to bf16 for the second product
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      Ab[r * S::LDB + c] =
          __float2bfloat16(gelu(Af[r * S::LDA + c] + b1e[j0 + c]));
    }
    __syncthreads();

    // phase 2: acc[64, D] += a w2[:, j0:j0+HC]^T
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      ARow a;
      wmma::load_matrix_sync(a, Ab + rb * 16 * S::LDB + kk * 16, S::LDB);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        BCol b;
        wmma::load_matrix_sync(
            b, W2s + (ch * (D / 2) + f * 16) * S::LDW2 + kk * 16, S::LDW2);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }
  __syncthreads();  // staging may now overwrite the tiles
}

// Writes the accumulator to the f32 staging tile [64, D] (stride LDST) and
// returns it, visible to the whole CTA.
template <int D>
__device__ __forceinline__ const float* stage(unsigned char* smem,
                                              Acc (&acc)[D / 32]) {
  using S = FwdSmem<D>;
  float* St = S::staging(smem);
  const int warp = threadIdx.x / 32, rb = warp & 3, ch = warp >> 2;
#pragma unroll
  for (int f = 0; f < D / 32; ++f)
    wmma::store_matrix_sync(St + rb * 16 * S::LDST + ch * (D / 2) + f * 16,
                            acc[f], S::LDST, wmma::mem_row_major);
  __syncthreads();
  return St;
}

}  // namespace ffn
