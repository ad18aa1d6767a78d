// Flash-attention forward on the fused qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel m3vit_tpu/ops/flash_attention.py:_fwd_kernel
// (pallas_call in _fwd, reached through flash_attention_qkv).  It computes
//   o = softmax(q k^T * scale, keys >= valid masked) v,   lse = m + log(l)
// per (batch, head) directly on qkv [B, N, 3C]: head h reads q, k and v as
// the column slices h*D, C + h*D and 2C + h*D, so no transposes exist around
// the kernel, and o is written at columns h*D of [B, N, C].
//
// What bounds it: at the flagship shape (B=8, N=1025, H=6, D=64) one launch
// does 12.9 GFLOP on ~25 MB, about 500 FLOP per byte, above the H100's
// ridge (~295 bf16 FLOP/B): the tensor cores bound it (0.013 ms at 989
// TFLOP/s), and the [N, N] score matrix must never reach device memory.
//
// Design.  One CTA of one warpgroup per (64-query tile, head, batch): 102
// CTAs at B=1 (one wave on 132 SMs), 816 at B=8 (5 resident per SM at 96
// registers and 42 KB of shared memory: 1.24 waves).
// - Loads: thread 0 starts TMA copies over a 3-D tensor map of qkv
//   (dims 3C, N, B), so the head offset is a coordinate and rows past N
//   arrive as zeros, never as the next image's rows.  Q is loaded once; K
//   and V stream through a 2-stage ring of 64-key tiles on mbarriers.  The
//   copy of tile t+1 is in flight while tile t is multiplied; a stage is
//   refilled as soon as all four warps are done with it.
// - S = Q K^T: wgmma m64n64k16, Q and K both K-major in shared memory,
//   swizzled by TMA as the descriptors read them (128 B, or 64 B at D=32).
//   The f32 scores stay in registers.  Within a CTA the products and the
//   softmax run in turn; the ~5 CTAs resident on an SM overlap each other
//   (issuing tile t+1's scores under tile t's softmax measured slower at
//   B=8: 123 registers and a 3rd stage leave 3 CTAs per SM).
// - Online softmax on the accumulator fragment: scores scaled by
//   scale*log2(e), exp2f, row max by quad shuffles; the row sum stays per
//   thread until the end.  S, P and O never touch shared memory.
// - O += P V: wgmma with A = P from registers (the S accumulator rounded to
//   bf16 pairs is wgmma's A-register layout) and B = V MN-major (transpose
//   bit).  O is rescaled in registers.  p is rounded to bf16 before P V, as
//   on the TPU; scores, statistics and accumulators are f32.
// - Epilogue: O / l as bf16 at columns h*D of o; lse = (m2 + log2 l) ln 2,
//   the natural log the backward and the plain version expect.
// Keys at or past min(valid, N) are masked to -inf; the key loop stops at
// the last tile holding a valid key.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 128;  // one warpgroup

template <int D>
struct Smem {
  static constexpr int TILE = Tile<D>::BYTES;
  static constexpr int Q = 0;
  static constexpr int K = TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;   // Q barrier, then stages
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qkv_map,
                 bf16* __restrict__ out, float* __restrict__ lse, int N,
                 int H, int valid, float scale_log2) {
  using T = Tile<D>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR);

  const int tid = threadIdx.x, lane = tid % 32;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const int n_kv = min(valid, N);
  const int n_tiles = (n_kv + ROWS - 1) / ROWS;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], S::TILE);
    tma_load_tile<D>(smem + S::Q, &qkv_map, &bars[0], h * D, q0, b);
    for (int s = 0; s < STAGES && s < n_tiles; ++s) {
      mbar_expect_tx(&bars[1 + s], 2 * S::TILE);
      tma_load_tile<D>(smem + S::K + s * S::TILE, &qkv_map, &bars[1 + s],
                       C + h * D, s * ROWS, b);
      tma_load_tile<D>(smem + S::V + s * S::TILE, &qkv_map, &bars[1 + s],
                       2 * C + h * D, s * ROWS, b);
    }
  }

  // this thread's rows r0 and r0 + 8, columns 8n + cq + {0, 1}
  const int cq = 2 * (lane % 4);
  float o[T::NCH][T::CW / 2];
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
#pragma unroll
    for (int j = 0; j < T::CW / 2; ++j) o[c][j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(&bars[0], 0);
  const uint8_t* Qs = smem + S::Q;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint8_t* Ks = smem + S::K + st * S::TILE;
    const uint8_t* Vs = smem + S::V + st * S::TILE;
    mbar_wait(&bars[1 + st], (t / STAGES) & 1);

    // S = Q K^T, f32 in registers
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk)
      wgmma_ss_n64(s, desc_k<D>(Qs, kk), desc_k<D>(Ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int lim = n_kv - t * ROWS;   // valid keys in this tile
    if (lim < ROWS) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if ((j / 4) * 8 + cq + (j & 1) >= lim) s[j] = -INFINITY;
    }

    // online softmax in the log2 domain; key 0 of every tile is valid, so
    // the running max is finite after the first tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * i], s[4 * nb + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[4 * nb + 2 * i + e];
          v = exp2f(fmaf(v, scale_log2, -m_new));
          sum += v;
        }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
#pragma unroll
        for (int nb = 0; nb < T::CW / 8; ++nb) {
          o[c][4 * nb + 2 * i] *= alpha;
          o[c][4 * nb + 2 * i + 1] *= alpha;
        }
    }

    // O += P V, P from registers
    uint32_t p[4][4];
    to_a_frags(s, p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        wgmma_rs(o[c], p[kk], desc_mn<D>(Vs, c, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) fence_regs(o[c]);

    __syncthreads();   // every warp is done with this stage: refill it
    if (tid == 0 && t + STAGES < n_tiles) {
      mbar_expect_tx(&bars[1 + st], 2 * S::TILE);
      tma_load_tile<D>(smem + S::K + st * S::TILE, &qkv_map, &bars[1 + st],
                       C + h * D, (t + STAGES) * ROWS, b);
      tma_load_tile<D>(smem + S::V + st * S::TILE, &qkv_map, &bars[1 + st],
                       2 * C + h * D, (t + STAGES) * ROWS, b);
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  store_acc<D>(o, out + int64_t(b) * N * C + h * D, C, q0, N, inv[0], inv[1]);
  if (lane % 4 == 0) {
    const int r = q0 + (tid / 32) * 16 + lane / 4;
    float* dst = lse + (int64_t(b) * H + h) * N;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r + 8 * i < N) dst[r + 8 * i] = (m[i] + log2f(l[i])) * LN2;
  }
}

template <int D>
cudaError_t launch(const void* qkv, void* out, void* lse, int B, int N, int H,
                   int valid, float scale, cudaStream_t stream) {
  CUtensorMap map;
  if (!make_tile_map<D>(&map, qkv, 3 * H * D, N, B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((N + ROWS - 1) / ROWS, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      map, static_cast<bf16*>(out), static_cast<float*>(lse), N, H, valid,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, N, 3*H*D] bf16 contiguous and 16-byte aligned, out [B, N, H*D]
// bf16, lse [B, H, N] f32.  Returns a cudaError_t; cudaErrorInvalidValue
// for a head_dim not built or a tensor map the CUDA driver refuses.
extern "C" int flash_attention_fwd(const void* qkv, void* out, void* lse,
                                   int B, int N, int H, int D, int valid,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qkv, out, lse, B, N, H, valid, scale, s);
    case 64: return launch<64>(qkv, out, lse, B, N, H, valid, scale, s);
    case 128: return launch<128>(qkv, out, lse, B, N, H, valid, scale, s);
    default: return int(cudaErrorInvalidValue);
  }
}
