// Flash-attention backward on the fused qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel m3vit_tpu/ops/flash_attention.py:_bwd_kernel
// (pallas_call in _bwd, the VJP of flash_attention_qkv).  Per (batch, head)
// it recomputes the probabilities from the forward's logsumexp and forms
//   p  = exp(q k^T * scale - lse)        (keys >= valid masked to 0)
//   delta = rowsum(dO o),  dS = p (dO v^T - delta) * scale
//   dq = dS k,   dk = dS^T q,   dv = p^T dO
// reading q, k, v as column slices h*D, C + h*D, 2C + h*D of qkv [B, N, 3C]
// and writing dq, dk, dv into the same three column blocks of dqkv, so no
// transposes exist around the kernel.  Scores, p, dP and delta are f32; p
// and dS are rounded to bf16 before their products, which accumulate in f32
// (the TPU kernel's numerics).
//
// What bounds it: at the flagship shape (B=8, N=1025, H=6, D=64) the
// backward needs 5 products of 2*N*N*D per (batch, head), 32 GFLOP, on
// ~30 MB: far above the H100's bf16 ridge, so the tensor cores bound it
// (0.033 ms at 989 TFLOP/s; 0.046 ms for the 7 products done here).
//
// Design.  Blocks run in parallel in no order, so the work is split into
// passes, deterministically (no atomics; two runs give the same bits):
//   1. prep: eight lanes per (batch, head, row) write lse * log2(e) and
//      delta into a scratch laid out per 64-row query tile, [B*H, tiles,
//      2, 64] f32, padded with lse2 = +inf (so p = 0) and delta = 0 past N.
//   2. dk/dv: one CTA of one warpgroup per (64-key tile, head, batch).  K
//      and V are loaded once by TMA; Q, dO and the tile's lse2/delta
//      stream through a 2-stage TMA/mbarrier ring, the copy of tile j+1 in
//      flight while tile j is multiplied.  With keys as rows, S^T = K Q^T
//      and dP^T = V dO^T come from wgmma (both operands K-major), P^T and
//      dS^T are formed in registers (lse2/delta indexed by column from the
//      stage's vector), then dV += P^T dO and dK += dS^T Q take A from
//      registers and B = dO or Q MN-major (transpose bit).  All four
//      accumulators stay in registers.
//   3. dq: one CTA per (64-query tile, head, batch) with Q and dO resident
//      and K/V streaming; S = Q K^T and dP = dO V^T, P and dS in registers,
//      dQ += dS K with K MN-major.
// Passes 2 and 3 are independent and share one grid, dk/dv CTAs first: at
// 159 registers an SM holds 3 dk/dv CTAs, so the 816 of the flagship shape
// would end in a wave of 24, which the dq CTAs fill instead.  The dq pass
// recomputes S and dP: 7 products instead of 5, the price of determinism
// without a dq scratch of atomics.  The two kernels are one launch of the
// wrapper.  Rows past N arrive as TMA zeros and are never stored; key
// tiles wholly past valid store zero dk/dv, and keys at or past valid get
// p = 0, so they get exactly zero gradient, as on the TPU.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int STAGES = 2;
constexpr int THREADS = 128;       // one warpgroup
constexpr int VEC = 2 * ROWS * 4;  // bytes of a tile's lse2 + delta

__device__ __forceinline__ int64_t stats_offset(int bh, int tile,
                                                int n_tiles) {
  return (int64_t(bh) * n_tiles + tile) * 2 * ROWS;
}

// stats[bh, tile, 0, i] = lse * log2(e), stats[bh, tile, 1, i] = rowsum(dO o)
// for row tile*64 + i; +inf and 0 past N.  Eight lanes share a row, 16
// bytes each per load, so a warp reads four whole rows of o and dO at once;
// rows run fastest within a (batch, head).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ stats,
                      int N, int H, int n_tiles, int64_t total) {
  const int64_t i = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / 8;
  const int lane8 = threadIdx.x % 8;
  if (i >= total) return;   // never taken: 64 rows a tile, 32 a block
  const int n = int(i % (int64_t(n_tiles) * ROWS));
  const int bh = int(i / (int64_t(n_tiles) * ROWS));
  const int b = bh / H, h = bh % H;
  float dl = 0.f;
  if (n < N) {
    const int64_t off = (int64_t(b) * N + n) * H * D + h * D;
    const uint4* op = reinterpret_cast<const uint4*>(o + off);
    const uint4* dp = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
    for (int c = lane8; c < D / 8; c += 8) {
      const uint4 a = op[c], g = dp[c];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(a2[k]);
        const float2 y = __bfloat1622float2(g2[k]);
        dl = fmaf(x.x, y.x, dl);
        dl = fmaf(x.y, y.y, dl);
      }
    }
  }
#pragma unroll
  for (int off = 4; off; off >>= 1) dl += __shfl_xor_sync(0xffffffffu, dl, off);
  if (lane8 == 0) {
    float* st = stats + stats_offset(bh, n / ROWS, n_tiles) + n % ROWS;
    st[0] = n < N ? lse[int64_t(bh) * N + n] * LOG2E : INFINITY;
    st[ROWS] = dl;
  }
}

template <int D>
struct DkdvSmem {
  static constexpr int TILE = Tile<D>::BYTES;
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;                    // stages
  static constexpr int DO = Q + STAGES * TILE;          // stages
  static constexpr int VECS = DO + STAGES * TILE;       // stages
  static constexpr int BAR = VECS + STAGES * VEC;       // K/V, then stages
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;
};

// dk, dv of key tile blockIdx.x of (batch b, head h).
template <int D>
__device__ __forceinline__ void dkdv_tile(
    uint8_t* smem_raw, const CUtensorMap* qkv_map, const CUtensorMap* do_map,
    const float* __restrict__ stats, bf16* __restrict__ dqkv, int N, int H,
    int b, int valid, float scale, int n_tiles) {
  using T = Tile<D>;
  using S = DkdvSmem<D>;
  const int tid = threadIdx.x, lane = tid % 32;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y;
  const int C = H * D;
  const int64_t rs = 3 * int64_t(C);
  bf16* dk_dst = dqkv + int64_t(b) * N * rs + C + h * D;
  bf16* dv_dst = dk_dst + C;

  if (k0 >= valid) {   // key tiles wholly past valid: dk = dv = 0
    for (int i = tid; i < ROWS * D / 8; i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (k0 + r < N) {
        *reinterpret_cast<uint4*>(dk_dst + (k0 + r) * rs + c) = uint4{};
        *reinterpret_cast<uint4*>(dv_dst + (k0 + r) * rs + c) = uint4{};
      }
    }
    return;
  }

  uint8_t* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR);
  const int bh = b * H + h;
  const float* st_bh = stats + stats_offset(bh, 0, n_tiles);

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_stage = [&](int st, int j) {   // Q, dO, lse2/delta of q tile j
    mbar_expect_tx(&bars[1 + st], 2 * S::TILE + VEC);
    tma_load_tile<D>(smem + S::Q + st * S::TILE, qkv_map, &bars[1 + st],
                     h * D, j * ROWS, b);
    tma_load_tile<D>(smem + S::DO + st * S::TILE, do_map, &bars[1 + st],
                     h * D, j * ROWS, b);
    bulk_load(smem + S::VECS + st * VEC, st_bh + int64_t(j) * 2 * ROWS, VEC,
              &bars[1 + st]);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * S::TILE);
    tma_load_tile<D>(smem + S::K, qkv_map, &bars[0], C + h * D, k0, b);
    tma_load_tile<D>(smem + S::V, qkv_map, &bars[0], 2 * C + h * D, k0, b);
    for (int st = 0; st < STAGES && st < n_tiles; ++st) load_stage(st, st);
  }

  // this thread's key rows r0, r0 + 8 and query columns 8n + cq + {0, 1}
  const int r0 = (tid / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  const bool key_ok[2] = {k0 + r0 < valid, k0 + r0 + 8 < valid};
  const float scale_log2 = scale * LOG2E;
  float dk[T::NCH][T::CW / 2], dv[T::NCH][T::CW / 2];
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
#pragma unroll
    for (int j = 0; j < T::CW / 2; ++j) dk[c][j] = dv[c][j] = 0.f;

  mbar_wait(&bars[0], 0);
  const uint8_t* Ks = smem + S::K;
  const uint8_t* Vs = smem + S::V;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint8_t* Qs = smem + S::Q + st * S::TILE;
    const uint8_t* dOs = smem + S::DO + st * S::TILE;
    const float* lse2 = reinterpret_cast<const float*>(smem + S::VECS +
                                                       st * VEC);
    const float* dlt = lse2 + ROWS;
    mbar_wait(&bars[1 + st], (j / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, keys as rows
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk)
      wgmma_ss_n64(s, desc_k<D>(Ks, kk), desc_k<D>(Qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk)
      wgmma_ss_n64(dp, desc_k<D>(Vs, kk), desc_k<D>(dOs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp2(S^T scale log2e - lse2[col]), dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int col = (x / 4) * 8 + cq + (x & 1);
      s[x] = key_ok[(x / 2) & 1] ? exp2f(fmaf(s[x], scale_log2, -lse2[col]))
                                 : 0.f;
      dp[x] = s[x] * (dp[x] - dlt[col]) * scale;
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(s, pa);
    to_a_frags(dp, dsa);

    // dV += P^T dO, dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int c = 0; c < T::NCH; ++c) {
        wgmma_rs(dv[c], pa[kk], desc_mn<D>(dOs, c, kk));
        wgmma_rs(dk[c], dsa[kk], desc_mn<D>(Qs, c, kk));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) {
      fence_regs(dk[c]);
      fence_regs(dv[c]);
    }

    __syncthreads();   // every warp is done with this stage: refill it
    if (tid == 0 && j + STAGES < n_tiles) load_stage(st, j + STAGES);
  }

  store_acc<D>(dk, dk_dst, rs, k0, N, 1.f, 1.f);
  store_acc<D>(dv, dv_dst, rs, k0, N, 1.f, 1.f);
}

template <int D>
struct DqSmem {
  static constexpr int TILE = Tile<D>::BYTES;
  static constexpr int Q = 0;
  static constexpr int DO = TILE;
  static constexpr int K = 2 * TILE;                    // stages
  static constexpr int V = K + STAGES * TILE;           // stages
  static constexpr int BAR = V + STAGES * TILE;         // Q/dO, then stages
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;
};

// dq of query tile blockIdx.x of (batch b, head h).
template <int D>
__device__ __forceinline__ void dq_tile(
    uint8_t* smem_raw, const CUtensorMap* qkv_map, const CUtensorMap* do_map,
    const float* __restrict__ stats, bf16* __restrict__ dqkv, int N, int H,
    int b, int valid, float scale, int n_qtiles) {
  using T = Tile<D>;
  using S = DqSmem<D>;
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR);

  const int tid = threadIdx.x, lane = tid % 32;
  const int qt = blockIdx.x, q0 = qt * ROWS, h = blockIdx.y;
  const int C = H * D;
  const int n_kt = (valid + ROWS - 1) / ROWS;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_stage = [&](int st, int t) {   // K, V of key tile t
    mbar_expect_tx(&bars[1 + st], 2 * S::TILE);
    tma_load_tile<D>(smem + S::K + st * S::TILE, qkv_map, &bars[1 + st],
                     C + h * D, t * ROWS, b);
    tma_load_tile<D>(smem + S::V + st * S::TILE, qkv_map, &bars[1 + st],
                     2 * C + h * D, t * ROWS, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * S::TILE);
    tma_load_tile<D>(smem + S::Q, qkv_map, &bars[0], h * D, q0, b);
    tma_load_tile<D>(smem + S::DO, do_map, &bars[0], h * D, q0, b);
    for (int st = 0; st < STAGES && st < n_kt; ++st) load_stage(st, st);
  }

  // this thread's query rows r0, r0 + 8 and key columns 8n + cq + {0, 1}
  const int r0 = (tid / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  const float* vec = stats + stats_offset(b * H + h, qt, n_qtiles);
  const float l2[2] = {vec[r0], vec[r0 + 8]};
  const float dl[2] = {vec[ROWS + r0], vec[ROWS + r0 + 8]};
  const float scale_log2 = scale * LOG2E;
  float dq[T::NCH][T::CW / 2];
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
#pragma unroll
    for (int j = 0; j < T::CW / 2; ++j) dq[c][j] = 0.f;

  mbar_wait(&bars[0], 0);
  const uint8_t* Qs = smem + S::Q;
  const uint8_t* dOs = smem + S::DO;
  for (int t = 0; t < n_kt; ++t) {
    const int st = t % STAGES;
    const uint8_t* Ks = smem + S::K + st * S::TILE;
    const uint8_t* Vs = smem + S::V + st * S::TILE;
    mbar_wait(&bars[1 + st], (t / STAGES) & 1);

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk)
      wgmma_ss_n64(s, desc_k<D>(Qs, kk), desc_k<D>(Ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk)
      wgmma_ss_n64(dp, desc_k<D>(dOs, kk), desc_k<D>(Vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - delta) scale, keys >= valid masked
    const int lim = valid - t * ROWS;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float p = (x / 4) * 8 + cq + (x & 1) < lim
                          ? exp2f(fmaf(s[x], scale_log2, -l2[(x / 2) & 1]))
                          : 0.f;
      dp[x] = p * (dp[x] - dl[(x / 2) & 1]) * scale;
    }
    uint32_t dsa[4][4];
    to_a_frags(dp, dsa);

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        wgmma_rs(dq[c], dsa[kk], desc_mn<D>(Ks, c, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) fence_regs(dq[c]);

    __syncthreads();   // every warp is done with this stage: refill it
    if (tid == 0 && t + STAGES < n_kt) load_stage(st, t + STAGES);
  }

  store_acc<D>(dq, dqkv + int64_t(b) * N * 3 * C + h * D, 3 * int64_t(C), q0,
               N, 1.f, 1.f);
}

template <int D>
constexpr int bwd_smem_bytes() {
  return DkdvSmem<D>::BYTES > DqSmem<D>::BYTES ? DkdvSmem<D>::BYTES
                                               : DqSmem<D>::BYTES;
}

// The dk/dv and dq passes in one grid (n_tiles, H, 2B): blockIdx.z < B
// runs dk/dv for batch z, the rest dq for batch z - B.  CTAs are dispatched
// z-major, so the longer dk/dv CTAs go first and the dq CTAs fill the SMs
// as they drain, instead of each pass ending in a part-filled wave.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap qkv_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const float* __restrict__ stats, bf16* __restrict__ dqkv,
                 int N, int H, int B, int valid, float scale, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  if (int(blockIdx.z) < B)
    dkdv_tile<D>(smem_raw, &qkv_map, &do_map, stats, dqkv, N, H, blockIdx.z,
                 valid, scale, n_tiles);
  else
    dq_tile<D>(smem_raw, &qkv_map, &do_map, stats, dqkv, N, H,
               blockIdx.z - B, valid, scale, n_tiles);
}

template <int D>
cudaError_t launch(const void* qkv, const void* o, const void* lse,
                   const void* dout, void* stats, void* dqkv, int B, int N,
                   int H, int valid, float scale, cudaStream_t stream) {
  CUtensorMap qkv_map, do_map;
  if (!make_tile_map<D>(&qkv_map, qkv, 3 * H * D, N, B) ||
      !make_tile_map<D>(&do_map, dout, H * D, N, B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + ROWS - 1) / ROWS;
  const int64_t total = int64_t(B) * H * n_tiles * ROWS;   // rows
  flash_bwd_prep_kernel<D><<<unsigned((total + 31) / 32), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(stats), N, H,
      n_tiles, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_kernel<D><<<dim3(n_tiles, H, 2 * B), THREADS,
                        bwd_smem_bytes<D>(), stream>>>(
      qkv_map, do_map, static_cast<const float*>(stats),
      static_cast<bf16*>(dqkv), N, H, B, valid, scale, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, N, 3*H*D] bf16, o and dout [B, N, H*D] bf16, lse [B, H, N] f32
// (the forward's), stats f32 scratch of B*H*ceil(N/64)*128 floats, dqkv
// [B, N, 3*H*D] bf16 out; all contiguous and 16-byte aligned.  Returns a
// cudaError_t; cudaErrorInvalidValue for a head_dim not built or a tensor
// map the CUDA driver refuses.
extern "C" int flash_attention_bwd(const void* qkv, const void* o,
                                   const void* lse, const void* dout,
                                   void* stats, void* dqkv, int B, int N,
                                   int H, int D, int valid, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(qkv, o, lse, dout, stats, dqkv, B, N, H, valid, scale,
                        s);
    case 64:
      return launch<64>(qkv, o, lse, dout, stats, dqkv, B, N, H, valid, scale,
                        s);
    case 128:
      return launch<128>(qkv, o, lse, dout, stats, dqkv, B, N, H, valid,
                         scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
