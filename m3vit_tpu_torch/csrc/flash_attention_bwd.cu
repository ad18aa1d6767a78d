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
// ~30 MB: far above the H100's bf16 ridge, so the tensor cores bound it,
// provided the [N, N] score matrices never reach device memory.
//
// Design.  On the TPU the grid runs in order, so dk/dv accumulate in VMEM
// across q tiles; here blocks run in parallel in no order, so the work is
// split three ways, deterministically (no atomics):
//   1. delta pass: one warp per (batch, row, head) writes delta [B, H, N].
//   2. dk/dv pass: one CTA per (64-key tile, head, batch), 4 warps of 16
//      keys; K/V stay in shared memory while Q/dO stream through in 64-row
//      tiles; each warp forms S^T and dP^T for its keys, then
//      dV += P^T dO and dK += dS^T Q in WMMA accumulators (registers).
//   3. dq pass: one CTA per (64-query tile, head, batch), 4 warps of 16
//      queries; K/V stream through in 64-key tiles and dQ += dS K.
// The dq pass recomputes S and dP: 7 products instead of 5, the price of
// determinism without a dq scratch of atomics.  Products run through WMMA
// bf16 16x16x16; no cp.async/TMA pipelining and no wgmma yet: simple and
// right first.  Rows past N (N=1025 is no tile multiple) are zero-filled on
// load and never stored; key tiles past valid skip the q loop and store
// zero dk/dv, as the TPU kernel's masked columns give.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64;        // rows (queries or keys) per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

template <int D>
struct Smem {
  static constexpr int LDH = D + 8;    // bf16 row stride of the four tiles
  static constexpr int LDS = BT + 4;   // f32 row stride of a warp's S / dP
  static constexpr int LDP = BT + 8;   // bf16 row stride of a warp's P / dS
  static constexpr int LDO = D + 4;    // f32 row stride of the output staging
  static constexpr size_t tile = size_t(BT) * LDH * sizeof(bf16);
  static constexpr size_t s = size_t(WARPS) * 16 * LDS * sizeof(float);
  static constexpr size_t p = size_t(WARPS) * 16 * LDP * sizeof(bf16);
  static constexpr size_t vec = BT * sizeof(float);
  static constexpr size_t bytes = 4 * tile + 2 * s + 2 * p + 2 * vec;
  // the output staging reuses two adjacent tiles once the loop is done
  static_assert(size_t(WARPS) * 16 * LDO * sizeof(float) <= 2 * tile,
                "staging does not fit");
};

// Copies rows [r0, r0 + 64) of a strided [n, D] bf16 slice into shared
// memory (row stride LDH), 16 bytes per thread per step; rows >= n are zero.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int n, int64_t stride, int tid) {
  constexpr int CPR = D / 8;
  for (int i = tid; i < BT * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + int64_t(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::LDH + c) = v;
  }
}

// lse and delta of rows [r0, r0 + 64) into shared memory; 0 past n.
__device__ __forceinline__ void load_vecs(float* lse_s, float* delta_s,
                                          const float* lse, const float* delta,
                                          int r0, int n, int tid) {
  for (int i = tid; i < BT; i += THREADS) {
    const bool in = r0 + i < n;
    lse_s[i] = in ? lse[r0 + i] : 0.f;
    delta_s[i] = in ? delta[r0 + i] : 0.f;
  }
}

// Each warp stages its [16, D] f32 accumulators and writes them as bf16 to
// rows row0 + [0, 16) (< n) of dst (row stride `stride`).
template <int D>
__device__ __forceinline__ void store_rows(Acc (&acc)[D / 16], float* stw,
                                           bf16* dst, int row0, int n,
                                           int64_t stride, int lane) {
  constexpr int LDO = Smem<D>::LDO;
#pragma unroll
  for (int f = 0; f < D / 16; ++f)
    wmma::store_matrix_sync(stw + f * 16, acc[f], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    if (row0 + r < n)
      dst[int64_t(row0 + r) * stride + c] = __float2bfloat16(stw[r * LDO + c]);
  }
  __syncwarp();
}

// delta[b, h, n] = sum_d dO[b, n, h*D + d] o[b, n, h*D + d], one warp a row.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int N,
                       int H) {
  const int64_t row = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int h = int(row % H);
  const int64_t bn = row / H;                 // b * N + n
  const bf16* op = o + bn * H * D + h * D;
  const bf16* dp = dout + bn * H * D + h * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32)
    s += __bfloat162float(op[i]) * __bfloat162float(dp[i]);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int64_t b = bn / N, n = bn % N;
    delta[(b * H + h) * N + n] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ qkv,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      bf16* __restrict__ dqkv, int N, int H, int valid,
                      float scale) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::tile);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * S::tile);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * S::tile);
  float* Ss = reinterpret_cast<float*>(smem + 4 * S::tile);
  float* dPs = reinterpret_cast<float*>(smem + 4 * S::tile + S::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 4 * S::tile + 2 * S::s);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 4 * S::tile + 2 * S::s + S::p);
  float* lse_s =
      reinterpret_cast<float*>(smem + 4 * S::tile + 2 * S::s + 2 * S::p);
  float* delta_s = lse_s + BT;
  float* stage = reinterpret_cast<float*>(smem + 2 * S::tile);  // over Q/dO

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const int64_t rs = 3 * int64_t(C);
  const bf16* base = qkv + int64_t(b) * N * rs;
  const bf16* dbase = dout + int64_t(b) * N * C;
  const float* lse_b = lse + (int64_t(b) * H + h) * N;
  const float* delta_b = delta + (int64_t(b) * H + h) * N;
  float* Sw = Ss + warp * 16 * S::LDS;
  float* dPw = dPs + warp * 16 * S::LDS;
  bf16* Pw = Ps + warp * 16 * S::LDP;
  bf16* dSw = dSs + warp * 16 * S::LDP;

  Acc dk[D / 16], dv[D / 16];
#pragma unroll
  for (int f = 0; f < D / 16; ++f) {
    wmma::fill_fragment(dk[f], 0.f);
    wmma::fill_fragment(dv[f], 0.f);
  }

  if (k0 < valid) {  // key tiles wholly past valid keep dk = dv = 0
    load_rows<D>(Ks, base + C + h * D, k0, N, rs, tid);
    load_rows<D>(Vs, base + 2 * C + h * D, k0, N, rs, tid);
    // lane pair (2r, 2r+1) owns key row r of the warp: queries [0,32) / [32,64)
    const int r = lane >> 1, half = lane & 1;
    const bool key_ok = k0 + warp * 16 + r < valid;
    for (int q0 = 0; q0 < N; q0 += BT) {
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_rows<D>(Qs, base + h * D, q0, N, rs, tid);
      load_rows<D>(dOs, dbase + h * D, q0, N, C, tid);
      load_vecs(lse_s, delta_s, lse_b, delta_b, q0, N, tid);
      __syncthreads();

      // S^T_w [16 keys, 64 q] = K_w Q^T and dP^T_w = V_w dO^T (f32)
#pragma unroll
      for (int nt = 0; nt < BT / 16; ++nt) {
        Acc s, dp;
        wmma::fill_fragment(s, 0.f);
        wmma::fill_fragment(dp, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ARow a;
          BCol bq;
          wmma::load_matrix_sync(a, Ks + warp * 16 * S::LDH + kk * 16, S::LDH);
          wmma::load_matrix_sync(bq, Qs + nt * 16 * S::LDH + kk * 16, S::LDH);
          wmma::mma_sync(s, a, bq, s);
          wmma::load_matrix_sync(a, Vs + warp * 16 * S::LDH + kk * 16, S::LDH);
          wmma::load_matrix_sync(bq, dOs + nt * 16 * S::LDH + kk * 16,
                                 S::LDH);
          wmma::mma_sync(dp, a, bq, dp);
        }
        wmma::store_matrix_sync(Sw + nt * 16, s, S::LDS, wmma::mem_row_major);
        wmma::store_matrix_sync(dPw + nt * 16, dp, S::LDS,
                                wmma::mem_row_major);
      }
      __syncwarp();

      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int c = half * 32 + j;
        float p = 0.f, ds = 0.f;
        if (key_ok && q0 + c < N) {
          p = expf(Sw[r * S::LDS + c] * scale - lse_s[c]);
          ds = p * (dPw[r * S::LDS + c] - delta_s[c]) * scale;
        }
        Pw[r * S::LDP + c] = __float2bfloat16(p);
        dSw[r * S::LDP + c] = __float2bfloat16(ds);
      }
      __syncwarp();

      // dV_w += P^T_w dO,  dK_w += dS^T_w Q
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        ARow ap, as;
        wmma::load_matrix_sync(ap, Pw + kk * 16, S::LDP);
        wmma::load_matrix_sync(as, dSw + kk * 16, S::LDP);
#pragma unroll
        for (int nt = 0; nt < D / 16; ++nt) {
          BRow bm;
          wmma::load_matrix_sync(bm, dOs + kk * 16 * S::LDH + nt * 16, S::LDH);
          wmma::mma_sync(dv[nt], ap, bm, dv[nt]);
          wmma::load_matrix_sync(bm, Qs + kk * 16 * S::LDH + nt * 16, S::LDH);
          wmma::mma_sync(dk[nt], as, bm, dk[nt]);
        }
      }
    }
  }

  __syncthreads();  // the staging overwrites the Q/dO tiles
  float* stw = stage + warp * 16 * S::LDO;
  bf16* dst = dqkv + int64_t(b) * N * rs + h * D;
  store_rows<D>(dk, stw, dst + C, k0 + warp * 16, N, rs, lane);
  store_rows<D>(dv, stw, dst + 2 * C, k0 + warp * 16, N, rs, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ qkv,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dqkv,
                    int N, int H, int valid, float scale) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + S::tile);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * S::tile);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * S::tile);
  float* Ss = reinterpret_cast<float*>(smem + 4 * S::tile);
  float* dPs = reinterpret_cast<float*>(smem + 4 * S::tile + S::s);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 4 * S::tile + 2 * S::s);
  float* lse_s =
      reinterpret_cast<float*>(smem + 4 * S::tile + 2 * S::s + 2 * S::p);
  float* delta_s = lse_s + BT;
  float* stage = reinterpret_cast<float*>(smem);  // over Q/dO

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const int64_t rs = 3 * int64_t(C);
  const bf16* base = qkv + int64_t(b) * N * rs;
  float* Sw = Ss + warp * 16 * S::LDS;
  float* dPw = dPs + warp * 16 * S::LDS;
  bf16* dSw = dSs + warp * 16 * S::LDP;

  load_rows<D>(Qs, base + h * D, q0, N, rs, tid);
  load_rows<D>(dOs, dout + int64_t(b) * N * C + h * D, q0, N, C, tid);
  load_vecs(lse_s, delta_s, lse + (int64_t(b) * H + h) * N,
            delta + (int64_t(b) * H + h) * N, q0, N, tid);

  Acc dq[D / 16];
#pragma unroll
  for (int f = 0; f < D / 16; ++f) wmma::fill_fragment(dq[f], 0.f);

  // lane pair (2r, 2r+1) owns query row r of the warp: keys [0,32) / [32,64)
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const bool q_ok = q0 + row < N;
  for (int k0 = 0; k0 < valid; k0 += BT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D>(Ks, base + C + h * D, k0, N, rs, tid);
    load_rows<D>(Vs, base + 2 * C + h * D, k0, N, rs, tid);
    __syncthreads();

    // S_w [16 q, 64 keys] = Q_w K^T and dP_w = dO_w V^T (f32)
#pragma unroll
    for (int nt = 0; nt < BT / 16; ++nt) {
      Acc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ARow a;
        BCol bk;
        wmma::load_matrix_sync(a, Qs + warp * 16 * S::LDH + kk * 16, S::LDH);
        wmma::load_matrix_sync(bk, Ks + nt * 16 * S::LDH + kk * 16, S::LDH);
        wmma::mma_sync(s, a, bk, s);
        wmma::load_matrix_sync(a, dOs + warp * 16 * S::LDH + kk * 16, S::LDH);
        wmma::load_matrix_sync(bk, Vs + nt * 16 * S::LDH + kk * 16, S::LDH);
        wmma::mma_sync(dp, a, bk, dp);
      }
      wmma::store_matrix_sync(Sw + nt * 16, s, S::LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(dPw + nt * 16, dp, S::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    const float l = lse_s[row], dl = delta_s[row];
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float ds = 0.f;
      if (q_ok && k0 + c < valid) {
        const float p = expf(Sw[r * S::LDS + c] * scale - l);
        ds = p * (dPw[r * S::LDS + c] - dl) * scale;
      }
      dSw[r * S::LDP + c] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dQ_w += dS_w K
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      ARow as;
      wmma::load_matrix_sync(as, dSw + kk * 16, S::LDP);
#pragma unroll
      for (int nt = 0; nt < D / 16; ++nt) {
        BRow bk;
        wmma::load_matrix_sync(bk, Ks + kk * 16 * S::LDH + nt * 16, S::LDH);
        wmma::mma_sync(dq[nt], as, bk, dq[nt]);
      }
    }
  }

  __syncthreads();  // the staging overwrites the Q/dO tiles
  store_rows<D>(dq, stage + warp * 16 * S::LDO,
                dqkv + int64_t(b) * N * rs + h * D, q0 + warp * 16, N, rs,
                lane);
}

template <int D>
cudaError_t launch(const void* qkv, const void* o, const void* lse,
                   const void* dout, void* delta, void* dqkv, int B, int N,
                   int H, int valid, float scale, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err != cudaSuccess) return err;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16* dst = static_cast<bf16*>(dqkv);

  const int64_t rows = int64_t(B) * N * H;
  flash_bwd_delta_kernel<D><<<unsigned((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(o), g, dl, rows, N, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((N + BT - 1) / BT, H, B);
  flash_bwd_dkdv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, g, l, dl, dst, N, H, valid, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, g, l, dl, dst, N, H, valid, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, N, 3*H*D] bf16, o and dout [B, N, H*D] bf16, lse [B, H, N] f32
// (the forward's), delta [B, H, N] f32 scratch, dqkv [B, N, 3*H*D] bf16
// out; all contiguous.  Returns a cudaError_t; cudaErrorInvalidValue for a
// head_dim not built.
extern "C" int flash_attention_bwd(const void* qkv, const void* o,
                                   const void* lse, const void* dout,
                                   void* delta, void* dqkv, int B, int N,
                                   int H, int D, int valid, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(qkv, o, lse, dout, delta, dqkv, B, N, H, valid, scale,
                        s);
    case 64:
      return launch<64>(qkv, o, lse, dout, delta, dqkv, B, N, H, valid, scale,
                        s);
    case 128:
      return launch<128>(qkv, o, lse, dout, delta, dqkv, B, N, H, valid,
                         scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
