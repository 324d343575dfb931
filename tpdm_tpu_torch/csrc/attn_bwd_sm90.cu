// K1's backward for Hopper (sm_90a): dQ, dK and dV of softmax(Q K^T / sqrt(d)) V
// at head dim 64, and at any head dim below 64 on operands zero-padded to 64
// columns (the scale is the true head dim's).
//
// It replaces no Pallas kernel. The JAX package differentiates K1
// (tpdm_tpu/ops/attention.py:_resident_flash_attention) by a dense
// recompute through attention_reference (its custom VJP's _bwd, :449), an
// XLA program. On the card that recompute would hold the (n, n) scores,
// probabilities and their gradients in fp32: ~1.9 GB each at the 1024 px
// CFG batch (2, 24, 4480, 64), in every one of the 24 layers a DRaFT step
// differentiates. This kernel recomputes the scores tile by tile instead
// (FlashAttention-2's backward) and never writes an n x n array.
//
// The function, per batch*head, with s2 = q.k * scale_log2 (the exp2
// domain of the forward, scale_log2 = log2(e) / sqrt(head_dim)) and the
// forward's row statistic lse = m + log2(l) (K3's m and l):
//   p = exp2(s2 - lse), 0 at columns >= kv_len and at rows >= n_q;
//   dp = dO V^T;  ds = p (dp - D), D = rowsum(dO o O) (the wrapper's);
//   dV = p^T dO;  dK = scale ds^T Q;  dQ = scale ds K,  scale = 1 / sqrt(d).
// p and ds are rounded to bf16 for the products (as the forward rounds P
// for PV); every product accumulates in fp32; dQ, dK, dV are written in
// bf16. Rows of K and V at or past kv_len get dK = dV = 0, written.
//
// Two kernels, so that no sum crosses blocks and the result does not
// depend on the order blocks run in (no atomics):
//   attn_bwd_dkdv_kernel: a block owns 64 kv rows of one batch*head and
//     walks every 64-row q tile: S = Q K^T and dP = dO V^T, then
//     dV += P^T dO and dK += dS^T Q in registers;
//   attn_bwd_dq_kernel: a block owns 64 q rows and walks the kv tiles
//     below kv_len: S, dP, then dQ += dS K.
// The scores are computed twice (once in each), 7 products of 64 x 64 x 64
// a (q tile, kv tile) pair against the 5 a fused kernel would run.
//
// What bounds it on the H100: compute. At (2, 24, 4480, 64) the backward's
// products are 2.5 x the forward's 246 GFLOP; the bytes (q, k, v, o, dO,
// dQ, dK, dV in bf16) are ~0.3 GB. This first version is the simple one:
// warp-level bf16 tensor-core products (nvcuda::wmma, 16 x 16 x 16, fp32
// accumulators) on tiles that every thread loads into shared memory with
// 16-byte loads, four warps a block, one q (or kv) row strip of 16 a warp.
// No TMA, no wgmma, no pipelining of the loads behind the products; its
// time against the bound is in PERF.md, and its redesign on the wgmma +
// TMA template of attn_sm90.cu is queued (ROADMAP queue 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // head dim, padded
constexpr int kT = 64;         // rows of a q tile and of a kv tile
constexpr int kWarps = 4;      // each owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;
constexpr int kLdH = kD + 8;   // bf16 row stride in shared memory: 144 bytes
constexpr int kLdF = kT + 4;   // fp32 row stride: 272 bytes
constexpr int kTileH = kT * kLdH;  // bf16 elements of one tile
constexpr int kTileF = kT * kLdF;  // fp32 elements of one tile
// q, dO, k, v, p, ds tiles in bf16; s and dp in fp32; lse and D for 64 rows
constexpr int kSmemBytes = 6 * kTileH * 2 + 2 * kTileF * 4 + 2 * kT * 4;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kTileH * 2 % 32 == 0 && kTileF * 4 % 32 == 0, "wmma wants 32-byte aligned tiles");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Smem {
  bf16 *q, *dout, *k, *v, *p, *ds;
  float *s, *dp, *lse, *delta;
};

__device__ __forceinline__ Smem carve(unsigned char* base) {
  Smem m;
  bf16* h = reinterpret_cast<bf16*>(base);
  m.q = h;
  m.dout = h + kTileH;
  m.k = h + 2 * kTileH;
  m.v = h + 3 * kTileH;
  m.p = h + 4 * kTileH;
  m.ds = h + 5 * kTileH;
  float* f = reinterpret_cast<float*>(h + 6 * kTileH);
  m.s = f;
  m.dp = f + kTileF;
  m.lse = f + 2 * kTileF;
  m.delta = m.lse + kT;
  return m;
}

// rows [row0, row0 + 64) of a (n, 64) bf16 matrix into a tile, 16 bytes a
// thread a step; rows at or past n are zero
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, int row0, int n) {
  for (int c = threadIdx.x; c < kT * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * kD + col);
    *reinterpret_cast<uint4*>(tile + r * kLdH + col) = val;
  }
}

// this warp's 16 rows of S = Q K^T and dP = dO V^T into sm.s and sm.dp
__device__ __forceinline__ void scores_and_dp(const Smem& sm, int warp) {
  FragC s_acc[kT / 16], dp_acc[kT / 16];
#pragma unroll
  for (int n = 0; n < kT / 16; ++n) {
    wmma::fill_fragment(s_acc[n], 0.0f);
    wmma::fill_fragment(dp_acc[n], 0.0f);
  }
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    FragA a_q, a_do;
    wmma::load_matrix_sync(a_q, sm.q + 16 * warp * kLdH + 16 * kk, kLdH);
    wmma::load_matrix_sync(a_do, sm.dout + 16 * warp * kLdH + 16 * kk, kLdH);
#pragma unroll
    for (int n = 0; n < kT / 16; ++n) {
      // K^T and V^T (d x kv) read as column-major views of the row-major tiles
      FragBt b_k, b_v;
      wmma::load_matrix_sync(b_k, sm.k + 16 * n * kLdH + 16 * kk, kLdH);
      wmma::mma_sync(s_acc[n], a_q, b_k, s_acc[n]);
      wmma::load_matrix_sync(b_v, sm.v + 16 * n * kLdH + 16 * kk, kLdH);
      wmma::mma_sync(dp_acc[n], a_do, b_v, dp_acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kT / 16; ++n) {
    wmma::store_matrix_sync(sm.s + 16 * warp * kLdF + 16 * n, s_acc[n], kLdF, wmma::mem_row_major);
    wmma::store_matrix_sync(sm.dp + 16 * warp * kLdF + 16 * n, dp_acc[n], kLdF,
                            wmma::mem_row_major);
  }
}

// p and ds of this warp's 16 rows, in bf16 (p only where keep_p)
__device__ __forceinline__ void probs_and_ds(const Smem& sm, int warp, int q0, int n_q, int kv0,
                                             int kv_len, float scale_log2, bool keep_p) {
  const int lane = threadIdx.x % 32;
#pragma unroll 4
  for (int i = lane; i < 16 * kT; i += 32) {
    const int r = 16 * warp + i / kT, c = i % kT;
    float p = 0.0f, ds = 0.0f;
    if (q0 + r < n_q && kv0 + c < kv_len) {
      p = exp2f(sm.s[r * kLdF + c] * scale_log2 - sm.lse[r]);
      ds = p * (sm.dp[r * kLdF + c] - sm.delta[r]);
    }
    if (keep_p) sm.p[r * kLdH + c] = __float2bfloat16(p);
    sm.ds[r * kLdH + c] = __float2bfloat16(ds);
  }
}

// scale the accumulators, stage them through fp32 shared memory (this
// warp's rows of `stage`) and write rows row0.. (< n) in bf16; rows at or
// past `valid` are written as zeros
__device__ __forceinline__ void write_rows(FragC* acc, float scale, float* stage, int warp,
                                           bf16* dst, int row0, int n, int valid) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) {
#pragma unroll
    for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= scale;
    wmma::store_matrix_sync(stage + 16 * warp * kLdF + 16 * j, acc[j], kLdF, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kD; i += 32) {
    const int r = 16 * warp + i / kD, c = i % kD, row = row0 + r;
    if (row < n)
      dst[static_cast<size_t>(row) * kD + c] =
          __float2bfloat16(row < valid ? stage[r * kLdF + c] : 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int n_q, int n_kv, int kv_len,
                     float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);
  const int warp = threadIdx.x / 32, bh = blockIdx.y, kv0 = blockIdx.x * kT;
  const size_t off_q = static_cast<size_t>(bh) * n_q * kD;
  const size_t off_kv = static_cast<size_t>(bh) * n_kv * kD;
  FragC acc_dk[kD / 16], acc_dv[kD / 16];
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.0f);
    wmma::fill_fragment(acc_dv[j], 0.0f);
  }
  if (kv0 < kv_len) {  // a tile wholly past kv_len only writes its zeros
    load_tile(sm.k, k + off_kv, kv0, n_kv);
    load_tile(sm.v, v + off_kv, kv0, n_kv);
    for (int q0 = 0; q0 < n_q; q0 += kT) {
      __syncthreads();  // the last tile's q, dO, p and ds are read
      load_tile(sm.q, q + off_q, q0, n_q);
      load_tile(sm.dout, dout + off_q, q0, n_q);
      if (threadIdx.x < kT) {
        const int row = q0 + threadIdx.x;
        sm.lse[threadIdx.x] = row < n_q ? lse[static_cast<size_t>(bh) * n_q + row] : 0.0f;
        sm.delta[threadIdx.x] = row < n_q ? delta[static_cast<size_t>(bh) * n_q + row] : 0.0f;
      }
      __syncthreads();
      scores_and_dp(sm, warp);
      __syncwarp();
      probs_and_ds(sm, warp, q0, n_q, kv0, kv_len, scale_log2, true);
      __syncthreads();  // every warp's rows of p and ds
      // this warp's 16 kv rows: dV += P^T dO, dK += dS^T Q (P^T and dS^T
      // read as column-major views of the row-major [q][kv] tiles)
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        FragAt a_pt, a_dst;
        wmma::load_matrix_sync(a_pt, sm.p + 16 * kk * kLdH + 16 * warp, kLdH);
        wmma::load_matrix_sync(a_dst, sm.ds + 16 * kk * kLdH + 16 * warp, kLdH);
#pragma unroll
        for (int j = 0; j < kD / 16; ++j) {
          FragB b_do, b_q;
          wmma::load_matrix_sync(b_do, sm.dout + 16 * kk * kLdH + 16 * j, kLdH);
          wmma::mma_sync(acc_dv[j], a_pt, b_do, acc_dv[j]);
          wmma::load_matrix_sync(b_q, sm.q + 16 * kk * kLdH + 16 * j, kLdH);
          wmma::mma_sync(acc_dk[j], a_dst, b_q, acc_dk[j]);
        }
      }
    }
  }
  __syncthreads();  // s and dp become the epilogue's staging
  write_rows(acc_dk, scale, sm.s, warp, dk + off_kv, kv0, n_kv, kv_len);
  write_rows(acc_dv, 1.0f, sm.dp, warp, dv + off_kv, kv0, n_kv, kv_len);
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int n_q, int n_kv, int kv_len, float scale_log2,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);
  const int warp = threadIdx.x / 32, bh = blockIdx.y, q0 = blockIdx.x * kT;
  const size_t off_q = static_cast<size_t>(bh) * n_q * kD;
  const size_t off_kv = static_cast<size_t>(bh) * n_kv * kD;
  load_tile(sm.q, q + off_q, q0, n_q);
  load_tile(sm.dout, dout + off_q, q0, n_q);
  if (threadIdx.x < kT) {
    const int row = q0 + threadIdx.x;
    sm.lse[threadIdx.x] = row < n_q ? lse[static_cast<size_t>(bh) * n_q + row] : 0.0f;
    sm.delta[threadIdx.x] = row < n_q ? delta[static_cast<size_t>(bh) * n_q + row] : 0.0f;
  }
  FragC acc_dq[kD / 16];
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) wmma::fill_fragment(acc_dq[j], 0.0f);
  for (int kv0 = 0; kv0 < kv_len; kv0 += kT) {
    __syncthreads();  // every warp is done with the last k and v tiles
    load_tile(sm.k, k + off_kv, kv0, n_kv);
    load_tile(sm.v, v + off_kv, kv0, n_kv);
    __syncthreads();
    scores_and_dp(sm, warp);
    __syncwarp();
    probs_and_ds(sm, warp, q0, n_q, kv0, kv_len, scale_log2, false);
    __syncwarp();  // this warp's rows of ds: dQ needs no other warp's
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      FragA a_ds;
      wmma::load_matrix_sync(a_ds, sm.ds + 16 * warp * kLdH + 16 * kk, kLdH);
#pragma unroll
      for (int j = 0; j < kD / 16; ++j) {
        FragB b_k;
        wmma::load_matrix_sync(b_k, sm.k + 16 * kk * kLdH + 16 * j, kLdH);
        wmma::mma_sync(acc_dq[j], a_ds, b_k, acc_dq[j]);
      }
    }
  }
  __syncwarp();
  write_rows(acc_dq, scale, sm.s, warp, dq + off_q, q0, n_q, n_q);
}

}  // namespace

// K1's backward. q, dout, dq: (bh, n_q, 64); k, v, dk, dv: (bh, n_kv, 64);
// bf16, contiguous, 16-byte aligned (padded past head_dim with zeros, where
// head_dim < 64). lse, delta: (bh, n_q) fp32: the forward's m + log2(l)
// (exp2 domain) and rowsum(dO o O). Columns at or past kv_len
// (1 <= kv_len <= n_kv) are masked. Launches the dK/dV kernel, then the dQ
// kernel, on `stream`. Returns a cudaError_t.
extern "C" int tpdm_flash_attention_bwd_d64(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dq, void* dk, void* dv, int bh, int n_q,
                                            int n_kv, int kv_len, int head_dim, void* stream) {
  if (head_dim < 1 || head_dim > kD || kv_len < 1 || kv_len > n_kv || n_q < 1 || bh < 1 ||
      bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bf16* qh = static_cast<const bf16*>(q);
  const bf16* kh = static_cast<const bf16*>(k);
  const bf16* vh = static_cast<const bf16*>(v);
  const bf16* doh = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  attn_bwd_dkdv_kernel<<<dim3((n_kv + kT - 1) / kT, bh), kThreads, kSmemBytes, s>>>(
      qh, kh, vh, doh, lf, df, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_q, n_kv,
      kv_len, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dq_kernel<<<dim3((n_q + kT - 1) / kT, bh), kThreads, kSmemBytes, s>>>(
      qh, kh, vh, doh, lf, df, static_cast<bf16*>(dq), n_q, n_kv, kv_len, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
