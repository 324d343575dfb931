// K2, the VAE mid-block attention at head_dim 512, for Hopper (sm_90a):
// wgmma fed by TMA, with the 512 output columns split over two consumer
// warp groups.
//
//   K2  tpdm_flash_attention_d512 replaces tpdm_tpu/ops/attention.py
//       _flash_kernel_streaming (driven by _flash_attention_streaming_impl):
//       one head of 512 at (b, 1, 16384, 512) at 1024 px (b = 1, 2) and
//       (1, 1, 65536, 512) at 2048 px, once a decode.
//
// The function is K1's (attn_sm90.cu): scores in the exp2 domain, scaled by
// log2(e)/sqrt(512) in fp32; columns >= kv_len biased to -1e30, never
// zero-filled (a zero fill would pull the running max up to 0 and NaN the
// rows whose valid scores are all strongly negative); p = exp2(s - m) in
// fp32, l summed from the fp32 p, P rounded to bf16 for the PV product;
// O / l written once in bf16. Tile 0 always holds a valid column, so the
// running max is a real score from the first tile on.
//
// What bounds it on the H100: 4 n_q n_kv 512 operations (550 GFLOP at
// 16384, 0.556 ms at 989 TFLOP/s) against 67 MB of operands, so on paper
// the tensor cores. But O's 512 columns limit a block to 64 query rows,
// and each block streams all of K and V through shared memory: 64 FLOP a
// byte read from L2, so K and V must come from L2 at ~64 B a clock an SM
// to feed the tensor cores at their peak. The design:
// - O for 64 rows x 512 columns in fp32 is 256 registers a thread in one
//   warp group, so two consumer warp groups own 256 columns each (128
//   registers; setmaxnreg 240), and a producer warp group (24 registers)
//   whose one thread issues every TMA load: 384 threads, 64 query rows and
//   one batch*head a block, one block an SM (256 blocks at 1024 px, b = 1);
// - q, k, v and o through 3-D tensor maps (512, n, b*h), each row as eight
//   64-column boxes of 128-byte swizzled rows, so a tile never reads the
//   next head's rows and TMA zero-fills rows past n. Q (64 KB) is loaded
//   once a block. K and V come in 64-row tiles (64 KB each), one slot each,
//   reloaded out of phase: S_t, softmax, P_t V_t in turn, so the producer
//   reloads K while P V reads V and V while the next Q K^T reads K. Only
//   tiles below kv_len are loaded; a full and an empty mbarrier guard each
//   slot, and each one's phase flips every tile;
// - S = Q K^T split between the consumers: each computes S for 32 of the
//   tile's 64 columns (wgmma m64n32k16, both operands K-major in shared
//   memory, 32 k16 steps, four a box); the row maxima pass through shared
//   memory under a named barrier, P is written as bf16 into a 128-byte
//   swizzled shared tile (two buffers), and both consumers read the whole
//   P as the A operand of P V; each keeps its share of l, summed once at
//   the end;
// - O += P V: wgmma m64n256k16, V MN-major through the transpose bit. A
//   consumer's 256 columns are four TMA boxes, 8 KB apart: the
//   descriptor's LBO (sm90.cuh);
// - the epilogue writes O / l as bf16 into Q's 64 KB (after both
//   consumers' last S product), and each consumer stores its four boxes by
//   TMA, which drops rows >= n_q.
// On an H100 80GB HBM3 at 700 W this split S in 64-row slots was faster at
// both decode shapes than each consumer computing the whole S with P in
// registers, in 64-row slots or in a 32-row two-stage ring (PERF.md holds
// the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int kD = 512;
constexpr int kBox = 64;  // columns of a TMA box: one 128-byte swizzle row
constexpr int kBoxes = kD / kBox;
constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kSCols = kBKV / 2;  // S columns a consumer computes
constexpr int kThreads = 384;     // two consumer warp groups and the producer
// registers a thread after setmaxnreg (65,536 an SM)
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedScore = -1e30f;
// named barriers (0 is __syncthreads): kBarMax, kBarP and kBarEnd over both
// consumers, kBarStore + c over consumer c
constexpr int kBarMax = 1, kBarP = 2, kBarEnd = 3, kBarStore = 4;

// shared memory: Q, one K and one V slot, two P tiles, the row statistics
constexpr int kBoxQ = kBQ * 128;    // bytes of a 64-column box of Q (and O)
constexpr int kBoxKV = kBKV * 128;  // ... of K or V
constexpr int kTileQ = kBoxes * kBoxQ;
constexpr int kTileKV = kBoxes * kBoxKV;
constexpr int kTileP = kBQ * kBKV * 2;  // bf16, 128 bytes a row
constexpr int kOffK = kTileQ;
constexpr int kOffV = kOffK + kTileKV;
constexpr int kOffP = kOffV + kTileKV;
// each consumer's row maxima (two buffers), then its l
constexpr int kOffStat = kOffP + 2 * kTileP;
constexpr int kOffBar = kOffStat + 3 * 2 * kBQ * 4;
constexpr int kSmemBytes = kOffBar + 8 * 5 + 1024;  // five mbarriers, alignment slack
static_assert(128 * (2 * kConsumerRegs + kProducerRegs) <= 65536, "register file");
static_assert(kSmemBytes <= 232448, "Hopper allows 227 KB of shared memory a block");

// S (64 x 32) = Q K^T over d = 512: 32 k16 steps, four inside each
// 64-column box (+32 bytes, 2 in the descriptor's 16-byte units), then on
// to the next box.
__device__ __forceinline__ void issue_qk(float (&sc)[kSCols / 2], uint64_t desc_q,
                                         uint64_t desc_k) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t at_q = (kk / 4) * (kBoxQ >> 4) + 2 * (kk % 4);
    const uint64_t at_k = (kk / 4) * (kBoxKV >> 4) + 2 * (kk % 4);
    sm90::wgmma_m64n32k16_ss(sc, desc_q + at_q, desc_k + at_k, kk);
  }
}

// O += P V with P from shared memory (K-major, 32 bytes a k16 step) and V
// MN-major, 16 kv rows (2048 bytes) a k16 step.
__device__ __forceinline__ void issue_pv(float (&o)[128], uint64_t desc_p, uint64_t desc_v) {
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk) {
    sm90::wgmma_m64n256k16_ss_tb(o, desc_p + 2 * kk, desc_v + 128 * kk, 1);
  }
}

// S to exp2-domain scores, masked only where the columns reach kv_len, and
// the row maxima of this thread's rows r = 0 (g) and 1 (g + 8), reduced
// over the quad. sc[4j + 2r + {0, 1}] sits at column col0 + 8j + 2q + {0, 1}.
template <int N>
__device__ __forceinline__ void scores_and_max(float (&sc)[N], float (&mx)[2], int col0,
                                               int kv_len, float scale_log2, int q) {
  if (col0 + 2 * N > kv_len) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = col0 + 8 * (i / 4) + 2 * q + (i & 1);
      sc[i] = col < kv_len ? sc[i] * scale_log2 : kMaskedScore;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] *= scale_log2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      m = fmaxf(m, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    mx[r] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  }
}

// The online softmax step given the tile's row maxima: sc to the fp32 p,
// this thread's share of l, and alpha[r], which rescales row r of O.
template <int N>
__device__ __forceinline__ void softmax_step(float (&sc)[N], const float (&mx)[2],
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = exp2f(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      sc[4 * j + 2 * r] = exp2f(sc[4 * j + 2 * r] - m_new);
      sc[4 * j + 2 * r + 1] = exp2f(sc[4 * j + 2 * r + 1] - m_new);
      sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
    l_run[r] = l_run[r] * alpha[r] + sum;
  }
}

__device__ __forceinline__ void rescale(float (&o)[128], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// Where a consumer thread sits: consumer c (columns 256c .. 256c + 255 of
// O), rows row0 and row0 + 8 of the block's 64, and its quad position.
struct Thread {
  int c, row0, g, q;
};

// The softmax of tile t on this consumer's 32 columns of S: scores, row
// maxima exchanged with the other consumer, p, this thread's share of l and
// alpha; P is then written as bf16 to shared buffer t % 2.
__device__ __forceinline__ void softmax_tile(float (&sc)[kSCols / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int t,
                                             int kv_len, float scale_log2, const Thread& th,
                                             unsigned char* smem) {
  float mx[2];
  scores_and_max(sc, mx, t * kBKV + th.c * kSCols, kv_len, scale_log2, th.q);
  float* s_max = reinterpret_cast<float*>(smem + kOffStat) + (t & 1) * 2 * kBQ;
  if (th.q == 0) {
    s_max[th.c * kBQ + th.row0] = mx[0];
    s_max[th.c * kBQ + th.row0 + 8] = mx[1];
  }
  sm90::named_barrier(kBarMax, 256);
  mx[0] = fmaxf(mx[0], s_max[(1 - th.c) * kBQ + th.row0]);
  mx[1] = fmaxf(mx[1], s_max[(1 - th.c) * kBQ + th.row0 + 8]);
  softmax_step(sc, mx, m_run, l_run, alpha);
  // this consumer's 32 columns of P: 16-byte chunks 4c .. 4c + 3 of each
  // 128-byte row, swizzled (row % 8 == g)
  unsigned char* s_p = smem + kOffP + (t & 1) * kTileP;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < kSCols / 8; ++j) {
      *reinterpret_cast<uint32_t*>(s_p + (th.row0 + 8 * r) * 128 +
                                   (((th.c * kSCols / 8 + j) ^ th.g) * 16) + 4 * th.q) =
          sm90::pack_bf16x2(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
    }
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(kBarP, 256);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_d512_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_o, int kv_len,
                           float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = q_full + 2;
  uint64_t* k_empty = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int n_tiles = (kv_len + kBKV - 1) / kBKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(k_full, 1);
    sm90::mbar_init(v_full, 1);
    sm90::mbar_init(k_empty, 256);
    sm90::mbar_init(v_empty, 256);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load, K_t before V_t
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_map(&map_q);
      sm90::tma_prefetch_map(&map_k);
      sm90::tma_prefetch_map(&map_v);
      sm90::mbar_arrive_expect_tx(q_full, kTileQ);
      for (int b = 0; b < kBoxes; ++b) {
        sm90::tma_load_3d(smem + b * kBoxQ, &map_q, q_full, kBox * b, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const uint32_t free_parity = (t & 1) ^ 1;
        sm90::mbar_wait(k_empty, free_parity);
        sm90::mbar_arrive_expect_tx(k_full, kTileKV);
        for (int b = 0; b < kBoxes; ++b) {
          sm90::tma_load_3d(smem + kOffK + b * kBoxKV, &map_k, k_full, kBox * b, t * kBKV, bh);
        }
        sm90::mbar_wait(v_empty, free_parity);
        sm90::mbar_arrive_expect_tx(v_full, kTileKV);
        for (int b = 0; b < kBoxes; ++b) {
          sm90::tma_load_3d(smem + kOffV + b * kBoxKV, &map_v, v_full, kBox * b, t * kBKV, bh);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg;  // this consumer owns columns 256c .. 256c + 255 of O
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2;
    const int q = lane & 3;
    const int row0 = 16 * warp + g;  // rows row0 and row0 + 8 of the 64
    float* stat = reinterpret_cast<float*>(smem + kOffStat);
    const Thread th{c, row0, g, q};
    const uint64_t desc_q = sm90::make_smem_desc(smem, 16, 1024);
    // this consumer's S columns (K rows) inside each K box, and its V boxes
    const uint64_t desc_k = sm90::make_smem_desc(smem + kOffK + c * kSCols * 128, 16, 1024);
    const uint64_t desc_v = sm90::make_smem_desc(smem + kOffV + 4 * c * kBoxKV, kBoxKV, 1024);

    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    // rows g and g + 8 of the warp's 16: running max and this thread's
    // share of the running denominator
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    float sc[kSCols / 2];  // S of the current tile, then its fp32 p

    sm90::mbar_wait(q_full, 0);
    // S_t, softmax, P_t V_t in turn; each slot's phase flips every tile
    for (int t = 0; t < n_tiles; ++t) {
      const uint32_t parity = t & 1;
      sm90::mbar_wait(k_full, parity);
      sm90::wgmma_fence();
      issue_qk(sc, desc_q, desc_k);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::mbar_arrive(k_empty);
      softmax_tile(sc, m_run, l_run, alpha, t, kv_len, scale_log2, th, smem);
      rescale(o, alpha);
      sm90::mbar_wait(v_full, parity);
      sm90::wgmma_fence();
      issue_pv(o, sm90::make_smem_desc(smem + kOffP + (t & 1) * kTileP, 16, 1024), desc_v);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::mbar_arrive(v_empty);
    }

    // l over the whole row: the quad, then the other consumer's columns.
    // Then O / l into Q's boxes 4c .. 4c + 3 (both consumers' last S
    // product is done once both pass kBarEnd), 128-byte swizzled as the o
    // map expects, and four TMA stores
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l;
      if (q == 0) stat[4 * kBQ + c * kBQ + row0 + 8 * r] = l;
    }
    sm90::named_barrier(kBarEnd, 256);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = 1.f / (inv[r] + stat[4 * kBQ + (1 - c) * kBQ + row0 + 8 * r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;  // row % 8 == g
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        unsigned char* box = smem + (4 * c + j / 8) * kBoxQ;
        *reinterpret_cast<uint32_t*>(box + row * 128 + (((j % 8) ^ g) * 16) + 4 * q) =
            sm90::pack_bf16x2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(kBarStore + c, 128);
    if ((threadIdx.x & 127) == 0) {
      for (int b = 4 * c; b < 4 * c + 4; ++b) {
        sm90::tma_store_3d(&map_o, smem + b * kBoxQ, kBox * b, q0, bh);
      }
      sm90::tma_store_commit();
      sm90::tma_store_wait();
    }
  }
}

}  // namespace

// K2. q, o: (bh, n_q, 512); k, v: (bh, n_kv, 512); bf16, contiguous, 16-byte
// aligned. Columns at or past kv_len (1 <= kv_len <= n_kv) are masked.
// Returns a cudaError_t.
extern "C" int tpdm_flash_attention_d512(const void* q, const void* k, const void* v, void* o,
                                         int bh, int n_q, int n_kv, int kv_len, void* stream) {
  for (const void* p : {q, k, v, static_cast<const void*>(o)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  CUtensorMap map_q, map_k, map_v, map_o;
  const uint64_t row = kD * 2;
  const uint64_t dims_q[3] = {kD, static_cast<uint64_t>(n_q), static_cast<uint64_t>(bh)};
  const uint64_t dims_kv[3] = {kD, static_cast<uint64_t>(n_kv), static_cast<uint64_t>(bh)};
  const uint64_t strides_q[2] = {row, row * n_q};
  const uint64_t strides_kv[2] = {row, row * n_kv};
  const uint32_t box_q[3] = {kBox, kBQ, 1};
  const uint32_t box_kv[3] = {kBox, kBKV, 1};
  int err = sm90::make_tensor_map(&map_q, q, 3, dims_q, strides_q, box_q);
  if (err == 0) err = sm90::make_tensor_map(&map_k, k, 3, dims_kv, strides_kv, box_kv);
  if (err == 0) err = sm90::make_tensor_map(&map_v, v, 3, dims_kv, strides_kv, box_kv);
  if (err == 0) err = sm90::make_tensor_map(&map_o, o, 3, dims_q, strides_q, box_q);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_attn_d512_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_q + kBQ - 1) / kBQ, bh);
  flash_attn_d512_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, map_o, kv_len, kLog2e / sqrtf(static_cast<float>(kD)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
