// K1, the MMDiT joint attention, and K3, the same attention with each query
// row's softmax statistics, for Hopper (sm_90a): one kernel template, wgmma
// fed by TMA through an mbarrier ring, with a producer warp.
//
//   K1  tpdm_flash_attention_d64 replaces tpdm_tpu/ops/attention.py
//       _flash_kernel (+ _chunk_walk): softmax(Q K^T / sqrt(d)) V for each
//       batch*head at d = 64, q/k/v (2b, 24, 4480, 64) with kv_len = 4429
//       at 1024 px, 24 calls a step.
//   K1 at d 40, 80 and 160 (tpdm_flash_attention_d40 / _d80 / _d160): the
//       same function at the SD1.5 UNet's head dims (8 heads of C/8 at
//       C = 320, 640, 1280): self-attention q = k = v (2b, 8, 4096, 40),
//       (2b, 8, 1024, 80), (2b, 8, 256, 160) and the mid block's
//       (2b, 8, 64, 160); cross-attention against the 77 text tokens,
//       kv (2b, 8, 77, d); 32 calls a CFG forward at 512 px.
//   K1 at d 128 (tpdm_flash_attention_d128): FLUX.1's 24 heads of 128 over
//       the joint [text, image] sequence, q = k = v (b, 24, 4608, 128) at
//       1024 px (512 T5 tokens + 4096 image tokens, no padding, no kv_len),
//       57 calls a forward (19 double + 38 single blocks).
//   K1 at any other head dim below 64 (tpdm_flash_attention_d64_padded):
//       the d-64 kernel on q, k, v zero-padded to 64 columns on the host,
//       with the true d's scale (the toy UNets' d 4, 6 and 8).
//   K3 tpdm_flash_attention_stats_d64 replaces tpdm_tpu/ops/attention.py
//       _flash_kernel_stats: K1 plus each query row's m and l, the local
//       step of the sequence-parallel ring (parallel/sp_attention.py). At
//       2048 px a ring of one runs q (2b, 24, 16717, 64) against the image
//       kv (2b, 24, 16384, 64) and the 333 text tokens; rank 0 of four runs
//       q (2b, 24, 4429, 64) against kv shards of 4096 rows and the text.
//
// The function: scores in the exp2 domain, scaled by log2(e)/sqrt(d) in
// fp32; columns >= kv_len biased to -1e30, never zero-filled (a zero fill
// would pull the running max up to 0, and when every valid score is
// strongly negative all valid exp2(s - 0) underflow and the row becomes
// 0/0; tile 0 always holds a valid column, so the running max is a real
// score from the first tile on); p = exp2(s - m) in fp32, the running
// denominator l summed from the fp32 p, P rounded to bf16 for the PV
// product; O / l written once in bf16. K3 (kStats) also writes, as fp32,
// m = the largest exp2-domain score over the columns < kv_len (the running
// max, identical across the 4 threads of a quad after the shuffles) and
// l = sum exp2(s - m) over them, summed from the fp32 p and reduced over
// the quad exactly as the O epilogue reduces it before dividing. These are
// the statistics that the ring's merge and merge_attention_shards combine.
//
// What bounds it on the H100: compute. K1: 246 GFLOP over 110 MB at the
// shape above. K3: 3.37 TFLOP in the ring of one's image call (3.40 ms at
// 989 TFLOP/s), and its statistics add 8 bytes a query row to the bytes
// moved. So the tensor cores and how well they are fed. The design:
// - one block a (64 x kConsumers query rows, batch*head), one block an SM;
//   kConsumers + 1 warp groups: each consumer owns 64 query rows (registers
//   up to 160 with three consumers, 240 with two), and one producer
//   (registers down to 24) whose one thread issues every TMA load. Three
//   consumers beat two at the 1024 px shape (0.618 against 0.686 ms on an
//   H100 80GB HBM3 at 700 W, scripts/sm90_variants.py); with few heads a
//   long sequence fills the card's 132 SMs better with two (BQ 128). K3
//   keeps three at both ring shapes: they beat two at rank 0 of four
//   (0.621 against 0.662 ms, the same card and script) and at the ring of
//   one within the spread of rounds (8.47 against 8.83 ms median), so one
//   instantiation serves every n_q;
// - q, k, v and o through 3-D tensor maps (64, n, b*h), so a tile never
//   reads the next head's rows: TMA zero-fills rows past n. Q is loaded
//   once a block; K and V come as 128 x 64 tiles through a 2-stage ring,
//   each stage with a full barrier for K, one for V, and an empty barrier
//   that every consumer thread arrives on. Only the tiles below kv_len
//   are loaded, and the last of them is masked by the bias: the ring's
//   text call (n_kv 333) reads past n_kv there, into TMA's zero fill;
// - S = Q K^T: wgmma m64n128k16 from shared memory (both K-major), four
//   k16 steps; the 64 x 128 fp32 S stays in registers (64 a thread, two
//   rows a thread), the row max and sum reduce over the 4 threads of a
//   quad, and m and l stay in registers. The mask runs only in the tile
//   that holds kv_len;
// - O = alpha O + P V: wgmma m64n64k16 with A = P from registers (the S
//   accumulator converted pairwise to bf16x2 is already the A fragment)
//   and B = V from shared memory, MN-major through the transpose bit;
// - the epilogue writes O / l as bf16 into the warp group's own Q rows
//   (128-byte swizzled, conflict free) and stores the 64 x 64 tile with
//   one TMA store, which drops rows >= n_q. K3's m and l are plain stores
//   from one thread of each quad (rows g and g + 8), guarded by n_q.
// Head dims other than 64: a row of d bf16 is padded to kChunks boxes of
// 64 columns (d 40 -> 64, d 80 -> 128, d 160 -> 192; d 128 fills its two
// boxes exactly). The tensor maps keep the true extent d in their inner
// dimension, so TMA zero-fills a box past column d on load and drops those
// columns on store: the zero Q and K columns add nothing to Q K^T, the
// zero V columns give O columns that the store clips. Each 64-column box
// of a tile lies in shared memory as a tile of its own (rows x 128 bytes,
// swizzled), so S = Q K^T runs 4 k16 steps a box and O = P V one m64n64
// product a box, on the layouts of d 64. The softmax scale is 1/sqrt(d) of
// the true d, passed from the host. The ring needs 2 x (K + V) tiles of
// 128 x 64 kChunks beside Q: d 80 and d 128 share two consumers (160 KB;
// the O accumulator, 64 x 128 fp32, is 64 registers a thread beside S's
// 64), d 160 takes one consumer (Q 24 KB, the ring 192 KB: 216 KB of the
// 227) and its O accumulator (64 x 192 fp32) is 96 registers a thread
// beside S's 64 and P's 32. These instantiations are right first; their
// speed is not tuned.
// Overlap: each warp group issues S of tile t before P V of tile t - 1
// and runs tile t's softmax while that product is in flight (two wgmma
// groups in flight, waited in order), and the consumer warp groups, on
// their own rows, fill each other's gaps. A third ring stage bought
// nothing measurable at the 1024 px shape, so the ring keeps two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int kBox = 64;  // bf16 columns of a TMA box: 128 bytes, one swizzle row
constexpr int kBoxRow = kBox * 2;
// consumer warp groups of each instantiation (see the note at the top)
constexpr int kK1Consumers = 3;
constexpr int kK3Consumers = 3;
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (65,536 an SM)
constexpr int kProducerRegs = 24;
constexpr int kBKV = 128;
constexpr int kStages = 2;
constexpr int kBoxKV = kBKV * kBoxRow;  // one 64-column box of a K or V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedScore = -1e30f;

// The layout of a block with kConsumers consumer warp groups and rows of
// kChunks 64-column boxes. Q's box c holds the block's kBQ rows (each warp
// group's 64 together); a K or V tile's box c its 128 rows.
template <int kConsumers, int kChunks>
struct Cfg {
  // one consumer keeps the launch's registers (255 a thread at 256
  // threads) and reallocates none
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kBQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBoxQ = kBQ * kBoxRow;
  static constexpr int kTileQ = kChunks * kBoxQ;
  static constexpr int kTileKV = kChunks * kBoxKV;
  // ring stages: d 160's tiles leave room for two only
  static constexpr int kRing = kChunks == 3 ? 2 : kStages;
  static constexpr int kOffK = kTileQ;
  static constexpr int kOffV = kOffK + kRing * kTileKV;
  static constexpr int kOffBar = kOffV + kRing * kTileKV;
  static constexpr int kSmemBytes = kOffBar + 8 * (1 + 3 * kRing) + 1024;  // + alignment slack
  static_assert(kConsumers >= 1 && kConsumers <= 3, "one to three consumer warp groups");
  static_assert(kChunks >= 1 && kChunks <= 3, "head dims up to 192 columns");
  static_assert(kConsumers == 1 ||
                    128 * (kConsumers * kConsumerRegs + kProducerRegs) <= 65536,
                "register file");
  static_assert(kSmemBytes <= 232448, "Hopper allows 227 KB of shared memory a block");
};

// S (64 x 128) = Q K^T for one warp group: both operands K-major, four k16
// steps of +32 bytes (2 in the descriptor's 16-byte address units) a box;
// box c of Q starts box_q bytes after box c - 1, of K kBoxKV bytes.
template <int kChunks>
__device__ __forceinline__ void issue_qk(float (&sc)[64], const unsigned char* s_q, int box_q,
                                         const unsigned char* s_k) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint64_t desc_q = sm90::make_smem_desc(s_q + c * box_q, 16, 1024);
    const uint64_t desc_k = sm90::make_smem_desc(s_k + c * kBoxKV, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_m64n128k16_ss(sc, desc_q + 2 * kk, desc_k + 2 * kk, c + kk);
    }
  }
}

// O += P V, one m64n64 product a 64-column box of V: the A fragment of k16
// step kk is p[4kk .. 4kk + 3]; V is MN-major, 16 kv rows (2048 bytes) a
// k16 step.
template <int kChunks>
__device__ __forceinline__ void issue_pv(float (&o)[kChunks][32], const uint32_t (&p)[32],
                                         const unsigned char* s_v) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint64_t desc_v = sm90::make_smem_desc(s_v + c * kBoxKV, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      sm90::wgmma_m64n64k16_rs_tb(o[c], a, desc_v + 128 * kk, 1);
    }
  }
}

// The online softmax of one kv tile starting at column kv0, in place: S to
// exp2-domain scores (masked only in the tile that holds kv_len), then to
// the fp32 p. Rows r = 0 (g) and 1 (g + 8) hold sc[4j + 2r + {0, 1}], at
// columns 8j + 2q + {0, 1}; alpha[r] rescales the row's O.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int kv0,
                                             int kv_len, float scale_log2, int q) {
  if (kv0 + kBKV > kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = kv0 + 8 * (i / 4) + 2 * q + (i & 1);
      sc[i] = col < kv_len ? sc[i] * scale_log2 : kMaskedScore;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    alpha[r] = exp2f(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j + 2 * r] = exp2f(sc[4 * j + 2 * r] - m_new);
      sc[4 * j + 2 * r + 1] = exp2f(sc[4 * j + 2 * r + 1] - m_new);
      sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
    l_run[r] = l_run[r] * alpha[r] + sum;
  }
}

template <int kChunks>
__device__ __forceinline__ void rescale(float (&o)[kChunks][32], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[c][4 * j + 0] *= alpha[0];
      o[c][4 * j + 1] *= alpha[0];
      o[c][4 * j + 2] *= alpha[1];
      o[c][4 * j + 3] *= alpha[1];
    }
  }
}

template <int kChunks>
__device__ __forceinline__ void fence_o(float (&o)[kChunks][32]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) sm90::fence_regs(o[c]);
}

// P rounded to bf16, pairwise: p[2j + r] holds row r's columns 8j + 2q,
// 8j + 2q + 1, so p[4kk .. 4kk + 3] is mma's A fragment of k16 step kk.
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&sc)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      p[2 * j + r] = sm90::pack_bf16x2(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
    }
  }
}

// m_out, l_out: (bh, n_q) fp32, written by K3 (kStats) only.
template <bool kStats, int kConsumers, int kChunks>
__global__ void __launch_bounds__(128 * (kConsumers + 1), 1)
    flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_o, float* __restrict__ m_out,
                           float* __restrict__ l_out, int n_q, int kv_len, float scale_log2) {
  using C = Cfg<kConsumers, kChunks>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::kRing;
  uint64_t* kv_empty = v_full + C::kRing;

  const int q0 = blockIdx.x * C::kBQ;
  const int bh = blockIdx.y;
  const int n_tiles = (kv_len + kBKV - 1) / kBKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < C::kRing; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 128 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every load, a TMA box per 64 columns
    if constexpr (kConsumers > 1) sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      sm90::tma_prefetch_map(&map_q);
      sm90::tma_prefetch_map(&map_k);
      sm90::tma_prefetch_map(&map_v);
      sm90::mbar_arrive_expect_tx(q_full, C::kTileQ);
      for (int c = 0; c < kChunks; ++c) {
        sm90::tma_load_3d(smem + c * C::kBoxQ, &map_q, q_full, c * kBox, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::kRing;
        unsigned char* s_k = smem + C::kOffK + s * C::kTileKV;
        unsigned char* s_v = smem + C::kOffV + s * C::kTileKV;
        sm90::mbar_wait(&kv_empty[s], ((t / C::kRing) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&k_full[s], C::kTileKV);
        for (int c = 0; c < kChunks; ++c) {
          sm90::tma_load_3d(s_k + c * kBoxKV, &map_k, &k_full[s], c * kBox, t * kBKV, bh);
        }
        sm90::mbar_arrive_expect_tx(&v_full[s], C::kTileKV);
        for (int c = 0; c < kChunks; ++c) {
          sm90::tma_load_3d(s_v + c * kBoxKV, &map_v, &v_full[s], c * kBox, t * kBKV, bh);
        }
      }
    }
  } else {
    if constexpr (kConsumers > 1) sm90::setmaxnreg_inc<C::kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2;
    const int q = lane & 3;
    // this warp group's 64 rows of Q's box 0; box c is c * kBoxQ further
    unsigned char* s_q = smem + wg * 64 * kBoxRow;

    float o[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    }
    // rows g and g + 8 of the warp's 16: running max and this thread's
    // share of the running denominator
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float sc[64];   // S of the current tile, then its fp32 p
    uint32_t p[32];  // bf16 P of the previous tile, the A operand of PV

    // tile 0: S alone
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&k_full[0], 0);
    sm90::wgmma_fence();
    issue_qk<kChunks>(sc, s_q, C::kBoxQ, smem + C::kOffK);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    float alpha[2];
    softmax_tile(sc, m_run, l_run, alpha, 0, kv_len, scale_log2, q);
    pack_p(p, sc);

    // tile t: S_t is issued before P_{t-1} V_{t-1}, so the softmax of S_t
    // runs while the tensor cores take the PV product
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % C::kRing;
      const int prev = (t - 1) % C::kRing;
      sm90::mbar_wait(&k_full[s], (t / C::kRing) & 1);
      sm90::mbar_wait(&v_full[prev], ((t - 1) / C::kRing) & 1);
      sm90::wgmma_fence();
      issue_qk<kChunks>(sc, s_q, C::kBoxQ, smem + C::kOffK + s * C::kTileKV);
      sm90::wgmma_commit();
      issue_pv<kChunks>(o, p, smem + C::kOffV + prev * C::kTileKV);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S_t is in
      sm90::fence_regs(sc);
      softmax_tile(sc, m_run, l_run, alpha, t * kBKV, kv_len, scale_log2, q);
      sm90::wgmma_wait<0>();  // P_{t-1} V_{t-1} is in: stage prev is free
      fence_o(o);
      sm90::fence_regs(p);
      sm90::mbar_arrive(&kv_empty[prev]);
      rescale(o, alpha);
      pack_p(p, sc);
    }
    const int last = (n_tiles - 1) % C::kRing;
    sm90::mbar_wait(&v_full[last], ((n_tiles - 1) / C::kRing) & 1);
    sm90::wgmma_fence();
    issue_pv<kChunks>(o, p, smem + C::kOffV + last * C::kTileKV);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_o(o);
    sm90::fence_regs(p);
    sm90::mbar_arrive(&kv_empty[last]);

    // O / l into this warp group's Q rows (its last S product is done),
    // 128-byte swizzled as the o map expects, then one TMA store a box; K3's m
    // and l (the quad's reduced l) from one thread of the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = 16 * warp + g + 8 * r;  // row % 8 == g
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(s_q + c * C::kBoxQ + row * kBoxRow + ((j ^ g) * 16) +
                                       4 * q) =
              sm90::pack_bf16x2(o[c][4 * j + 2 * r] * inv, o[c][4 * j + 2 * r + 1] * inv);
        }
      }
      if constexpr (kStats) {
        const int row_q = q0 + 64 * wg + row;
        if (q == 0 && row_q < n_q) {
          const size_t at = static_cast<size_t>(bh) * n_q + row_q;
          m_out[at] = m_run[r];
          l_out[at] = l;
        }
      }
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + wg, 128);
    if ((threadIdx.x & 127) == 0 && q0 + 64 * wg < n_q) {
      for (int c = 0; c < kChunks; ++c) {
        sm90::tma_store_3d(&map_o, s_q + c * C::kBoxQ, c * kBox, q0 + 64 * wg, bh);
      }
      sm90::tma_store_commit();
      sm90::tma_store_wait();
    }
  }
}

// log2(e) / sqrt(d): the scores' scale of the true head dim d, not the padded one
inline float scale_of(int d) { return kLog2e / sqrtf(static_cast<float>(d)); }

// q, o: (bh, n_q, d); k, v: (bh, n_kv, d); bf16, contiguous, 16-byte
// aligned, d <= 64 kChunks (the tensor maps' inner extent: a box past it
// is zero-filled on load and clipped on store); m, l (kStats): (bh, n_q)
// fp32. Columns at or past kv_len (1 <= kv_len <= n_kv) are masked;
// scale_log2 multiplies the scores (scale_of(d) for an unpadded d).
// Returns a cudaError_t.
template <bool kStats, int kConsumers, int kChunks>
int launch(int d, float scale_log2, const void* q, const void* k, const void* v, void* o, void* m, void* l,
           int bh, int n_q, int n_kv, int kv_len, void* stream) {
  using C = Cfg<kConsumers, kChunks>;
  for (const void* p : {q, k, v, static_cast<const void*>(o)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  CUtensorMap map_q, map_k, map_v, map_o;
  const uint64_t row = static_cast<uint64_t>(d) * 2;  // a multiple of 16 bytes for d % 8 == 0
  const uint64_t dims_q[3] = {static_cast<uint64_t>(d), static_cast<uint64_t>(n_q),
                              static_cast<uint64_t>(bh)};
  const uint64_t dims_kv[3] = {static_cast<uint64_t>(d), static_cast<uint64_t>(n_kv),
                               static_cast<uint64_t>(bh)};
  const uint64_t strides_q[2] = {row, row * n_q};
  const uint64_t strides_kv[2] = {row, row * n_kv};
  const uint32_t box_q[3] = {kBox, C::kBQ, 1};
  const uint32_t box_kv[3] = {kBox, kBKV, 1};
  const uint32_t box_o[3] = {kBox, 64, 1};
  int err = sm90::make_tensor_map(&map_q, q, 3, dims_q, strides_q, box_q);
  if (err == 0) err = sm90::make_tensor_map(&map_k, k, 3, dims_kv, strides_kv, box_kv);
  if (err == 0) err = sm90::make_tensor_map(&map_v, v, 3, dims_kv, strides_kv, box_kv);
  if (err == 0) err = sm90::make_tensor_map(&map_o, o, 3, dims_q, strides_q, box_o);
  if (err != 0) return err;
  auto kernel = flash_attn_sm90_kernel<kStats, kConsumers, kChunks>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_q + C::kBQ - 1) / C::kBQ, bh);
  kernel<<<grid, C::kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, map_o, static_cast<float*>(m), static_cast<float*>(l), n_q, kv_len,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. q, o: (bh, n_q, 64); k, v: (bh, n_kv, 64); bf16, contiguous, 16-byte
// aligned. Columns at or past kv_len (1 <= kv_len <= n_kv) are masked.
// Returns a cudaError_t.
extern "C" int tpdm_flash_attention_d64(const void* q, const void* k, const void* v, void* o,
                                        int bh, int n_q, int n_kv, int kv_len, void* stream) {
  return launch<false, kK1Consumers, 1>(64, scale_of(64), q, k, v, o, nullptr, nullptr, bh,
                                        n_q, n_kv, kv_len, stream);
}

// K1 at a head dim below 64 that has no entry of its own (the toy UNets'
// 4, 6 and 8): the wrapper zero-pads q, k and v to 64 columns on the host
// and this runs the d-64 kernel with the scale of the true head_dim. The
// zero columns add nothing to Q K^T, and the output's columns past head_dim
// (zero) are cut off by the wrapper.
extern "C" int tpdm_flash_attention_d64_padded(const void* q, const void* k, const void* v,
                                               void* o, int bh, int n_q, int n_kv, int kv_len,
                                               int head_dim, void* stream) {
  if (head_dim < 1 || head_dim > 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false, kK1Consumers, 1>(64, scale_of(head_dim), q, k, v, o, nullptr, nullptr,
                                        bh, n_q, n_kv, kv_len, stream);
}

// K1 at the SD1.5 UNet's head dims (see the note at the top): q, o
// (bh, n_q, d), k, v (bh, n_kv, d) with d = 40, 80, 160; otherwise as
// tpdm_flash_attention_d64.
extern "C" int tpdm_flash_attention_d40(const void* q, const void* k, const void* v, void* o,
                                        int bh, int n_q, int n_kv, int kv_len, void* stream) {
  return launch<false, kK1Consumers, 1>(40, scale_of(40), q, k, v, o, nullptr, nullptr, bh,
                                        n_q, n_kv, kv_len, stream);
}

extern "C" int tpdm_flash_attention_d80(const void* q, const void* k, const void* v, void* o,
                                        int bh, int n_q, int n_kv, int kv_len, void* stream) {
  return launch<false, 2, 2>(80, scale_of(80), q, k, v, o, nullptr, nullptr, bh, n_q, n_kv,
                             kv_len, stream);
}

// K1 at FLUX's head dim 128: the d-80 instantiation (two consumers, rows
// of two 64-column boxes) with no zero-filled columns.
extern "C" int tpdm_flash_attention_d128(const void* q, const void* k, const void* v, void* o,
                                         int bh, int n_q, int n_kv, int kv_len, void* stream) {
  return launch<false, 2, 2>(128, scale_of(128), q, k, v, o, nullptr, nullptr, bh, n_q, n_kv,
                             kv_len, stream);
}

extern "C" int tpdm_flash_attention_d160(const void* q, const void* k, const void* v, void* o,
                                         int bh, int n_q, int n_kv, int kv_len, void* stream) {
  return launch<false, 1, 3>(160, scale_of(160), q, k, v, o, nullptr, nullptr, bh, n_q, n_kv,
                             kv_len, stream);
}

// K3: K1, and also m, l: (bh, n_q) fp32, the row statistics in the exp2
// domain (see the note at the top).
extern "C" int tpdm_flash_attention_stats_d64(const void* q, const void* k, const void* v,
                                              void* o, void* m, void* l, int bh, int n_q,
                                              int n_kv, int kv_len, void* stream) {
  return launch<true, kK3Consumers, 1>(64, scale_of(64), q, k, v, o, m, l, bh, n_q, n_kv,
                                       kv_len, stream);
}
