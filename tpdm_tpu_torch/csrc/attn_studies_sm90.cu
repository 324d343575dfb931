// The K1 layout and tuning studies' four kernels for Hopper (sm_90a), one
// kernel template, wgmma fed by TMA (or by the producer's plain loads)
// through an mbarrier ring, with a producer warp group. Its Kind template
// argument picks what a tile's scores become: K6's online softmax, K8's
// int8 QK^T then K6's softmax, K7's max-free softmax, or one of K9's two
// floor probes.
//
//   K6  tpdm_attention_strided_d64 replaces experiments/attn_variants.py
//       _kernel_v1, _kernel_v2, _kernel_v4; attn_overlap.py
//       _kernel_prefetch; attn_layout.py _kernel_kt; attn_nocopy.py
//       _kernel_vsum, _kernel_packed2; attn_round3.py and attn_round3b.py
//       _kernel_T; attn_natural_operands.py _kernel_nat; attn_round4.py
//       kernel_call and _split_kernel (two streams); attn_block_layout.py
//       _kernel_call; attn_transpose_cost.py kernel_only;
//       attn_kernel_floor.py kernel_call and _kernel_inT (the last five run
//       tpdm_tpu/ops/attention.py _flash_kernel on pre-transposed operands).
//   K8  tpdm_attention_int8qk_d64 replaces attn_round3.py _kernel_I and
//       _kernel_TI: S = q k^T of per-row int8 q and k on the int8 tensor
//       cores, s = (float(S) * sq) * sk, then as K6.
//   K7  tpdm_attention_maxfree_d64 replaces attn_variants.py _kernel_v3
//       and attn_round3b.py _kernel_Tm: p = exp2(s - rb[row]) against a
//       given bound rb per query row; no running max, no alpha, no rescale.
//   K9  tpdm_attention_probe_d64 replaces the floor probes, attn_overlap.py
//       _kernel_qk_only and _kernel_noexp and attn_layout.py
//       _kernel_kt_qkonly (see probe_walk).
//
// The function. Every operand is a 4-D view (b, h, token, dim) given by
// four element strides, its dim or its token axis contiguous. Scores are in
// the exp2 domain (q arrives scaled by log2(e)/sqrt(d), as every study
// scales it outside its kernel); columns at or past kv_len get a -1e30
// bias, never a zero fill (a zero fill pulls the running max up to 0 and
// underflows rows of strongly negative scores), and only the tiles below
// kv_len are loaded. p = exp2(s - m) in fp32, P rounded to bf16 for P V.
// The denominator is the fp32 row sum of p when V is 64 wide; when V is
// 65..80 wide its column 64 (the studies' ones column, zeroed by the caller
// where it masks) is the denominator, sum p_bf16 * v[:, 64] in fp32, and
// columns 65.. are never read. score_bf16 rounds s, s - m and m - m_new to
// bf16 and takes exp2 of a bf16 value as JAX does, exp(x * ln 2) in bf16
// steps. Two streams: even and odd kv tiles carry their own (m, l, O),
// merged exactly at the end. K8: S in int32 (exact), then
// s = (float(S) * sq[row]) * sk[col], each product rounded alone (sk first
// with k_scale_first); scores_out, when not null, receives S. K7 masks and
// divides as K6; its soft_bf16 rounds s, rb and s - rb to bf16 and takes
// exp2_bf16. K9 has no kv_len mask; it excludes columns at or past n_kv
// itself (TMA's zero fill would give them a score of 0).
//
// What bounds it on the H100: compute. At the study shape (48 heads of
// 4480 x 4429) the two products are 246 GFLOP (0.249 ms at 989 TFLOP/s)
// against 110 MB of operands; K8's QK^T half runs at the int8 rate. So it
// is K1's design (csrc/attn_sm90.cu), with the studies' operand layouts
// each going through the products in its own orientation:
// - one block a (64 x kConsumers query rows, batch*head), one block an SM;
//   kConsumers consumer warp groups of 64 query rows each and a producer
//   warp group (registers down to kProducerRegs). Its first thread issues
//   the TMA loads; all 128 copy what takes the plain or the staged route
//   and stage the per-tile vectors, and arrive on those barriers only.
//   Two consumers: three need more than the 152 registers a thread they
//   can get beside a producer with room for the plain-route copies, and
//   spill; even so they lost or tied at the study shape (0.761 against
//   0.654 ms natural, scripts/sm90_variants.py, PERF.md section 6).
// - Q is loaded once a block, one 64-token box a consumer; K and V come as
//   128-token tiles through a 3-stage ring, a full barrier for K and one for
//   V a stage and an empty barrier every consumer thread arrives on. Two
//   stages, K1's depth, left the natural layout at 0.94 ms, three take it
//   to 0.67 (PERF.md section 6).
// - S = Q K^T: wgmma m64n128k16 from shared memory. Natural Q and K are
//   K-major. Q^T (token axis contiguous) is an MN-major A: its box is 64
//   dims of 64 tokens, and a k16 step moves 16 dim rows (2048 bytes); K^T
//   is an MN-major B of two 64-token boxes, LBO the box stride. The
//   transpose bits are immediates, so the orientations are template
//   arguments, instantiated where the studies pass them: K6 every one of
//   q, K, V natural or transposed; K8 V or V^T; K7 (q, K, V), (q, K, V^T)
//   or (q^T, K, V^T); K9 K or K^T beside natural q and V. K8: wgmma
//   m64n128k32 s8 on
//   64-byte-swizzled tiles (d 64 is 64 bytes a row), two k32 steps; s8
//   operands are K-major only, so an int8 q^T is transposed once a block
//   on its way into shared memory. The int32 S is converted and scaled in
//   its own registers. (Converting by adding 1.5 * 2^23 as float bits
//   instead of the conversion instruction was slower: 0.921 against 0.842
//   ms, PERF.md section 6.)
// - O += P V: wgmma m64n64k16 with P from registers (the S accumulator
//   converted pairwise to bf16x2). A natural V is an MN-major B (the
//   transpose bit); V^T is a K-major B of two 64-token boxes, no transpose.
// - V's column 64 (the ones column) comes as a 128-value vector a stage,
//   staged by the producer; each thread dots its bf16 P with it in fp32
//   after packing P (16 shared loads and 64 FMAs a tile). An n8 product of
//   the P fragments with the column on the tensor cores was slower in the
//   same call (0.880 against 0.841 ms with V_ext 65, PERF.md section 6).
//   K8's sk comes the same way with its K tile; sq is read once.
// - the load route of each operand is fixed on the host. TMA (a rank-4
//   tensor map of the view) where the view's base is 16-byte aligned and
//   every stride but the contiguous one is a multiple of 16 bytes. A
//   natural V 65..80 wide whose rows are not (V_ext 65: 130 bytes) is
//   staged: a tile's 128 raw rows are contiguous, so a TMA map of 8-row
//   groups as 8-byte elements loads them into one of two staging buffers,
//   two tiles ahead, and the producer rewrites them into the swizzled tile
//   (four aligned 32-bit loads and funnel shifts a 16-byte chunk) and
//   V's column 64 into its vector (2.29 ms with plain loads, 0.84 staged,
//   PERF.md section 6). Anything else (the card tests' transposed views
//   at n 333, a view off 16-byte alignment, an int8 q^T) is copied by the
//   producer with plain loads into the same swizzled layout, fenced for
//   the async proxy, and arrives on the same full barrier.
// - the epilogue writes O / l as bf16 into the warp group's Q box, in O's
//   own orientation (o^T staged transposed: 64 dims of 64 tokens), and
//   stores it with one TMA store, or with plain stores on the plain route.
// Overlap as K1: each warp group issues S of tile t before P V of tile
// t - 1 and runs tile t's softmax while that product is in flight. K9
// walks its own schedule of K and V tiles the same way (probe_walk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <array>
#include <type_traits>
#include <utility>

#include "sm90.cuh"

namespace {

constexpr int kD = 64;
constexpr int kStudiesConsumers = 2;  // consumer warp groups (see the note at the top)
constexpr int kBKV = 128;
constexpr int kStages = 3;
constexpr int kBox = 64 * 128;     // 64 rows of 128 bytes, one TMA box
constexpr int kTileKV = 2 * kBox;  // a K or V stage: 128 tokens
constexpr float kMaskedScore = -1e30f;
constexpr float kLn2Bf16 = 0.69140625f;  // log(2) rounded to bf16

// What a tile's scores become (the template's Kind argument)
enum Kind { kOnline = 0, kInt8Qk = 1, kMaxFree = 2, kQkOnly = 3, kNoExp = 4 };

enum Operand { kQ = 0, kK = 1, kV = 2, kO = 3 };
constexpr int kVStaged = 4;  // route bit: V's raw rows through TMA, reformatted
// a staging buffer: 128 raw V rows of up to 80 columns, + 128 bytes slack
constexpr int kStageBytes = 128 * 80 * 2 + 128;

struct View {  // element strides of a (b, h, token, dim) view
  long long sb, sh, sn, sd;
};

struct Params {
  const unsigned char* q;
  const unsigned char* k;
  const unsigned char* v;
  unsigned char* o;
  const float* sq;  // K8: (b*h, n_q), contiguous
  const float* sk;  // K8: (b*h, n_kv), contiguous
  int* s_out;       // K8: raw int32 scores (b*h, n_q, n_kv), or null
  const float* rb;  // K7: (b, h, n_q) with element strides rb_sb, rb_sh, rb_sn
  long long rb_sb, rb_sh, rb_sn;
  View qs, ks, vs, os;
  int heads, n_q, n_kv, kv_len, n_tiles;
  int chunk;          // K9: kv columns a chunk, a multiple of 64
  int q_t, o_t;       // q, o token-contiguous (runtime for K8's q and for o)
  int tma;            // bit Operand: through its tensor map, else plain loads;
                      // bit kVStaged: V's raw rows through TMA (see the note)
  int ones;           // V's column 64 is the denominator
  int soft_bf16;      // K6 score_bf16, K7 soft_bf16
  int k_scale_first;  // K8: (float(S) * sk) * sq
};

// The layout of a block with kConsumers consumer warp groups.
template <int kConsumers>
struct Cfg {
  // registers a thread after setmaxnreg: the block keeps what it was
  // launched with (65,536 an SM over its threads, in steps of 8), so the
  // consumers' increase must fit in what the producer gives up
  static constexpr int kConsumerRegs = kConsumers == 3 ? 152 : 200;
  static constexpr int kProducerRegs = kConsumers == 3 ? 56 : 104;
  static constexpr int kBQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kOffK = kConsumers * kBox;  // Q: a box a consumer
  static constexpr int kOffV = kOffK + kStages * kTileKV;
  static constexpr int kOffV64 = kOffV + kStages * kTileKV;  // V[:, 64], 128 bf16 a stage
  static constexpr int kOffSk = kOffV64 + kStages * 256;     // K8's sk, 128 fp32 a stage
  static constexpr int kOffStage = kOffSk + kStages * 512;   // two staging buffers
  static constexpr int kOffBar = kOffStage + 2 * kStageBytes;
  static constexpr int kSmemBytes = kOffBar + 8 * (3 + 3 * kStages) + 1024;  // + alignment
  static_assert(kConsumers == 2 || kConsumers == 3, "two or three consumer warp groups");
  static_assert(kConsumers * kConsumerRegs + kProducerRegs <= (kConsumers + 1) * kLaunchRegs,
                "setmaxnreg.inc would wait for registers no warp group gives up");
  static_assert(kSmemBytes <= 232448, "Hopper allows 227 KB of shared memory a block");
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// exp2 of a bf16 value as the studies' bf16 softmax takes it: exp(x * ln 2)
// with ln 2 and the product rounded to bf16, the result rounded to bf16.
__device__ __forceinline__ float exp2_bf16(float x) {
  return round_bf16(expf(round_bf16(x * kLn2Bf16)));
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// The scores of a tile live in the S accumulator's own registers: fp32 for
// K6, and for K8 the int32 S overwritten in place by the fp32 bits of its
// scaled scores, so S and the scores never take 64 registers each.
__device__ __forceinline__ float get(float x) { return x; }
__device__ __forceinline__ float get(int x) { return __int_as_float(x); }
__device__ __forceinline__ void put(float& x, float v) { x = v; }
__device__ __forceinline__ void put(int& x, float v) { x = __float_as_int(v); }

// The 16-byte chunk `ch` of row r of a swizzled box: 128-byte rows swizzle
// over 8 rows, 64-byte rows (int8 at d 64) over 8 rows of 4 chunks.
template <int kRowBytes>
__device__ __forceinline__ int swizzle(int r, int ch) {
  return kRowBytes == 128 ? ch ^ (r & 7) : ch ^ ((r >> 1) & 3);
}

// 16 bytes from s, of which the first `valid` (< 16, or a misaligned 16) are
// read and the rest are zero, with loads as wide as s's alignment allows.
template <int kElem>
__device__ __forceinline__ uint4 load_chunk(const unsigned char* s, int valid) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  if (valid >= 16 && (a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(reinterpret_cast<const unsigned int*>(s) + i);
  } else if (kElem == 2) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (2 * e < valid) {
        const uint32_t x = __ldg(reinterpret_cast<const unsigned short*>(s) + e);
        w[e >> 1] |= x << (16 * (e & 1));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (e < valid) w[e >> 2] |= static_cast<uint32_t>(__ldg(s + e)) << (8 * (e & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The plain-load route: the producer warp group (thread pt of 128) copies a
// box of kRows rows of kRowBytes into swizzled shared memory, row r from
// src + r * stride (bytes); rows at or past n_rows and bytes at or past
// n_bytes of a row are zero, as TMA's fill. kSplit: a token-contiguous tile
// of 128 tokens, two boxes of 64 token columns (the second's source 128
// bytes on, its bytes counted from there) over the same 64 dim rows. Up to
// four chunks a thread are loaded before any is stored, so their loads are
// in flight together.
template <int kRows, int kRowBytes, int kElem, bool kSplit = false>
__device__ __forceinline__ void copy_box(unsigned char* dst, const unsigned char* src,
                                         long long stride, int n_rows, int n_bytes, int pt) {
  constexpr int kChunks = kRowBytes / 16;
  constexpr int kBoxRows = kSplit ? 64 : kRows;
  constexpr int kPerThread = (kSplit ? 2 : 1) * kRows * kChunks / 128;
  constexpr int kMaxBatch = 4;
  constexpr int kBatch = kPerThread < kMaxBatch ? kPerThread : kMaxBatch;
  static_assert(kPerThread % kBatch == 0, "whole batches");
#pragma unroll 1
  for (int b0 = 0; b0 < kPerThread; b0 += kBatch) {
    uint4 val[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = pt + 128 * (b0 + i);
      const int j = c / (kBoxRows * kChunks);
      const int r = (c / kChunks) % kBoxRows, ch = c % kChunks;
      const int valid = n_bytes - 128 * j - 16 * ch;
      val[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_rows && valid > 0) {
        const unsigned char* s = src + r * stride + 128 * j + 16 * ch;
        val[i] = (valid >= 16 && (reinterpret_cast<uintptr_t>(s) & 15) == 0)
                     ? __ldg(reinterpret_cast<const uint4*>(s))
                     : load_chunk<kElem>(s, valid);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = pt + 128 * (b0 + i);
      const int j = c / (kBoxRows * kChunks);
      const int r = (c / kChunks) % kBoxRows, ch = c % kChunks;
      *reinterpret_cast<uint4*>(dst + j * kBox + r * kRowBytes +
                                16 * swizzle<kRowBytes>(r, ch)) = val[i];
    }
  }
}

// An int8 q^T box (64 dim rows of tokens, dim d at src + d * sd) into a
// K-major 64-byte-swizzled box of 64 token rows: four dims of one token a
// thread a step, so a warp reads 32 consecutive tokens of a dim row.
__device__ __forceinline__ void copy_box_transposed_s8(unsigned char* dst,
                                                       const unsigned char* src, long long sd,
                                                       int n_tok, int pt) {
#pragma unroll 4
  for (int c = pt; c < 64 * 16; c += 128) {
    const int tok = c & 63, grp = c >> 6;  // dims 4 grp .. 4 grp + 3
    uint32_t w = 0u;
    if (tok < n_tok) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w |= static_cast<uint32_t>(__ldg(src + (4 * grp + e) * sd + tok)) << (8 * e);
      }
    }
    *reinterpret_cast<uint32_t*>(dst + tok * 64 + 16 * swizzle<64>(tok, grp >> 2) +
                                 4 * (grp & 3)) = w;
  }
}

// The staged route's second half: the producer warp group (thread pt of
// 128) copies 128 raw V rows, row r at stg + r * row_bytes (2-byte
// aligned), into the swizzled 64-column tile, four aligned words and a
// funnel shift a 16-byte chunk; thread r also takes row r's column 64.
__device__ __forceinline__ void reformat_v(unsigned char* dst, unsigned short* v64,
                                           const unsigned char* stg, int row_bytes, bool ones,
                                           int pt) {
#pragma unroll 1
  for (int i0 = 0; i0 < 8; i0 += 2) {
#pragma unroll
    for (int i = i0; i < i0 + 2; ++i) {
      const int c = pt + 128 * i;
      const int r = c >> 3, ch = c & 7;
      const uintptr_t src = reinterpret_cast<uintptr_t>(stg + r * row_bytes + 16 * ch);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(src & ~static_cast<uintptr_t>(3));
      const uint32_t shift = 8 * (src & 3);
      uint32_t x[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) x[j] = w[j];
      *reinterpret_cast<uint4*>(dst + r * 128 + 16 * swizzle<128>(r, ch)) =
          make_uint4(__funnelshift_r(x[0], x[1], shift), __funnelshift_r(x[1], x[2], shift),
                     __funnelshift_r(x[2], x[3], shift), __funnelshift_r(x[3], x[4], shift));
    }
  }
  if (ones) v64[pt] = *reinterpret_cast<const unsigned short*>(stg + pt * row_bytes + 2 * kD);
}

// The plain-store route: the consumer warp group (thread lt of 128) writes
// its staged 64 x 128-byte box, row r to dst + r * stride (bytes), rows
// below n_rows and bytes below n_bytes only.
__device__ __forceinline__ void store_box(unsigned char* dst, long long stride, int n_rows,
                                          int n_bytes, const unsigned char* src, int lt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lt + 128 * i;
    const int r = c >> 3, ch = c & 7;
    const int valid = n_bytes - 16 * ch;
    if (r >= n_rows || valid <= 0) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(src + r * 128 + 16 * swizzle<128>(r, ch));
    unsigned char* d = dst + r * stride + 16 * ch;
    if (valid >= 16 && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = val;
    } else {
      const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (2 * e < valid) {
          reinterpret_cast<unsigned short*>(d)[e] =
              static_cast<unsigned short>(w[e >> 1] >> (16 * (e & 1)));
        }
      }
    }
  }
}

// S (64 x 128) = Q K^T for one warp group, bf16: four k16 steps. A
// K-major operand steps 32 bytes (2 descriptor units), an MN-major one 16
// dim rows (2048 bytes, 128 units).
template <bool kQT, bool kKT>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t desc_q, const void* s_k) {
  const uint64_t desc_k = kKT ? sm90::make_smem_desc(s_k, kBox, 1024)
                              : sm90::make_smem_desc(s_k, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    sm90::wgmma_m64n128k16_ss<kQT, kKT>(sc, desc_q + (kQT ? 128 : 2) * kk,
                                        desc_k + (kKT ? 128 : 2) * kk, kk);
  }
}

// K8's S (64 x 128, int32) = q k^T: two k32 steps of 32 bytes in the
// 64-byte-swizzled rows.
__device__ __forceinline__ void issue_qk(int (&si)[64], uint64_t desc_q, const void* s_k) {
  const uint64_t desc_k = sm90::make_smem_desc(s_k, 16, 512, 2);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    sm90::wgmma_m64n128k32_s8_ss(si, desc_q + 2 * kk, desc_k + 2 * kk, kk);
  }
}

// O += P V: the A fragment of k16 step kk is p[4kk .. 4kk + 3]. A natural
// V is MN-major, 16 kv rows (2048 bytes) a step; V^T is K-major in two
// 64-token boxes, 32 bytes a step inside a box.
template <bool kVT>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32],
                                         const unsigned char* s_v) {
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    if constexpr (kVT) {
      sm90::wgmma_m64n64k16_rs<0>(
          o, a, sm90::make_smem_desc(s_v + (kk >> 2) * kBox, 16, 1024) + 2 * (kk & 3), 1);
    } else {
      sm90::wgmma_m64n64k16_rs<1>(o, a, sm90::make_smem_desc(s_v, 1024, 1024) + 128 * kk, 1);
    }
  }
}

// Rows g (r = 0) and g + 8 (r = 1) of the warp's 16: the running max (the
// whole row's) and this thread's share of the running denominator.
struct RowState {
  float m[2];
  float l[2];
};

// The online softmax of one kv tile starting at column kv0, in place: S to
// masked (and in score_bf16, rounded) scores, then to the fp32 p. Rows r
// hold sc[4j + 2r + {0, 1}] at columns 8j + 2q + {0, 1}; alpha[r]
// rescales the row's O. With the ones column the denominator is summed
// later, from the bf16 P (ones_dot).
template <typename T>
__device__ __forceinline__ void softmax_tile(T (&sc)[64], RowState& st, float (&alpha)[2], int kv0,
                                             const Params& p, int q) {
  if (kv0 + kBKV > p.kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (kv0 + 8 * (i / 4) + 2 * q + (i & 1) >= p.kv_len) put(sc[i], kMaskedScore);
    }
  }
  const bool soft = p.soft_bf16;
  if (soft) {
#pragma unroll
    for (int i = 0; i < 64; ++i) put(sc[i], round_bf16(get(sc[i])));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx = fmaxf(mx, fmaxf(get(sc[4 * j + 2 * r]), get(sc[4 * j + 2 * r + 1])));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[r], mx);
    const float dm = st.m[r] - m_new;  // -inf on the first tile: alpha 0
    alpha[r] = exp2f(soft ? round_bf16(dm) : dm);
    st.m[r] = m_new;
    float sum = 0.f;
    if (soft) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const float x = exp2_bf16(round_bf16(get(sc[i]) - m_new));
          put(sc[i], x);
          sum += x;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const float x = exp2f(get(sc[i]) - m_new);
          put(sc[i], x);
          sum += x;
        }
      }
    }
    st.l[r] = st.l[r] * alpha[r] + (p.ones ? 0.f : sum);
  }
}

// K7's tile, in place: masked (and in soft_bf16 rounded) scores to
// p = exp2(s - rb[row]) against the row's bound (rounded to bf16 already in
// soft_bf16); no max, so nothing to rescale.
__device__ __forceinline__ void maxfree_tile(float (&sc)[64], RowState& st, const float (&rb)[2],
                                             int kv0, const Params& p, int q) {
  if (kv0 + kBKV > p.kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (kv0 + 8 * (i / 4) + 2 * q + (i & 1) >= p.kv_len) sc[i] = kMaskedScore;
    }
  }
  // one loop a mode: a select inside the loop would compute both
  if (p.soft_bf16) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = exp2_bf16(round_bf16(round_bf16(sc[i]) - rb[(i >> 1) & 1]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = exp2f(sc[i] - rb[(i >> 1) & 1]);
  }
  if (!p.ones) {
#pragma unroll
    for (int i = 0; i < 64; ++i) st.l[(i >> 1) & 1] += sc[i];
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// P rounded to bf16, pairwise: p[2j + r] holds row r's columns 8j + 2q,
// 8j + 2q + 1, so p[4kk .. 4kk + 3] is the A fragment of k16 step kk.
template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const T (&sc)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      p[2 * j + r] = sm90::pack_bf16x2(get(sc[4 * j + 2 * r]), get(sc[4 * j + 2 * r + 1]));
    }
  }
}

// The ones-column denominator of one tile, in the tile's own frame: each
// row's share of sum p_bf16 * v[:, 64] over this thread's 32 columns.
__device__ __forceinline__ void ones_dot(RowState& st, const uint32_t (&p)[32],
                                         const unsigned char* v64, int q) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t vv = *reinterpret_cast<const uint32_t*>(v64 + 2 * (8 * j + 2 * q));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st.l[r] = fmaf(bf16_lo(p[2 * j + r]), bf16_lo(vv),
                     fmaf(bf16_hi(p[2 * j + r]), bf16_hi(vv), st.l[r]));
    }
  }
}

// K8: the int32 S to exp2-domain scores in place, each product rounded
// alone, after S goes into scores_out where asked.
__device__ __forceinline__ void scale_scores(int (&si)[64], const float* sk, const float (&sq)[2],
                                             const Params& p, size_t bh, int row0, int kv0,
                                             int q) {
  if (p.s_out != nullptr) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = kv0 + 8 * (i / 4) + 2 * q + (i & 1);
      if (row < p.n_q && col < p.n_kv) {
        p.s_out[(bh * p.n_q + row) * static_cast<size_t>(p.n_kv) + col] = si[i];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 skv = *reinterpret_cast<const float2*>(sk + 8 * j + 2 * q);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        const float x = static_cast<float>(si[i]);
        const float s = e ? skv.y : skv.x;
        put(si[i], p.k_scale_first ? __fmul_rn(__fmul_rn(x, s), sq[r])
                                   : __fmul_rn(__fmul_rn(x, sq[r]), s));
      }
    }
  }
}

// What a consumer thread keeps across the walk besides its registers.
struct Walk {
  unsigned char* smem;  // the barriers sit at Cfg::kOffBar
  uint64_t desc_q;
  float sq[2];  // K8's row scales
  float rb[2];  // K7's row bounds
  size_t bh;
  int row0;
  int q;
};

// Tile t >= 1 of the walk: S_t is issued before P_{t-1} V_{t-1} (into
// o_pv), tile t's softmax runs while that product is in flight (into st,
// whose O is o_cur), then P_t replaces P_{t-1}.
template <bool kQT, bool kKT, bool kVT, int kKind, int kConsumers, typename T>
__device__ __forceinline__ void walk_tile(int t, float (&o_pv)[32], float (&o_cur)[32],
                                          RowState& st, T (&sc)[64], uint32_t (&p)[32],
                                          const Walk& w, const Params& prm) {
  constexpr bool kInt8 = kKind == kInt8Qk;
  using C = Cfg<kConsumers>;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(w.smem + C::kOffBar) + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;
  const int s = t % kStages;
  const int prev = (t - 1) % kStages;
  sm90::mbar_wait(&k_full[s], (t / kStages) & 1);
  sm90::mbar_wait(&v_full[prev], ((t - 1) / kStages) & 1);
  sm90::wgmma_fence();
  if constexpr (kInt8) {
    issue_qk(sc, w.desc_q, w.smem + C::kOffK + s * kTileKV);
  } else {
    issue_qk<kQT, kKT>(sc, w.desc_q, w.smem + C::kOffK + s * kTileKV);
  }
  sm90::wgmma_commit();
  issue_pv<kVT>(o_pv, p, w.smem + C::kOffV + prev * kTileKV);
  sm90::wgmma_commit();
  sm90::wgmma_wait<1>();  // S_t is in
  sm90::fence_regs(sc);
  float alpha[2];
  if constexpr (kInt8) {
    scale_scores(sc, reinterpret_cast<const float*>(w.smem + C::kOffSk + s * 512), w.sq, prm,
                 w.bh, w.row0, t * kBKV, w.q);
  }
  if constexpr (kKind == kMaxFree) {
    maxfree_tile(sc, st, w.rb, t * kBKV, prm, w.q);
  } else {
    softmax_tile(sc, st, alpha, t * kBKV, prm, w.q);
  }
  sm90::wgmma_wait<0>();  // P_{t-1} V_{t-1} is in: stage prev is free
  sm90::fence_regs(o_pv);
  sm90::fence_regs(p);
  sm90::mbar_arrive(&kv_empty[prev]);
  if constexpr (kKind != kMaxFree) rescale(o_cur, alpha);
  pack_p(p, sc);
  if (prm.ones) {
    sm90::mbar_wait(&v_full[s], (t / kStages) & 1);
    ones_dot(st, p, w.smem + C::kOffV64 + s * 256, w.q);
  }
}

// The walk's schedule of steps, which the producer and the consumers both
// follow: step i loads kv tile t's K into stage i % kStages, and its V
// where the step's P V needs it (pv()).
// - K6-K8: every tile below kv_len once, each with its P V.
// - K9 qk_only: every tile once; P V on a tile where a chunk starts
//   (halves(): bit 0 at its first 64 columns, bit 1 at its second; a chunk
//   is a multiple of 64 columns, so its first 64 lie in one half).
// - K9 noexp: chunk [c0, c1) by chunk, the tiles that hold it twice:
//   pass 0 (its row max, no P V), then pass 1 (its P V); the last step of
//   a chunk's pass 1 moves on to the next chunk's pass 0.
template <int kKind>
struct Schedule {
  int t = 0;  // this step's kv tile; n_tiles past the last step
  int c0 = 0, c1;
  int pass = 0;
  int cs = 0;  // qk_only: the first chunk start at or past column t * kBKV

  __device__ explicit Schedule(const Params& p) : c1(min(p.chunk, p.n_kv)) {}
  __device__ bool more(const Params& p) const { return t < p.n_tiles; }
  __device__ int halves(const Params& p) const {
    const int c = t * kBKV;
    return (cs == c ? 1 : 0) |
           ((cs == c + 64 || (cs == c && p.chunk == 64)) && c + 64 < p.n_kv ? 2 : 0);
  }
  __device__ bool pv(const Params& p) const {
    if constexpr (kKind == kQkOnly) {
      return halves(p) != 0;
    } else if constexpr (kKind == kNoExp) {
      return pass == 1;
    } else {
      return true;
    }
  }
  __device__ void next(const Params& p) {
    if constexpr (kKind == kNoExp) {
      if (t < (c1 - 1) / kBKV) {
        ++t;
      } else if (pass == 0) {
        pass = 1;
        t = c0 / kBKV;
      } else {
        pass = 0;
        c0 = c1;
        c1 = min(c0 + p.chunk, p.n_kv);
        t = c0 < p.n_kv ? c0 / kBKV : p.n_tiles;
      }
    } else {
      ++t;
      if constexpr (kKind == kQkOnly) {
        while (cs < t * kBKV) cs += p.chunk;
      }
    }
  }
  __device__ void next_v(const Params& p) {  // on to the next step that loads V
    do {
      next(p);
    } while (more(p) && !pv(p));
  }
};

// K9's walk, the floor probes, in steps through the ring: a step issues
// one K tile's S before the P V that the previous step owes (as walk_tile
// does) and works on S while that product is in flight. The producer walks
// the same steps (Schedule).
// - qk_only: every tile's S, as the probe runs it; a tile that starts a
//   chunk feeds that chunk's first 64 columns of S, unexponentiated and
//   rounded to bf16, into P V (P zero elsewhere and at or past n_kv). The
//   output is O, undivided.
// - noexp: chunk by chunk, the chunk's tiles twice. Pass 1 takes the row
//   max m_new over the chunk's columns; then O and the ones column's sum l
//   are multiplied by m_old - m_new (not on the first chunk); pass 2 feeds
//   P = s - m_new (zero outside the chunk) into P V, l += P . V[:, 64]. The
//   output is O / (l + 1). A 640-column chunk of S does not fit in
//   registers, so its QK^T runs twice.
template <bool kKT, int kKind, int kConsumers>
__device__ __forceinline__ void probe_walk(float (&o)[32], RowState& st, float (&sc)[64],
                                           uint32_t (&p)[32], const Walk& w, const Params& prm) {
  using C = Cfg<kConsumers>;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(w.smem + C::kOffBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;
  const int q = w.q;
  int i = 0;           // the step: its K (and V) tile sits in stage i % kStages
  bool owed = false;   // step i - 1's P waits for its P V
  // one step on tile t: `work(kv0)` turns S into what the step needs; `pv`,
  // the step's P V is owed to the next step. `owes` (std::true_type or
  // false_type) says whether this step issues the previous step's P V, so
  // that no wgmma wait is conditional (ptxas serializes the products
  // where it cannot tell which groups are in flight)
  auto step = [&](int t, auto work, bool pv, auto owes) {
    constexpr bool kOwes = decltype(owes)::value;
    const int s = i % kStages;
    const int prev = (i + kStages - 1) % kStages;
    sm90::mbar_wait(&k_full[s], (i / kStages) & 1);
    if constexpr (kOwes) sm90::mbar_wait(&v_full[prev], ((i - 1) / kStages) & 1);
    sm90::wgmma_fence();
    issue_qk<false, kKT>(sc, w.desc_q, w.smem + C::kOffK + s * kTileKV);
    sm90::wgmma_commit();
    if constexpr (kOwes) {
      issue_pv<false>(o, p, w.smem + C::kOffV + prev * kTileKV);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
    } else {
      sm90::wgmma_wait<0>();
    }
    sm90::fence_regs(sc);
    work(t * kBKV);
    if constexpr (kOwes) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(p);
    }
    if (i > 0) sm90::mbar_arrive(&kv_empty[prev]);
    if (pv) {
      pack_p(p, sc);
      if constexpr (kKind == kNoExp) {
        sm90::mbar_wait(&v_full[s], (i / kStages) & 1);
        ones_dot(st, p, w.smem + C::kOffV64 + s * 256, q);
      }
    }
    owed = pv;
    ++i;
  };
  auto issue = [&](int t, auto work, bool pv) {
    if (owed) {
      step(t, work, pv, std::true_type());
    } else {
      step(t, work, pv, std::false_type());
    }
  };

  sm90::mbar_wait(q_full, 0);
  if constexpr (kKind == kQkOnly) {
    for (Schedule<kKind> at(prm); at.more(prm); at.next(prm)) {
      const int halves = at.halves(prm);
      issue(at.t, [&](int kv0) {
        if (halves == 0) return;
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          const int col = 8 * (j / 4) + 2 * q + (j & 1);
          if (!(halves >> (col / 64) & 1) || kv0 + col >= prm.n_kv) sc[j] = 0.f;
        }
      }, halves != 0);
    }
  } else {
    for (Schedule<kKind> at(prm); at.more(prm);) {  // one chunk an iteration
      const int c0 = at.c0, c1 = at.c1;
      float mx[2] = {-INFINITY, -INFINITY};
      do {  // pass 0: the chunk's row max
        issue(at.t, [&](int kv0) {
#pragma unroll
          for (int j = 0; j < 64; ++j) {
            const int col = kv0 + 8 * (j / 4) + 2 * q + (j & 1);
            if (col >= c0 && col < c1) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
          }
        }, false);
        at.next(prm);
      } while (at.pass == 0);
      // every P V so far is in (pass 0 owes none): rescale O and l
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = c0 == 0 ? mx[r] : fmaxf(st.m[r], mx[r]);
        if (c0 > 0) {
          const float f = st.m[r] - m_new;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[4 * j + 2 * r] *= f;
            o[4 * j + 2 * r + 1] *= f;
          }
          st.l[r] *= f;
        }
        st.m[r] = m_new;
      }
      do {  // pass 1: P = s - m_new, P V
        issue(at.t, [&](int kv0) {
#pragma unroll
          for (int j = 0; j < 64; ++j) {
            const int col = kv0 + 8 * (j / 4) + 2 * q + (j & 1);
            sc[j] = col >= c0 && col < c1 ? sc[j] - st.m[(j >> 1) & 1] : 0.f;
          }
        }, true);
        at.next(prm);
      } while (at.pass == 1);
    }
  }
  const int last = (i - 1) % kStages;
  if (owed) {
    sm90::mbar_wait(&v_full[last], ((i - 1) / kStages) & 1);
    sm90::wgmma_fence();
    issue_pv<false>(o, p, w.smem + C::kOffV + last * kTileKV);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(p);
  }
  sm90::mbar_arrive(&kv_empty[last]);
}

template <bool kQT, bool kKT, bool kVT, int kKind, bool kTwo>
__global__ void __launch_bounds__(128 * (kStudiesConsumers + 1), 1)
    studies_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o,
                        const __grid_constant__ Params prm) {
  constexpr int kConsumers = kStudiesConsumers;
  constexpr bool kInt8 = kKind == kInt8Qk;
  constexpr bool kProbe = kKind == kQkOnly || kKind == kNoExp;
  using C = Cfg<kConsumers>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;
  uint64_t* stage_full = kv_empty + kStages;  // the staged route's two buffers

  const int q0 = blockIdx.x * C::kBQ;
  const int bh = blockIdx.y;
  const int bi = bh / prm.heads, hi = bh % prm.heads;
  const int n_tiles = prm.n_tiles;
  const int wg = threadIdx.x / 128;
  // which full barriers the whole producer warp group arrives on (its
  // plain-route copies, V's column 64, K8's sk); the others take one
  // arrival, from the thread that issues their TMA loads
  const bool all_q = !(prm.tma >> kQ & 1);
  const bool all_k = !(prm.tma >> kK & 1) || kInt8;
  const bool all_v = !(prm.tma >> kV & 1) || prm.ones;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, all_q ? 128 : 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], all_k ? 128 : 1);
      sm90::mbar_init(&v_full[s], all_v ? 128 : 1);
      sm90::mbar_init(&kv_empty[s], 128 * kConsumers);
    }
    sm90::mbar_init(&stage_full[0], 1);
    sm90::mbar_init(&stage_full[1], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: thread 0 issues the TMA loads, all 128 copy the
    // plain-route tiles and stage the per-tile vectors; a thread arrives
    // on the barriers it has work for (thread 0 on all)
    sm90::setmaxnreg_dec<C::kProducerRegs>();
    const int pt = threadIdx.x - 128 * kConsumers;
    const bool tma_q = prm.tma >> kQ & 1, tma_k = prm.tma >> kK & 1, tma_v = prm.tma >> kV & 1;
    constexpr int kQElem = kInt8 ? 1 : 2;
    const unsigned char* qb = prm.q + (bi * prm.qs.sb + hi * prm.qs.sh) * kQElem;
    const unsigned char* kb = prm.k + (bi * prm.ks.sb + hi * prm.ks.sh) * kQElem;
    const unsigned char* vb = prm.v + (bi * prm.vs.sb + hi * prm.vs.sh) * 2;
    if (pt == 0) {
      if (tma_q) sm90::tma_prefetch_map(&map_q);
      if (tma_k) sm90::tma_prefetch_map(&map_k);
      if (tma_v) sm90::tma_prefetch_map(&map_v);
    }
    // Q, one 64-token box a consumer
    if (tma_q) {
      if (pt == 0) {
        sm90::mbar_expect_tx(q_full, kConsumers * (kInt8 ? kBox / 2 : kBox));
        for (int c = 0; c < kConsumers; ++c) {
          const int tok0 = q0 + 64 * c;
          if (kQT) {
            sm90::tma_load_4d(smem + c * kBox, &map_q, q_full, tok0, 0, hi, bi);
          } else {
            sm90::tma_load_4d(smem + c * kBox, &map_q, q_full, 0, tok0, hi, bi);
          }
        }
      }
    } else {
      for (int c = 0; c < kConsumers; ++c) {
        const int tok0 = q0 + 64 * c;
        if constexpr (kInt8) {
          if (prm.q_t) {
            copy_box_transposed_s8(smem + c * kBox, qb + tok0 * prm.qs.sn, prm.qs.sd,
                                   prm.n_q - tok0, pt);
          } else {
            copy_box<64, 64, 1>(smem + c * kBox, qb + tok0 * prm.qs.sn, prm.qs.sn,
                                prm.n_q - tok0, 64, pt);
          }
        } else if constexpr (kQT) {
          copy_box<64, 128, 2>(smem + c * kBox, qb + 2 * tok0 * prm.qs.sn, 2 * prm.qs.sd, 64,
                               2 * (prm.n_q - tok0), pt);
        } else {
          copy_box<64, 128, 2>(smem + c * kBox, qb + 2 * tok0 * prm.qs.sn, 2 * prm.qs.sn,
                               prm.n_q - tok0, 128, pt);
        }
      }
      sm90::fence_proxy_async();
    }
    if (pt == 0 || all_q) sm90::mbar_arrive(q_full);
    if (pt != 0 && !all_k && !all_v) return;

    // the staged route: V's raw rows (row stride not a multiple of 16
    // bytes), 16 groups of 8 rows a tile, through TMA into two staging
    // buffers, each refilled two V loads ahead once reformatted (`ahead`:
    // the schedule's step of the next V load to issue, kept by thread 0)
    const bool staged = prm.tma >> kVStaged & 1;
    const int row_bytes = 2 * static_cast<int>(prm.vs.sn);
    Schedule<kKind> ahead(prm);
    if (!ahead.pv(prm)) ahead.next_v(prm);
    if (staged && pt == 0) {
      sm90::tma_prefetch_map(&map_v);
      for (int j = 0; j < 2 && ahead.more(prm); ++j, ahead.next_v(prm)) {
        sm90::mbar_arrive_expect_tx(&stage_full[j], kBKV * row_bytes);
        sm90::tma_load_4d(smem + C::kOffStage + j * kStageBytes, &map_v, &stage_full[j], 0,
                          ahead.t * kBKV / 8, hi, bi);
      }
    }

    int u = 0;  // V loads so far
    // step i of the walk: kv tile t's K into stage i % kStages, and its V
    // where the step's P V needs it; the V full barrier is arrived on
    // either way, so every stage's barriers keep one phase a step
    auto produce = [&](int i, int t, bool with_v) {
      const int s = i % kStages;
      const int kv0 = t * kBKV;
      unsigned char* s_k = smem + C::kOffK + s * kTileKV;
      unsigned char* s_v = smem + C::kOffV + s * kTileKV;
      sm90::mbar_wait(&kv_empty[s], ((i / kStages) & 1) ^ 1);
      // K (and K8's sk)
      if (tma_k) {
        if (pt == 0) {
          sm90::mbar_expect_tx(&k_full[s], kInt8 ? kTileKV / 2 : kTileKV);
          if (kKT) {
            sm90::tma_load_4d(s_k, &map_k, &k_full[s], kv0, 0, hi, bi);
            sm90::tma_load_4d(s_k + kBox, &map_k, &k_full[s], kv0 + 64, 0, hi, bi);
          } else {
            sm90::tma_load_4d(s_k, &map_k, &k_full[s], 0, kv0, hi, bi);
          }
        }
      } else {
        if constexpr (kInt8) {
          copy_box<128, 64, 1>(s_k, kb + kv0 * prm.ks.sn, prm.ks.sn, prm.n_kv - kv0, 64, pt);
        } else if constexpr (kKT) {
          copy_box<64, 128, 2, true>(s_k, kb + 2 * kv0 * prm.ks.sn, 2 * prm.ks.sd, 64,
                                     2 * (prm.n_kv - kv0), pt);
        } else {
          copy_box<128, 128, 2>(s_k, kb + 2 * kv0 * prm.ks.sn, 2 * prm.ks.sn, prm.n_kv - kv0,
                                128, pt);
        }
        sm90::fence_proxy_async();
      }
      if constexpr (kInt8) {
        const int col = kv0 + pt;
        reinterpret_cast<float*>(smem + C::kOffSk + s * 512)[pt] =
            col < prm.n_kv ? prm.sk[static_cast<size_t>(bh) * prm.n_kv + col] : 0.f;
      }
      if (pt == 0 || all_k) sm90::mbar_arrive(&k_full[s]);
      // V (and its column 64)
      if (with_v) {
        if (tma_v) {
          if (pt == 0) {
            sm90::mbar_expect_tx(&v_full[s], kTileKV);
            if (kVT) {
              sm90::tma_load_4d(s_v, &map_v, &v_full[s], kv0, 0, hi, bi);
              sm90::tma_load_4d(s_v + kBox, &map_v, &v_full[s], kv0 + 64, 0, hi, bi);
            } else {
              sm90::tma_load_4d(s_v, &map_v, &v_full[s], 0, kv0, hi, bi);
            }
          }
        } else if (!kVT && staged) {
          const int b = u & 1;
          unsigned char* stg = smem + C::kOffStage + b * kStageBytes;
          sm90::mbar_wait(&stage_full[b], (u >> 1) & 1);
          reformat_v(s_v, reinterpret_cast<unsigned short*>(smem + C::kOffV64 + s * 256), stg,
                     row_bytes, prm.ones, pt);
          sm90::fence_proxy_async();
          sm90::named_barrier(8, 128);  // every read of this buffer is done
          if (pt == 0 && ahead.more(prm)) {
            sm90::mbar_arrive_expect_tx(&stage_full[b], kBKV * row_bytes);
            sm90::tma_load_4d(stg, &map_v, &stage_full[b], 0, ahead.t * kBKV / 8, hi, bi);
            ahead.next_v(prm);
          }
        } else {
          if constexpr (kVT) {
            copy_box<64, 128, 2, true>(s_v, vb + 2 * kv0 * prm.vs.sn, 2 * prm.vs.sd, 64,
                                       2 * (prm.n_kv - kv0), pt);
          } else {
            copy_box<128, 128, 2>(s_v, vb + 2 * kv0 * prm.vs.sn, 2 * prm.vs.sn, prm.n_kv - kv0,
                                  128, pt);
          }
          sm90::fence_proxy_async();
        }
        if (prm.ones && !staged) {
          const int row = kv0 + pt;
          reinterpret_cast<unsigned short*>(smem + C::kOffV64 + s * 256)[pt] =
              row < prm.n_kv ? __ldg(reinterpret_cast<const unsigned short*>(
                                   vb + 2 * (row * prm.vs.sn + kD * prm.vs.sd)))
                             : static_cast<unsigned short>(0);
        }
        ++u;
      }
      if (pt == 0 || all_v) sm90::mbar_arrive(&v_full[s]);
    };

    int i = 0;
    for (Schedule<kKind> at(prm); at.more(prm); at.next(prm)) produce(i++, at.t, at.pv(prm));
  } else {
    sm90::setmaxnreg_inc<C::kConsumerRegs>();
    const int lt = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int warp = lt / 32;
    const int g = lane >> 2;
    const int q = lane & 3;
    unsigned char* s_q = smem + wg * kBox;  // this warp group's 64 rows
    Walk w;
    w.smem = smem;
    w.desc_q = kInt8  ? sm90::make_smem_desc(s_q, 16, 512, 2)
               : kQT ? sm90::make_smem_desc(s_q, kBox, 1024)
                     : sm90::make_smem_desc(s_q, 16, 1024);
    w.bh = bh;
    w.row0 = q0 + 64 * wg + 16 * warp + g;
    w.q = q;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w.row0 + 8 * r;
      w.sq[r] = kInt8 && row < prm.n_q ? prm.sq[w.bh * prm.n_q + row] : 0.f;
      w.rb[r] = 0.f;
      if (kKind == kMaxFree && row < prm.n_q) {
        w.rb[r] = prm.rb[bi * prm.rb_sb + hi * prm.rb_sh + row * prm.rb_sn];
        if (prm.soft_bf16) w.rb[r] = round_bf16(w.rb[r]);
      }
    }

    float o0[32], o1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o0[i] = o1[i] = 0.f;
    RowState st0 = {{-INFINITY, -INFINITY}, {0.f, 0.f}};
    RowState st1 = st0;
    // S of the current tile (int32 for K8), then its scores, then its
    // fp32 p, in the same registers
    std::conditional_t<kInt8, int, float> sc[64];
    uint32_t p[32];  // bf16 P of the previous tile, the A operand of PV

    if constexpr (kProbe) {
      probe_walk<kKT, kKind, kConsumers>(o0, st0, sc, p, w, prm);
    } else {
      // tile 0: S alone
      sm90::mbar_wait(q_full, 0);
      sm90::mbar_wait(&k_full[0], 0);
      sm90::wgmma_fence();
      if constexpr (kInt8) {
        issue_qk(sc, w.desc_q, smem + C::kOffK);
      } else {
        issue_qk<kQT, kKT>(sc, w.desc_q, smem + C::kOffK);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      if constexpr (kInt8) {
        scale_scores(sc, reinterpret_cast<const float*>(smem + C::kOffSk), w.sq, prm, w.bh,
                     w.row0, 0, q);
      }
      if constexpr (kKind == kMaxFree) {
        maxfree_tile(sc, st0, w.rb, 0, prm, q);
      } else {
        float alpha[2];
        softmax_tile(sc, st0, alpha, 0, prm, q);
      }
      pack_p(p, sc);
      if (prm.ones) {
        sm90::mbar_wait(&v_full[0], 0);
        ones_dot(st0, p, smem + C::kOffV64, q);
      }

      if constexpr (kTwo) {  // even tiles in (st0, o0), odd in (st1, o1)
        for (int t = 1; t < n_tiles; t += 2) {
          walk_tile<kQT, kKT, kVT, kKind, kConsumers>(t, o0, o1, st1, sc, p, w, prm);
          if (t + 1 < n_tiles) {
            walk_tile<kQT, kKT, kVT, kKind, kConsumers>(t + 1, o1, o0, st0, sc, p, w, prm);
          }
        }
      } else {
        for (int t = 1; t < n_tiles; ++t) {
          walk_tile<kQT, kKT, kVT, kKind, kConsumers>(t, o0, o0, st0, sc, p, w, prm);
        }
      }
      const int last = (n_tiles - 1) % kStages;
      const unsigned char* s_v = smem + C::kOffV + last * kTileKV;
      sm90::mbar_wait(&v_full[last], ((n_tiles - 1) / kStages) & 1);
      sm90::wgmma_fence();
      if (kTwo && (n_tiles - 1) % 2) {
        issue_pv<kVT>(o1, p, s_v);
      } else {
        issue_pv<kVT>(o0, p, s_v);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o0);
      if constexpr (kTwo) sm90::fence_regs(o1);
      sm90::fence_regs(p);
      sm90::mbar_arrive(&kv_empty[last]);
    }

    if constexpr (kTwo) {  // the exact merge; an empty stream weighs 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(st0.m[r], st1.m[r]);
        const float wa = exp2f(st0.m[r] - m), wc = exp2f(st1.m[r] - m);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o0[4 * j + 2 * r] = o0[4 * j + 2 * r] * wa + o1[4 * j + 2 * r] * wc;
          o0[4 * j + 2 * r + 1] = o0[4 * j + 2 * r + 1] * wa + o1[4 * j + 2 * r + 1] * wc;
        }
        st0.l[r] = st0.l[r] * wa + st1.l[r] * wc;
      }
    }

    // O / l (K9 qk_only: O; noexp: O / (l + 1)) into this warp group's Q
    // box (its last S product is done), in O's orientation and 128-byte
    // swizzled as the o map expects
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = st0.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = kKind == kQkOnly ? 1.f : 1.f / (kKind == kNoExp ? l + 1.f : l);
      const int row = 16 * warp + g + 8 * r;  // row % 8 == g
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float lo = o0[4 * j + 2 * r] * inv, hi_ = o0[4 * j + 2 * r + 1] * inv;
        if (prm.o_t) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 8 * j + 2 * q + e;
            *reinterpret_cast<__nv_bfloat16*>(s_q + d * 128 + 16 * swizzle<128>(d, row >> 3) +
                                              2 * (row & 7)) = __float2bfloat16_rn(e ? hi_ : lo);
          }
        } else {
          *reinterpret_cast<uint32_t*>(s_q + row * 128 + 16 * (j ^ g) + 4 * q) =
              sm90::pack_bf16x2(lo, hi_);
        }
      }
    }
    const int tok0 = q0 + 64 * wg;
    if (prm.tma >> kO & 1) {
      sm90::fence_proxy_async();
      sm90::named_barrier(1 + wg, 128);
      if (lt == 0 && tok0 < prm.n_q) {
        if (prm.o_t) {
          sm90::tma_store_4d(&map_o, s_q, tok0, 0, hi, bi);
        } else {
          sm90::tma_store_4d(&map_o, s_q, 0, tok0, hi, bi);
        }
        sm90::tma_store_commit();
        sm90::tma_store_wait();
      }
    } else {
      sm90::named_barrier(1 + wg, 128);
      unsigned char* ob = prm.o + 2 * (bi * prm.os.sb + hi * prm.os.sh + tok0 * prm.os.sn);
      if (prm.o_t) {
        store_box(ob, 2 * prm.os.sd, kD, 2 * (prm.n_q - tok0), s_q, lt);
      } else {
        store_box(ob, 2 * prm.os.sn, prm.n_q - tok0, 128, s_q, lt);
      }
    }
  }
}

// ---------------------------------------------------------------- host

// The tensor map of a (b, h, token, 64) view with element strides s, its
// dim axis contiguous (box: 64 dims of box_tok tokens) or its token axis
// (box: 64 tokens of 64 dims). Fails, and the operand takes the plain-load
// route, unless the base is 16-byte aligned and every other stride a
// multiple of 16 bytes. A size-1 axis's stride is never used, so it is
// replaced by a valid one.
int map_view(CUtensorMap* map, const void* ptr, const View& s, int elem, int b, int h, int n,
             uint32_t box_tok, bool int8) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const bool tok_contig = s.sd != 1;
  const long long inner = tok_contig ? n : kD;
  long long st[3] = {tok_contig ? s.sd : s.sn, s.sh, s.sb};
  const long long ext[3] = {tok_contig ? kD : n, h, b};
  uint64_t dims[4] = {static_cast<uint64_t>(inner), 0, 0, 0};
  uint64_t strides[3];
  long long span = inner * elem;
  for (int i = 0; i < 3; ++i) {
    const long long bytes = ext[i] == 1 ? (span + 15) / 16 * 16 : st[i] * elem;
    if (bytes <= 0 || bytes % 16 || bytes >= (1ll << 40)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    dims[i + 1] = static_cast<uint64_t>(ext[i]);
    strides[i] = static_cast<uint64_t>(bytes);
    span = bytes * ext[i];
  }
  const uint32_t box[4] = {64, tok_contig ? 64u : box_tok, 1, 1};
  return sm90::make_tensor_map(map, ptr, 4, dims, strides, box,
                               int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                               int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// The staged route's tensor map of a natural V whose row stride (sn
// elements, up to 80) is not a multiple of 16 bytes: its rows in groups of
// 8 (16 sn bytes, a multiple of 16), as 8-byte elements, so a box of 16
// groups is one tile's 128 raw rows. Needs n_kv a multiple of 8 (a group
// never reaches past the head) and the base and head strides 16-byte
// aligned.
int map_staged(CUtensorMap* map, const void* ptr, const View& s, int b, int h, int n) {
  if (s.sd != 1 || s.sn < kD + 1 || s.sn > 80 || n % 8 ||
      reinterpret_cast<uintptr_t>(ptr) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long group = 16 * s.sn;
  const long long st[2] = {s.sh * 2, s.sb * 2};
  const long long ext[2] = {h, b};
  uint64_t strides[3] = {static_cast<uint64_t>(group), 0, 0};
  long long span = group * (n / 8);
  for (int i = 0; i < 2; ++i) {
    const long long bytes = ext[i] == 1 ? (span + 15) / 16 * 16 : st[i];
    if (bytes <= 0 || bytes % 16 || bytes >= (1ll << 40)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    strides[i + 1] = static_cast<uint64_t>(bytes);
    span = bytes * ext[i];
  }
  const uint64_t dims[4] = {static_cast<uint64_t>(2 * s.sn), static_cast<uint64_t>(n / 8),
                            static_cast<uint64_t>(h), static_cast<uint64_t>(b)};
  const uint32_t box[4] = {static_cast<uint32_t>(2 * s.sn), kBKV / 8, 1, 1};
  return sm90::make_tensor_map(map, ptr, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_INT64,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
}

struct Launch {
  CUtensorMap maps[4];
  Params prm;
  int bh;
  cudaStream_t stream;
};

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const long long* strides, int h, int n_q, int n_kv, int kv_len, int v_cols) {
  Params p = {};
  p.q = static_cast<const unsigned char*>(q);
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.o = static_cast<unsigned char*>(o);
  View* views[4] = {&p.qs, &p.ks, &p.vs, &p.os};
  for (int i = 0; i < 4; ++i) {
    *views[i] = View{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  }
  p.heads = h;
  p.n_q = n_q;
  p.n_kv = n_kv;
  p.kv_len = kv_len;
  p.n_tiles = (kv_len + kBKV - 1) / kBKV;
  p.q_t = p.qs.sd != 1;
  p.o_t = p.os.sd != 1;
  p.ones = v_cols > kD;
  return p;
}

// The tensor maps of the four operands and the route bits (K8's q^T always
// takes the plain, transposing route: s8 wgmma is K-major only).
void map_operands(Launch& l, int b, bool int8) {
  Params& p = l.prm;
  const int h = p.heads;
  const int qe = int8 ? 1 : 2;
  p.tma = 0;
  if (!(int8 && p.q_t) && map_view(&l.maps[kQ], p.q, p.qs, qe, b, h, p.n_q, 64, int8) == 0) {
    p.tma |= 1 << kQ;
  }
  if (map_view(&l.maps[kK], p.k, p.ks, qe, b, h, p.n_kv, kBKV, int8) == 0) p.tma |= 1 << kK;
  if (map_view(&l.maps[kV], p.v, p.vs, 2, b, h, p.n_kv, kBKV, false) == 0) {
    p.tma |= 1 << kV;
  } else if (map_staged(&l.maps[kV], p.v, p.vs, b, h, p.n_kv) == 0) {
    p.tma |= 1 << kVStaged;
  }
  if (map_view(&l.maps[kO], p.o, p.os, 2, b, h, p.n_q, 64, false) == 0) p.tma |= 1 << kO;
}

template <bool kQT, bool kKT, bool kVT, int kKind, bool kTwo>
int launch(const Launch& l) {
  using C = Cfg<kStudiesConsumers>;
  auto kernel = studies_sm90_kernel<kQT, kKT, kVT, kKind, kTwo>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((l.prm.n_q + C::kBQ - 1) / C::kBQ, l.bh);
  kernel<<<grid, C::kThreads, C::kSmemBytes, l.stream>>>(l.maps[kQ], l.maps[kK], l.maps[kV],
                                                          l.maps[kO], l.prm);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const Launch&);

// K7's and K9's orientations, a bit (4 q^T + 2 K^T + V^T) each: the ones
// the studies pass (see the note at the top). The entries launch these
// alone and tpdm_attention_studies_layouts reports them.
template <int kKind>
constexpr unsigned kLayouts = kKind == kMaxFree ? (1u << 0b000) | (1u << 0b001) | (1u << 0b101)
                                                : (1u << 0b000) | (1u << 0b010);

template <int kKind, size_t I>
constexpr LaunchFn layout_launch() {
  if constexpr ((kLayouts<kKind> >> I & 1) != 0) {
    return &launch<(I & 4) != 0, (I & 2) != 0, (I & 1) != 0, kKind, false>;
  } else {
    return nullptr;
  }
}

template <int kKind, size_t... I>
constexpr std::array<LaunchFn, 8> layout_table(std::index_sequence<I...>) {
  return {{layout_launch<kKind, I>()...}};
}

template <int kKind>
int launch_layout(const Launch& l) {
  static constexpr std::array<LaunchFn, 8> kTable =
      layout_table<kKind>(std::make_index_sequence<8>());
  const LaunchFn fn =
      kTable[(l.prm.q_t << 2) | ((l.prm.ks.sd != 1) << 1) | (l.prm.vs.sd != 1)];
  return fn != nullptr ? fn(l) : static_cast<int>(cudaErrorInvalidValue);
}

// K6's instantiations by index: bit 3 q^T, 2 K^T, 1 V^T, 0 two streams.
template <size_t I>
int launch_bf16(const Launch& l) {
  return launch<((I >> 3) & 1) != 0, ((I >> 2) & 1) != 0, ((I >> 1) & 1) != 0, kOnline,
                (I & 1) != 0>(l);
}

template <size_t... I>
constexpr std::array<LaunchFn, sizeof...(I)> bf16_table(std::index_sequence<I...>) {
  return {{&launch_bf16<I>...}};
}

constexpr std::array<LaunchFn, 16> kBf16Launch = bf16_table(std::make_index_sequence<16>());

// ---------------------------------------------------------------- helper check

// One block of 128 threads: the new sm90.cuh pieces alone. which 0: out
// (64 x 128 int32) = a (64 x 64 int8) . b (128 x 64 int8)^T through
// 64-byte-swizzled TMA tiles and wgmma m64n128k32 s8. which 1: out (64 x
// 128 fp32) = A . b^T with A = a^T, a (64 x 64 bf16) holding A's columns
// as rows (M contiguous: an MN-major A), b (128 x 64 bf16) K-major.
__global__ void __launch_bounds__(128) helper_check_kernel(const __grid_constant__ CUtensorMap
                                                               map_a,
                                                           const __grid_constant__ CUtensorMap
                                                               map_b,
                                                           void* out, int which) {
  __shared__ __align__(1024) unsigned char smem[3 * kBox];
  __shared__ uint64_t bar;
  const int t = threadIdx.x;
  if (t == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int a_bytes = which == 0 ? kBox / 2 : kBox;
  if (t == 0) {
    sm90::mbar_arrive_expect_tx(&bar, 3 * a_bytes);
    sm90::tma_load_2d(smem, &map_a, &bar, 0, 0);
    sm90::tma_load_2d(smem + kBox, &map_b, &bar, 0, 0);
  }
  sm90::mbar_wait(&bar, 0);
  const int lane = t & 31, warp = t / 32, g = lane >> 2, q = lane & 3;
  if (which == 0) {
    int d[64];
    sm90::wgmma_fence();
    issue_qk(d, sm90::make_smem_desc(smem, 16, 512, 2), smem + kBox);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(d);
    int* o = static_cast<int*>(out);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      o[(16 * warp + g + 8 * ((i >> 1) & 1)) * 128 + 8 * (i / 4) + 2 * q + (i & 1)] = d[i];
    }
  } else {
    float d[64];
    sm90::wgmma_fence();
    issue_qk<true, false>(d, sm90::make_smem_desc(smem, kBox, 1024), smem + kBox);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(d);
    float* o = static_cast<float*>(out);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      o[(16 * warp + g + 8 * ((i >> 1) & 1)) * 128 + 8 * (i / 4) + 2 * q + (i & 1)] = d[i];
    }
  }
}

}  // namespace

// The entries take (b, h, n, 64) views given by `strides`, 16 element
// strides (b, h, token, dim) for q, k, v, o in that order, each with its dim
// or its token axis contiguous; q k^T is the score in the exp2 domain (q
// already carries log2(e)/sqrt(64)). v is (b, h, n_kv, v_cols) bf16 with
// v_cols 64 (row-sum denominator) or 65..80 (the ones column at 64); o is
// bf16. 1 <= kv_len <= n_kv. Each returns a cudaError_t.

// K6: bf16 q, k; streams 1 or 2; score_bf16 rounds the softmax's values to
// bf16.
extern "C" int tpdm_attention_strided_d64(const void* q, const void* k, const void* v, void* o,
                                          const long long* strides, int b, int h, int n_q,
                                          int n_kv, int kv_len, int v_cols, int score_bf16,
                                          int streams, void* stream) {
  Launch l;
  l.prm = make_params(q, k, v, o, strides, h, n_q, n_kv, kv_len, v_cols);
  l.prm.soft_bf16 = score_bf16;
  l.bh = b * h;
  l.stream = static_cast<cudaStream_t>(stream);
  map_operands(l, b, false);
  const int idx = (l.prm.q_t << 3) | ((l.prm.ks.sd != 1) << 2) | ((l.prm.vs.sd != 1) << 1) |
                  (streams == 2);
  return kBf16Launch[idx](l);
}

// K8: q, k int8 (k dim-contiguous), sq (b*h, n_q) and sk (b*h, n_kv) fp32
// contiguous; s_out, if not null, receives the raw int32 scores
// (b*h, n_q, n_kv), every column (the walk then covers n_kv).
extern "C" int tpdm_attention_int8qk_d64(const void* q, const void* k, const void* v, void* o,
                                         const void* sq, const void* sk, void* s_out,
                                         const long long* strides, int b, int h, int n_q,
                                         int n_kv, int kv_len, int v_cols, int k_scale_first,
                                         void* stream) {
  Launch l;
  l.prm = make_params(q, k, v, o, strides, h, n_q, n_kv, kv_len, v_cols);
  l.prm.sq = static_cast<const float*>(sq);
  l.prm.sk = static_cast<const float*>(sk);
  l.prm.s_out = static_cast<int*>(s_out);
  l.prm.k_scale_first = k_scale_first;
  if (s_out != nullptr) l.prm.n_tiles = (n_kv + kBKV - 1) / kBKV;
  l.bh = b * h;
  l.stream = static_cast<cudaStream_t>(stream);
  map_operands(l, b, true);
  return l.prm.vs.sd != 1 ? launch<false, false, true, kInt8Qk, false>(l)
                          : launch<false, false, false, kInt8Qk, false>(l);
}

// K7: rb (b, h, n_q) fp32 with element strides strides[16..18], the bound
// subtracted in the exp2 domain; soft_bf16 as the studies' bf16 softmax.
// q, k and v in an orientation of kLayouts<kMaxFree>; o either way.
extern "C" int tpdm_attention_maxfree_d64(const void* q, const void* k, const void* v, void* o,
                                          const void* rb, const long long* strides, int b, int h,
                                          int n_q, int n_kv, int kv_len, int v_cols,
                                          int soft_bf16, void* stream) {
  Launch l;
  l.prm = make_params(q, k, v, o, strides, h, n_q, n_kv, kv_len, v_cols);
  l.prm.rb = static_cast<const float*>(rb);
  l.prm.rb_sb = strides[16];
  l.prm.rb_sh = strides[17];
  l.prm.rb_sn = strides[18];
  l.prm.soft_bf16 = soft_bf16;
  l.bh = b * h;
  l.stream = static_cast<cudaStream_t>(stream);
  map_operands(l, b, false);
  return launch_layout<kMaxFree>(l);
}

// K9: mode 0 qk_only, 1 noexp (v_cols >= 65); chunk a positive multiple of
// 64; no kv_len mask (the probes have none). q, k and v in an orientation
// of kLayouts<kQkOnly> or kLayouts<kNoExp>; o either way.
extern "C" int tpdm_attention_probe_d64(const void* q, const void* k, const void* v, void* o,
                                        const long long* strides, int b, int h, int n_q,
                                        int n_kv, int v_cols, int mode, int chunk, void* stream) {
  if (chunk <= 0 || chunk % 64 || (mode == 1 && v_cols <= kD) || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch l;
  l.prm = make_params(q, k, v, o, strides, h, n_q, n_kv, n_kv, v_cols);
  l.prm.chunk = chunk;
  l.prm.ones = mode == 1;  // qk_only's output is undivided
  l.bh = b * h;
  l.stream = static_cast<cudaStream_t>(stream);
  map_operands(l, b, false);
  return mode == 0 ? launch_layout<kQkOnly>(l) : launch_layout<kNoExp>(l);
}

// The orientations K7 (kind 2) and K9 (3 qk_only, 4 noexp) are instantiated
// for, a bit (4 q^T + 2 K^T + V^T) each; 0 for another kind.
extern "C" int tpdm_attention_studies_layouts(int kind) {
  switch (kind) {
    case kMaxFree:
      return kLayouts<kMaxFree>;
    case kQkOnly:
      return kLayouts<kQkOnly>;
    case kNoExp:
      return kLayouts<kNoExp>;
    default:
      return 0;
  }
}

// The load routes K6, K7 and K9 (int8 0) or K8 (int8 1) take for these
// views: bit 0 q, 1 k, 2 v, 3 o set where the operand goes through TMA,
// clear where it takes the plain-load (or, for o, plain-store) route; bit
// 4 set where V's raw rows go through TMA into staging and are reformatted
// there.
extern "C" int tpdm_attention_studies_routes(const void* q, const void* k, const void* v,
                                             void* o, const long long* strides, int b, int h,
                                             int n_q, int n_kv, int int8) {
  Launch l;
  l.prm = make_params(q, k, v, o, strides, h, n_q, n_kv, n_kv, kD);
  map_operands(l, b, int8 != 0);
  return l.prm.tma;
}

// The sm90.cuh helpers alone (see helper_check_kernel): which 0, a (64, 64)
// and b (128, 64) int8, out (64, 128) int32; which 1, a (64, 64) and b
// (128, 64) bf16, out (64, 128) fp32 = a^T b^T. All contiguous, 16-byte
// aligned. Returns a cudaError_t.
extern "C" int tpdm_sm90_helper_check(int which, const void* a, const void* b, void* out,
                                      void* stream) {
  const bool s8 = which == 0;
  const uint64_t row = s8 ? 64 : 128;
  const uint64_t dims_a[2] = {64, 64};
  const uint64_t dims_b[2] = {64, 128};
  const uint64_t strides[1] = {row};
  const uint32_t box_a[2] = {64, 64};
  const uint32_t box_b[2] = {64, 128};
  const CUtensorMapDataType type =
      s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swz = s8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap map_a, map_b;
  int err = sm90::make_tensor_map(&map_a, a, 2, dims_a, strides, box_a, type, swz);
  if (err == 0) err = sm90::make_tensor_map(&map_b, b, 2, dims_b, strides, box_b, type, swz);
  if (err != 0) return err;
  helper_check_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(map_a, map_b, out,
                                                                          which);
  return static_cast<int>(cudaGetLastError());
}
