// Two of the K1 layout and tuning studies' kernels (experiments/attn_*.py)
// for Hopper (sm_90a), head dim 64, on mma.sync: K7 and K9. K6 and K8 are
// the wgmma kernel of attn_studies_sm90.cu.
//
//   K7  tpdm_attention_maxfree_d64: p = exp2(s - rb) against a given bound
//       rb per query row, no running max and no rescale. Replaces
//       attn_variants.py _kernel_v3 and attn_round3b.py _kernel_Tm.
//   K9  tpdm_attention_probe_d64: the studies' floor probes, the functions
//       of attn_overlap.py _kernel_qk_only and _kernel_noexp and
//       attn_layout.py _kernel_kt_qkonly.
//
// Layouts. Every operand is a 4-D view (b, h, token, dim) given by four
// element strides, one of the dim and token strides being 1: natural
// (bh, n, 64), transposed (bh, 64, n), the projections' packed (b, n, h*64),
// K^T (bh, 64, n_kv). A tile is copied to shared memory in the orientation
// it has in device memory, 16 bytes a thread along the contiguous axis
// (single elements where a chunk is ragged or unaligned, as a 65-wide V with
// its ones column is), and the fragments are read out with ldmatrix: plain
// for an operand stored as the product wants it, .trans for one stored
// transposed. So Q^T and K^T reach the tensor cores through ldmatrix.trans,
// V^T needs no transpose (it is already PV's K-major B operand) and natural
// V takes .trans, and O^T is staged through shared memory so that its
// stores stay 16 bytes along tokens.
//
// The walk. A block owns 64 query rows of one (b, h), four warps of 16 rows,
// and walks kv in 64-row tiles: S = Q K^T (mma.sync m16n8k16 bf16) stays in
// registers, the softmax runs on the accumulator fragments (row statistics
// over the four lanes of a row group), P is repacked from those registers
// as the A operand of PV, and O accumulates in registers; two barriers a
// tile. Scores are in the exp2 domain: q arrives scaled by
// log2(e)/sqrt(d), as every study scales it outside its kernel. K7's
// columns at or past kv_len get a -1e30 bias, never a zero fill. The
// denominator is the fp32 row sum of p when V is 64 wide, else V's column
// 64 (the ones column, zeroed by the caller where it masks) accumulated in
// a ninth n8 tile and divided by; columns 65.. are never read. K7's
// bf16-soft mode rounds s, rb and s - rb to bf16 where the studies' bf16
// softmax dtype does, and takes exp2 of a bf16 value as JAX does,
// exp(x * ln 2) in bf16 steps.
//
// What bounds it on the H100: at the study shape (48 heads of 4480 x 4480
// at d 64) the 246 GFLOP of the two products against 110 MB of operands
// make it compute bound. This is the simple shape of the algorithm:
// synchronous tile copies, mma.sync rather than wgmma, 128 threads a block.
// K7 and K9 are to move onto attn_studies_sm90.cu's template.
//
// K9 computes exactly the JAX probes' functions. qk_only: for each chunk of
// `chunk` kv rows it runs the whole chunk's QK^T (as the probe did) but
// feeds only its first 64 columns, unexponentiated, into one PV against
// V[c0:c0+64, :64]; the output is that sum, undivided. noexp: the online
// walk with exp2(s - m) replaced by s - m and alpha by m_old - m_new, the
// running max updated once a chunk, output acc[:, :64] / (acc[:, 64] + 1).
// Its chunk max needs the chunk's scores before any of its PV, so it runs
// QK^T twice a chunk (a max pass, then the PV pass) rather than holding a
// 640-column chunk of S in shared memory: the probe's time carries one
// extra QK^T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;       // query rows a block: four warps of 16
constexpr int kBKV = 64;      // kv rows a tile
constexpr int kThreads = 128;
constexpr int kLd = 72;       // bf16 row stride of a 64-wide tile (144 B, conflict-free)
constexpr int kLdVN = 88;     // bf16 row stride of a natural V tile, 80 columns held
constexpr int kVRows = 80;    // V^T rows held: 64, the ones row, zeros to 80
constexpr int kOffK = kBQ * kLd * 2;
constexpr int kOffV = kOffK + kBKV * kLd * 2;
constexpr int kSmemBytes = kOffV + kVRows * kLd * 2;  // >= 64 * kLdVN * 2
static_assert(kVRows * kLd >= kBKV * kLdVN, "V region holds either orientation");
static_assert(kSmemBytes <= 48 * 1024, "static shared memory");

constexpr float kMaskedScore = -1e30f;
constexpr float kLn2Bf16 = 0.69140625f;  // log(2) rounded to bf16

enum ProbeMode { kQkOnly = 0, kNoExp = 1 };

struct View {  // element strides of a (b, h, token, dim) view
  long long sb, sh, sn, sd;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* rb;  // K7: (b, h, n_q) with strides rb_s
  View qs, ks, vs, os;
  long long rb_sb, rb_sh, rb_sn;
  int heads, n_q, n_kv, kv_len;
  int ones;           // V's column 64 is the denominator
  int soft_bf16;  // K7: round the softmax's values to bf16
  int chunk;      // K9
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// exp2 of a bf16 value as the studies' bf16 softmax takes it: exp(x * ln 2)
// with ln 2 and the product rounded to bf16, the result rounded to bf16.
__device__ __forceinline__ float exp2_bf16(float x) {
  return round_bf16(expf(round_bf16(x * kLn2Bf16)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `outer` lines of INNER elements (T: uint16_t for bf16, uint8_t for
// int8) from src, line o at src + o * s_outer with its elements contiguous,
// to dst[o * ld + i]. Lines at or past outer_valid and elements at or past
// inner_valid are zero. Whole aligned 16-byte chunks move as one load.
template <typename T, int OUTER, int INNER>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long s_outer,
                                          int outer_valid, int inner_valid, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = INNER / kVec;
  for (int c = tid; c < OUTER * kChunks; c += kThreads) {
    const int o = c / kChunks;
    const int i = (c % kChunks) * kVec;
    T* d = dst + o * ld + i;
    const T* s = src + o * s_outer + i;
    if (o < outer_valid && i + kVec <= inner_valid &&
        (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        d[e] = (o < outer_valid && i + e < inner_valid) ? s[e] : T(0);
      }
    }
  }
}

// The inverse of load_tile: dst[o * s_outer + i] = src[o * ld + i] for the
// valid lines and elements only.
__device__ __forceinline__ void store_tile(uint16_t* dst, long long s_outer, const uint16_t* src,
                                           int ld, int outer_valid, int inner_valid, int tid) {
  constexpr int kChunks = kD / 8;
  for (int c = tid; c < kD * kChunks; c += kThreads) {
    const int o = c / kChunks;
    const int i = (c % kChunks) * 8;
    if (o >= outer_valid) continue;
    uint16_t* d = dst + o * s_outer + i;
    const uint16_t* s = src + o * ld + i;
    if (i + 8 <= inner_valid && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < 8 && i + e < inner_valid; ++e) d[e] = s[e];
    }
  }
}

// The mma A-operand fragment of the 16 x 16 block at (r0, c0) of a
// row-major logical matrix M, held in shared memory either as M
// (M[r][c] at base[r * ld + c]) or as M^T (at base[c * ld + r]). The same
// registers are the B fragments of two n8 tiles when M is B^T, N-major:
// r[0], r[2] for rows r0..r0+7 and r[1], r[3] for rows r0+8..r0+15.
__device__ __forceinline__ void frag16(uint32_t (&r)[4], const bf16* base, int ld, int r0,
                                       int c0, bool transposed, int lane) {
  const int mi = lane >> 3, row = lane & 7;
  if (transposed) {
    ldsm_x4_trans(r, base + (c0 + (mi >> 1) * 8 + row) * ld + r0 + (mi & 1) * 8);
  } else {
    ldsm_x4(r, base + (r0 + (mi & 1) * 8 + row) * ld + c0 + (mi >> 1) * 8);
  }
}

// One (b, h) slice of the operands and the block's tile geometry.
struct Block {
  int tid, lane, warp, g, t, q0;
  size_t bh;
  long long q_off, k_off, v_off, o_off;
  bool q_tok, k_tok, v_tok, o_tok;  // token axis contiguous (stored transposed)
};

__device__ __forceinline__ Block make_block(const Params& p) {
  Block b;
  b.tid = threadIdx.x;
  b.lane = b.tid & 31;
  b.warp = b.tid >> 5;
  b.g = b.lane >> 2;
  b.t = b.lane & 3;
  b.q0 = blockIdx.x * kBQ;
  b.bh = blockIdx.y;
  const long long bi = blockIdx.y / p.heads, hi = blockIdx.y % p.heads;
  b.q_off = bi * p.qs.sb + hi * p.qs.sh;
  b.k_off = bi * p.ks.sb + hi * p.ks.sh;
  b.v_off = bi * p.vs.sb + hi * p.vs.sh;
  b.o_off = bi * p.os.sb + hi * p.os.sh;
  b.q_tok = p.qs.sd != 1;
  b.k_tok = p.ks.sd != 1;
  b.v_tok = p.vs.sd != 1;
  b.o_tok = p.os.sd != 1;
  return b;
}

// A (64 tokens x `dims` dims) tile of a bf16 operand whose rows start at
// `tok0`, in its own orientation: [token][dim] at stride ld if d-contiguous,
// else [dim][token]. Dims from `dims` to `dims_held` are zero.
template <int DIMS_HELD>
__device__ __forceinline__ void load_operand(bf16* dst, int ld, const bf16* base,
                                             const View& s, bool tok_contig, int tok0,
                                             int n_tok, int dims, int tid) {
  const uint16_t* src = reinterpret_cast<const uint16_t*>(base);
  uint16_t* d = reinterpret_cast<uint16_t*>(dst);
  if (tok_contig) {
    load_tile<uint16_t, DIMS_HELD, 64>(d, ld, src + tok0 * s.sn, s.sd, dims, n_tok - tok0, tid);
  } else {
    load_tile<uint16_t, 64, DIMS_HELD>(d, ld, src + tok0 * s.sn, s.sn, n_tok - tok0, dims, tid);
  }
}

// Q fragments of this warp's 16 rows into registers (bf16).
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[4][4], const bf16* sQ,
                                             const Block& b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) frag16(qa[kk], sQ, kLd, b.warp * 16, kk * 16, b.q_tok, b.lane);
}

// S = Q K^T for this warp's 16 rows over a 64-row kv tile (raw, fp32).
__device__ __forceinline__ void qk_bf16(float (&s)[8][4], uint32_t (&qa)[4][4],
                                        const bf16* sK, const Block& b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      frag16(r, sK, kLd, jp * 16, kk * 16, b.k_tok, b.lane);
      mma_bf16_16816(s[2 * jp], qa[kk], r[0], r[2]);
      mma_bf16_16816(s[2 * jp + 1], qa[kk], r[1], r[3]);
    }
  }
}

// acc[0..7] (+ acc[8], V's column 64, when ones) += P V for one kv tile;
// P is this warp's 16 x 64 probabilities in accumulator layout.
__device__ __forceinline__ void pv_bf16(float (&acc)[9][4], float (&pr)[8][4],
                                        const bf16* sV, bool ones, const Block& b) {
  const int ld = b.v_tok ? kLd : kLdVN;
  // V is held as V^T ([dv][token]) when token-contiguous: then B^T = V^T is
  // stored as itself; a natural V tile is B^T stored transposed
  const bool transposed = !b.v_tok;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(pr[2 * kk][0], pr[2 * kk][1]);
    a[1] = pack_bf16(pr[2 * kk][2], pr[2 * kk][3]);
    a[2] = pack_bf16(pr[2 * kk + 1][0], pr[2 * kk + 1][1]);
    a[3] = pack_bf16(pr[2 * kk + 1][2], pr[2 * kk + 1][3]);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      frag16(r, sV, ld, jp * 16, kk * 16, transposed, b.lane);
      mma_bf16_16816(acc[2 * jp], a, r[0], r[2]);
      mma_bf16_16816(acc[2 * jp + 1], a, r[1], r[3]);
    }
    if (ones) {
      uint32_t r[4];
      frag16(r, sV, ld, 64, kk * 16, transposed, b.lane);
      mma_bf16_16816(acc[8], a, r[0], r[2]);
    }
  }
}

// Scores into the exp2 domain with the kv_len bias (and bf16 rounding).
__device__ __forceinline__ void finish_scores(float (&s)[8][4], const Params& p, int kv0,
                                              const Block& b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kv0 + j * 8 + 2 * b.t + (e & 1);
      float x = col < p.kv_len ? s[j][e] : kMaskedScore;
      s[j][e] = p.soft_bf16 ? round_bf16(x) : x;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The running state of the rows g and g + 8 of this warp: max m (the whole
// row's, after the quad reduction), this thread's partial row sum l, and
// the output accumulator (tile 8 is V's column 64).
struct RowState {
  float acc[9][4];
  float m[2];
  float l[2];
};

__device__ __forceinline__ void init_state(RowState& st) {
#pragma unroll
  for (int j = 0; j < 9; ++j) st.acc[j][0] = st.acc[j][1] = st.acc[j][2] = st.acc[j][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// K7's step: p = exp2(s - rb), plain accumulation.
__device__ __forceinline__ void maxfree_step(RowState& st, float (&s)[8][4], const float (&rb)[2],
                                             const bf16* sV, const Params& p, const Block& b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = s[j][e] - rb[r];
      x = p.soft_bf16 ? exp2_bf16(round_bf16(x)) : exp2f(x);
      s[j][e] = x;
      st.l[r] += x;
    }
  }
  pv_bf16(st.acc, s, sV, p.ones, b);
}

// The denominators of rows g and g + 8: V's column 64 (tile 8 of acc, held
// by the lane with t = 0) when V carries the ones column, else the row sum.
__device__ __forceinline__ void denominators(float (&den)[2], RowState& st, bool ones,
                                             int lane) {
  if (ones) {
    den[0] = __shfl_sync(0xffffffffu, st.acc[8][0], lane & ~3);
    den[1] = __shfl_sync(0xffffffffu, st.acc[8][2], lane & ~3);
  } else {
    den[0] = quad_sum(st.l[0]);
    den[1] = quad_sum(st.l[1]);
  }
}

// O = acc / den, staged through shared memory (sO, in O's own orientation)
// and stored 16 bytes at a time where aligned.
__device__ __forceinline__ void write_out(float (&acc)[9][4], const float (&den)[2],
                                          bf16* sO, const Params& p, const Block& b) {
  __syncthreads();  // every warp is past its last read of shared memory
  const int row = b.warp * 16 + b.g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * b.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16 lo = __float2bfloat16_rn(acc[j][2 * h] / den[h]);
      const bf16 hi = __float2bfloat16_rn(acc[j][2 * h + 1] / den[h]);
      const int r = row + 8 * h;
      if (b.o_tok) {
        sO[col * kLd + r] = lo;
        sO[(col + 1) * kLd + r] = hi;
      } else {
        sO[r * kLd + col] = lo;
        sO[r * kLd + col + 1] = hi;
      }
    }
  }
  __syncthreads();
  uint16_t* ob = reinterpret_cast<uint16_t*>(p.o) + b.o_off + b.q0 * p.os.sn;
  const uint16_t* so = reinterpret_cast<const uint16_t*>(sO);
  const int n_rows = p.n_q - b.q0;
  if (b.o_tok) {
    store_tile(ob, p.os.sd, so, kLd, kD, n_rows, b.tid);
  } else {
    store_tile(ob, p.os.sn, so, kLd, n_rows, kD, b.tid);
  }
}

// Copies the kv tile at kv0 of K and V into shared memory (bf16).
__device__ __forceinline__ void load_kv_tile(bf16* sK, bf16* sV, const Params& p, const Block& b,
                                             int kv0, bool with_k, bool with_v) {
  if (with_k) {
    load_operand<64>(sK, kLd, static_cast<const bf16*>(p.k) + b.k_off, p.ks, b.k_tok, kv0,
                     p.n_kv, kD, b.tid);
  }
  if (with_v) {
    const int dims = p.ones ? kD + 1 : kD;
    const bf16* vb = static_cast<const bf16*>(p.v) + b.v_off;
    if (b.v_tok) {
      load_operand<kVRows>(sV, kLd, vb, p.vs, true, kv0, p.n_kv, dims, b.tid);
    } else {
      load_operand<kVRows>(sV, kLdVN, vb, p.vs, false, kv0, p.n_kv, dims, b.tid);
    }
  }
}

// K7: p = exp2(s - rb) against the bound rb of each query row.
__global__ void __launch_bounds__(kThreads) maxfree_kernel(const Params p) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* sV = reinterpret_cast<bf16*>(smem + kOffV);
  const Block b = make_block(p);
  const int row0 = b.q0 + b.warp * 16 + b.g;

  uint32_t qa[4][4];
  load_operand<64>(sQ, kLd, static_cast<const bf16*>(p.q) + b.q_off, p.qs, b.q_tok, b.q0, p.n_q,
                   kD, b.tid);
  __syncthreads();
  load_q_frags(qa, sQ, b);
  float rb[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.n_q) {
      const long long bi = blockIdx.y / p.heads, hi = blockIdx.y % p.heads;
      rb[r] = p.rb[bi * p.rb_sb + hi * p.rb_sh + row * p.rb_sn];
    }
    if (p.soft_bf16) rb[r] = round_bf16(rb[r]);
  }

  RowState st;
  init_state(st);
  const int n_tiles = (p.kv_len + kBKV - 1) / kBKV;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBKV;
    __syncthreads();  // the previous tile's reads are done
    load_kv_tile(sK, sV, p, b, kv0, true, true);
    __syncthreads();
    float s[8][4];
    qk_bf16(s, qa, sK, b);
    finish_scores(s, p, kv0, b);
    maxfree_step(st, s, rb, sV, p, b);
  }
  float den[2];
  denominators(den, st, p.ones, b.lane);
  write_out(st.acc, den, sQ, p, b);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) probe_kernel(const Params p) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* sV = reinterpret_cast<bf16*>(smem + kOffV);
  const Block b = make_block(p);
  uint32_t qa[4][4];
  load_operand<64>(sQ, kLd, static_cast<const bf16*>(p.q) + b.q_off, p.qs, b.q_tok, b.q0, p.n_q,
                   kD, b.tid);
  __syncthreads();
  load_q_frags(qa, sQ, b);

  RowState st;
  init_state(st);
  float s[8][4];
  if constexpr (MODE == kQkOnly) {
    // sum over chunks of (first 64 scores of the chunk) . V[c0:c0+64, :64]
    for (int kv0 = 0; kv0 < p.n_kv; kv0 += kBKV) {
      const bool first = kv0 % p.chunk == 0;
      __syncthreads();
      load_kv_tile(sK, sV, p, b, kv0, true, first);
      __syncthreads();
      qk_bf16(s, qa, sK, b);  // every tile's product runs, as in the probe
      if (first) pv_bf16(st.acc, s, sV, false, b);
    }
    const float one[2] = {1.f, 1.f};  // undivided
    write_out(st.acc, one, sQ, p, b);
  } else {
    for (int c0 = 0; c0 < p.n_kv; c0 += p.chunk) {
      const int c1 = min(c0 + p.chunk, p.n_kv);
      // pass 1: the chunk's row max
      float mx[2] = {-INFINITY, -INFINITY};
      for (int kv0 = c0; kv0 < c1; kv0 += kBKV) {
        __syncthreads();
        load_kv_tile(sK, sV, p, b, kv0, true, false);
        __syncthreads();
        qk_bf16(s, qa, sK, b);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (kv0 + j * 8 + 2 * b.t + (e & 1) < c1) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
      }
      float m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = c0 == 0 ? quad_max(mx[r]) : fmaxf(st.m[r], quad_max(mx[r]));
        if (c0 > 0) {
          const float f = st.m[r] - m_new[r];
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            st.acc[j][2 * r] *= f;
            st.acc[j][2 * r + 1] *= f;
          }
        }
        st.m[r] = m_new[r];
      }
      // pass 2: acc += (s - m_new) V_ext
      for (int kv0 = c0; kv0 < c1; kv0 += kBKV) {
        __syncthreads();
        load_kv_tile(sK, sV, p, b, kv0, true, true);
        __syncthreads();
        qk_bf16(s, qa, sK, b);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = kv0 + j * 8 + 2 * b.t + (e & 1) < c1;
            s[j][e] = ok ? s[j][e] - m_new[e >> 1] : 0.f;
          }
        }
        pv_bf16(st.acc, s, sV, true, b);
      }
    }
    float den[2];
    denominators(den, st, true, b.lane);
    den[0] += 1.f;  // acc[:, 64] + 1
    den[1] += 1.f;
    write_out(st.acc, den, sQ, p, b);
  }
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const long long* strides, int h, int n_q, int n_kv, int kv_len, int v_cols) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  View* views[4] = {&p.qs, &p.ks, &p.vs, &p.os};
  for (int i = 0; i < 4; ++i) {
    *views[i] = View{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  }
  p.heads = h;
  p.n_q = n_q;
  p.n_kv = n_kv;
  p.kv_len = kv_len;
  p.ones = v_cols > kD;
  return p;
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int bh, void* stream) {
  const dim3 grid((p.n_q + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries take bf16 views of shape (b, h, n, 64) given by `strides`,
// 16 element strides (b, h, token, dim) for q, k, v, o in that order (K7
// adds rb's (b, h, token) strides after them); q k^T is the score in the
// exp2 domain (q already carries log2(e)/sqrt(64)). v is (b, h, n_kv,
// v_cols) with v_cols 64 (row-sum denominator) or 65..80 (the ones column
// at 64). Each returns a cudaError_t.

// K7: rb (b, h, n_q) fp32, the bound subtracted in the exp2 domain.
extern "C" int tpdm_attention_maxfree_d64(const void* q, const void* k, const void* v, void* o,
                                          const void* rb, const long long* strides, int b, int h,
                                          int n_q, int n_kv, int kv_len, int v_cols,
                                          int soft_bf16, void* stream) {
  Params p = make_params(q, k, v, o, strides, h, n_q, n_kv, kv_len, v_cols);
  p.rb = static_cast<const float*>(rb);
  p.rb_sb = strides[16];
  p.rb_sh = strides[17];
  p.rb_sn = strides[18];
  p.soft_bf16 = soft_bf16;
  return launch(maxfree_kernel, p, b * h, stream);
}

// K9: mode 0 qk_only, 1 noexp (v_cols >= 65); chunk a positive multiple of
// 64; no kv_len mask (the probes have none).
extern "C" int tpdm_attention_probe_d64(const void* q, const void* k, const void* v, void* o,
                                        const long long* strides, int b, int h, int n_q,
                                        int n_kv, int v_cols, int mode, int chunk, void* stream) {
  Params p = make_params(q, k, v, o, strides, h, n_q, n_kv, n_kv, v_cols);
  p.chunk = chunk;
  return mode == kNoExp ? launch(probe_kernel<kNoExp>, p, b * h, stream)
                        : launch(probe_kernel<kQkOnly>, p, b * h, stream);
}
