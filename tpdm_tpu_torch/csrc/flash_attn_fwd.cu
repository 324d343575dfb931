// Non-causal flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// One kernel template serves both attention kernels of the SD3 generation
// path of the JAX package:
//
//   K1  tpdm_flash_attention_d64  replaces tpdm_tpu/ops/attention.py
//       _flash_kernel (+ _chunk_walk): MMDiT joint attention, q/k/v
//       (2b, 24, 4480, 64) with kv_len = 4429 at 1024 px, 24 calls a step.
//   K2  tpdm_flash_attention_d512 replaces tpdm_tpu/ops/attention.py
//       _flash_kernel_streaming: VAE mid-block attention, (b, 1, 16384, 512)
//       at 1024 px, once a decode.
//
// The TPU kernels differ in where K/V live (resident in VMEM, or streamed
// over a sequential grid axis with (m, acc) carried in scratch). On Hopper
// blocks run in parallel and carry nothing between them, so both become the
// same loop inside one block: a block owns BQ query rows of one batch*head
// and walks the kv axis in BKV-row tiles held in shared memory.
//
// Per kv tile:
//   1. all threads copy the K and V tiles into shared memory (16-byte loads,
//      rows past n_kv zero-filled);
//   2. S = Q K^T on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//      accumulate), scaled into the exp2 domain by log2(e)/sqrt(d) in fp32,
//      columns >= kv_len set to -1e30, written to shared memory;
//   3. online softmax: each row's threads take the tile max, rescale factor
//      alpha = exp2(m_old - m_new), p = exp2(s - m_new) (stored as bf16) and
//      the running denominator l, all in fp32;
//   4. O = alpha * O + P V on the tensor cores; O stays in registers, each
//      warp owning a 16-row by D/WARPS_N-column slice of it.
// After the walk O / l is written as bf16.
//
// Masking is a bias, never a zero fill: a masked score is -1e30, so it can
// never raise the running max. Zero-filling masked scores would pull the
// max up to 0, and when every valid score is strongly negative all valid
// exp2(s - 0) underflow and the row becomes 0/0 (see _prep_transposed in
// the JAX package). Tile 0 always holds a valid column (kv_len >= 1), so the
// running max is a real score from the first tile on.
//
// What bounds it on the H100: at both shapes above the work is compute
// bound (K1 246 GFLOP over 110 MB of operands, K2 550 GFLOP over 67 MB), so
// the limit is the tensor cores and how well they are fed. This first
// version is the simple, correct shape of the algorithm: synchronous tile
// copies, S and P staged through shared memory, four barriers a tile, and
// mma.sync rather than wgmma. Row strides are padded by 8 bf16 / 4 fp32
// elements so the fragment loads hit distinct shared-memory banks. TMA,
// wgmma, a copy pipeline and keeping P in registers are later work.
//
// K2's head is 512 wide: a 64 x 512 fp32 accumulator (128 KB) cannot live in
// one warp group's registers. Its blocks split the dv axis across warps
// instead (WARPS_N = 4 slices of 128 columns, 64 fp32 registers a thread)
// and share one copy of the row statistics through shared memory, so QK^T is
// computed once per block and not once per dv slice. The Q tile, K and V
// tiles then need 147 KB of dynamic shared memory (one block per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedScore = -1e30f;

template <int D, int BQ, int BKV, int WARPS_M, int WARPS_N>
struct Cfg {
  static constexpr int kWarps = WARPS_M * WARPS_N;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLdQKV = D + 8;  // bf16 row stride of Q, K, V tiles
  static constexpr int kLdS = BKV + 4;  // fp32 row stride of S
  static constexpr int kLdP = BKV + 8;  // bf16 row stride of P
  static constexpr int kOffK = BQ * kLdQKV * 2;
  static constexpr int kOffV = kOffK + BKV * kLdQKV * 2;
  static constexpr int kOffS = kOffV + BKV * kLdQKV * 2;
  static constexpr int kOffP = kOffS + BQ * kLdS * 4;
  static constexpr int kOffStat = kOffP + BQ * kLdP * 2;
  static constexpr int kSmemBytes = kOffStat + 2 * BQ * 4;  // alpha, l
  // S = Q K^T as m16n8 tiles, dealt to warps in runs along one row group
  static constexpr int kSColTiles = BKV / 8;
  static constexpr int kSTilesPerWarp = (BQ / 16) * kSColTiles / kWarps;
  // softmax: kThreadsPerRow consecutive lanes share one row
  static constexpr int kThreadsPerRow = kThreads / BQ;
  static constexpr int kColsPerThread = BKV / kThreadsPerRow;
  // O: each warp owns 16 rows by kDSlice columns
  static constexpr int kDSlice = D / WARPS_N;
  static constexpr int kOColTiles = kDSlice / 8;

  static_assert(BQ == 16 * WARPS_M, "one 16-row group per warp row");
  static_assert(D % 16 == 0 && BKV % 16 == 0, "mma k-depth is 16");
  static_assert(kDSlice % 8 == 0, "dv slice must be whole n8 tiles");
  static_assert((BQ / 16) * kSColTiles % kWarps == 0, "S tiles per warp");
  static_assert(kSColTiles % kSTilesPerWarp == 0, "a warp's S tiles share a row group");
  static_assert(kThreads % BQ == 0 && kThreadsPerRow <= 32 &&
                    (kThreadsPerRow & (kThreadsPerRow - 1)) == 0,
                "softmax row threads: a power of two within a warp");
  static_assert(BKV % kThreadsPerRow == 0, "softmax columns per thread");
  static_assert(kSmemBytes <= 232448, "Hopper allows 227 KB of shared memory a block");
};

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of a row-major 16x16 bf16 tile at `p` (its top-left corner)
// with row stride `ld`: rows g, g+8 and columns 2t, 2t+1, 2t+8, 2t+9.
__device__ __forceinline__ void ld_a_frag(uint32_t (&a)[4], const bf16* p, int ld, int g,
                                          int t) {
  const bf16* r = p + g * ld + 2 * t;
  a[0] = ld_pair(r);
  a[1] = ld_pair(r + 8 * ld);
  a[2] = ld_pair(r + 8);
  a[3] = ld_pair(r + 8 * ld + 8);
}

// ROWS x D tile of a row-major (n_rows, D) matrix into shared memory with row
// stride D + 8, rows at or past n_rows zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n_rows,
                                          int tid) {
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  for (int c = tid; c < ROWS * kChunksPerRow; c += NT) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) = val;
  }
}

template <int D, int BQ, int BKV, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    flash_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int n_q, int n_kv,
                          int kv_len, float scale_log2) {
  using C = Cfg<D, BQ, BKV, WARPS_M, WARPS_N>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + C::kOffK);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::kOffV);
  float* sS = reinterpret_cast<float*>(smem + C::kOffS);
  bf16* sP = reinterpret_cast<bf16*>(smem + C::kOffP);
  float* sAlpha = reinterpret_cast<float*>(smem + C::kOffStat);
  float* sL = sAlpha + BQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group: fragment row
  const int t = lane & 3;   // thread in group: fragment column pair
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * n_q * D;
  const bf16* kb = k + bh * n_kv * D;
  const bf16* vb = v + bh * n_kv * D;
  bf16* ob = o + bh * n_q * D;

  load_tile<D, BQ, C::kThreads>(sQ, qb, q0, n_q, tid);

  // S tiles of this warp: one row group, kSTilesPerWarp consecutive n8 tiles
  const int s_tile0 = warp * C::kSTilesPerWarp;
  const int s_row0 = (s_tile0 / C::kSColTiles) * 16;
  const int s_col0 = (s_tile0 % C::kSColTiles) * 8;

  // softmax row owned by this thread, with its running max and denominator
  const int sm_row = tid / C::kThreadsPerRow;
  const int sm_part = tid % C::kThreadsPerRow;
  float m_run = -INFINITY;
  float l_run = 0.f;

  // O slice of this warp
  const int o_row0 = (warp % WARPS_M) * 16;
  const int o_col0 = (warp / WARPS_M) * C::kDSlice;
  float acc[C::kOColTiles][4];
#pragma unroll
  for (int j = 0; j < C::kOColTiles; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  const int n_tiles = (kv_len + BKV - 1) / BKV;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * BKV;
    load_tile<D, BKV, C::kThreads>(sK, kb, kv0, n_kv, tid);
    load_tile<D, BKV, C::kThreads>(sV, vb, kv0, n_kv, tid);
    __syncthreads();

    // 2. S = Q K^T, exp2-domain scaled and masked
    {
      float s[C::kSTilesPerWarp][4];
#pragma unroll
      for (int i = 0; i < C::kSTilesPerWarp; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      }
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4];
        ld_a_frag(a, sQ + s_row0 * C::kLdQKV + kk, C::kLdQKV, g, t);
#pragma unroll
        for (int i = 0; i < C::kSTilesPerWarp; ++i) {
          // B = K^T: column n of B is row n of K, so K's row-major pairs load whole
          const bf16* kp = sK + (s_col0 + 8 * i + g) * C::kLdQKV + kk + 2 * t;
          mma_bf16_16816(s[i], a, ld_pair(kp), ld_pair(kp + 8));
        }
      }
#pragma unroll
      for (int i = 0; i < C::kSTilesPerWarp; ++i) {
        const int col = s_col0 + 8 * i + 2 * t;
        const bool ok0 = kv0 + col < kv_len;
        const bool ok1 = kv0 + col + 1 < kv_len;
        float* sp = sS + (s_row0 + g) * C::kLdS + col;
        sp[0] = ok0 ? s[i][0] * scale_log2 : kMaskedScore;
        sp[1] = ok1 ? s[i][1] * scale_log2 : kMaskedScore;
        sp[8 * C::kLdS] = ok0 ? s[i][2] * scale_log2 : kMaskedScore;
        sp[8 * C::kLdS + 1] = ok1 ? s[i][3] * scale_log2 : kMaskedScore;
      }
    }
    __syncthreads();

    // 3. online softmax over this tile (columns interleaved across the row's threads)
    {
      const float* srow = sS + sm_row * C::kLdS;
      bf16* prow = sP + sm_row * C::kLdP;
      float x[C::kColsPerThread];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::kColsPerThread; ++j) {
        x[j] = srow[j * C::kThreadsPerRow + sm_part];
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int off = C::kThreadsPerRow / 2; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::kColsPerThread; ++j) {
        const float p = exp2f(x[j] - m_new);
        prow[j * C::kThreadsPerRow + sm_part] = __float2bfloat16(p);
        sum += p;
      }
#pragma unroll
      for (int off = C::kThreadsPerRow / 2; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sm_part == 0) sAlpha[sm_row] = alpha;
    }
    __syncthreads();

    // 4. O = alpha * O + P V
    {
      const float a_lo = sAlpha[o_row0 + g];
      const float a_hi = sAlpha[o_row0 + g + 8];
#pragma unroll
      for (int j = 0; j < C::kOColTiles; ++j) {
        acc[j][0] *= a_lo;
        acc[j][1] *= a_lo;
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
      const uint16_t* vraw = reinterpret_cast<const uint16_t*>(sV);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        uint32_t a[4];
        ld_a_frag(a, sP + o_row0 * C::kLdP + kk, C::kLdP, g, t);
#pragma unroll
        for (int j = 0; j < C::kOColTiles; ++j) {
          // B = V: a register pairs rows 2t and 2t+1 of one column, so pack two halves
          const uint16_t* vp = vraw + (kk + 2 * t) * C::kLdQKV + o_col0 + 8 * j + g;
          const uint32_t b0 = vp[0] | (static_cast<uint32_t>(vp[C::kLdQKV]) << 16);
          const uint32_t b1 =
              vp[8 * C::kLdQKV] | (static_cast<uint32_t>(vp[9 * C::kLdQKV]) << 16);
          mma_bf16_16816(acc[j], a, b0, b1);
        }
      }
    }
    __syncthreads();
  }

  if (sm_part == 0) sL[sm_row] = l_run;
  __syncthreads();

  const float inv_lo = 1.f / sL[o_row0 + g];
  const float inv_hi = 1.f / sL[o_row0 + g + 8];
  const int row_lo = q0 + o_row0 + g;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int j = 0; j < C::kOColTiles; ++j) {
    const int col = o_col0 + 8 * j + 2 * t;
    if (row_lo < n_q) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(row_lo) * D + col) =
          __floats2bfloat162_rn(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    }
    if (row_hi < n_q) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(row_hi) * D + col) =
          __floats2bfloat162_rn(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
    }
  }
}

template <int D, int BQ, int BKV, int WARPS_M, int WARPS_N>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n_q, int n_kv,
           int kv_len, void* stream) {
  using C = Cfg<D, BQ, BKV, WARPS_M, WARPS_N>;
  auto kernel = flash_attn_fwd_kernel<D, BQ, BKV, WARPS_M, WARPS_N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_q + BQ - 1) / BQ, bh);
  kernel<<<grid, C::kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), n_q, n_kv, kv_len, kLog2e / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (bh, n_q, D); k, v: (bh, n_kv, D); bf16, contiguous. Columns at or
// past kv_len (1 <= kv_len <= n_kv) are masked. Returns a cudaError_t.
extern "C" int tpdm_flash_attention_d64(const void* q, const void* k, const void* v, void* o,
                                        int bh, int n_q, int n_kv, int kv_len, void* stream) {
  return launch<64, 64, 64, 4, 1>(q, k, v, o, bh, n_q, n_kv, kv_len, stream);
}

extern "C" int tpdm_flash_attention_d512(const void* q, const void* k, const void* v, void* o,
                                         int bh, int n_q, int n_kv, int kv_len, void* stream) {
  return launch<512, 64, 32, 4, 4>(q, k, v, o, bh, n_q, n_kv, kv_len, stream);
}

extern "C" const char* tpdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
