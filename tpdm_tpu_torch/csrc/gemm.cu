// The int8 GEMM of the W8A8 dense layers, Hopper (sm_90a).
//
//   K4  tpdm_int8_gemm replaces experiments/attn_round3.py _mm_kernel_i8, the
//       int8 x int8 -> int32 product that tpdm_tpu/ops/quant.py
//       int8_dynamic_matmul runs (dot_general with preferred_element_type
//       int32) in every qkv, out and FF matmul of a quant_matmuls MMDiT at
//       quant_bits 8. Two epilogues: the raw int32 accumulator, or
//       ((float(acc) * x_scale[row]) * w_scale[col] + bias[col]) in fp32,
//       JAX's order, each operation rounded on its own (__fmul_rn and
//       __fadd_rn, so the compiler fuses none into an fma), then rounded
//       once to bf16.
//
// K5, the bf16 product, is a wgmma + TMA kernel of its own (gemm_sm90.cu).
//
// C (M, N) = A (M, K) . B^T with B given as (N, K), nn.Linear's (out, in)
// weight: both operands are K-major, the only layout of Hopper's integer
// mma (.row.col), and of wgmma's s8 form too.
//
// A block owns a 128 x 128 tile of C; its 8 warps (2 x 4) own 64 x 32 each,
// as 4 x 4 mma tiles with the accumulator in registers (64 a thread). K is
// walked 64 bytes a stage (64 int8 values) through a 3-stage cp.async ring
// in shared memory: the copy of stage k + 2 runs while stage k is
// multiplied, one barrier a stage. Shared-memory rows are padded by 16
// bytes (a stride of 20 words), so the 32 fragment words a warp loads fall
// in 32 distinct banks. Rows of A past M and of B past N, and 16-byte chunks
// past K, are zero-filled by the copy (cp.async with a source size of 0),
// and the epilogue stores only rows < M and columns < N: M = 666 or 1332
// text rows are not tile multiples.
//
// What bounds it on the H100: at the SD3 image shapes (M 8192, K and N of
// 1536 and 6144) the product is compute bound (FF proj_in: 154.6 GOP over
// 122 MB), so the limit is the tensor cores and how well they are fed. This
// first version is the simple, correct shape: mma.sync (not wgmma), 32-bit
// fragment loads from shared memory (not ldmatrix), one tile per block (no
// persistent scheduling). wgmma with TMA (as gemm_sm90.cu has), and the activation
// quantisation fused into the prologue, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBKBytes = 64;  // K bytes a stage
constexpr int kStages = 3;
constexpr int kLd = kBKBytes + 16;  // shared-memory row stride in bytes
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / kWarpsM / 16;  // m16 tiles a warp
constexpr int kNT = kBN / kWarpsN / 8;   // n8 tiles a warp
constexpr int kStageBytes = (kBM + kBN) * kLd;
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(kBKBytes % 32 == 0, "an mma step takes 32 bytes of K");
static_assert(kSmemBytes <= 232448, "Hopper allows 227 KB of shared memory a block");

enum Epilogue : int {
  kInt32,    // the raw accumulator
  kDequant,  // dequantised, bf16
};

__device__ __forceinline__ void cp_async_16(unsigned char* dst, const unsigned char* src,
                                            bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage layout: BM rows of A, then BN rows of B, each kLd bytes apart.
__device__ __forceinline__ void load_stage(unsigned char* s, const unsigned char* a,
                                           const unsigned char* b, int m0, int n0, int kb0,
                                           int m, int n, int k_bytes, int tid) {
  constexpr int kChunks = kBKBytes / 16;
  constexpr int kPerThread = (kBM + kBN) * kChunks / kThreads;
  static_assert((kBM + kBN) * kChunks % kThreads == 0, "16-byte chunks per thread");
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks;
    const int kb = (c % kChunks) * 16;
    const bool is_a = r < kBM;
    const int row = is_a ? m0 + r : n0 + r - kBM;
    const bool valid = row < (is_a ? m : n) && kb0 + kb < k_bytes;
    const unsigned char* src =
        (is_a ? a : b) + (valid ? static_cast<size_t>(row) * k_bytes + kb0 + kb : 0);
    cp_async_16(s + r * kLd + kb, src, valid);
  }
}

// Two values of one output row at columns col, col + 1 (col even), stored
// as one pair where both are in range and the row is pair-aligned (n even).
__device__ __forceinline__ void store_pair(int* row, int col, int n, int v0, int v1) {
  if ((n & 1) == 0 && col + 1 < n) {
    *reinterpret_cast<int2*>(row + col) = make_int2(v0, v1);
  } else {
    if (col < n) row[col] = v0;
    if (col + 1 < n) row[col + 1] = v1;
  }
}

__device__ __forceinline__ void store_pair(bf16* row, int col, int n, float v0, float v1) {
  if ((n & 1) == 0 && col + 1 < n) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < n) row[col] = __float2bfloat16_rn(v0);
    if (col + 1 < n) row[col + 1] = __float2bfloat16_rn(v1);
  }
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const unsigned char* __restrict__ a, const unsigned char* __restrict__ b,
                void* __restrict__ out, const float* __restrict__ x_scale,
                const float* __restrict__ w_scale, const bf16* __restrict__ bias, int m,
                int n, int k_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
    }
  }

  // the ring: stages 0 .. kStages - 2 in flight before the first product;
  // every iteration commits one group, empty or not, so the wait below
  // always leaves the newest kStages - 2 groups pending
  const int nk = (k_bytes + kBKBytes - 1) / kBKBytes;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(smem + s * kStageBytes, a, b, m0, n0, s * kBKBytes, m, n, k_bytes, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < nk) {
      load_stage(smem + (next % kStages) * kStageBytes, a, b, m0, n0, next * kBKBytes, m, n,
                 k_bytes, tid);
    }
    cp_async_commit();

    const unsigned char* sa = smem + (kt % kStages) * kStageBytes + (wm * kMT * 16) * kLd;
    const unsigned char* sb = smem + (kt % kStages) * kStageBytes + (kBM + wn * kNT * 8) * kLd;
#pragma unroll
    for (int kk = 0; kk < kBKBytes; kk += 32) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const unsigned char* p = sa + (16 * i + g) * kLd + kk + 4 * t;
        af[i][0] = ld_u32(p);
        af[i][1] = ld_u32(p + 8 * kLd);
        af[i][2] = ld_u32(p + 16);
        af[i][3] = ld_u32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const unsigned char* p = sb + (8 * j + g) * kLd + kk + 4 * t;
        const uint32_t b0 = ld_u32(p);
        const uint32_t b1 = ld_u32(p + 16);
#pragma unroll
        for (int i = 0; i < kMT; ++i) mma_s8_16832(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * kMT * 16 + 16 * i + g + 8 * half;
      if (row >= m) continue;
      const size_t off = static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn * kNT * 8 + 8 * j + 2 * t;
        const int c0 = acc[i][j][2 * half];
        const int c1 = acc[i][j][2 * half + 1];
        if constexpr (kEpi == kInt32) {
          store_pair(static_cast<int*>(out) + off, col, n, c0, c1);
        } else {
          const float xs = x_scale[row];
          float v[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = col + e;
            if (cc >= n) continue;
            float y = __fmul_rn(__fmul_rn(__int2float_rn(e ? c1 : c0), xs), w_scale[cc]);
            if (bias != nullptr) y = __fadd_rn(y, __bfloat162float(bias[cc]));
            v[e] = y;
          }
          store_pair(static_cast<bf16*>(out) + off, col, n, v[0], v[1]);
        }
      }
    }
  }
}

template <int kEpi>
int launch(const void* a, const void* b, void* out, const void* x_scale, const void* w_scale,
           const void* bias, int m, int n, int k_bytes, void* stream) {
  auto kernel = gemm_kernel<kEpi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(a), static_cast<const unsigned char*>(b), out,
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<const bf16*>(bias), m, n, k_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4. a (m, k) and b (n, k) int8, contiguous, 16-byte aligned, k a multiple
// of 32. With x_scale null: out (m, n) int32, the raw accumulator. Else
// out (m, n) bf16 = (acc * x_scale[row]) * w_scale[col] (+ bias[col]);
// x_scale (m,) and w_scale (n,) fp32, bias (n,) bf16 or null. Returns a
// cudaError_t.
extern "C" int tpdm_int8_gemm(const void* a, const void* b, void* out, const void* x_scale,
                              const void* w_scale, const void* bias, int m, int n, int k,
                              void* stream) {
  if (x_scale == nullptr) {
    return launch<kInt32>(a, b, out, nullptr, nullptr, nullptr, m, n, k, stream);
  }
  return launch<kDequant>(a, b, out, x_scale, w_scale, bias, m, n, k, stream);
}
