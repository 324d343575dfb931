// The GEMMs of the quantised dense layers, for Hopper (sm_90a): one
// persistent wgmma kernel fed by TMA through an mbarrier ring, a template
// on the operand type and the epilogue.
//
//   K5  tpdm_bf16_gemm replaces experiments/attn_round3.py _mm_kernel: bf16 x
//       bf16 with an fp32 accumulator and a bf16 output, the product of
//       w4_matmul (and w8_matmul) once the weight is dequantised.
//   K4  tpdm_int8_gemm replaces experiments/attn_round3.py _mm_kernel_i8, the
//       int8 x int8 -> int32 product that tpdm_tpu/ops/quant.py
//       int8_dynamic_matmul runs in every qkv, out and FF matmul of a
//       quant_matmuls MMDiT at quant_bits 8 (285 a step). Two epilogues: the
//       raw int32 accumulator, or ((float(acc) * x_scale[row]) *
//       w_scale[col] + bias[col]) in fp32, JAX's order, each operation
//       rounded on its own (__int2float_rn, which rounds: |acc| reaches
//       127^2 * 6144 > 2^24; then __fmul_rn, __fmul_rn, __fadd_rn, so the
//       compiler fuses none into an fma), then rounded once to bf16.
//
// C (M, N) = A (M, K) . B^T with B given as (N, K), nn.Linear's (out, in)
// weight; both operands are K-major, wgmma's native layout and the only one
// its s8 form takes.
//
// What bounds it on the H100: at the SD3 image shapes (M 8192, K and N of
// 1536 and 6144) the product is compute bound (FF proj_in: 154.6 GFLOP over
// 145 MB in bf16, 0.1563 ms at 989 TFLOP/s; 154.6 GOP over 122 MB in int8,
// 0.0781 ms at 1,979 TOP/s), so the limit is the tensor cores and how well
// they are fed. The design feeds them the Hopper way:
// - one block an SM (the grid is the SM count), each walking the 128 x 256
//   output tiles in a grouped raster (kGroupM row tiles a group, so a
//   group's B tiles stay in L2 while its A tiles stream);
// - a producer warp group whose one thread issues the TMA loads of A
//   (128 rows) and B (256 rows), 128 bytes of K each (64 bf16 or 128 int8:
//   one swizzle row), into a 3-stage ring of 48 KB stages, each stage with
//   a full and an empty mbarrier; its registers go down to 40. The int8
//   stage is the bf16 stage byte for byte, so one layout serves both;
// - two consumer warp groups (registers up to 232), each owning 64 x 256 of
//   the tile as 128 fp32 or int32 accumulators a thread, running wgmma
//   m64n256k16 (bf16) or m64n256k32 (s8) from shared memory: both read 32
//   bytes of K a step, four steps a stage, one k-block's products in flight
//   while the previous stage is released;
// - the bf16 epilogues (K5's rounding, K4's dequant) write bf16 into a
//   32 KB shared-memory slice a warp group (128-byte swizzled, conflict
//   free) and leave it to TMA stores, which drop rows >= M and columns
//   >= N, while the next tile's products run; the ring runs on across
//   tiles, so the producer loads the next tile meanwhile. Storing the
//   accumulators directly from registers held the tensor cores idle for
//   27 % of FF proj_in's time (PERF.md), and a fourth stage bought nothing,
//   so its 48 KB hold the output slices. Where N is not a multiple of 8 (no
//   tensor map: its rows are not 16-byte aligned) the epilogue stores pairs
//   directly, guarded, as the wrapper takes any N. K4's dequant reads
//   x_scale for its two rows and w_scale and bias for its column pairs from
//   global memory once a tile;
// - K4's int32 epilogue, which no request runs (the card tests and
//   chip_smoke.py's bit-identity check do), stores the accumulators
//   directly from registers as int32 pairs: a 64 x 256 int32 slice is 64 KB
//   a warp group, which does not fit beside the three stages.
// TMA zero-fills rows past M and N and columns past K, so a K of 96 or an
// M of 1 or 8193 needs no special path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Epilogue : int {
  kRoundBf16 = 0,  // K5: the fp32 accumulator rounded to bf16
  kDequant = 1,    // K4: the int32 accumulator dequantised, bf16
  kInt32 = 2,      // K4: the raw int32 accumulator
};

// What differs between the operand types: the accumulator, the tensor
// maps' element type and the wgmma instruction. Both read 32 bytes of K a
// step, so the descriptors advance by 2 (16-byte units) a step.
template <typename T>
struct Operand;

template <>
struct Operand<bf16> {
  using Acc = float;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    sm90::wgmma_m64n256k16_ss(d, a, b, scale_d);
  }
};

template <>
struct Operand<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ static __forceinline__ void mma(int (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    sm90::wgmma_m64n256k32_s8_ss(d, a, b, scale_d);
  }
};

constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kBKBytes = 128;  // K bytes a stage: one swizzle row
constexpr int kStages = 3;
constexpr int kGroupM = 8;
constexpr int kConsumers = 2;  // warp groups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileA = kBM * kBKBytes;
constexpr int kTileB = kBN * kBKBytes;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kOutBox = 64;                // columns of a store box: 128 bytes
constexpr int kOutBytes = 64 * kBN * 2;  // a consumer's 64 x 256 bf16 slice
constexpr int kOutOffset = kStages * kStageBytes;
constexpr int kBarOffset = kOutOffset + kConsumers * kOutBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment slack
static_assert(kBM == 64 * kConsumers, "one 64-row slice a consumer warp group");
static_assert(kSmemBytes <= 232448, "Hopper allows 227 KB of shared memory a block");

template <typename T>
constexpr int kBK = kBKBytes / static_cast<int>(sizeof(T));  // K elements a stage

struct Tile {
  int m0, n0;
};

// Grouped raster: kGroupM row tiles, then the next column tile.
__device__ __forceinline__ Tile tile_at(int t, int tiles_m, int tiles_n) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = (t / per_group) * kGroupM;
  const int rows = min(tiles_m - first_m, kGroupM);
  const int r = t % per_group;
  return {(first_m + r % rows) * kBM, (r / rows) * kBN};
}

__device__ __forceinline__ void store_pair(bf16* row, int col, int n, float v0, float v1) {
  if ((n & 1) == 0 && col + 1 < n) {
    *reinterpret_cast<uint32_t*>(row + col) = sm90::pack_bf16x2(v0, v1);
  } else {
    if (col < n) row[col] = __float2bfloat16_rn(v0);
    if (col + 1 < n) row[col + 1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ void store_pair(int* row, int col, int n, int v0, int v1) {
  if ((n & 1) == 0 && col + 1 < n) {
    *reinterpret_cast<int2*>(row + col) = make_int2(v0, v1);
  } else {
    if (col < n) row[col] = v0;
    if (col + 1 < n) row[col + 1] = v1;
  }
}

// K4's dequant of one accumulator, in JAX's order, every step rounded alone.
__device__ __forceinline__ float dequant(int acc, float xs, float ws, float b, bool has_bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  return has_bias ? __fadd_rn(y, b) : y;
}

// K4's dequant over a warp group's 64 x 256 slice: for each column pair j
// (w_scale and bias read once) and row half, put(j, half, v0, v1).
template <typename Put>
__device__ __forceinline__ void dequant_slice(const int (&acc)[128], const float (&xs)[2],
                                              const float* __restrict__ w_scale,
                                              const bf16* __restrict__ bias, int col0, int n,
                                              Put put) {
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = col0 + 8 * j;
    const float ws0 = col < n ? w_scale[col] : 0.f;
    const float ws1 = col + 1 < n ? w_scale[col + 1] : 0.f;
    const float b0 = has_bias && col < n ? __bfloat162float(bias[col]) : 0.f;
    const float b1 = has_bias && col + 1 < n ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      put(j, half, dequant(acc[4 * j + 2 * half], xs[half], ws0, b0, has_bias),
          dequant(acc[4 * j + 2 * half + 1], xs[half], ws1, b1, has_bias));
    }
  }
}

template <typename T, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c, void* __restrict__ out,
                     const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                     const bf16* __restrict__ bias, int m, int n, int k, int tma_store) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;

  const int tiles_m = (m + kBM - 1) / kBM;
  const int tiles_n = (n + kBN - 1) / kBN;
  const int n_tiles = tiles_m * tiles_n;
  const int nk = (k + kBK<T> - 1) / kBK<T>;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every load
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * kConsumers) {
      sm90::tma_prefetch_map(&map_a);
      sm90::tma_prefetch_map(&map_b);
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tile = tile_at(t, tiles_m, tiles_n);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % kStages;
          sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          unsigned char* stage = smem + s * kStageBytes;
          sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
          sm90::tma_load_2d(stage, &map_a, &full[s], kb * kBK<T>, tile.m0);
          sm90::tma_load_2d(stage + kTileA, &map_b, &full[s], kb * kBK<T>, tile.n0);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31;
    const int row_in_wg = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);
    const int q = lane & 3;
    unsigned char* s_out = smem + kOutOffset + wg * kOutBytes;
    typename Operand<T>::Acc acc[128];
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tile = tile_at(t, tiles_m, tiles_n);
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&full[s], (it / kStages) & 1);
        const unsigned char* stage = smem + s * kStageBytes;
        const uint64_t da = sm90::make_smem_desc(stage + wg * 64 * 128, 16, 1024);
        const uint64_t db = sm90::make_smem_desc(stage + kTileA, 16, 1024);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKBytes / 32; ++kk) {
          // +32 bytes a step: 2 in the descriptor's 16-byte address units
          Operand<T>::mma(acc, da + 2 * kk, db + 2 * kk, (kb | kk) != 0);
        }
        sm90::wgmma_commit();
        // the previous stage's products are done: release it
        sm90::wgmma_wait<1>();
        if (kb > 0) sm90::mbar_arrive(&empty[(it - 1) % kStages]);
      }
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive(&empty[(it - 1) % kStages]);
      sm90::fence_regs(acc);

      if constexpr (kEpi == kInt32) {
        // the raw accumulator, from registers: rows g and g + 8 of each
        // 16-row slice, column pairs 2q
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = tile.m0 + 64 * wg + row_in_wg + 8 * half;
          if (row < m) {
            int* out_row = static_cast<int*>(out) + static_cast<size_t>(row) * n;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j) {
              store_pair(out_row, tile.n0 + 8 * j + 2 * q, n, acc[4 * j + 2 * half],
                         acc[4 * j + 2 * half + 1]);
            }
          }
        }
      } else if (tma_store) {
        // through shared memory: this warp group's 64 x 256 slice as four
        // 64 x 64 boxes, 128-byte swizzled (conflict free), stored by TMA
        // while the next tile's products run. The previous tile's stores
        // must have read the buffer first.
        const int lead = (threadIdx.x & 127) == 0;
        if (lead) sm90::tma_store_wait();
        sm90::named_barrier(1 + wg, 128);
        if constexpr (kEpi == kRoundBf16) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = row_in_wg + 8 * half;  // row % 8 == lane / 4
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j) {
              *reinterpret_cast<uint32_t*>(s_out + (j / 8) * (64 * 128) + row * 128 +
                                           (((j % 8) ^ (row % 8)) * 16) + 4 * q) =
                  sm90::pack_bf16x2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
            }
          }
        } else {
          float xs[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = tile.m0 + 64 * wg + row_in_wg + 8 * half;
            xs[half] = row < m ? x_scale[row] : 0.f;
          }
          dequant_slice(acc, xs, w_scale, bias, tile.n0 + 2 * q, n,
                        [&](int j, int half, float v0, float v1) {
                          const int row = row_in_wg + 8 * half;
                          *reinterpret_cast<uint32_t*>(s_out + (j / 8) * (64 * 128) +
                                                       row * 128 +
                                                       (((j % 8) ^ (row % 8)) * 16) + 4 * q) =
                              sm90::pack_bf16x2(v0, v1);
                        });
        }
        sm90::fence_proxy_async();
        sm90::named_barrier(1 + wg, 128);
        if (lead && tile.m0 + 64 * wg < m) {
#pragma unroll
          for (int c = 0; c < kBN / kOutBox; ++c) {
            if (tile.n0 + kOutBox * c < n) {
              sm90::tma_store_2d(&map_c, s_out + c * (64 * 128), tile.n0 + kOutBox * c,
                                 tile.m0 + 64 * wg);
            }
          }
          sm90::tma_store_commit();
        }
      } else if constexpr (kEpi == kRoundBf16) {
        // N not a multiple of 8 (no tensor map): rows g and g + 8 of each
        // 16-row slice, column pairs 2q, stored directly
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = tile.m0 + 64 * wg + row_in_wg + 8 * half;
          if (row < m) {
            bf16* out_row = static_cast<bf16*>(out) + static_cast<size_t>(row) * n;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j) {
              store_pair(out_row, tile.n0 + 8 * j + 2 * q, n, acc[4 * j + 2 * half],
                         acc[4 * j + 2 * half + 1]);
            }
          }
        }
      } else {
        // K4's dequant where N is not a multiple of 8, stored directly
        float xs[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = tile.m0 + 64 * wg + row_in_wg + 8 * half;
          xs[half] = row < m ? x_scale[row] : 0.f;
        }
        dequant_slice(acc, xs, w_scale, bias, tile.n0 + 2 * q, n,
                      [&](int j, int half, float v0, float v1) {
                        const int row = tile.m0 + 64 * wg + row_in_wg + 8 * half;
                        if (row < m) {
                          store_pair(static_cast<bf16*>(out) + static_cast<size_t>(row) * n,
                                     tile.n0 + 8 * j + 2 * q, n, v0, v1);
                        }
                      });
      }
      sm90::fence_regs(acc);
    }
    if (kEpi != kInt32 && tma_store && (threadIdx.x & 127) == 0) sm90::tma_store_wait();
  }
}

// a (m, k) and b (n, k) of type T, contiguous, 16-byte aligned; out (m, n),
// bf16 or (kInt32) int32. Returns a cudaError_t.
template <typename T, int kEpi>
int launch(const void* a, const void* b, void* out, const void* x_scale, const void* w_scale,
           const void* bias, int m, int n, int k, void* stream) {
  constexpr CUtensorMapDataType type = Operand<T>::kMapType;
  CUtensorMap map_a, map_b, map_c = {};
  const uint64_t dims_a[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
  const uint64_t dims_b[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(n)};
  const uint64_t strides[1] = {static_cast<uint64_t>(k) * sizeof(T)};
  const uint32_t box_a[2] = {kBK<T>, kBM};
  const uint32_t box_b[2] = {kBK<T>, kBN};
  int err = sm90::make_tensor_map(&map_a, a, 2, dims_a, strides, box_a, type);
  if (err == 0) err = sm90::make_tensor_map(&map_b, b, 2, dims_b, strides, box_b, type);
  // a bf16 output through TMA where its row stride is whole 16-byte units
  const int tma_store = kEpi != kInt32 && n % 8 == 0;
  if (err == 0 && tma_store) {
    const uint64_t dims_c[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(m)};
    const uint64_t strides_c[1] = {static_cast<uint64_t>(n) * 2};
    const uint32_t box_c[2] = {kOutBox, 64};
    err = sm90::make_tensor_map(&map_c, out, 2, dims_c, strides_c, box_c);
  }
  if (err != 0) return err;

  auto kernel = gemm_sm90_kernel<T, kEpi>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int grid = n_tiles < sms ? n_tiles : sms;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, map_c, out, static_cast<const float*>(x_scale),
      static_cast<const float*>(w_scale), static_cast<const bf16*>(bias), m, n, k, tma_store);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5. a (m, k) and b (n, k) bf16, contiguous, 16-byte aligned, k a multiple
// of 16; out (m, n) bf16. Returns a cudaError_t.
extern "C" int tpdm_bf16_gemm(const void* a, const void* b, void* out, int m, int n, int k,
                              void* stream) {
  return launch<bf16, kRoundBf16>(a, b, out, nullptr, nullptr, nullptr, m, n, k, stream);
}

// K4. a (m, k) and b (n, k) int8, contiguous, 16-byte aligned, k a multiple
// of 32. With x_scale null: out (m, n) int32, the raw accumulator. Else
// out (m, n) bf16 = (acc * x_scale[row]) * w_scale[col] (+ bias[col]);
// x_scale (m,) and w_scale (n,) fp32, bias (n,) bf16 or null. Returns a
// cudaError_t.
extern "C" int tpdm_int8_gemm(const void* a, const void* b, void* out, const void* x_scale,
                              const void* w_scale, const void* bias, int m, int n, int k,
                              void* stream) {
  if (x_scale == nullptr) {
    return launch<int8_t, kInt32>(a, b, out, nullptr, nullptr, nullptr, m, n, k, stream);
  }
  return launch<int8_t, kDequant>(a, b, out, x_scale, w_scale, bias, m, n, k, stream);
}
