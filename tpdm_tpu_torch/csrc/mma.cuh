// Tensor-core helpers shared by the kernels in this directory (sm_90a).
//
// mma.sync fragments, as the PTX ISA lays them out for one warp: g = lane / 4
// is the fragment row, t = lane % 4 the thread in its group. For the bf16
// product below an A fragment covers 16 rows by 32 bytes of K (16 values)
// and a B fragment 32 bytes of K by 8 columns, and the registers hold:
// a[0] row g, bytes 4t..4t+3; a[1] row g + 8; a[2] row g, bytes 16 + 4t;
// a[3] row g + 8, bytes 16 + 4t; b0 column g, bytes 4t; b1 column g,
// bytes 16 + 4t. The accumulator c[0], c[1] is row g,
// columns 2t and 2t + 1; c[2], c[3] the same columns of row g + 8.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

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

// Four 8x8 b16 matrices from shared memory, lanes 8i..8i+7 giving the row
// addresses of matrix i (16 bytes each, 16-byte aligned). Without .trans
// lane (g, t) receives row g, elements 2t and 2t+1 of each matrix; with
// .trans the matrix is transposed on the way: row 2t and 2t+1, element g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
