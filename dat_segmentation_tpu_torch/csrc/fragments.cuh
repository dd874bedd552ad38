// Tensor-core fragment helpers shared by the deformable-attention kernels
// K1 (deform_attn_fwd.cu) and K2 (deform_attn_bwd.cu), for sm_90a.
//
// mma.sync m16n8k16 with bf16 operands and float32 sums: a thread of a
// warp (lane = 4 gq + tq) holds rows gq and gq + 8 and columns 2tq and
// 2tq + 1 of each 16 x 8 accumulator tile. An A fragment (16 x 16,
// row-major) is a[0] = (row gq, cols 2tq, 2tq + 1), a[1] = (row gq + 8,
// the same cols), a[2], a[3] = the same rows at cols + 8; so the
// accumulators of two neighbouring n8 tiles, rounded to bf16 in pairs,
// are the A fragment of the next product (pack_bf16).

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Normalised query coordinate of row (column) i: i / max(n - 1, 1) * 2 - 1,
// each operation rounded as the plain version rounds it.
__device__ __forceinline__ float query_coord(int i, float denom) {
  return __fsub_rn(__fmul_rn(__fdiv_rn((float)i, denom), 2.f), 1.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16, row-major) · b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
