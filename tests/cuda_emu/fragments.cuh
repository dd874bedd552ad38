// The CPU emulation of csrc/fragments.cuh (the helpers K3 uses): ldmatrix
// (.x4, plain and transposed) and mma.sync m16n8k16 (bf16 in, float32
// sums) exchange their operands across the 32 threads of a warp through
// a per-warp buffer and barrier, in the register layouts the PTX ISA gives.
#pragma once
#include <cuda_bf16.h>
namespace {
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r; std::memcpy(&r, &v, 4); return r;
}
inline void emu_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_warp_buf[w][l][0] = (uint64_t)p;
  emu_warp_sync();
  for (int j = 0; j < 4; ++j) {
    if (!trans) {
      const unsigned char* row = (const unsigned char*)emu_warp_buf[w][8 * j + l / 4][0];
      std::memcpy(&r[j], row + (l % 4) * 4, 4);
    } else {
      uint16_t lo, hi;
      const unsigned char* r0 = (const unsigned char*)emu_warp_buf[w][8 * j + 2 * (l % 4)][0];
      const unsigned char* r1 = (const unsigned char*)emu_warp_buf[w][8 * j + 2 * (l % 4) + 1][0];
      std::memcpy(&lo, r0 + (l / 4) * 2, 2);
      std::memcpy(&hi, r1 + (l / 4) * 2, 2);
      r[j] = lo | ((uint32_t)hi << 16);
    }
  }
  emu_warp_sync();
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, false); }
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, true); }
inline float emu_bf(uint32_t v, int hi) { __nv_bfloat16 b{(unsigned short)(hi ? v >> 16 : v & 0xffff)}; return __bfloat162float(b); }
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) emu_warp_buf[w][l][i] = a[i];
  emu_warp_buf[w][l][4] = b0; emu_warp_buf[w][l][5] = b1;
  emu_warp_sync();
  float A[16][16], B[16][8];
  for (int t = 0; t < 32; ++t) {
    const int gq = t / 4, tq = t % 4;
    for (int h = 0; h < 2; ++h) {
      A[gq][2 * tq + h] = emu_bf(emu_warp_buf[w][t][0], h);
      A[gq + 8][2 * tq + h] = emu_bf(emu_warp_buf[w][t][1], h);
      A[gq][2 * tq + 8 + h] = emu_bf(emu_warp_buf[w][t][2], h);
      A[gq + 8][2 * tq + 8 + h] = emu_bf(emu_warp_buf[w][t][3], h);
      B[2 * tq + h][gq] = emu_bf(emu_warp_buf[w][t][4], h);
      B[2 * tq + 8 + h][gq] = emu_bf(emu_warp_buf[w][t][5], h);
    }
  }
  emu_warp_sync();
  const int gq = l / 4, tq = l % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = gq + (i >= 2 ? 8 : 0), col = 2 * tq + (i & 1);
    float s = c[i];
    for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
    c[i] = s;
  }
}
}  // namespace
