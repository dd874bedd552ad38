// CPU emulation of the CUDA runtime features that csrc/x_block_fwd.cu (K3)
// uses, so that its source compiles with a host C++20 compiler and runs on
// the CPU: one OS thread a CUDA thread, a std::barrier for __syncthreads,
// one a warp for shuffles, ldmatrix and mma (fragments.cuh here), and
// cp.async whose copies land only at the wait that retires their group (a
// read before that wait sees stale shared memory, as it may on the card).
// Blocks run one after another; shared memory is poisoned with 0xff (NaN
// in bf16 and float32) before each. Used by test_torch_x_block_emulated.py.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(a, b)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, gridDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2, cudaDevAttrMaxSharedMemoryPerBlockOptin = 3 };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline std::barrier<>* emu_block_bar;
inline std::barrier<>* emu_warp_bar[32];
inline uint64_t emu_warp_buf[32][32][8];
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void emu_warp_sync() { emu_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  std::memcpy(&emu_warp_buf[w][l][0], &v, 4);
  emu_warp_sync();
  float r;
  std::memcpy(&r, &emu_warp_buf[w][l ^ o][0], 4);
  emu_warp_sync();
  return r;
}
inline unsigned __ldg(const unsigned* p) { return *p; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline float erff(float v) { return std::erf(v); }
inline float rsqrtf(float v) { return 1.f / std::sqrt(v); }
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 232448; return 0; }
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) { a->numRegs = 0; return 0; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int, size_t) { *n = 1; return 0; }
cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t);
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated error"; }

// cp.async: copies land only at the wait that retires their group
struct EmuCopy { void* dst; const void* src; bool valid; };
inline thread_local std::vector<EmuCopy> emu_open;
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline void emu_cp_async16(void* dst, const void* src, bool valid) { emu_open.push_back({dst, src, valid}); }
inline void emu_commit() { emu_groups.push_back(emu_open); emu_open.clear(); }
inline void emu_wait(int n) {
  while ((int)emu_groups.size() > n) {
    for (auto& c : emu_groups.front()) {
      if (c.valid) std::memcpy(c.dst, c.src, 16); else std::memset(c.dst, 0, 16);
    }
    emu_groups.erase(emu_groups.begin());
  }
}
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
