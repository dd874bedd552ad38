// CPU emulation of the CUDA runtime features that csrc/x_block_fwd.cu (K3)
// uses, so that its source compiles with a host C++20 compiler and runs on
// the CPU: a block's CUDA threads run as cooperative fibers on one OS
// thread (each on a stack of its own), a barrier for __syncthreads and one
// a warp for shuffles, ldmatrix and mma (fragments.cuh here), where a fiber
// that reaches a barrier before the last of its party switches to the next
// fiber; cp.async copies land only at the wait that retires their group (a
// read before that wait sees stale shared memory, as it may on the card).
// Blocks run one after another; shared memory is poisoned with 0xff (NaN
// in bf16 and float32) before each. Used by test_torch_x_block_emulated.py.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#if !defined(__x86_64__)
#include <ucontext.h>
#endif
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(a, b)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline dim3 threadIdx;  // the running fiber's
inline dim3 blockIdx, gridDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2, cudaDevAttrMaxSharedMemoryPerBlockOptin = 3 };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };

// Fibers: emu_run_block runs body(t) for t < n, each on its own stack, and
// returns when all have ended; emu_yield switches from the running fiber to
// the next. On x86-64 a switch saves the callee-saved registers and swaps
// stacks (emu_switch); elsewhere it is ucontext's swapcontext.
struct EmuCopy { void* dst; const void* src; bool valid; };
struct EmuFiber {
  void* sp;
  std::unique_ptr<char[]> stack;
  bool done;
  std::vector<EmuCopy> open;                 // cp.async copies not yet committed
  std::vector<std::vector<EmuCopy>> groups;  // committed groups not yet waited for
#if !defined(__x86_64__)
  ucontext_t ctx;
#endif
};
constexpr size_t EMU_STACK = 1 << 18;
inline std::vector<EmuFiber> emu_fibers;
inline int emu_cur;
inline uint64_t emu_progress;  // barrier arrivals and ended fibers
inline std::function<void(int)> emu_body;
#if defined(__x86_64__)
extern "C" void emu_switch(void** save_sp, void* to_sp);
asm(".text\n.globl emu_switch\n.type emu_switch,@function\nemu_switch:\n"
    "  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n  pushq %r14\n  pushq %r15\n"
    "  movq %rsp, (%rdi)\n  movq %rsi, %rsp\n"
    "  popq %r15\n  popq %r14\n  popq %r13\n  popq %r12\n  popq %rbx\n  popq %rbp\n  ret\n"
    ".size emu_switch, .-emu_switch\n");
inline void* emu_main_sp;
inline void emu_to_main() { emu_switch(&emu_fibers[emu_cur].sp, emu_main_sp); }
inline void emu_to_fiber(int t) { emu_switch(&emu_main_sp, emu_fibers[t].sp); }
#else
inline ucontext_t emu_main_ctx;
inline void emu_to_main() { swapcontext(&emu_fibers[emu_cur].ctx, &emu_main_ctx); }
inline void emu_to_fiber(int t) { swapcontext(&emu_main_ctx, &emu_fibers[t].ctx); }
#endif
inline void emu_yield() { emu_to_main(); }
[[noreturn]] inline void emu_fiber_main() {
  EmuFiber& f = emu_fibers[emu_cur];
  emu_body(emu_cur);
  f.open.clear();
  f.groups.clear();
  f.done = true;
  ++emu_progress;
  for (;;) emu_to_main();
}
inline void emu_run_block(int n, std::function<void(int)> body) {
  emu_body = std::move(body);
  if ((int)emu_fibers.size() < n) emu_fibers.resize(n);
  for (int t = 0; t < n; ++t) {
    EmuFiber& f = emu_fibers[t];
    if (!f.stack) f.stack.reset(new char[EMU_STACK]);
    f.done = false;
#if defined(__x86_64__)
    // emu_switch pops six registers and returns into emu_fiber_main, which
    // then sees its stack as a call would leave it (rsp + 8 16-byte aligned)
    void** sp = (void**)(((uintptr_t)(f.stack.get() + EMU_STACK) & ~(uintptr_t)15) - 64);
    for (int i = 0; i < 6; ++i) sp[i] = nullptr;
    sp[6] = (void*)&emu_fiber_main;
    sp[7] = nullptr;
    f.sp = sp;
#else
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.get();
    f.ctx.uc_stack.ss_size = EMU_STACK;
    f.ctx.uc_link = nullptr;
    makecontext(&f.ctx, (void (*)())emu_fiber_main, 0);
#endif
  }
  for (int left = n; left > 0;) {
    const uint64_t before = emu_progress;
    for (int t = 0; t < n; ++t) {
      if (emu_fibers[t].done) continue;
      emu_cur = t;
      threadIdx = dim3(t);
      emu_to_fiber(t);
      left -= emu_fibers[t].done;
    }
    if (left > 0 && emu_progress == before) {
      fprintf(stderr, "emulation deadlock: %d of %d threads wait at barriers no one else reaches\n",
              left, n);
      std::exit(3);
    }
  }
}

// A barrier of `expected` fibers: arrive, then switch to other fibers until
// the last of the party has arrived
struct EmuBarrier {
  int expected = 0, arrived = 0;
  unsigned gen = 0;
  void arrive_and_wait() {
    const unsigned g = gen;
    ++emu_progress;
    if (++arrived == expected) {
      arrived = 0;
      ++gen;
      return;
    }
    while (gen == g) emu_yield();
  }
};
inline EmuBarrier emu_block_bar;
inline EmuBarrier emu_warp_bar[32];
inline uint64_t emu_warp_buf[32][32][8];
inline void __syncthreads() { emu_block_bar.arrive_and_wait(); }
inline void emu_warp_sync() { emu_warp_bar[threadIdx.x / 32].arrive_and_wait(); }
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
inline void emu_cp_async16(void* dst, const void* src, bool valid) {
  emu_fibers[emu_cur].open.push_back({dst, src, valid});
}
inline void emu_commit() {
  EmuFiber& f = emu_fibers[emu_cur];
  f.groups.push_back(std::move(f.open));
  f.open.clear();
}
inline void emu_wait(int n) {
  auto& groups = emu_fibers[emu_cur].groups;
  while ((int)groups.size() > n) {
    for (auto& c : groups.front()) {
      if (c.valid) std::memcpy(c.dst, c.src, 16); else std::memset(c.dst, 0, 16);
    }
    groups.erase(groups.begin());
  }
}
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
