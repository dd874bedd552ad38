// Fused X-block forward (kernel K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel _fwd_pallas (dat_segmentation_tpu/ops/pallas/
// x_block.py:227, body _x_block_kernel, reached through fused_x_block and
// fused_conv_mlp). It computes _composite (:193) on an NHWC input x:
//
//   x1  = x + round(dw3(x) + b3)          LPU (mode X_LPU only)
//   y   = round(dw_k(x1) + b7)            window conv (identity in mode MLP)
//   y   = round(LN(y) * g + be)           float32 statistics, two-pass variance
//   h   = round(round(y · W1ᵀ) + b1)      fc1, C -> E, float32 sums
//   h   = round(h + round(dw3(h) + bd))   hidden depthwise with residual
//   out = round(gelu(h) · W2ᵀ + b2)       exact-erf GELU, fc2, E -> C
//
// where round() is to the working dtype (bf16 or float32) and every
// depthwise conv pads with zeros: x1 and h are zeroed outside the image
// before the next conv reads them (chained zero-padded convs are not one
// conv over a larger padded domain).
//
// What bounds it: the two products, 4·C·E flops a pixel. At DAT-T++ 512²,
// batch 16, the 26 calls of a forward do 447 GFLOP of them, 0.45 ms at the
// card's dense bf16 rate, while x and out (read once, written once) move
// 0.2 GB, 0.06 ms: on paper the tensor cores. In practice a block is held
// by what feeds them: the weights (each block streams all of W1 and W2
// from L2, up to 8 MB at C = 1024), the window phase and the hidden 3x3 +
// GELU on the CUDA cores, and shared-memory traffic. The design keeps the
// whole chain on chip and feeds the products from shared memory:
//  * A block owns (image, TH x 8 output pixels). It computes y over the tile
//    plus a one-pixel ring ((TH + 2) x 10 pixels, the rows of fc1's A
//    operand), LayerNorms it into shared memory, and never writes y, h or
//    the GELU output to device memory.
//  * The window phase (X modes) has the window k as a compile-time
//    constant (1, 3, 5, 7, 9), no device-memory load in its loops: a
//    channel chunk's x region (tile + both halos) and its taps and biases
//    are staged in the working type by cp.async (16 bytes a copy, zero
//    outside the image), the next chunk's while this one is computed; a
//    thread owns a channel pair and one row of outputs and slides along it
//    with the row's taps in registers, so a staged input is read once per
//    kernel row, not k*k times.
//  * The hidden width is walked in chunks of 64. fc1 makes h on the ring,
//    zeroes it outside the image; the 3x3 depthwise + residual + GELU runs
//    on the tile (a thread a channel pair and a run of pixels, the chunk's
//    taps staged); fc2 accumulates the chunk's share of out in registers.
//  * bf16 products: mma.sync m16n8k16, float32 sums, fragments by ldmatrix
//    (fragments.cuh). B (the nn.Linear weights, (out, in) row-major: the
//    column-major B, read by the non-transposed ldmatrix) streams through
//    a ring of RING_SLOTS fixed 64 x 64 tiles in shared memory, filled by
//    cp.async RING_SLOTS - 1 tiles ahead in the order the products take
//    them: per chunk the C/64 tiles of W1[e0:e0+64, :], then the C/64 tiles
//    of W2[:, e0:e0+64]. Its size does not depend on C. fc1 runs on a 4 x 2
//    warp grid (4 n8-tiles of every 4th ring m-tile a warp), fc2 on 2 x 4
//    (2 x 8 at TH = 2) with each 64-column tile's n8-tiles spread over the
//    warps and, where it costs at most 32 registers, the chunk's A
//    fragments held across its tiles.
//  * TH is chosen per width so that the out accumulator is 64 floats a
//    thread: 16 rows for C <= 128, 8 for 256, 4 for 512, 2 for 1024.
//    float32 (which only the checks use) runs TH = 2 at every width, its
//    products on the CUDA cores with B read from device memory.
//  * The output tile goes through shared memory and out in 16-byte stores.
// Not done: two blocks an SM (a bf16 block takes 110-210 KB of shared
// memory and 170-210 registers a thread), wgmma and TMA, the ring's
// recomputed fc1 rows (1.4-2.5x fc1's flops), the hidden 3x3 and the
// GELU in packed bf16.
//
// Layout: x and out (B, H, W, C) contiguous; the depthwise weights as
// Conv2d stores them, w3 (C, 1, 3, 3), w7 (C, 1, k, k), wd (E, 1, 3, 3);
// wf1 (E, C) and wf2 (C, E) as nn.Linear stores them; g, be, b3, b7, bf2
// (C); bf1, bd (E); everything in one dtype, 16-byte aligned. C a multiple
// of 32 up to 1024, E a multiple of 64, any H and W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "fragments.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TW = 8;       // tile width (output columns)
constexpr int RW = TW + 2;  // ring width
constexpr int NE = 64;      // hidden chunk: fc1's n and fc2's k a chunk

enum Mode { X_LPU = 0, X_PLAIN = 1, MLP = 2 };

__host__ __device__ inline int ring_rows_padded(int TH) { return ((TH + 2) * RW + 15) / 16 * 16; }

// Channels of one chunk of the window phase: 64 bytes of a pixel in bf16,
// 16 in float32 (a float32 block at C = 1024 must fit beside its 197 KB of y).
__host__ __device__ constexpr int win_channels(int tsize) { return tsize == 2 ? 32 : 4; }

// The window phase's regions, in pixels: x1 on the ring plus the window's
// halo (r1), and x on that plus the LPU's halo (r3). A region row is
// padded to an odd number of pixels, so the two rows a warp reads at once
// fall on other banks.
struct WinGeom {
  int r1h, r1w, r1p, r3h, r3w, r3p;
  __host__ __device__ constexpr WinGeom(int TH, int k)
      : r1h(TH + 2 + 2 * (k / 2)), r1w(RW + 2 * (k / 2)), r1p((RW + 2 * (k / 2)) | 1),
        r3h(TH + 4 + 2 * (k / 2)), r3w(RW + 2 + 2 * (k / 2)), r3p((RW + 2 + 2 * (k / 2)) | 1) {}
};

// Byte offsets inside one of the window phase's two chunk buffers: the x
// region staged from device memory (x itself, or x1 without the LPU), then
// the chunk's taps of the window conv and of the LPU and their biases, as
// Conv2d stores them: (channel, tap).
struct WinBuf {
  size_t x, w7, w3, b7, b3, size;
  __host__ __device__ WinBuf(int tsize, int TH, int k, bool lpu) {
    const WinGeom g(TH, k);
    const size_t cw = (size_t)win_channels(tsize) * tsize;
    x = 0;
    w7 = (size_t)(lpu ? g.r3h * g.r3p : g.r1h * g.r1p) * cw;
    w3 = w7 + cw * k * k;
    b7 = w3 + (lpu ? cw * 9 : 0);
    b3 = b7 + cw;
    size = b3 + (lpu ? cw : 0);
  }
};

// The weight stream (bf16): fc1's and fc2's B operands pass through a ring
// of RING_SLOTS tiles of 64 x 64 elements, rows padded to LDT (144 bytes:
// the 8 rows an ldmatrix reads fall on 8 distinct 16-byte bank groups).
constexpr int RING_SLOTS = 4;
constexpr int LDT = NE + 8;
constexpr int SLOT_ELEMS = NE * LDT;
// A hidden chunk's parameters: wd (64 x 9, as Conv2d stores it), b1, bd.
constexpr int PAR_ELEMS = NE * 9 + 2 * NE;

// Byte offsets of one block's shared memory. ys (the ring's y, then its
// LayerNorm, at last the output tile), prm (g, be, b2), par (the current
// hidden chunk's parameters) and the weight ring live throughout; the
// window phase's two chunk buffers and x1, and the hidden phase's h and
// GELU output, share the rest, one phase after the other.
struct Layout {
  int ldy, ldh;  // row strides in elements (16 bytes of padding a row)
  size_t ys, prm, par, ring, win, x1s, hs, gs, total;
  __host__ __device__ Layout(int tsize, int C, int k, int mode, int TH) {
    const int pad = 16 / tsize;
    const int mrp = ring_rows_padded(TH);
    ldy = C + pad;
    ldh = NE + pad;
    ys = 0;
    prm = align16((size_t)mrp * ldy * tsize);
    par = prm + (size_t)3 * C * tsize;
    ring = align16(par + (size_t)PAR_ELEMS * tsize);
    const size_t u = ring + (tsize == 2 ? (size_t)RING_SLOTS * SLOT_ELEMS * tsize : 0);
    hs = u;
    gs = align16(hs + (size_t)mrp * ldh * tsize);
    const size_t end_b = gs + (size_t)TH * TW * ldh * tsize;
    size_t end_a = u;
    win = x1s = u;
    if (mode != MLP) {
      const WinGeom g(TH, k);
      x1s = win + 2 * WinBuf(tsize, TH, k, mode == X_LPU).size;
      end_a = x1s + (mode == X_LPU ? (size_t)g.r1h * g.r1p * win_channels(tsize) * tsize : 0);
    }
    total = align16(end_a > end_b ? end_a : end_b);
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round to T and back: where _composite casts to the working dtype
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Two neighbouring channels as one 4-byte (bf16) or 8-byte (float32) word.
template <typename T> struct Pair2;
template <> struct Pair2<float> { using type = float2; };
template <> struct Pair2<__nv_bfloat16> { using type = __nv_bfloat162; };
__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
template <typename T> __device__ __forceinline__ float2 ld2(const T* p) {
  return to_f2(*reinterpret_cast<const typename Pair2<T>::type*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));  // exact erf, not tanh
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes from device memory to shared memory, asynchronously; zeros
// where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(r, c) for each cell of a rows x cols grid, the block's threads on
// consecutive cells; (r, c) advance without a division a cell.
template <typename F>
__device__ __forceinline__ void grid_walk(int rows, int cols, F&& f) {
  const int dr = THREADS / cols, dc = THREADS % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

__device__ __forceinline__ bool inside(int r, int c, int H, int W) {
  return r >= 0 && r < H && c >= 0 && c < W;
}

// ---- the window phase: y (before its LayerNorm) on the ring -----------------
//
// K, the window, is a compile-time constant here, instanced for each window
// the wrapper takes; the tile rows TH only bound loops, so one copy serves
// every tile (not inlined: 20 copies, not 50, keep the build short).
// Channels go in chunks of win_channels(); a chunk's x
// region (and its taps and biases) is staged by cp.async with 16-byte
// copies, zero outside the image, while the chunk before it is computed.
// A thread owns a channel pair and one row of outputs: it slides along the
// row with its taps in registers, so each staged input is read once per
// kernel row, not K*K times. Sums are float32, in the order a, b of the
// taps; x1 and y are rounded where _composite rounds them.
template <typename T, int K, bool LPU>
__device__ __noinline__ void window_phase(const T* __restrict__ xb, const T* __restrict__ w3,
                                          const T* __restrict__ b3, const T* __restrict__ w7,
                                          const T* __restrict__ b7, T* ys, int ldy,
                                          unsigned char* win, T* x1s, int H, int W, int C,
                                          int TH, int r0, int c0) {
  constexpr int CCW = win_channels(sizeof(T)), NP = CCW / 2;
  constexpr int EV = 16 / sizeof(T), VP = CCW / EV;  // elements a vector, vectors a pixel
  constexpr WinGeom G(0, K);  // the regions' widths (their heights depend on TH)
  constexpr int KH = K / 2;
  const int r1h = TH + 2 + 2 * KH;
  // the staged region: x1's region plus the LPU's halo, or x1's region itself
  const int SH = LPU ? r1h + 2 : r1h;
  constexpr int SW = LPU ? G.r3w : G.r1w, SP = LPU ? G.r3p : G.r1p;
  constexpr int OFF = LPU ? 2 + KH : 1 + KH;
  constexpr int N7 = CCW * K * K / EV, N3 = LPU ? CCW * 9 / EV : 0, NB = CCW / EV;
  const WinBuf wb(sizeof(T), TH, K, LPU);
  const int tid = threadIdx.x;

  auto stage = [&](int cb, int buf) {
    unsigned char* base = win + buf * wb.size;
    T* xs = reinterpret_cast<T*>(base + wb.x);
    grid_walk(SH, SW * VP, [&](int r, int cv) {
      const int c = cv / VP, v = cv % VP;
      const int gr = r0 - OFF + r, gc = c0 - OFF + c;
      const bool in = inside(gr, gc, H, W);
      cp_async16(xs + (r * SP + c) * CCW + v * EV,
                 in ? xb + ((size_t)gr * W + gc) * C + cb + v * EV : xb, in);
    });
    for (int i = tid; i < N7 + N3 + (LPU ? 2 : 1) * NB; i += THREADS) {
      if (i < N7)
        cp_async16(base + wb.w7 + i * 16, w7 + (size_t)cb * K * K + i * EV, true);
      else if (i < N7 + N3)
        cp_async16(base + wb.w3 + (i - N7) * 16, w3 + (size_t)cb * 9 + (i - N7) * EV, true);
      else if (i < N7 + N3 + NB)
        cp_async16(base + wb.b7 + (i - N7 - N3) * 16, b7 + cb + (i - N7 - N3) * EV, true);
      else
        cp_async16(base + wb.b3 + (i - N7 - N3 - NB) * 16, b3 + cb + (i - N7 - N3 - NB) * EV,
                   true);
    }
  };

  const int nch = C / CCW;
  stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int cb = ch * CCW;
    if (ch + 1 < nch) {
      stage(cb + CCW, (ch + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* base = win + (ch & 1) * wb.size;
    const T* xs = reinterpret_cast<const T*>(base + wb.x);
    const T* t7 = reinterpret_cast<const T*>(base + wb.w7);
    const T* bb7 = reinterpret_cast<const T*>(base + wb.b7);
    const T* src1 = xs;  // what the window conv reads: x1 (zero outside the image)
    if constexpr (LPU) {
      const T* t3 = reinterpret_cast<const T*>(base + wb.w3);
      const T* bb3 = reinterpret_cast<const T*>(base + wb.b3);
      // x1 = x + round(dw3(x) + b3), zero outside the image
      for (int it = tid; it < r1h * NP; it += THREADS) {
        const int r = it / NP, p = it % NP;
        float2 acc[G.r1w];
#pragma unroll
        for (int j = 0; j < G.r1w; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float2 w[3];
#pragma unroll
          for (int b = 0; b < 3; ++b)
            w[b] = make_float2(to_f(t3[2 * p * 9 + a * 3 + b]), to_f(t3[(2 * p + 1) * 9 + a * 3 + b]));
          const T* row = xs + (r + a) * G.r3p * CCW + 2 * p;
#pragma unroll
          for (int c = 0; c < G.r3w; ++c) {
            const float2 v = ld2(row + c * CCW);
#pragma unroll
            for (int b = 0; b < 3; ++b) {
              const int j = c - b;
              if (j >= 0 && j < G.r1w) {
                acc[j].x = fmaf(v.x, w[b].x, acc[j].x);
                acc[j].y = fmaf(v.y, w[b].y, acc[j].y);
              }
            }
          }
        }
        const float2 bias = make_float2(to_f(bb3[2 * p]), to_f(bb3[2 * p + 1]));
        const int gr = r0 - 1 - KH + r;
        const T* mid = xs + (r + 1) * G.r3p * CCW + 2 * p;
        T* out = x1s + r * G.r1p * CCW + 2 * p;
#pragma unroll
        for (int j = 0; j < G.r1w; ++j) {
          float vx = 0.f, vy = 0.f;
          if (inside(gr, c0 - 1 - KH + j, H, W)) {
            const float2 xc = ld2(mid + (j + 1) * CCW);
            vx = rnd<T>(xc.x + rnd<T>(acc[j].x + bias.x));
            vy = rnd<T>(xc.y + rnd<T>(acc[j].y + bias.y));
          }
          st2(out + j * CCW, vx, vy);
        }
      }
      __syncthreads();
      src1 = x1s;
    }
    // y = dw_K(x1) + b7 on the ring, rounded into ys
    for (int it = tid; it < (TH + 2) * NP; it += THREADS) {
      const int r = it / NP, p = it % NP;
      float2 acc[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll 1
      for (int a = 0; a < K; ++a) {
        float2 w[K];
#pragma unroll
        for (int b = 0; b < K; ++b)
          w[b] = make_float2(to_f(t7[2 * p * K * K + a * K + b]),
                             to_f(t7[(2 * p + 1) * K * K + a * K + b]));
        const T* row = src1 + (r + a) * G.r1p * CCW + 2 * p;
#pragma unroll
        for (int c = 0; c < G.r1w; ++c) {
          const float2 v = ld2(row + c * CCW);
#pragma unroll
          for (int b = 0; b < K; ++b) {
            const int j = c - b;
            if (j >= 0 && j < RW) {
              acc[j].x = fmaf(v.x, w[b].x, acc[j].x);
              acc[j].y = fmaf(v.y, w[b].y, acc[j].y);
            }
          }
        }
      }
      const float2 bias = make_float2(to_f(bb7[2 * p]), to_f(bb7[2 * p + 1]));
      T* out = ys + r * RW * ldy + cb + 2 * p;
#pragma unroll
      for (int j = 0; j < RW; ++j) st2(out + j * ldy, acc[j].x + bias.x, acc[j].y + bias.y);
    }
    __syncthreads();  // the next chunk's copies overwrite this chunk's buffer and x1
  }
}

template <typename T, bool LPU>
__device__ void window_phase_k(int k, const T* xb, const T* w3, const T* b3, const T* w7,
                               const T* b7, T* ys, int ldy, unsigned char* win, T* x1s, int H,
                               int W, int C, int TH, int r0, int c0) {
  switch (k) {
#define XB_WINDOW(K)                                                                          \
  case K:                                                                                     \
    window_phase<T, K, LPU>(xb, w3, b3, w7, b7, ys, ldy, win, x1s, H, W, C, TH, r0, c0);     \
    break;
    XB_WINDOW(1) XB_WINDOW(3) XB_WINDOW(5) XB_WINDOW(7) XB_WINDOW(9)
#undef XB_WINDOW
  }
}

// float32 products on the CUDA cores (only the checks run float32), in the
// register layout of mma.m16n8k16: lane l holds rows l/4 and l/4 + 8 and
// columns 2(l%4) and 2(l%4) + 1 of a 16 x 8 tile; 8 of K a step. A is
// row-major in shared memory, B 8 rows of an (N, K) row-major weight in
// device memory (column-major B).
struct MmaF32 {
  struct A { float r[2][8]; };  // rows l/4 and l/4 + 8
  struct B { float r[2][8]; };  // columns 2(l%4) and 2(l%4) + 1
  __device__ static void load8(float (&dst)[8], const float* p) {
    const float4 u = reinterpret_cast<const float4*>(p)[0];
    const float4 v = reinterpret_cast<const float4*>(p)[1];
    dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
    dst[4] = v.x; dst[5] = v.y; dst[6] = v.z; dst[7] = v.w;
  }
  __device__ static void load_a(A& f, const float* a, int lda, int lane) {
    load8(f.r[0], a + (lane >> 2) * lda);
    load8(f.r[1], a + ((lane >> 2) + 8) * lda);
  }
  __device__ static void load_b(B& f, const float* w, int ldw, int lane) {
    load8(f.r[0], w + (size_t)((lane & 3) * 2) * ldw);
    load8(f.r[1], w + (size_t)((lane & 3) * 2 + 1) * ldw);
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      d[0] = fmaf(a.r[0][i], b.r[0][i], d[0]);
      d[1] = fmaf(a.r[0][i], b.r[1][i], d[1]);
      d[2] = fmaf(a.r[1][i], b.r[0][i], d[2]);
      d[3] = fmaf(a.r[1][i], b.r[1][i], d[3]);
    }
  }
};

template <typename T, int TH>
__global__ void __launch_bounds__(THREADS, 1)
x_block_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w3, const T* __restrict__ b3,
                   const T* __restrict__ w7, const T* __restrict__ b7, const T* __restrict__ g,
                   const T* __restrict__ be, const T* __restrict__ wf1,
                   const T* __restrict__ bf1, const T* __restrict__ wd,
                   const T* __restrict__ bd, const T* __restrict__ wf2,
                   const T* __restrict__ bf2, T* __restrict__ out, int H, int W, int C, int E,
                   int k, int mode, float eps) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int EV = 16 / sizeof(T);               // elements a 16-byte vector
  constexpr int MOUT = TH * TW;                    // output pixels of the tile
  constexpr int MRING = (TH + 2) * RW;             // ring pixels
  constexpr int MRP = (MRING + 15) / 16 * 16;      // ring rows padded to m-tiles
  constexpr int MT_RING = MRP / 16, MT_OUT = MOUT / 16;
  // fc1 (ring x 64 of a chunk): WM1 x WN1 warps, each NN1 n8-tiles of
  // every WM1-th m-tile
  constexpr int WM1 = 4, WN1 = WARPS / WM1, NN1 = 8 / WN1, MW1 = (MT_RING + WM1 - 1) / WM1;
  // fc2 (tile x C): per 64-column weight tile, WM2 x WN2 warps, each NN2
  // n8-tiles of MW2 m-tiles; NT tiles cover C <= 64 * 32 / TH
  constexpr int WM2 = MT_OUT >= 2 ? 2 : 1, WN2 = WARPS / WM2, NN2 = 8 / WN2;
  constexpr int MW2 = MT_OUT / WM2, NT = 32 / TH;
  // fc2's A fragments (the chunk's GELU output) held in registers across
  // the chunk's weight tiles where that costs at most 32 registers
  constexpr bool HOLD_A = BF16 && MW2 <= 2;
  constexpr int PV = PAR_ELEMS / EV;               // 16-byte vectors of a chunk's parameters
  static_assert(MOUT % 16 == 0 && MT_OUT % WM2 == 0, "the tile is whole m-tiles");
  static_assert(PV <= THREADS, "a vector of a chunk's parameters a thread");

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(sizeof(T), C, k, mode, TH);
  const int ldy = lay.ldy, ldh = lay.ldh;
  T* ys = reinterpret_cast<T*>(smem + lay.ys);
  T* prm = reinterpret_cast<T*>(smem + lay.prm);  // g, be, b2
  T* par = reinterpret_cast<T*>(smem + lay.par);  // wd (64 x 9), b1, bd of the chunk
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  T* hs = reinterpret_cast<T*>(smem + lay.hs);
  T* gs = reinterpret_cast<T*>(smem + lay.gs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH;
  const T* xb = x + (size_t)blockIdx.z * H * W * C;
  const int VPC = C / EV;                          // 16-byte vectors of a pixel
  const int NKT = (C + NE - 1) / NE;               // 64-wide weight tiles over C
  const int n_tiles = E / NE * 2 * NKT;

  // The weight stream, in the order the products take it: for each hidden
  // chunk of 64, the NKT tiles of W1[e0:e0+64, :], then the NKT tiles of
  // W2[:, e0:e0+64], each into the next slot of the ring; past C nothing is
  // copied (the products do not read it). A thread copies the same two
  // 16-byte pieces of every tile (rows r and r + 32, column v * EV), so its
  // addresses advance by additions, not a division a tile.
  const int rq = tid / (NE / EV), vq = (tid % (NE / EV)) * EV;
  const T* w1c = wf1 + (size_t)rq * C + vq;  // the issuing chunk's W1 rows
  const T* w2c = wf2 + (size_t)rq * E + vq;  // and W2 columns
  int is_j = 0, is_left = n_tiles, is_slot = 0;
  auto issue_next = [&]() {
    if constexpr (BF16) {
      if (is_left == 0) return;
      T* dst = ring + is_slot * SLOT_ELEMS + rq * LDT + vq;
      if (is_j < NKT) {
        if (is_j * NE + vq < C) {
          const T* src = w1c + is_j * NE;
          cp_async16(dst, src, true);
          cp_async16(dst + 32 * LDT, src + (size_t)32 * C, true);
        }
      } else {
        const int n = (is_j - NKT) * NE + rq;  // output channel of the first piece
        const T* src = w2c + (size_t)(is_j - NKT) * NE * E;
        if (n < C) cp_async16(dst, src, true);
        if (n + 32 < C) cp_async16(dst + 32 * LDT, src + (size_t)32 * E, true);
      }
      --is_left;
      is_slot = is_slot == RING_SLOTS - 1 ? 0 : is_slot + 1;
      if (++is_j == 2 * NKT) {
        is_j = 0;
        w1c += (size_t)NE * C;
        w2c += NE;
      }
    }
  };
  static_assert(NE * NE / EV == 2 * THREADS || !BF16, "two pieces of a tile a thread");
  auto par_src = [&](int ci, int i) -> const T* {
    constexpr int NW = NE * 9 / EV, NB = NE / EV;
    if (i < NW) return wd + (size_t)ci * NE * 9 + i * EV;
    if (i < NW + NB) return bf1 + ci * NE + (i - NW) * EV;
    return bd + ci * NE + (i - NW - NB) * EV;
  };

  // ---- 0. the first group: g, be, b2, chunk 0's parameters, the first tiles ----
  for (int i = tid; i < 3 * VPC; i += THREADS) {
    const int which = i / VPC, v = i - which * VPC;
    cp_async16(prm + i * EV, (which == 0 ? g : which == 1 ? be : bf2) + v * EV, true);
  }
  if (tid < PV) cp_async16(par + tid * EV, par_src(0, tid), true);
  for (int i = 0; i < RING_SLOTS - 1; ++i) issue_next();
  cp_async_commit();

  // ---- 1. y on the ring: (TH + 2) x RW pixels from image (r0 - 1, c0 - 1) ----
  if (mode == MLP) {
    grid_walk(MRP, VPC, [&](int q, int v) {
      const int r = r0 - 1 + q / RW, c = c0 - 1 + q % RW;
      const bool in = q < MRING && inside(r, c, H, W);
      cp_async16(ys + q * ldy + v * EV, in ? xb + ((size_t)r * W + c) * C + v * EV : xb, in);
    });
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = tid; i < (MRP - MRING) * C; i += THREADS)  // the m-tiles' padding rows
      ys[(MRING + i / C) * ldy + i % C] = from_f<T>(0.f);
    unsigned char* win = smem + lay.win;
    T* x1s = reinterpret_cast<T*>(smem + lay.x1s);
    if (mode == X_LPU)
      window_phase_k<T, true>(k, xb, w3, b3, w7, b7, ys, ldy, win, x1s, H, W, C, TH, r0, c0);
    else
      window_phase_k<T, false>(k, xb, w3, b3, w7, b7, ys, ldy, win, x1s, H, W, C, TH, r0, c0);
  }
  __syncthreads();

  // ---- 2. LayerNorm over C of each ring pixel, in place: a warp takes 4
  // pixels at once (channel pairs a lane), float32 statistics, two passes ----
  for (int q0 = warp * 4; q0 < MRING; q0 += WARPS * 4) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f}, mean[4], rstd[4];
    for (int c = 2 * lane; c < C; c += 64)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < MRING) {
          const float2 f = ld2(ys + (q0 + u) * ldy + c);
          s[u] += f.x + f.y;
        }
#pragma unroll
    for (int u = 0; u < 4; ++u) mean[u] = warp_sum(s[u]) / (float)C;
    for (int c = 2 * lane; c < C; c += 64)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < MRING) {
          const float2 f = ld2(ys + (q0 + u) * ldy + c);
          const float dx = f.x - mean[u], dy = f.y - mean[u];
          v[u] = fmaf(dy, dy, fmaf(dx, dx, v[u]));
        }
#pragma unroll
    for (int u = 0; u < 4; ++u) rstd[u] = rsqrtf(warp_sum(v[u]) / (float)C + eps);
    for (int c = 2 * lane; c < C; c += 64) {
      const float2 gg = ld2(prm + c), bb = ld2(prm + C + c);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < MRING) {
          T* p = ys + (q0 + u) * ldy + c;
          const float2 f = ld2(p);
          st2(p, (f.x - mean[u]) * rstd[u] * gg.x + bb.x, (f.y - mean[u]) * rstd[u] * gg.y + bb.y);
        }
    }
  }
  // (the first step of the stream below begins with a barrier)

  // ---- 3. the hidden width in chunks of NE ----
  const int wm1 = warp % WM1, wn1 = warp / WM1;         // fc1's warp grid
  const int wm2 = warp % WM2, wn2 = warp / WM2;          // fc2's warp grid
  float acc2[MW2][NT][NN2][4];
#pragma unroll
  for (int i = 0; i < MW2; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int n = 0; n < NN2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][t][n][j] = 0.f;

  int use_slot = 0;  // the slot of the tile the next step computes with
  // one step of the stream: that tile has landed and every thread is done
  // with the one before it, whose slot takes the tile RING_SLOTS - 1 ahead
  auto step = [&]() {
    cp_async_wait<RING_SLOTS - 2>();
    __syncthreads();
    issue_next();
    cp_async_commit();
    const T* slot = ring + use_slot * SLOT_ELEMS;
    use_slot = use_slot == RING_SLOTS - 1 ? 0 : use_slot + 1;
    return slot;
  };

  for (int e0 = 0, ci = 0; e0 < E; e0 += NE, ++ci) {
    // the next chunk's parameters, into registers now, into par after this
    // chunk's hidden phase
    uint4 par_next = make_uint4(0u, 0u, 0u, 0u);
    if (tid < PV && e0 + NE < E) par_next = *reinterpret_cast<const uint4*>(par_src(ci + 1, tid));

    // fc1 on the ring: this warp's NN1 n8-tiles of every WM1-th m-tile
    float acc1[MW1][NN1][4];
#pragma unroll
    for (int i = 0; i < MW1; ++i)
#pragma unroll
      for (int n = 0; n < NN1; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc1[i][n][j] = 0.f;
    for (int jt = 0; jt < NKT; ++jt) {
      const T* slot = step();
      const int kv = min(NE, C - jt * NE);
      if constexpr (BF16) {
        for (int kk = 0; kk < kv; kk += 16) {
          uint32_t b[NN1 / 2][4];  // two n8-tiles an ldmatrix
#pragma unroll
          for (int h = 0; h < NN1 / 2; ++h)
            ldsm_x4(b[h], slot + (wn1 * 8 * NN1 + h * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT +
                              kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < MW1; ++i) {
            const int m = wm1 + WM1 * i;
            if (m < MT_RING) {
              uint32_t a[4];
              ldsm_x4(a, ys + (m * 16 + (lane & 15)) * ldy + jt * NE + kk + (lane >> 4) * 8);
#pragma unroll
              for (int h = 0; h < NN1 / 2; ++h) {
                mma(acc1[i][2 * h], a, b[h][0], b[h][1]);
                mma(acc1[i][2 * h + 1], a, b[h][2], b[h][3]);
              }
            }
          }
        }
      } else {
        for (int kk = 0; kk < kv; kk += 8) {
          MmaF32::B bf[NN1];
#pragma unroll
          for (int n = 0; n < NN1; ++n)
            MmaF32::load_b(bf[n], wf1 + (size_t)(e0 + (wn1 * NN1 + n) * 8) * C + jt * NE + kk, C,
                           lane);
#pragma unroll
          for (int i = 0; i < MW1; ++i) {
            const int m = wm1 + WM1 * i;
            if (m < MT_RING) {
              MmaF32::A af;
              MmaF32::load_a(af, ys + m * 16 * ldy + jt * NE + kk, ldy, lane);
#pragma unroll
              for (int n = 0; n < NN1; ++n) MmaF32::mma(acc1[i][n], af, bf[n]);
            }
          }
        }
      }
    }
    // h = round(round(y · W1ᵀ) + b1), zero outside the image: the hidden
    // depthwise pads with zeros
#pragma unroll
    for (int i = 0; i < MW1; ++i) {
      const int m = wm1 + WM1 * i;
      if (m >= MT_RING) continue;
#pragma unroll
      for (int n = 0; n < NN1; ++n) {
        const int col = (wn1 * NN1 + n) * 8 + (lane & 3) * 2;
        const float2 bias = ld2(par + NE * 9 + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = m * 16 + (lane >> 2) + half * 8;
          const bool ok = q < MRING && inside(r0 - 1 + q / RW, c0 - 1 + q % RW, H, W);
          st2(hs + q * ldh + col, ok ? rnd<T>(acc1[i][n][2 * half]) + bias.x : 0.f,
              ok ? rnd<T>(acc1[i][n][2 * half + 1]) + bias.y : 0.f);
        }
      }
    }
    __syncthreads();

    // hidden 3x3 depthwise + residual + GELU on the tile: a thread takes a
    // channel pair and a run of L pixels along a tile row, sliding
    {
      constexpr int L = TH < TW ? TH : TW, RUNS = TW / L;
      const T* wds = par;
      const T* bds = par + NE * 9 + NE;
      for (int it = tid; it < TH * RUNS * (NE / 2); it += THREADS) {
        const int e = 2 * (it % (NE / 2)), run = it / (NE / 2);
        const int pi = run / RUNS, pj0 = (run % RUNS) * L;
        float2 w[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) w[t] = make_float2(to_f(wds[e * 9 + t]), to_f(wds[(e + 1) * 9 + t]));
        float2 acc[L];
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T* row = hs + ((pi + a) * RW + pj0) * ldh + e;
#pragma unroll
          for (int c = 0; c < L + 2; ++c) {
            const float2 v = ld2(row + c * ldh);
#pragma unroll
            for (int b = 0; b < 3; ++b) {
              const int j = c - b;
              if (j >= 0 && j < L) {
                acc[j].x = fmaf(v.x, w[a * 3 + b].x, acc[j].x);
                acc[j].y = fmaf(v.y, w[a * 3 + b].y, acc[j].y);
              }
            }
          }
        }
        const float2 bias = ld2(bds + e);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const float2 hc = ld2(hs + ((pi + 1) * RW + pj0 + j + 1) * ldh + e);
          const float hx = rnd<T>(hc.x + rnd<T>(acc[j].x + bias.x));
          const float hy = rnd<T>(hc.y + rnd<T>(acc[j].y + bias.y));
          st2(gs + (pi * TW + pj0 + j) * ldh + e, gelu(hx), gelu(hy));
        }
      }
    }

    // fc2: out += gelu(h) · W2[:, e0:e0+64]ᵀ, one 64-column tile a step
    uint32_t ah[HOLD_A ? MW2 : 1][NE / 16][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t >= NKT) break;
      const T* slot = step();
      // this chunk's hidden phase is done: par takes the next chunk's
      if (t == 0 && tid < PV && e0 + NE < E) *reinterpret_cast<uint4*>(par + tid * EV) = par_next;
      if constexpr (HOLD_A) {
        if (t == 0)
#pragma unroll
          for (int i = 0; i < MW2; ++i)
#pragma unroll
            for (int ks = 0; ks < NE / 16; ++ks)
              ldsm_x4(ah[i][ks],
                      gs + ((wm2 + WM2 * i) * 16 + (lane & 15)) * ldh + ks * 16 + (lane >> 4) * 8);
      }
      const int n0 = t * NE + wn2 * 8 * NN2;  // this warp's first output column
      if (n0 >= C) continue;
      if constexpr (BF16) {
#pragma unroll
        for (int kq = 0; kq < NE / 32; ++kq) {  // two k16 steps a turn
          // NN2 == 2: b[h], both n8-tiles at step 2 kq + h; NN2 == 1: b[0], the
          // one n8-tile at both steps
          uint32_t b[2][4];
          if constexpr (NN2 == 2) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              ldsm_x4(b[h], slot + (wn2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT + kq * 32 +
                                h * 16 + ((lane >> 3) & 1) * 8);
          } else {
            ldsm_x4(b[0], slot + (wn2 * 8 + (lane & 7)) * LDT + kq * 32 + (lane >> 3) * 8);
          }
#pragma unroll
          for (int i = 0; i < MW2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t a[4];
              if constexpr (HOLD_A) {
#pragma unroll
                for (int r = 0; r < 4; ++r) a[r] = ah[i][2 * kq + h][r];
              } else {
                ldsm_x4(a, gs + ((wm2 + WM2 * i) * 16 + (lane & 15)) * ldh + kq * 32 + h * 16 +
                               (lane >> 4) * 8);
              }
              if constexpr (NN2 == 2) {
                mma(acc2[i][t][0], a, b[h][0], b[h][1]);
                mma(acc2[i][t][1], a, b[h][2], b[h][3]);
              } else {
                mma(acc2[i][t][0], a, b[0][2 * h], b[0][2 * h + 1]);
              }
            }
        }
      } else {
        for (int kk = 0; kk < NE; kk += 8) {
          MmaF32::B bf[NN2];
#pragma unroll
          for (int n = 0; n < NN2; ++n)
            MmaF32::load_b(bf[n], wf2 + (size_t)(n0 + n * 8) * E + e0 + kk, E, lane);
#pragma unroll
          for (int i = 0; i < MW2; ++i) {
            MmaF32::A af;
            MmaF32::load_a(af, gs + (wm2 + WM2 * i) * 16 * ldh + kk, ldh, lane);
#pragma unroll
            for (int n = 0; n < NN2; ++n) MmaF32::mma(acc2[i][t][n], af, bf[n]);
          }
        }
      }
    }
  }

  // ---- 4. out = acc + b2: the tile through shared memory (ys is free: the
  // last fc1 step is behind the last fc2 step's barrier), then 16-byte stores
  // of the pixels inside the image ----
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int n = 0; n < NN2; ++n) {
      const int col = t * NE + (wn2 * NN2 + n) * 8 + (lane & 3) * 2;
      if (col >= C) continue;
      const float2 bias = ld2(prm + 2 * C + col);
#pragma unroll
      for (int i = 0; i < MW2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (wm2 + WM2 * i) * 16 + (lane >> 2) + half * 8;
          st2(ys + p * ldy + col, acc2[i][t][n][2 * half] + bias.x,
              acc2[i][t][n][2 * half + 1] + bias.y);
        }
    }
  }
  __syncthreads();
  T* ob = out + (size_t)blockIdx.z * H * W * C;
  grid_walk(MOUT, VPC, [&](int p, int v) {
    const int r = r0 + p / TW, c = c0 + p % TW;
    if (r < H && c < W)
      *reinterpret_cast<uint4*>(ob + ((size_t)r * W + c) * C + v * EV) =
          *reinterpret_cast<const uint4*>(ys + p * ldy + v * EV);
  });
}

int max_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// The tile rows of a launch: bf16, the largest tile whose fc2 accumulator
// (64 floats a thread: NT = 32 / TH weight tiles of 64 columns) covers C
// and whose block fits shared memory; float32 (the checks), 2 rows, the one
// instance that fits at every width. 0 if none fits.
int choose_tile(int tsize, int C, int mode, int k, int max_smem) {
  const int ths[] = {16, 8, 4, 2};
  for (int th : ths)
    if ((tsize == 2 || th == 2) && C <= 64 * (32 / th) &&
        Layout(tsize, C, k, mode, th).total <= (size_t)max_smem)
      return th;
  return 0;
}

const void* kernel_of(int tsize, int th) {
  using bf16 = __nv_bfloat16;
  if (tsize == 4) return th == 2 ? reinterpret_cast<const void*>(x_block_fwd_kernel<float, 2>) : nullptr;
  switch (th) {
    case 16: return reinterpret_cast<const void*>(x_block_fwd_kernel<bf16, 16>);
    case 8: return reinterpret_cast<const void*>(x_block_fwd_kernel<bf16, 8>);
    case 4: return reinterpret_cast<const void*>(x_block_fwd_kernel<bf16, 4>);
    case 2: return reinterpret_cast<const void*>(x_block_fwd_kernel<bf16, 2>);
    default: return nullptr;
  }
}

// The kernel instance a launch at these widths takes, and its shared memory.
cudaError_t prepare(int tsize, int C, int mode, int k, const void** fn, int* th, size_t* smem) {
  *th = choose_tile(tsize, C, mode, k, max_smem_optin());
  *fn = kernel_of(tsize, *th);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  *smem = Layout(tsize, C, k, mode, *th).total;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T>
cudaError_t launch(const void* const* p, void* out, int B, int H, int W, int C, int E, int k,
                   int mode, float eps, cudaStream_t stream) {
  const void* fn;
  int th;
  size_t smem;
  cudaError_t err = prepare(sizeof(T), C, mode, k, &fn, &th, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + th - 1) / th, B);
  T* o = static_cast<T*>(out);
  void* args[21];
  for (int i = 0; i < 13; ++i) args[i] = (void*)(p + i);  // the 13 parameter pointers
  void* rest[] = {&o, &H, &W, &C, &E, &k, &mode, &eps};
  for (int i = 0; i < 8; ++i) args[13 + i] = rest[i];
  err = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 = X block with the LPU, 1 = X block without it, 2 = MLP only (k = 1;
// w3, b3, w7, b7 unused). dtype: 0 = float32, 1 = bfloat16. Depthwise
// weights as Conv2d stores them: w3 (C, 1, 3, 3), w7 (C, 1, k, k), wd
// (E, 1, 3, 3). Returns a cudaError_t (0 = launched).
int dat_x_block_fwd(const void* x, const void* w3, const void* b3, const void* w7, const void* b7,
                    const void* g, const void* be, const void* wf1, const void* bf1,
                    const void* wd, const void* bd, const void* wf2, const void* bf2, void* out,
                    int B, int H, int W, int C, int E, int k, int mode, float eps, int dtype,
                    void* stream) {
  if (C % 32 || C > 1024 || E % NE || mode < 0 || mode > 2 ||
      (mode != MLP && (k < 1 || k > 9 || k % 2 == 0)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const void* p[13] = {x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, out, B, H, W, C, E, k, mode, eps, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, out, B, H, W, C, E, k, mode, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Output rows of the (rows x 8)-pixel tile the launch takes (0: none fits).
int dat_x_block_fwd_tile(int dtype, int C, int mode, int k) {
  return choose_tile(dtype == 0 ? 4 : 2, C, mode, k, max_smem_optin());
}

// Bytes of dynamic shared memory one block takes with tile rows `th`.
long long dat_x_block_fwd_smem_bytes(int dtype, int C, int mode, int k, int th) {
  return (long long)Layout(dtype == 0 ? 4 : 2, C, k, mode, th).total;
}

// Blocks of the launch at these widths resident on one SM, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (0 if none fits).
int dat_x_block_fwd_resident_blocks(int dtype, int C, int mode, int k) {
  const void* fn;
  int th, n = 0;
  size_t smem;
  if (prepare(dtype == 0 ? 4 : 2, C, mode, k, &fn, &th, &smem) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, THREADS, smem) != cudaSuccess) return 0;
  return n;
}

// Registers a thread of the launch's kernel instance takes (0 if none fits).
int dat_x_block_fwd_registers(int dtype, int C, int mode, int k) {
  const void* fn;
  int th;
  size_t smem;
  cudaFuncAttributes attr;
  if (prepare(dtype == 0 ? 4 : 2, C, mode, k, &fn, &th, &smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, fn) != cudaSuccess)
    return 0;
  return attr.numRegs;
}

int dat_x_block_fwd_warps_per_block() { return WARPS; }

const char* dat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
