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
// 0.2 GB, 0.06 ms. So the kernel is bounded by the tensor cores, and the
// design is about keeping the products on them with the whole chain on
// chip:
//  * A block owns (image, TH x 8 output pixels). It computes y over the tile
//    plus a one-pixel ring ((TH + 2) x 10 pixels, the rows of fc1's A
//    operand), LayerNorms it into shared memory, and never writes y, h or
//    the GELU output to device memory.
//  * The hidden width is walked in chunks of 64. For each chunk fc1 makes
//    h on the ring (8 warps, one 8-column n-tile each, all ring m-tiles),
//    zeroes it outside the image, the 3x3 depthwise + residual + GELU runs
//    on the tile, and fc2 accumulates the chunk's share of out in
//    registers (each warp owns C / 64 output n-tiles of every row).
//  * bf16 products run on the tensor cores, mma.sync m16n8k16 with float32
//    accumulation: A from shared memory by ldmatrix, B (the nn.Linear
//    weights, (out, in) row-major, i.e. column-major B) straight from L2,
//    where both weight matrices of a stage stay (at most 2.4 MB). float32
//    (which only the checks use) runs the same tiles on the CUDA cores.
//  * TH is chosen per width so that the out accumulator is 64 floats a
//    thread: 16 rows for C <= 128, 8 for 256, 4 for 512, 2 for 1024 (fewer
//    when a float32 block would not fit shared memory).
// Not done yet: wgmma, TMA, pipelined weight loads, more than one block an
// SM (a bf16 block takes 60-140 KB of shared memory), and the ring's
// recomputed fc1 rows (1.4-2.5x fc1's flops).
//
// Layout: x and out (B, H, W, C) contiguous; w3 (9, C) and w7 (k*k, C)
// tap-major with channels contiguous, wd (9, E) likewise; wf1 (E, C) and
// wf2 (C, E) as nn.Linear stores them; g, be, b3, b7, bf2 (C); bf1, bd (E);
// everything in one dtype. C a multiple of 32 up to 1024, E a multiple of
// 64, any H and W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TW = 8;       // tile width (output columns)
constexpr int RW = TW + 2;  // ring width
constexpr int NE = 64;      // hidden chunk: one 8-column n-tile per warp in fc1
constexpr int CC = 32;      // channel chunk of the depthwise phase (X modes)

enum Mode { X_LPU = 0, X_PLAIN = 1, MLP = 2 };

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }
__host__ __device__ inline int ring_rows_padded(int TH) { return ((TH + 2) * RW + 15) / 16 * 16; }

// Byte offsets of one block's shared memory. ys (the ring's y, then its
// LayerNorm) lives throughout; the depthwise phase's x and x1 (float32,
// one channel chunk) and the hidden phase's h and GELU output share the
// rest, one phase after the other.
struct Layout {
  int ldy, ldh;  // row strides in elements (16 bytes of padding a row)
  size_t ys, xs, x1s, hs, gs, total;
  __host__ __device__ Layout(int tsize, int C, int k, int mode, int TH) {
    const int pad = 16 / tsize;
    const int mrp = ring_rows_padded(TH);
    ldy = C + pad;
    ldh = NE + pad;
    ys = 0;
    const size_t u = align16((size_t)mrp * ldy * tsize);
    hs = u;
    gs = align16(hs + (size_t)mrp * ldh * tsize);
    const size_t end_b = gs + (size_t)TH * TW * ldh * tsize;
    size_t end_a = u;
    xs = x1s = u;
    if (mode != MLP) {
      const int kh = k / 2;
      end_a = x1s + (size_t)(TH + 2 + 2 * kh) * (RW + 2 * kh) * CC * sizeof(float);
      if (mode == X_LPU) {
        xs = align16(end_a);
        end_a = xs + (size_t)(TH + 4 + 2 * kh) * (RW + 2 + 2 * kh) * CC * sizeof(float);
      }
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

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));  // exact erf, not tanh
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp's 16 x 8 x KS step of D += A·B, in the register layout of
// mma.m16n8k16: lane l holds rows l/4 and l/4 + 8, columns 2(l%4) and
// 2(l%4) + 1 of the 16 x 8 tile. A is row-major in shared memory (16 rows
// from `a`, stride `lda`), B is 8 rows of a (N, K) row-major weight in
// global memory (from `w`, stride `ldw`: column-major B).
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static constexpr int KS = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  __device__ static void load_a(A& f, const __nv_bfloat16* a, int lda, int lane) {
    const __nv_bfloat16* p = a + (lane & 15) * lda + (lane >> 4) * 8;
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(f.r[0]), "=r"(f.r[1]), "=r"(f.r[2]), "=r"(f.r[3])
                 : "r"(addr));
  }
  __device__ static void load_b(B& f, const __nv_bfloat16* w, int ldw, int lane) {
    const __nv_bfloat16* p = w + (size_t)(lane >> 2) * ldw + (lane & 3) * 2;
    f.r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    f.r[1] = __ldg(reinterpret_cast<const unsigned int*>(p + 8));
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

// float32: the same tile on the CUDA cores, 8 of K at a time.
template <> struct Mma<float> {
  static constexpr int KS = 8;
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
  using M = Mma<T>;
  constexpr int MOUT = TH * TW;                   // output pixels of the tile
  constexpr int MRING = (TH + 2) * RW;            // ring pixels
  constexpr int MRP = (MRING + 15) / 16 * 16;     // ring rows padded to m-tiles
  constexpr int MT_RING = MRP / 16;
  constexpr int MT_OUT = MOUT / 16;
  constexpr int NT2 = 32 / TH;                    // fc2 n-tiles a warp may own
  static_assert(MOUT % 16 == 0, "the tile is whole m-tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(sizeof(T), C, k, mode, TH);
  const int ldy = lay.ldy, ldh = lay.ldh;
  T* ys = reinterpret_cast<T*>(smem + lay.ys);
  T* hs = reinterpret_cast<T*>(smem + lay.hs);
  T* gs = reinterpret_cast<T*>(smem + lay.gs);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* x1s = reinterpret_cast<float*>(smem + lay.x1s);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH;
  const T* xb = x + (size_t)blockIdx.z * H * W * C;
  auto inside = [H, W](int r, int c) { return r >= 0 && r < H && c >= 0 && c < W; };

  // ---- 1. y on the ring: (TH + 2) x RW pixels from image (r0 - 1, c0 - 1) ----
  if (mode == MLP) {
    for (int i = tid; i < MRP * C; i += THREADS) {
      const int q = i / C, c = i % C;
      const int r = r0 - 1 + q / RW, cc = c0 - 1 + q % RW;
      ys[q * ldy + c] = (q < MRING && inside(r, cc)) ? xb[((size_t)r * W + cc) * C + c]
                                                      : from_f<T>(0.f);
    }
  } else {
    const int kh = k / 2;
    const int R2W = RW + 2 * kh, R2H = TH + 2 + 2 * kh;  // x1: the ring + the window halo
    const int R3W = R2W + 2, R3H = R2H + 2;              // x: that + the LPU halo
    for (int cb = 0; cb < C; cb += CC) {
      if (mode == X_LPU) {
        for (int i = tid; i < R3H * R3W * CC; i += THREADS) {
          const int c = i % CC, p = i / CC;
          const int r = r0 - 2 - kh + p / R3W, cc = c0 - 2 - kh + p % R3W;
          xs[i] = inside(r, cc) ? to_f(xb[((size_t)r * W + cc) * C + cb + c]) : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < R2H * R2W * CC; i += THREADS) {
          const int c = i % CC, p = i / CC, u = p / R2W, v = p % R2W;
          float val = 0.f;
          if (inside(r0 - 1 - kh + u, c0 - 1 - kh + v)) {
            float acc = 0.f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
              for (int b = 0; b < 3; ++b)
                acc = fmaf(xs[((u + a) * R3W + v + b) * CC + c], to_f(w3[(a * 3 + b) * C + cb + c]),
                           acc);
            const float dw = rnd<T>(acc + to_f(b3[cb + c]));
            val = rnd<T>(xs[((u + 1) * R3W + v + 1) * CC + c] + dw);
          }
          x1s[i] = val;  // zero outside the image: the window conv pads x1 with zeros
        }
      } else {
        for (int i = tid; i < R2H * R2W * CC; i += THREADS) {
          const int c = i % CC, p = i / CC;
          const int r = r0 - 1 - kh + p / R2W, cc = c0 - 1 - kh + p % R2W;
          x1s[i] = inside(r, cc) ? to_f(xb[((size_t)r * W + cc) * C + cb + c]) : 0.f;
        }
      }
      __syncthreads();
      for (int i = tid; i < MRP * CC; i += THREADS) {
        const int c = i % CC, q = i / CC;
        float val = 0.f;
        if (q < MRING) {
          const int ri = q / RW, ci = q % RW;
          float acc = 0.f;
          for (int a = 0; a < k; ++a)
            for (int b = 0; b < k; ++b)
              acc = fmaf(x1s[((ri + a) * R2W + ci + b) * CC + c], to_f(w7[(a * k + b) * C + cb + c]),
                         acc);
          val = acc + to_f(b7[cb + c]);
        }
        ys[q * ldy + cb + c] = from_f<T>(val);
      }
      __syncthreads();  // the next chunk overwrites xs and x1s
    }
  }
  __syncthreads();

  // ---- 2. LayerNorm over C of each ring pixel, in place; a warp a pixel ----
  for (int q = warp; q < MRING; q += WARPS) {
    T* row = ys + q * ldy;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(row[c]);
    const float mean = warp_sum(s) / (float)C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(row[c]) - mean;
      v = fmaf(d, d, v);
    }
    const float rstd = rsqrtf(warp_sum(v) / (float)C + eps);
    for (int c = lane; c < C; c += 32)
      row[c] = from_f<T>((to_f(row[c]) - mean) * rstd * to_f(g[c]) + to_f(be[c]));
  }
  __syncthreads();

  // ---- 3. the hidden width in chunks of NE ----
  float acc2[MT_OUT][NT2][4];
#pragma unroll
  for (int m = 0; m < MT_OUT; ++m)
#pragma unroll
    for (int t = 0; t < NT2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[m][t][j] = 0.f;
  const int ntiles2 = C / 8;

  for (int e0 = 0; e0 < E; e0 += NE) {
    // fc1 on the ring: this warp's 8 hidden columns, every ring m-tile
    {
      float acc1[MT_RING][4];
#pragma unroll
      for (int m = 0; m < MT_RING; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc1[m][j] = 0.f;
      const T* wrow = wf1 + (size_t)(e0 + warp * 8) * C;
      for (int kk = 0; kk < C; kk += M::KS) {
        typename M::B bfr;
        M::load_b(bfr, wrow + kk, C, lane);
#pragma unroll
        for (int m = 0; m < MT_RING; ++m) {
          typename M::A afr;
          M::load_a(afr, ys + m * 16 * ldy + kk, ldy, lane);
          M::mma(acc1[m], afr, bfr);
        }
      }
      const int col = warp * 8 + (lane & 3) * 2;
      const float bias0 = to_f(bf1[e0 + col]), bias1 = to_f(bf1[e0 + col + 1]);
#pragma unroll
      for (int m = 0; m < MT_RING; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = m * 16 + (lane >> 2) + half * 8;
          // h is zero outside the image: the hidden depthwise pads with zeros
          const bool ok = q < MRING && inside(r0 - 1 + q / RW, c0 - 1 + q % RW);
          hs[q * ldh + col] = from_f<T>(ok ? rnd<T>(acc1[m][2 * half]) + bias0 : 0.f);
          hs[q * ldh + col + 1] = from_f<T>(ok ? rnd<T>(acc1[m][2 * half + 1]) + bias1 : 0.f);
        }
    }
    __syncthreads();

    // hidden 3x3 depthwise + residual + GELU on the tile
    for (int i = tid; i < MOUT * NE; i += THREADS) {
      const int e = i % NE, p = i / NE, pi = p / TW, pj = p % TW;
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          acc = fmaf(to_f(hs[((pi + a) * RW + pj + b) * ldh + e]),
                     to_f(wd[(a * 3 + b) * E + e0 + e]), acc);
      const float dw = rnd<T>(acc + to_f(bd[e0 + e]));
      const float hr = rnd<T>(to_f(hs[((pi + 1) * RW + pj + 1) * ldh + e]) + dw);
      gs[p * ldh + e] = from_f<T>(gelu(hr));
    }
    __syncthreads();

    // fc2: this warp's output n-tiles (warp, warp + 8, ...) of every tile row
    for (int kk = 0; kk < NE; kk += M::KS) {
      if constexpr (sizeof(T) == 2) {
        typename M::A afr[MT_OUT];
#pragma unroll
        for (int m = 0; m < MT_OUT; ++m) M::load_a(afr[m], gs + m * 16 * ldh + kk, ldh, lane);
#pragma unroll
        for (int t = 0; t < NT2; ++t) {
          const int nt = warp + t * WARPS;
          if (nt < ntiles2) {
            typename M::B bfr;
            M::load_b(bfr, wf2 + (size_t)nt * 8 * E + e0 + kk, E, lane);
#pragma unroll
            for (int m = 0; m < MT_OUT; ++m) M::mma(acc2[m][t], afr[m], bfr);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < NT2; ++t) {
          const int nt = warp + t * WARPS;
          if (nt < ntiles2) {
            typename M::B bfr;
            M::load_b(bfr, wf2 + (size_t)nt * 8 * E + e0 + kk, E, lane);
#pragma unroll
            for (int m = 0; m < MT_OUT; ++m) {
              typename M::A afr;
              M::load_a(afr, gs + m * 16 * ldh + kk, ldh, lane);
              M::mma(acc2[m][t], afr, bfr);
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk rewrites hs and gs
  }

  // ---- 4. out = acc + b2, the tile's pixels inside the image ----
  T* ob = out + (size_t)blockIdx.z * H * W * C;
#pragma unroll
  for (int t = 0; t < NT2; ++t) {
    const int nt = warp + t * WARPS;
    if (nt >= ntiles2) continue;
    const int col = nt * 8 + (lane & 3) * 2;
    const float bias0 = to_f(bf2[col]), bias1 = to_f(bf2[col + 1]);
#pragma unroll
    for (int m = 0; m < MT_OUT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m * 16 + (lane >> 2) + half * 8;
        const int r = r0 + p / TW, cc = c0 + p % TW;
        if (r < H && cc < W) {
          T* o = ob + ((size_t)r * W + cc) * C + col;
          o[0] = from_f<T>(acc2[m][t][2 * half] + bias0);
          o[1] = from_f<T>(acc2[m][t][2 * half + 1] + bias1);
        }
      }
  }
}

int max_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// The largest tile whose out accumulator (TH/2 m-tiles x 32/TH n-tiles a
// warp) covers C and whose block fits shared memory; 0 if none does.
int choose_tile(int tsize, int C, int mode, int k, int max_smem) {
  const int ths[] = {16, 8, 4, 2};
  for (int th : ths)
    if (C <= 64 * (32 / th) && Layout(tsize, C, k, mode, th).total <= (size_t)max_smem) return th;
  return 0;
}

template <typename T, int TH>
cudaError_t launch_tile(const void* const* p, void* out, int B, int H, int W, int C, int E, int k,
                        int mode, float eps, cudaStream_t stream) {
  const Layout lay(sizeof(T), C, k, mode, TH);
  cudaError_t err = cudaFuncSetAttribute(x_block_fwd_kernel<T, TH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const T* const* a = reinterpret_cast<const T* const*>(p);
  x_block_fwd_kernel<T, TH><<<grid, THREADS, lay.total, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10], a[11], a[12],
      static_cast<T*>(out), H, W, C, E, k, mode, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* const* p, void* out, int B, int H, int W, int C, int E, int k,
                   int mode, float eps, cudaStream_t stream) {
  switch (choose_tile(sizeof(T), C, mode, k, max_smem_optin())) {
    case 16: return launch_tile<T, 16>(p, out, B, H, W, C, E, k, mode, eps, stream);
    case 8: return launch_tile<T, 8>(p, out, B, H, W, C, E, k, mode, eps, stream);
    case 4: return launch_tile<T, 4>(p, out, B, H, W, C, E, k, mode, eps, stream);
    case 2: return launch_tile<T, 2>(p, out, B, H, W, C, E, k, mode, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// mode: 0 = X block with the LPU, 1 = X block without it, 2 = MLP only (k = 1;
// w3, b3, w7, b7 unused). dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 = launched).
int dat_x_block_fwd(const void* x, const void* w3, const void* b3, const void* w7, const void* b7,
                    const void* g, const void* be, const void* wf1, const void* bf1,
                    const void* wd, const void* bd, const void* wf2, const void* bf2, void* out,
                    int B, int H, int W, int C, int E, int k, int mode, float eps, int dtype,
                    void* stream) {
  if (C % CC || C > 1024 || E % NE || mode < 0 || mode > 2 || (mode != MLP && k % 2 == 0))
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

const char* dat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
