// Fused deformable-attention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel fused_deform_attention_v2
// (dat_segmentation_tpu/ops/pallas/deform_attn.py:711, bodies _kernel_v3,
// _kernel_v4 and _kernel_v2) and, through the same function, the round-1
// fused_deform_attention_fwd (:811). It computes _xla_reference (:1549)
// directly: for each batch*group bg, head h and query m = (y, x)
//
//   s[n]   = q[m]·k[n] * scale + bias(m, n)           n < Ns samples
//   bias   = the (th, tw) RPE table of head h of group bg % g, sampled
//            bilinearly at fy = (0.5 * (yq - pos_y[n]) + 1) * 0.5 * (th-1),
//            fx likewise; taps outside the table weigh 0
//   out[m] = softmax(s) · v                           (fp32 softmax)
//
// with yq = y / max(hn - 1, 1) * 2 - 1 (hn = the true height when q is
// padded), xq likewise. The TPU built the bias as two tap-weight matmuls
// because its gathers scalarise; the card reads the taps from shared
// memory, so the tap matrices and the sample-group packing are gone.
//
// What bounds it: by the shapes alone (q, out, k, v, pos, table each moved
// once; 4·HW·Ns·Cg flops) it does about 250 flops a byte in bf16, just
// under the card's 295, so moving q and out bounds it: about 0.11 ms a
// forward of a batch of 16. But every score also needs its bias, a
// bilinear lookup on the CUDA cores (about 30 instructions a score), and
// an exponential (16 a clock an SM), so instruction issue and latency
// bound it in practice: 604 M scores a forward are about 0.65 ms of pure
// issue at the card's rate. The attribution build without the bias takes
// about half of K1's time (PERF.md): the lookup is one half, the products,
// the softmax and the loads the other.
//
// Design of the bf16 instance (FlashAttention-2's forward):
//   - a block of 8 warps owns one head of one batch*group and walks a run
//     of 128-query tiles, 16 queries a warp; the head's K and V stream
//     through shared memory in chunks of NCH = 64 samples, double
//     buffered with cp.async, so any Ns is a number of chunks and the
//     next chunk loads while this one computes; the head's table is built
//     once a block, while the first chunk loads, and the grid has one
//     block a resident slot, so that each block builds it once for as
//     many tiles as it can;
//   - Q·Kᵀ and P·V run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     float32 sums): q's fragments stay in registers, K comes by ldmatrix
//     and V by ldmatrix.trans, and P, rounded to bf16 as the reference
//     rounds it, is the A operand of P·V straight from the accumulators;
//     the online softmax runs on the accumulators (the running max
//     rescales the sums and the output);
//   - the bias is formed in the accumulator layout, with few instructions
//     a score: the table sits in shared memory with a zero border, as
//     32-bit words holding the bf16 pair (t[y][x], t[y][x+1]), so two
//     loads give a score's four taps; coordinates are clamped into the
//     border (exact: a tap wholly outside weighs 0 either way), so no tap
//     needs a bounds test; floor and the word index come from adding
//     2^23 rounded down (no float-int conversions);
//   - at most 128 registers a thread, so two blocks (16 warps) are
//     resident on an SM.
// An attribution build, -DK1_NO_BIAS, leaves the bias out (timed only,
// launched nowhere else): it says how much of K1 the lookup takes.
//
// The float32 instance serves the float32 checks: the products on the CUDA
// cores in full float32 (no TF32), a block of 4 warps owning one head and
// 64 queries, 4 queries a warp, K, V and the scores in shared memory.
//
// Layout: q (BG, H, W, Cg), k and v (BG, Ns, Cg), pos (BG, Ns, 2) fp32 as
// (y, x), table (g, h_g, th, tw), out like q; all contiguous; q, k, v,
// table and out in one dtype, fp32 or bf16; Cg = h_g * 32. Any H and W;
// no padding of the queries is needed (hn/wn only set the coordinate
// normalisation). Any Ns: both instances take the samples in chunks with
// an online softmax (float32 only where K, V and the scores of all Ns do
// not fit in shared memory beside the table).
//
// For training, a launch with an ``lse`` pointer also writes each query's
// log-sum-exp of the scores, max + log(sum of exponentials), float32 in
// (BG, h_g, H*W): the backward (K2) takes P = exp(s - lse) from it a
// chunk of samples at a time. The output's arithmetic is the same with or
// without it (serving passes none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "fragments.cuh"

namespace {

constexpr int HC = 32;  // head width
constexpr unsigned FULL = 0xffffffffu;

int max_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// ============================ float32 instance ============================

constexpr int FWARPS = 4;  // warps per block
constexpr int QW = 4;      // queries a warp carries at once
constexpr int QB = 64;     // queries per block
static_assert(QW == 4, "a warp's scores are stored as one float4 per sample");

// Byte offsets of the shared-memory arrays of one block.
struct SmemF {
  static constexpr int KS = HC + 4;  // padded K row: no bank conflicts
  size_t ks, vs, tbl, by, bx, sbuf, total;
  __host__ __device__ SmemF(int Ns, int th, int tw) {
    ks = 0;
    vs = align16(ks + (size_t)Ns * KS * sizeof(float));
    tbl = align16(vs + (size_t)Ns * HC * sizeof(float));
    by = align16(tbl + (size_t)th * tw * sizeof(float));
    bx = align16(by + (size_t)Ns * sizeof(float));
    sbuf = align16(bx + (size_t)Ns * sizeof(float));
    total = sbuf + (size_t)FWARPS * Ns * QW * sizeof(float);
  }
};

// 32 consecutive values (16-byte aligned) into registers.
__device__ __forceinline__ void load_row(const float* p, float (&r)[HC]) {
#pragma unroll
  for (int i = 0; i < HC / 4; ++i) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    r[4 * i] = t.x;
    r[4 * i + 1] = t.y;
    r[4 * i + 2] = t.z;
    r[4 * i + 3] = t.w;
  }
}

// Bilinear sample of a (th, tw) table at unnormalised (fy, fx), zeros padding.
__device__ __forceinline__ float table_tap(const float* tbl, int th, int tw, float fy, float fx) {
  const float y0f = floorf(fy), x0f = floorf(fx);
  const float ty = fy - y0f, tx = fx - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int yy = y0 + dy;
    if (yy < 0 || yy >= th) continue;
    const float wy = dy ? ty : 1.f - ty;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int xx = x0 + dx;
      if (xx < 0 || xx >= tw) continue;
      const float wx = dx ? tx : 1.f - tx;
      acc = fmaf(wy * wx, tbl[yy * tw + xx], acc);
    }
  }
  return acc;
}

// grid: (ceil(H*W / QB), h_g, BG); block: FWARPS * 32 threads.
__global__ void __launch_bounds__(FWARPS * 32)
deform_attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ pos,
                           const float* __restrict__ table, float* __restrict__ out,
                           float* __restrict__ lse, int H, int W, int Ns, int Cg, int g,
                           int h_g, int th, int tw, int nsc, float qy_step, float qx_step,
                           float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemF lay(nsc, th, tw);  // nsc: samples a chunk (Ns when they all fit)
  constexpr int KS = SmemF::KS;
  float* ks = reinterpret_cast<float*>(smem + lay.ks);
  float* vs = reinterpret_cast<float*>(smem + lay.vs);
  float* tbl = reinterpret_cast<float*>(smem + lay.tbl);
  float* by = reinterpret_cast<float*>(smem + lay.by);
  float* bx = reinterpret_cast<float*>(smem + lay.bx);
  float* sbuf = reinterpret_cast<float*>(smem + lay.sbuf);

  const int bg = blockIdx.z, h = blockIdx.y;
  const int HW = H * W;
  const int m_begin = blockIdx.x * QB;
  const int m_end = min(m_begin + QB, HW);

  // ---- this head's table, and its K, V and tap offsets a chunk at a time ----
  const float* kg = k + (size_t)bg * Ns * Cg + h * HC;
  const float* vg = v + (size_t)bg * Ns * Cg + h * HC;
  const float* tg = table + ((size_t)(bg % g) * h_g + h) * th * tw;
  for (int i = threadIdx.x; i < th * tw; i += blockDim.x) tbl[i] = tg[i];
  // fy = yq * ay + by[n]: the part of the tap coordinate that depends on n
  const float ay = 0.25f * (th - 1), ax = 0.25f * (tw - 1);
  auto load_chunk = [&](int n0, int nc) {
    for (int i = threadIdx.x; i < nc * HC; i += blockDim.x) {
      const int n = i / HC, c = i % HC;
      ks[n * KS + c] = kg[(size_t)(n0 + n) * Cg + c];
      vs[n * HC + c] = vg[(size_t)(n0 + n) * Cg + c];
    }
    for (int n = threadIdx.x; n < nc; n += blockDim.x) {
      const float2 p = reinterpret_cast<const float2*>(pos)[(size_t)bg * Ns + n0 + n];
      by[n] = 0.5f * (th - 1) - p.x * ay;
      bx[n] = 0.5f * (tw - 1) - p.y * ax;
    }
  };
  const bool one_chunk = Ns <= nsc;
  if (one_chunk) load_chunk(0, Ns);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = sbuf + (size_t)warp * nsc * QW;  // this warp's scores, [n][qi]

  // Every warp takes the same number of query groups, so that with several
  // chunks all reach each chunk's barriers; with one chunk a warp stops at
  // m_end.
  for (int it = 0; it < QB / (FWARPS * QW); ++it) {
    const int m0 = m_begin + (it * FWARPS + warp) * QW;
    if (one_chunk && m0 >= m_end) break;
    // ---- queries m0 .. m0+QW-1 (past m_end: computed, not stored) ----
    float qr[QW][HC];
    float yq[QW], xq[QW];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int m = min(m0 + qi, m_end - 1);
      load_row(q + ((size_t)bg * HW + m) * Cg + h * HC, qr[qi]);
#pragma unroll
      for (int c = 0; c < HC; ++c) qr[qi][c] *= scale;
      yq[qi] = (m / W) * qy_step - 1.f;
      xq[qi] = (m % W) * qx_step - 1.f;
    }

    float run[QW], sum[QW], acc[QW];  // running max, sum of exponentials, P·V
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      run[qi] = -CUDART_INF_F;
      sum[qi] = 0.f;
      acc[qi] = 0.f;
    }
    for (int n0 = 0; n0 < Ns; n0 += nsc) {
      const int nc = min(nsc, Ns - n0);
      if (!one_chunk) {
        __syncthreads();  // every warp is done with the previous chunk
        load_chunk(n0, nc);
        __syncthreads();
      }

      // pass 1: scores of the lane's samples n = lane, lane + 32, ...
      float mx[QW];
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) mx[qi] = run[qi];
      for (int n = lane; n < nc; n += 32) {
        float kr[HC];
        load_row(ks + n * KS, kr);
        const float byn = by[n], bxn = bx[n];
        float s[QW];
#pragma unroll
        for (int qi = 0; qi < QW; ++qi) {
          float a = 0.f;
#pragma unroll
          for (int c = 0; c < HC; ++c) a = fmaf(qr[qi][c], kr[c], a);
          a += table_tap(tbl, th, tw, fmaf(yq[qi], ay, byn), fmaf(xq[qi], ax, bxn));
          s[qi] = a;
          mx[qi] = fmaxf(mx[qi], a);
        }
        *reinterpret_cast<float4*>(sw + n * QW) = make_float4(s[0], s[1], s[2], s[3]);
      }
      float rescale[QW];  // exp(old max - new max): 0 before the first chunk
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx[qi] = fmaxf(mx[qi], __shfl_xor_sync(FULL, mx[qi], o));
        rescale[qi] = __expf(run[qi] - mx[qi]);
        run[qi] = mx[qi];
      }

      // pass 2: exponentials (each lane rewrites only its own samples)
      float part[QW] = {0.f, 0.f, 0.f, 0.f};
      for (int n = lane; n < nc; n += 32) {
        float4 e = *reinterpret_cast<float4*>(sw + n * QW);
        e.x = __expf(e.x - mx[0]);
        e.y = __expf(e.y - mx[1]);
        e.z = __expf(e.z - mx[2]);
        e.w = __expf(e.w - mx[3]);
        part[0] += e.x;
        part[1] += e.y;
        part[2] += e.z;
        part[3] += e.w;
        *reinterpret_cast<float4*>(sw + n * QW) = e;
      }
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part[qi] += __shfl_xor_sync(FULL, part[qi], o);
        sum[qi] = sum[qi] * rescale[qi] + part[qi];
        acc[qi] *= rescale[qi];
      }
      __syncwarp();  // pass 3 reads every lane's exponentials

      // pass 3: out += P·V, lane `lane` owns channel `lane`
      for (int n = 0; n < nc; ++n) {
        const float4 p = *reinterpret_cast<const float4*>(sw + n * QW);
        const float vv = vs[n * HC + lane];
        acc[0] = fmaf(p.x, vv, acc[0]);
        acc[1] = fmaf(p.y, vv, acc[1]);
        acc[2] = fmaf(p.z, vv, acc[2]);
        acc[3] = fmaf(p.w, vv, acc[3]);
      }
      __syncwarp();  // the next chunk or queries overwrite this warp's scores
    }
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      if (m0 + qi < m_end) {
        out[((size_t)bg * HW + m0 + qi) * Cg + h * HC + lane] = acc[qi] / sum[qi];
        if (lse != nullptr && lane == 0)
          lse[((size_t)bg * h_g + h) * HW + m0 + qi] = run[qi] + logf(sum[qi]);
      }
    }
  }
}

// Samples a chunk: all Ns if they fit in shared memory beside the table,
// else the most (a multiple of 32) that do; 0 if not even 32 fit.
int chunk_samples_f32(int Ns, int th, int tw, int max_smem) {
  if (SmemF(Ns, th, tw).total <= (size_t)max_smem) return Ns;
  int nsc = (Ns - 1) / 32 * 32;
  while (nsc >= 32 && SmemF(nsc, th, tw).total > (size_t)max_smem) nsc -= 32;
  return nsc >= 32 ? nsc : 0;
}

cudaError_t prepare_f32(int Ns, int th, int tw, int* nsc, size_t* smem) {
  *nsc = chunk_samples_f32(Ns, th, tw, max_smem_optin());
  if (*nsc == 0) return cudaErrorInvalidValue;
  *smem = SmemF(*nsc, th, tw).total;
  return cudaFuncSetAttribute(deform_attn_fwd_f32_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* pos,
                       const float* table, float* out, float* lse, int BG, int H, int W, int Ns,
                       int Cg, int g, int h_g, int th, int tw, int hn, int wn, float scale,
                       cudaStream_t stream) {
  int nsc = 0;
  size_t smem = 0;
  cudaError_t err = prepare_f32(Ns, th, tw, &nsc, &smem);
  if (err != cudaSuccess) return err;
  const float qy_step = 2.f / (float)(hn > 1 ? hn - 1 : 1);
  const float qx_step = 2.f / (float)(wn > 1 ? wn - 1 : 1);
  const dim3 grid((H * W + QB - 1) / QB, h_g, BG);
  deform_attn_fwd_f32_kernel<<<grid, FWARPS * 32, smem, stream>>>(
      q, k, v, pos, table, out, lse, H, W, Ns, Cg, g, h_g, th, tw, nsc, qy_step, qx_step, scale);
  return cudaGetLastError();
}

// ============================= bf16 instance ==============================

constexpr int BWARPS = 8;               // warps per block
constexpr int BTHREADS = BWARPS * 32;
constexpr int QTILE = 16 * BWARPS;      // queries a block tile: 16 a warp
constexpr int NCH = 64;                 // samples a chunk
constexpr int NT = NCH / 8;             // n8 score tiles a chunk
constexpr int RSB = HC + 8;             // K, V row stride (elements): ldmatrix conflict-free
constexpr int WAVES = 1;                // the grid aims at this many blocks a resident slot
constexpr float LOG2E = 1.4426950408889634f;
constexpr float TWO23 = 8388608.f;      // 2^23: adding it rounds to an integer
constexpr uint32_t TWO23_BITS = 0x4B000000u;
static_assert(NCH * (HC * 2 / 16) == BTHREADS, "one 16-byte K and V copy a thread a chunk");

// Byte offsets of the shared-memory arrays of one block. The table is
// (th + 3) x (tw + 2) 32-bit words: word (r, c) holds the bf16 pair
// (t[r-1][c-1], t[r-1][c]), zero outside the table, so rows -1 .. th + 1
// and pair columns -1 .. tw of the table are there.
struct SmemB {
  int pw, ph;
  size_t tbl, kv, byx, total;
  __host__ __device__ SmemB(int th, int tw) {
    pw = tw + 2;
    ph = th + 3;
    tbl = 0;
    kv = align16(tbl + (size_t)ph * pw * sizeof(uint32_t));  // [buffer][K, V][NCH][RSB]
    byx = kv + (size_t)2 * 2 * NCH * RSB * sizeof(__nv_bfloat16);
    total = byx + (size_t)2 * NCH * sizeof(float2);            // [buffer][NCH]
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A table coordinate v = f + 1 clamped into [0, vmax] (exact: a tap wholly
// outside the table reads the zero border), as the bits of its floor +
// 2^23 (v + 2^23 rounded down) and its fraction.
__device__ __forceinline__ void tap_split(float v, float vmax, uint32_t& bits, float& frac) {
  v = fmaxf(fminf(v, vmax), 0.f);
  const float r = __fadd_rd(v, TWO23);
  bits = __float_as_uint(r);
  frac = v - (r - TWO23);
}

// The bias at table coordinates (fy + 1, fx + 1) = (vy, vx): two words,
// each a row's pair of taps. `tbl` is the shared address of word (0, 0)
// shifted back by 2^23 (pw + 1) words, so that tap_split's bits index it.
[[maybe_unused]] __device__ __forceinline__ float bias_at(float vy, float vx, float vy_max,
                                                          float vx_max, uint32_t tbl, int pw) {
  uint32_t by, bx;
  float ty, tx;
  tap_split(vy, vy_max, by, ty);
  tap_split(vx, vx_max, bx, tx);
  const uint32_t a = tbl + 4u * (by * (uint32_t)pw + bx);
  const uint32_t w0 = lds32(a), w1 = lds32(a + 4u * pw);
  const float l0 = __uint_as_float(w0 << 16), h0 = __uint_as_float(w0 & 0xffff0000u);
  const float l1 = __uint_as_float(w1 << 16), h1 = __uint_as_float(w1 & 0xffff0000u);
  const float r0 = fmaf(tx, h0 - l0, l0), r1 = fmaf(tx, h1 - l1, l1);
  return fmaf(ty, r1 - r0, r0);
}

// grid: (query runs, h_g, BG); block: BTHREADS. A block walks query tiles
// [tile0, tile0 + tiles_per_block) of head h of batch*group bg; each tile
// takes the head's samples in chunks of NCH, the chunks double buffered.
__global__ void __launch_bounds__(BTHREADS, 2)
deform_attn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const float* __restrict__ pos,
                            const __nv_bfloat16* __restrict__ table,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H,
                            int W, int Ns, int Cg, int g, int h_g, int th, int tw,
                            int tiles_per_block, float y_denom, float x_denom, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemB lay(th, tw);
  const int pw = lay.pw;
  uint32_t* tp = reinterpret_cast<uint32_t*>(smem + lay.tbl);
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem + lay.kv);
  float2* byx = reinterpret_cast<float2*>(smem + lay.byx);

  const int bg = blockIdx.z, h = blockIdx.y;
  const int HW = H * W;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tiles = min(tiles_per_block, (HW + QTILE - 1) / QTILE - tile0);
  const int nch = (Ns + NCH - 1) / NCH;
  const int items = tiles * nch;  // (tile, chunk) pairs, chunk fastest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column pair

  // ---- a chunk of K, V (cp.async, zero past Ns) and its tap offsets ----
  const __nv_bfloat16* kg = k + (size_t)bg * Ns * Cg + h * HC;
  const __nv_bfloat16* vg = v + (size_t)bg * Ns * Cg + h * HC;
  const float2* pg = reinterpret_cast<const float2*>(pos) + (size_t)bg * Ns;
  // fy + 1 = yq * ay + (by[n] = 0.5 (th - 1) + 1 - pos_y[n] * ay)
  const float ay = 0.25f * (th - 1), ax = 0.25f * (tw - 1);
  const float cy = 0.5f * (th - 1) + 1.f, cx = 0.5f * (tw - 1) + 1.f;
  auto issue_kv = [&](int c, int buf) {
    const int r = threadIdx.x / 4, part = threadIdx.x % 4, n = c * NCH + r;
    const size_t off = (size_t)(n < Ns ? n : 0) * Cg + part * 8;
    __nv_bfloat16* dst = kv + (size_t)buf * 2 * NCH * RSB + r * RSB + part * 8;
    cp_async16(dst, kg + off, n < Ns);
    cp_async16(dst + NCH * RSB, vg + off, n < Ns);
    cp_async_commit();
  };
  auto pos_of = [&](int c) {
    const int n = c * NCH + threadIdx.x;
    return threadIdx.x < NCH && n < Ns ? pg[n] : make_float2(0.f, 0.f);
  };
  auto put_byx = [&](float2 p, int buf) {
    if (threadIdx.x < NCH)
      byx[buf * NCH + threadIdx.x] = make_float2(cy - p.x * ay, cx - p.y * ax);
  };
  issue_kv(0, 0);
  put_byx(pos_of(0), 0);

  // ---- the table as bf16 pair words with a zero border (a warp a row),
  //      built while the first chunk loads ----
  {
    const uint16_t* tg = reinterpret_cast<const uint16_t*>(table) +
                         ((size_t)(bg % g) * h_g + h) * th * tw;
#pragma unroll 1
    for (int r = warp; r < lay.ph; r += BWARPS) {
      const int y = r - 1;
      const uint16_t* row = tg + y * tw;
      for (int c = lane; c < pw; c += 32) {
        uint32_t lo = 0, hi = 0;
        if (y >= 0 && y < th) {
          if (c >= 1 && c <= tw) lo = __ldg(row + c - 1);
          if (c < tw) hi = __ldg(row + c);
        }
        tp[r * pw + c] = lo | (hi << 16);
      }
    }
  }
  [[maybe_unused]] const uint32_t tbl = smem_addr(tp) - 4u * TWO23_BITS * (uint32_t)(pw + 1);
  [[maybe_unused]] const float vy_max = (float)(th + 1), vx_max = (float)(tw + 1);

  // per tile: q fragments, the thread's two queries (rows gq, gq + 8)
  uint32_t aq[2][4];
  int m_row[2];
  [[maybe_unused]] float yq[2], xq[2];
  float run[2], lsum[2], o[4][4];  // running max, thread's sum of exponentials, P·V

  for (int it = 0; it < items; ++it) {
    const int c = it % nch, tile = tile0 + it / nch;
    const int buf = nch > 1 ? it & 1 : 0;
    cp_async_wait_all();
    __syncthreads();  // chunk `it` is in shared memory; every warp is done with it - 1
    const bool next = nch > 1 && it + 1 < items;
    float2 p_next = make_float2(0.f, 0.f);
    if (next) {
      const int cn = (it + 1) % nch;
      issue_kv(cn, buf ^ 1);
      p_next = pos_of(cn);
    }

    if (c == 0) {  // ---- a new tile: this warp's 16 queries ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = tile * QTILE + warp * 16 + gq + 8 * r;
        m_row[r] = m;
        const int mc = min(m, HW - 1);  // past HW: computed, not stored
        yq[r] = query_coord(mc / W, y_denom);
        xq[r] = query_coord(mc % W, x_denom);
        run[r] = -CUDART_INF_F;
        lsum[r] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mc = min(m_row[i & 1], HW - 1);
          aq[kk][i] = *reinterpret_cast<const uint32_t*>(
              q + ((size_t)bg * HW + mc) * Cg + h * HC + 16 * kk + 2 * tq + 8 * (i >> 1));
        }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
    }

    const __nv_bfloat16* ks = kv + (size_t)buf * 2 * NCH * RSB;
    const __nv_bfloat16* vs = ks + NCH * RSB;
    [[maybe_unused]] const float2* bb = byx + buf * NCH;
    const int nc = min(NCH, Ns - c * NCH);  // live samples of the chunk

    // ---- S = Q·Kᵀ: [n8 tile j][r]: query row gq + 8 (r >> 1), sample 8j + 2tq + (r & 1) ----
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b[4];
      ldsm_x4(b, ks + (8 * j + (lane & 7)) * RSB + 8 * (lane >> 3));
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma(s[j], aq[0], b[0], b[1]);
      mma(s[j], aq[1], b[2], b[3]);
    }

    // ---- scale and bias; samples past Ns masked; the row maxima ----
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#ifndef K1_NO_BIAS
        const float2 t = bb[8 * j + 2 * tq + e];
#endif
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#ifdef K1_NO_BIAS
          const float bias = 0.f;
#else
          const float bias = bias_at(fmaf(yq[r], ay, t.x), fmaf(xq[r], ax, t.y), vy_max, vx_max,
                                     tbl, pw);
#endif
          s[j][2 * r + e] = fmaf(s[j][2 * r + e], scale, bias);
        }
      }
    if (nc < NCH)  // the last chunk of a ragged Ns
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (8 * j + 2 * tq + (i & 1) >= nc) s[j][i] = -CUDART_INF_F;
    float mx[2] = {run[0], run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);

    // ---- online softmax on the accumulators ----
    float ml[2];  // the new max, times log2(e)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      ml[r] = mx[r] * LOG2E;
      const float rescale = ex2(fmaf(run[r], LOG2E, -ml[r]));  // 0 before the first chunk
      run[r] = mx[r];
      lsum[r] *= rescale;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[n][2 * r] *= rescale;
        o[n][2 * r + 1] *= rescale;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(fmaf(s[j][i], LOG2E, -ml[i >> 1]));
        lsum[i >> 1] += p;
        s[j][i] = p;
      }

    // ---- O += P·V: P (bf16) from the accumulators, V by ldmatrix.trans ----
#pragma unroll
    for (int kk = 0; kk < NCH / 16; ++kk) {
      const uint32_t aP[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * RSB +
                         8 * (2 * cp + (lane >> 4)));
        mma(o[2 * cp], aP, b[0], b[1]);
        mma(o[2 * cp + 1], aP, b[2], b[3]);
      }
    }

    if (next) put_byx(p_next, buf ^ 1);  // read after the next barrier

    if (c == nch - 1) {  // ---- the tile's output and log-sum-exp ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = lsum[r];
        l += __shfl_xor_sync(FULL, l, 1);
        l += __shfl_xor_sync(FULL, l, 2);
        if (m_row[r] >= HW) continue;
        const size_t row = ((size_t)bg * HW + m_row[r]) * Cg + h * HC + 2 * tq;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<uint32_t*>(out + row + 8 * n) =
              pack_bf16(o[n][2 * r] / l, o[n][2 * r + 1] / l);
        if (lse != nullptr && tq == 0)
          lse[((size_t)bg * h_g + h) * HW + m_row[r]] = run[r] + logf(l);
      }
    }
  }
}

cudaError_t prepare_bf16(int th, int tw, size_t* smem) {
  *smem = SmemB(th, tw).total;
  if (*smem > (size_t)max_smem_optin()) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(deform_attn_fwd_bf16_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        const float* pos, const __nv_bfloat16* table, __nv_bfloat16* out,
                        float* lse, int BG, int H, int W, int Ns, int Cg, int g, int h_g, int th,
                        int tw, int hn, int wn, float scale, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare_bf16(th, tw, &smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, deform_attn_fwd_bf16_kernel,
                                                           BTHREADS, smem)) != cudaSuccess)
    return err;
  // split each (batch*group, head)'s query tiles into runs, so that about
  // WAVES blocks a resident slot cover the card
  const int tiles = (H * W + QTILE - 1) / QTILE, groups = BG * h_g;
  const int want = WAVES * sms * (per_sm > 0 ? per_sm : 1);
  int runs = want / groups;
  runs = runs < 1 ? 1 : (runs > tiles ? tiles : runs);
  const int per_run = (tiles + runs - 1) / runs;
  runs = (tiles + per_run - 1) / per_run;
  const float y_denom = (float)(hn > 1 ? hn - 1 : 1);
  const float x_denom = (float)(wn > 1 ? wn - 1 : 1);
  deform_attn_fwd_bf16_kernel<<<dim3(runs, h_g, BG), BTHREADS, smem, stream>>>(
      q, k, v, pos, table, out, lse, H, W, Ns, Cg, g, h_g, th, tw, per_run, y_denom, x_denom,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; lse may be null (no log-sum-exp
// written). Returns a cudaError_t (0 = launched).
int dat_deform_attn_fwd(const void* q, const void* k, const void* v, const float* pos,
                        const void* table, void* out, float* lse, int BG, int H, int W, int Ns,
                        int Cg, int g, int h_g, int th, int tw, int hn, int wn, float scale,
                        int dtype, void* stream) {
  if (Cg != h_g * HC) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), pos, static_cast<const float*>(table),
                           static_cast<float*>(out), lse, BG, H, W, Ns, Cg, g, h_g, th, tw, hn,
                           wn, scale, s);
  if (dtype == 1)
    return (int)launch_bf16(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), pos, static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), lse, BG, H, W, Ns, Cg, g, h_g, th, tw, hn, wn, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block takes (float32: with Ns in
// chunks where they do not all fit; bf16: any Ns).
long long dat_deform_attn_fwd_smem_bytes(int dtype, int Ns, int th, int tw) {
  if (dtype == 0)
    return (long long)SmemF(chunk_samples_f32(Ns, th, tw, max_smem_optin()), th, tw).total;
  return (long long)SmemB(th, tw).total;
}

// Samples a block takes per chunk (Ns when they all fit in one).
int dat_deform_attn_fwd_chunk(int dtype, int Ns, int th, int tw) {
  return dtype == 0 ? chunk_samples_f32(Ns, th, tw, max_smem_optin()) : (Ns < NCH ? Ns : NCH);
}

// Blocks resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// 0 if a block does not fit).
int dat_deform_attn_fwd_resident_blocks(int dtype, int Ns, int th, int tw) {
  size_t smem = 0;
  int nsc = 0, n = 0;
  if (dtype == 0) {
    if (prepare_f32(Ns, th, tw, &nsc, &smem) != cudaSuccess) return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, deform_attn_fwd_f32_kernel,
                                                      FWARPS * 32, smem) != cudaSuccess)
      return 0;
    return n;
  }
  if (prepare_bf16(th, tw, &smem) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, deform_attn_fwd_bf16_kernel, BTHREADS,
                                                    smem) != cudaSuccess)
    return 0;
  return n;
}

int dat_deform_attn_fwd_warps_per_block(int dtype) { return dtype == 0 ? FWARPS : BWARPS; }

const char* dat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
