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
// because its gathers scalarise; the card reads the four taps from shared
// memory, so the tap matrices and the sample-group packing are gone.
//
// What bounds it: by the shapes alone (q, out, k, v, pos, table each moved
// once; 4·HW·Ns·Cg flops at Ns = 256) it does about 250 flops a byte in
// bf16, just under the card's 295, so moving q and out bounds it: about
// 0.02 ms at stage 0 of a batch of 16. This kernel runs the products on the
// CUDA cores in fp32, not the tensor cores, and adds the bias lookup (four
// shared-memory taps per score), so instruction throughput bounds it in practice.
// The design does three things about that: heads are independent, so a
// block owns one head (32 channels) and keeps that head's K, V and table in
// shared memory for 64 queries; a warp carries 4 queries at once so every
// K row read from shared memory feeds 4 dot products; the scores and the
// bias never leave the SM. Tensor-core (wgmma) products are later work.
//
// Layout: q (BG, H, W, Cg), k and v (BG, Ns, Cg), pos (BG, Ns, 2) fp32 as
// (y, x), table (g, h_g, th, tw), out like q; all contiguous; q, k, v,
// table and out in one dtype, fp32 or bf16; Cg = h_g * 32. Any H and W; no
// padding of the queries is needed (hn/wn only set the coordinate
// normalisation). Any Ns: where the head's K and V (and the scores) do not
// fit in shared memory with the table, as at stage 0 of an image of about
// 900 x 1200 (Ns 1064), the samples are taken in chunks that do, with an
// online softmax (the running max rescales the sums); up to one chunk, the
// arithmetic is that of a single pass.
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

namespace {

constexpr int HC = 32;     // head width: lane l owns output channel l
constexpr int WARPS = 4;   // warps per block
constexpr int QW = 4;      // queries a warp carries at once
constexpr int QB = 64;     // queries per block
constexpr unsigned FULL = 0xffffffffu;
static_assert(QW == 4, "a warp's scores are stored as one float4 per sample");

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the shared-memory arrays of one block.
template <typename T>
struct Smem {
  static constexpr int KS = HC + 16 / (int)sizeof(T);  // padded K row: no bank conflicts
  size_t ks, vs, tbl, by, bx, sbuf, total;
  __host__ __device__ Smem(int Ns, int th, int tw) {
    ks = 0;
    vs = align16(ks + (size_t)Ns * KS * sizeof(T));
    tbl = align16(vs + (size_t)Ns * HC * sizeof(T));
    by = align16(tbl + (size_t)th * tw * sizeof(T));
    bx = align16(by + (size_t)Ns * sizeof(float));
    sbuf = align16(bx + (size_t)Ns * sizeof(float));
    total = sbuf + (size_t)WARPS * Ns * QW * sizeof(float);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 32 consecutive values (16-byte aligned) into registers as fp32.
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

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&r)[HC]) {
#pragma unroll
  for (int i = 0; i < HC / 8; ++i) {
    const uint4 t = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      r[8 * i + 2 * j] = f.x;
      r[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// Bilinear sample of a (th, tw) table at unnormalised (fy, fx), zeros padding.
template <typename T>
__device__ __forceinline__ float table_tap(const T* tbl, int th, int tw, float fy, float fx) {
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
      acc = fmaf(wy * wx, to_f(tbl[yy * tw + xx]), acc);
    }
  }
  return acc;
}

// grid: (ceil(H*W / QB), h_g, BG); block: WARPS * 32 threads.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
deform_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ pos,
                       const T* __restrict__ table, T* __restrict__ out,
                       float* __restrict__ lse, int H, int W, int Ns, int Cg, int g, int h_g,
                       int th, int tw,
                       int nsc, float qy_step, float qx_step, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> lay(nsc, th, tw);  // nsc: samples a chunk (Ns when they all fit)
  constexpr int KS = Smem<T>::KS;
  T* ks = reinterpret_cast<T*>(smem + lay.ks);
  T* vs = reinterpret_cast<T*>(smem + lay.vs);
  T* tbl = reinterpret_cast<T*>(smem + lay.tbl);
  float* by = reinterpret_cast<float*>(smem + lay.by);
  float* bx = reinterpret_cast<float*>(smem + lay.bx);
  float* sbuf = reinterpret_cast<float*>(smem + lay.sbuf);

  const int bg = blockIdx.z, h = blockIdx.y;
  const int HW = H * W;
  const int m_begin = blockIdx.x * QB;
  const int m_end = min(m_begin + QB, HW);

  // ---- this head's table, and its K, V and tap offsets a chunk at a time ----
  const T* kg = k + (size_t)bg * Ns * Cg + h * HC;
  const T* vg = v + (size_t)bg * Ns * Cg + h * HC;
  const T* tg = table + ((size_t)(bg % g) * h_g + h) * th * tw;
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
  for (int it = 0; it < QB / (WARPS * QW); ++it) {
    const int m0 = m_begin + (it * WARPS + warp) * QW;
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
        const float vv = to_f(vs[n * HC + lane]);
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
        store(out + ((size_t)bg * HW + m0 + qi) * Cg + h * HC + lane, acc[qi] / sum[qi]);
        if (lse != nullptr && lane == 0)
          lse[((size_t)bg * h_g + h) * HW + m0 + qi] = run[qi] + logf(sum[qi]);
      }
    }
  }
}

// Samples a chunk: all Ns if they fit in shared memory beside the table,
// else the most (a multiple of 32) that do; 0 if not even 32 fit.
template <typename T>
int chunk_samples(int Ns, int th, int tw, int max_smem) {
  if (Smem<T>(Ns, th, tw).total <= (size_t)max_smem) return Ns;
  int nsc = (Ns - 1) / 32 * 32;
  while (nsc >= 32 && Smem<T>(nsc, th, tw).total > (size_t)max_smem) nsc -= 32;
  return nsc >= 32 ? nsc : 0;
}

int max_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* pos,
                   const void* table, void* out, float* lse, int BG, int H, int W, int Ns,
                   int Cg, int g, int h_g, int th, int tw, int hn, int wn, float scale,
                   cudaStream_t stream) {
  const int nsc = chunk_samples<T>(Ns, th, tw, max_smem_optin());
  if (nsc == 0) return cudaErrorInvalidValue;
  const Smem<T> lay(nsc, th, tw);
  cudaError_t err = cudaFuncSetAttribute(deform_attn_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return err;
  const float qy_step = 2.f / (float)(hn > 1 ? hn - 1 : 1);
  const float qx_step = 2.f / (float)(wn > 1 ? wn - 1 : 1);
  const dim3 grid((H * W + QB - 1) / QB, h_g, BG);
  deform_attn_fwd_kernel<T><<<grid, WARPS * 32, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<const T*>(table), static_cast<T*>(out), lse, H, W, Ns, Cg, g, h_g, th, tw, nsc,
      qy_step, qx_step, scale);
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
    return (int)launch<float>(q, k, v, pos, table, out, lse, BG, H, W, Ns, Cg, g, h_g, th, tw,
                              hn, wn, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, pos, table, out, lse, BG, H, W, Ns, Cg, g,
                                      h_g, th, tw, hn, wn, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block takes (with Ns in chunks where
// they do not all fit).
long long dat_deform_attn_fwd_smem_bytes(int dtype, int Ns, int th, int tw) {
  const int max_smem = max_smem_optin();
  if (dtype == 0)
    return (long long)Smem<float>(chunk_samples<float>(Ns, th, tw, max_smem), th, tw).total;
  return (long long)Smem<__nv_bfloat16>(chunk_samples<__nv_bfloat16>(Ns, th, tw, max_smem), th,
                                        tw).total;
}

// Samples a block takes per chunk (Ns when they all fit).
int dat_deform_attn_fwd_chunk(int dtype, int Ns, int th, int tw) {
  const int max_smem = max_smem_optin();
  return dtype == 0 ? chunk_samples<float>(Ns, th, tw, max_smem)
                    : chunk_samples<__nv_bfloat16>(Ns, th, tw, max_smem);
}

const char* dat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
