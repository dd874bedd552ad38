// Fused deformable-attention backward (kernel K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel fused_deform_attention_bwd_v2
// (dat_segmentation_tpu/ops/pallas/deform_attn.py:1420, bodies
// _kernel_v2_bwd :891 and _kernel_v4_bwd :1125). It computes the gradient
// of K1 (csrc/deform_attn_fwd.cu) directly: for each batch*group bg, head
// h, query i and sample j, with P recomputed in the block exactly as K1
// computes it,
//
//   S_ij  = scale * q_i·k_j + bias_ij,   P = softmax_j(S)
//   dP_ij = dO_i·v_j,   D_i = sum_j P_ij dP_ij   (= dO_i·O_i: O is not
//                                                 saved, D is recomputed)
//   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j              (the block owns its queries)
//   dk_j  = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
//   dtable[bg % g, h, ty, tx] += dS_ij * wy * wx   over the four taps
//   dpos_j += sum_i dS_ij * d bias_ij / d(fy, fx) * (-0.25 (th-1), -0.25 (tw-1))
//
// where the tap derivative is the -1/+1 pair of the bilinear weights
// (deform_attn.py:1415-1417) and taps outside the table weigh 0 in every
// term, as in the forward. pos is not clamped here: for
// offset_range_factor >= 0 taps leave the table.
//
// The tap coordinates fy, fx are formed with the plain version's own
// operations, each rounded (no fused multiply-add): the bias is continuous
// in them, but its slope jumps where floor(fy) does, so a coordinate one
// ulp across an integer would move dpos by a whole tap's slope.
//
// What bounds it: by the shapes (q, dout, dq, k, v, dk, dv, pos, dpos,
// table, dtable each moved once; about 10·HW·Ns·Cg flops for S, dP, dq,
// dk and dv) it does about 800 flops a byte in bf16, above the card's
// 295, so operations bound it: about 0.04 ms at stage 0 of a batch of 16
// on the tensor cores. This kernel runs its products on the
// CUDA cores in fp32 and adds four shared-memory atomics per score for
// the table gradient, so instruction throughput bounds it in practice.
//
// Design. A block owns one head (32 channels) of one batch*group and a
// tile of QB queries, a multiple of 16 chosen by query_tile() so that the
// grid fills about WAVES waves of the card's SMs (one block an SM): large
// tiles flush fewer partial sums, enough blocks keep every SM busy. Each
// of its 4 warps takes 4 queries at a time (16 per block step):
//   1. lane = sample: recompute S and P (K, V and the table in shared
//      memory), dP = dO·v, D by a warp sum, dS; the bias gradient goes
//      into a shared dtable accumulator (shared atomics) and a shared
//      dpos accumulator;
//   2. lane = channel: dq over all samples, written once (no atomics);
//   3. after a block barrier, each warp owns a quarter of the samples and
//      adds the step's 16 queries into the shared dk, dv accumulators of
//      those samples (plain adds: no two warps write one row).
// At the end a block flushes dk, dv, dpos and dtable to device memory
// with one float32 atomic add per entry (the outputs start at zero), so
// the sums over query tiles and, for dtable, over the batch, run in an
// order that changes from run to run; the wrapper's tests allow for it
// relative to the largest |gradient|.
//
// Shared memory at stage 0 (Ns 256, table 111 x 111): K and V rows padded
// against bank conflicts, the dtable accumulator (49 KB f32), dk and dv
// accumulators (64 KB f32), P and dS of 16 queries (32 KB) and 16 q and
// dO rows. In bf16 the table itself also lives in shared memory (221,408
// bytes a block). In float32 K and V take twice the room and the table
// would push the block over the 232,448 bytes it may have, so a float32
// block reads the table from device memory through the L1 cache
// (229,520 bytes). float32 serves the checks; training runs bf16.
//
// Layout: q, dout, dq (BG, H, W, Cg); k, v (BG, Ns, Cg); pos (BG, Ns, 2)
// fp32 as (y, x); table (g, h_g, th, tw); q, k, v, table, dout and dq in
// one dtype, fp32 or bf16; dk, dv (BG, Ns, Cg), dpos (BG, Ns, 2) and
// dtable (g, h_g, th, tw) fp32 and zero on entry. Cg = h_g * 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int HC = 32;          // head width: lane l owns channel l
constexpr int WARPS = 4;        // warps per block
constexpr int QW = 4;           // queries a warp carries at once
constexpr int QS = WARPS * QW;  // queries a block takes per step
constexpr int WAVES = 8;        // the grid aims at this many blocks per SM
constexpr unsigned FULL = 0xffffffffu;
static_assert(QW == 4, "a warp's P and dS are stored as one float4 per sample");

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the shared-memory arrays of one block.
template <typename T>
struct Smem {
  static constexpr int KS = HC + 16 / (int)sizeof(T);  // padded K/V row
  static constexpr bool TABLE = sizeof(T) == 2;        // table in shared memory
  size_t ks, vs, tbl, py, px, dtbl, dk, dv, dpos, pbuf, dsbuf, qrow, dorow, total;
  __host__ __device__ Smem(int Ns, int th, int tw) {
    ks = 0;
    vs = align16(ks + (size_t)Ns * KS * sizeof(T));
    tbl = align16(vs + (size_t)Ns * KS * sizeof(T));
    py = align16(tbl + (TABLE ? (size_t)th * tw * sizeof(T) : 0));
    px = align16(py + (size_t)Ns * sizeof(float));
    dtbl = align16(px + (size_t)Ns * sizeof(float));
    dk = align16(dtbl + (size_t)th * tw * sizeof(float));
    dv = align16(dk + (size_t)Ns * HC * sizeof(float));
    dpos = align16(dv + (size_t)Ns * HC * sizeof(float));
    pbuf = align16(dpos + (size_t)Ns * 2 * sizeof(float));
    dsbuf = align16(pbuf + (size_t)WARPS * Ns * QW * sizeof(float));
    qrow = align16(dsbuf + (size_t)WARPS * Ns * QW * sizeof(float));
    dorow = align16(qrow + (size_t)QS * HC * sizeof(float));
    total = dorow + (size_t)QS * HC * sizeof(float);
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

// Normalised query coordinate of row (column) i: i / max(n - 1, 1) * 2 - 1.
__device__ __forceinline__ float query_coord(int i, float denom) {
  return __fsub_rn(__fmul_rn(__fdiv_rn((float)i, denom), 2.f), 1.f);
}

// Table coordinate ((query - sample) * 0.5 + 1) * 0.5 * (size - 1).
__device__ __forceinline__ float tap_coord(float query, float sample, float span) {
  return __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(query, sample), 0.5f), 1.f), 0.5f),
                   span);
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

// The bias gradient of one score: ds * (tap weight) into the four taps of
// the shared dtable accumulator, and ds * d bias / d(fy, fx) into (gy, gx).
template <typename T>
__device__ __forceinline__ void tap_grad(const T* tbl, float* dtbl, int th, int tw, float fy,
                                         float fx, float ds, float& gy, float& gx) {
  const float y0f = floorf(fy), x0f = floorf(fx);
  const float ty = fy - y0f, tx = fx - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  float t[2][2];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int yy = y0 + dy, xx = x0 + dx;
      const bool in = yy >= 0 && yy < th && xx >= 0 && xx < tw;
      t[dy][dx] = in ? to_f(tbl[yy * tw + xx]) : 0.f;
      if (in) atomicAdd(dtbl + yy * tw + xx, ds * (dy ? ty : 1.f - ty) * (dx ? tx : 1.f - tx));
    }
  }
  gy = fmaf(ds, (1.f - tx) * (t[1][0] - t[0][0]) + tx * (t[1][1] - t[0][1]), gy);
  gx = fmaf(ds, (1.f - ty) * (t[0][1] - t[0][0]) + ty * (t[1][1] - t[1][0]), gx);
}

// grid: (ceil(H*W / QB), h_g, BG); block: WARPS * 32 threads.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32, 1)
deform_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ pos,
                       const T* __restrict__ table, const T* __restrict__ dout,
                       T* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dpos, float* __restrict__ dtable,
                       int H, int W, int Ns, int Cg, int g, int h_g, int th, int tw, int QB,
                       float y_denom, float x_denom, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> lay(Ns, th, tw);
  constexpr int KS = Smem<T>::KS;
  T* ks = reinterpret_cast<T*>(smem + lay.ks);
  T* vs = reinterpret_cast<T*>(smem + lay.vs);
  T* tbl_s = reinterpret_cast<T*>(smem + lay.tbl);
  float* pys = reinterpret_cast<float*>(smem + lay.py);
  float* pxs = reinterpret_cast<float*>(smem + lay.px);
  float* dtbl = reinterpret_cast<float*>(smem + lay.dtbl);
  float* dks = reinterpret_cast<float*>(smem + lay.dk);
  float* dvs = reinterpret_cast<float*>(smem + lay.dv);
  float* dps = reinterpret_cast<float*>(smem + lay.dpos);
  float* pbuf = reinterpret_cast<float*>(smem + lay.pbuf);
  float* dsbuf = reinterpret_cast<float*>(smem + lay.dsbuf);
  float* qrow = reinterpret_cast<float*>(smem + lay.qrow);
  float* dorow = reinterpret_cast<float*>(smem + lay.dorow);

  const int bg = blockIdx.z, h = blockIdx.y;
  const int HW = H * W;
  const int m_begin = blockIdx.x * QB;
  const int m_end = min(m_begin + QB, HW);

  // ---- this head's K, V, table and sample positions; zeroed accumulators ----
  const T* kg = k + (size_t)bg * Ns * Cg + h * HC;
  const T* vg = v + (size_t)bg * Ns * Cg + h * HC;
  for (int i = threadIdx.x; i < Ns * HC; i += blockDim.x) {
    const int n = i / HC, c = i % HC;
    ks[n * KS + c] = kg[(size_t)n * Cg + c];
    vs[n * KS + c] = vg[(size_t)n * Cg + c];
    dks[i] = 0.f;
    dvs[i] = 0.f;
  }
  const size_t tbl_off = ((size_t)(bg % g) * h_g + h) * th * tw;
  if (Smem<T>::TABLE)
    for (int i = threadIdx.x; i < th * tw; i += blockDim.x) tbl_s[i] = table[tbl_off + i];
  const T* tb = Smem<T>::TABLE ? tbl_s : table + tbl_off;
  for (int i = threadIdx.x; i < th * tw; i += blockDim.x) dtbl[i] = 0.f;
  const float ay = 0.25f * (th - 1), ax = 0.25f * (tw - 1);  // -d fy / d pos_y, likewise x
  const float spy = (float)(th - 1), spx = (float)(tw - 1);
  for (int n = threadIdx.x; n < Ns; n += blockDim.x) {
    const float2 p = reinterpret_cast<const float2*>(pos)[(size_t)bg * Ns + n];
    pys[n] = p.x;
    pxs[n] = p.y;
    dps[2 * n] = 0.f;
    dps[2 * n + 1] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = pbuf + (size_t)warp * Ns * QW;    // this warp's P, [n][qi]
  float* dsw = dsbuf + (size_t)warp * Ns * QW;  // this warp's dP, then dS

  for (int base = m_begin; base < m_end; base += QS) {
    // ---- queries m0 .. m0+QW-1; past m_end their dO is 0, so they add 0 ----
    const int m0 = base + warp * QW;
    float yq[QW], xq[QW];
    size_t row[QW];
    bool live[QW];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int m = min(m0 + qi, m_end - 1);
      live[qi] = m0 + qi < m_end;
      row[qi] = ((size_t)bg * HW + m) * Cg + h * HC;
      yq[qi] = query_coord(m / W, y_denom);
      xq[qi] = query_coord(m % W, x_denom);
    }

    // 1a. lane = sample: scores S (as K1), their row maxima
    float mx[QW];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) mx[qi] = -CUDART_INF_F;
    {
      float qr[QW][HC];
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        load_row(q + row[qi], qr[qi]);
#pragma unroll
        for (int c = 0; c < HC; ++c) qr[qi][c] *= scale;
      }
      for (int n = lane; n < Ns; n += 32) {
        float kr[HC];
        load_row(ks + n * KS, kr);
        const float pyn = pys[n], pxn = pxs[n];
        float s[QW];
#pragma unroll
        for (int qi = 0; qi < QW; ++qi) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < HC; ++c) acc = fmaf(qr[qi][c], kr[c], acc);
          acc += table_tap(tb, th, tw, tap_coord(yq[qi], pyn, spy), tap_coord(xq[qi], pxn, spx));
          s[qi] = acc;
          mx[qi] = fmaxf(mx[qi], acc);
        }
        *reinterpret_cast<float4*>(pw + n * QW) = make_float4(s[0], s[1], s[2], s[3]);
      }
    }
#pragma unroll
    for (int qi = 0; qi < QW; ++qi)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx[qi] = fmaxf(mx[qi], __shfl_xor_sync(FULL, mx[qi], o));

    // 1b. exponentials and their sums (each lane rewrites only its own samples)
    float sum[QW] = {0.f, 0.f, 0.f, 0.f};
    for (int n = lane; n < Ns; n += 32) {
      float4 e = *reinterpret_cast<float4*>(pw + n * QW);
      e.x = __expf(e.x - mx[0]);
      e.y = __expf(e.y - mx[1]);
      e.z = __expf(e.z - mx[2]);
      e.w = __expf(e.w - mx[3]);
      sum[0] += e.x;
      sum[1] += e.y;
      sum[2] += e.z;
      sum[3] += e.w;
      *reinterpret_cast<float4*>(pw + n * QW) = e;
    }
#pragma unroll
    for (int qi = 0; qi < QW; ++qi)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum[qi] += __shfl_xor_sync(FULL, sum[qi], o);

    // 1c. P = e / sum, dP = dO·v, and D = sum_n P dP
    float dsum[QW] = {0.f, 0.f, 0.f, 0.f};
    {
      float dor[QW][HC];
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        load_row(dout + row[qi], dor[qi]);
#pragma unroll
        for (int c = 0; c < HC; ++c) dor[qi][c] = live[qi] ? dor[qi][c] : 0.f;
      }
      float inv[QW];
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) inv[qi] = 1.f / sum[qi];
      for (int n = lane; n < Ns; n += 32) {
        float vr[HC];
        load_row(vs + n * KS, vr);
        const float4 e = *reinterpret_cast<const float4*>(pw + n * QW);
        const float p[QW] = {e.x * inv[0], e.y * inv[1], e.z * inv[2], e.w * inv[3]};
        float dp[QW];
#pragma unroll
        for (int qi = 0; qi < QW; ++qi) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < HC; ++c) acc = fmaf(dor[qi][c], vr[c], acc);
          dp[qi] = acc;
          dsum[qi] = fmaf(p[qi], acc, dsum[qi]);
        }
        *reinterpret_cast<float4*>(pw + n * QW) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(dsw + n * QW) = make_float4(dp[0], dp[1], dp[2], dp[3]);
      }
    }
#pragma unroll
    for (int qi = 0; qi < QW; ++qi)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dsum[qi] += __shfl_xor_sync(FULL, dsum[qi], o);

    // 1d. dS = P (dP - D); the bias gradient into dtable and dpos
    for (int n = lane; n < Ns; n += 32) {
      const float4 p = *reinterpret_cast<const float4*>(pw + n * QW);
      const float4 dp = *reinterpret_cast<const float4*>(dsw + n * QW);
      const float ds[QW] = {p.x * (dp.x - dsum[0]), p.y * (dp.y - dsum[1]),
                            p.z * (dp.z - dsum[2]), p.w * (dp.w - dsum[3])};
      *reinterpret_cast<float4*>(dsw + n * QW) = make_float4(ds[0], ds[1], ds[2], ds[3]);
      const float pyn = pys[n], pxn = pxs[n];
      float gy = 0.f, gx = 0.f;
#pragma unroll
      for (int qi = 0; qi < QW; ++qi)
        tap_grad(tb, dtbl, th, tw, tap_coord(yq[qi], pyn, spy), tap_coord(xq[qi], pxn, spx),
                 ds[qi], gy, gx);
      atomicAdd(dps + 2 * n, -ay * gy);
      atomicAdd(dps + 2 * n + 1, -ax * gx);
    }
    __syncwarp();  // step 2 reads every lane's dS

    // 2. lane = channel: dq = scale * sum_n dS k
    {
      float acc[QW] = {0.f, 0.f, 0.f, 0.f};
      for (int n = 0; n < Ns; ++n) {
        const float4 ds = *reinterpret_cast<const float4*>(dsw + n * QW);
        const float kv = to_f(ks[n * KS + lane]);
        acc[0] = fmaf(ds.x, kv, acc[0]);
        acc[1] = fmaf(ds.y, kv, acc[1]);
        acc[2] = fmaf(ds.z, kv, acc[2]);
        acc[3] = fmaf(ds.w, kv, acc[3]);
      }
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        if (live[qi]) store(dq + row[qi] + lane, acc[qi] * scale);
        const int j = warp * QW + qi;
        qrow[j * HC + lane] = to_f(q[row[qi] + lane]) * scale;
        dorow[j * HC + lane] = live[qi] ? to_f(dout[row[qi] + lane]) : 0.f;
      }
    }
    __syncthreads();  // step 3 reads every warp's P, dS, q and dO

    // 3. lane = channel, warp w owns samples w, w + WARPS, ...: dk and dv
    {
      float qc[QS], dc[QS];
#pragma unroll
      for (int j = 0; j < QS; ++j) {
        qc[j] = qrow[j * HC + lane];
        dc[j] = dorow[j * HC + lane];
      }
      for (int n = warp; n < Ns; n += WARPS) {
        float dka = 0.f, dva = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float4 p = *reinterpret_cast<const float4*>(pbuf + ((size_t)w * Ns + n) * QW);
          const float4 ds = *reinterpret_cast<const float4*>(dsbuf + ((size_t)w * Ns + n) * QW);
          dka = fmaf(ds.x, qc[4 * w], dka);
          dka = fmaf(ds.y, qc[4 * w + 1], dka);
          dka = fmaf(ds.z, qc[4 * w + 2], dka);
          dka = fmaf(ds.w, qc[4 * w + 3], dka);
          dva = fmaf(p.x, dc[4 * w], dva);
          dva = fmaf(p.y, dc[4 * w + 1], dva);
          dva = fmaf(p.z, dc[4 * w + 2], dva);
          dva = fmaf(p.w, dc[4 * w + 3], dva);
        }
        dks[n * HC + lane] += dka;
        dvs[n * HC + lane] += dva;
      }
    }
    __syncthreads();  // the next step overwrites P, dS, q and dO
  }

  // ---- flush: one atomic add per entry into the zeroed outputs ----
  float* dkg = dk + (size_t)bg * Ns * Cg + h * HC;
  float* dvg = dv + (size_t)bg * Ns * Cg + h * HC;
  for (int i = threadIdx.x; i < Ns * HC; i += blockDim.x) {
    const int n = i / HC, c = i % HC;
    atomicAdd(dkg + (size_t)n * Cg + c, dks[i]);
    atomicAdd(dvg + (size_t)n * Cg + c, dvs[i]);
  }
  for (int i = threadIdx.x; i < 2 * Ns; i += blockDim.x)
    atomicAdd(dpos + (size_t)bg * Ns * 2 + i, dps[i]);
  for (int i = threadIdx.x; i < th * tw; i += blockDim.x)
    if (dtbl[i] != 0.f) atomicAdd(dtable + tbl_off + i, dtbl[i]);
}

// Queries per block for `heads` = BG * h_g: a multiple of QS whose tiles
// cover the HW queries, in about WAVES * sms blocks.
int query_tile(int HW, int heads, int sms) {
  const int steps = (HW + QS - 1) / QS, fill = WAVES * sms / (heads > 1 ? heads : 1);
  const int tiles = fill < 1 ? 1 : (fill < steps ? fill : steps);
  const int per_tile = (HW + tiles - 1) / tiles;
  return (per_tile + QS - 1) / QS * QS;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* pos,
                   const void* table, const void* dout, void* dq, float* dk, float* dv,
                   float* dpos, float* dtable, int BG, int H, int W, int Ns, int Cg, int g,
                   int h_g, int th, int tw, int hn, int wn, float scale, cudaStream_t stream) {
  const Smem<T> lay(Ns, th, tw);
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (lay.total > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(deform_attn_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return err;
  const float y_denom = (float)(hn > 1 ? hn - 1 : 1);
  const float x_denom = (float)(wn > 1 ? wn - 1 : 1);
  const int QB = query_tile(H * W, BG * h_g, sms);
  const dim3 grid((H * W + QB - 1) / QB, h_g, BG);
  deform_attn_bwd_kernel<T><<<grid, WARPS * 32, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<const T*>(table), static_cast<const T*>(dout), static_cast<T*>(dq), dk, dv,
      dpos, dtable, H, W, Ns, Cg, g, h_g, th, tw, QB, y_denom, x_denom, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int dat_deform_attn_bwd(const void* q, const void* k, const void* v, const float* pos,
                        const void* table, const void* dout, void* dq, float* dk, float* dv,
                        float* dpos, float* dtable, int BG, int H, int W, int Ns, int Cg, int g,
                        int h_g, int th, int tw, int hn, int wn, float scale, int dtype,
                        void* stream) {
  if (Cg != h_g * HC) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, pos, table, dout, dq, dk, dv, dpos, dtable, BG, H, W,
                              Ns, Cg, g, h_g, th, tw, hn, wn, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, pos, table, dout, dq, dk, dv, dpos, dtable, BG,
                                      H, W, Ns, Cg, g, h_g, th, tw, hn, wn, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block takes.
long long dat_deform_attn_bwd_smem_bytes(int dtype, int Ns, int th, int tw) {
  return dtype == 0 ? (long long)Smem<float>(Ns, th, tw).total
                    : (long long)Smem<__nv_bfloat16>(Ns, th, tw).total;
}

const char* dat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
