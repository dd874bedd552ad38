// Fused deformable-attention backward (kernel K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel fused_deform_attention_bwd_v2
// (dat_segmentation_tpu/ops/pallas/deform_attn.py:1420, bodies
// _kernel_v2_bwd :891 and _kernel_v4_bwd :1125). It computes the gradient
// of K1 (csrc/deform_attn_fwd.cu): for each batch*group bg, head h, query
// i and sample j,
//
//   S_ij  = scale * q_i·k_j + bias_ij,   P_ij = exp(S_ij - lse_i)
//   dP_ij = dO_i·v_j,   D_i = dO_i·O_i   (= sum_j P_ij dP_ij)
//   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
//   dtable[bg % g, h, ty, tx] += dS_ij * wy * wx   over the four taps
//   dpos_j += sum_i dS_ij * d bias_ij / d(fy, fx) * (-0.25 (th-1), -0.25 (tw-1))
//
// lse (the log-sum-exp of each query's scores) and O are K1's, saved by
// the forward: so P comes a chunk of samples at a time, with no pass over
// all of a query's samples. In bf16, D from the stored bf16 O differs from
// sum_j P_ij dP_ij by O's rounding (one part in 2^9 of |dO||O|); the card
// checks hold the result to the plain version within the bf16 gate. The
// tap derivative is the -1/+1 pair of the bilinear weights
// (deform_attn.py:1415-1417); taps outside the table weigh 0 in every
// term, as in the forward; pos is not clamped.
//
// The tap coordinates fy, fx are formed with the plain version's own
// operations, each rounded (no fused multiply-add): the bias is continuous
// in them, but its slope jumps where floor(fy) does, so a coordinate one
// ulp across an integer would move dpos by a whole tap's slope.
//
// What bounds it: by the shapes (q, dout, out, dq, k, v, dk, dv, pos, dpos,
// lse, table, dtable each moved once; 10·HW·Ns·Cg flops for S, dP, dq, dk
// and dv) it does several hundred flops a byte in bf16, above the card's
// 295, so the tensor cores bound it: about 0.2 ms a train step. Beside the
// products, each score costs a bias lookup (four table taps) and a bias
// gradient (four shared-memory atomic adds and the dpos slope), which run
// on the CUDA cores and bound it in practice.
//
// Design (FlashAttention-2's backward, turned round the samples). A block
// of 8 warps owns one head of one batch*group, a chunk of NC = 128
// samples (16 a warp) and a run of query tiles; any Ns is a number of
// chunks, so shared memory does not grow with Ns. The grid splits the
// queries so that about WAVES blocks a slot fill the card. Per tile of QT =
// 64 queries, loaded once into shared memory with their lse and D:
//   1. each warp forms S^T and dP^T for its 16 samples x 32 queries at a
//      time (samples are the rows: K and V stay in registers as the A
//      operands all along), with mma.sync m16n8k16 (bf16 in, f32
//      accumulate);
//   2. each thread walks its 32 scores: bias, P, dS, the dpos slope into
//      registers (a thread owns two samples) and the table gradient into a
//      float32 table accumulator in shared memory. A float32 atomic add to
//      shared memory is a compare-and-swap loop on this card (SASS
//      ATOMS.CAST.SPIN), four a score at first, and they took three
//      quarters of K2's time (PERF.md). So a thread's 8 queries of a
//      sample are 8 consecutive queries (the mma column order is permuted
//      to make them so): along a row their taps move right through the
//      table by about 0.43 columns a query, and the gradient is summed in
//      registers over a run of queries that share a pair of columns, then
//      added once per column and row when the run moves on;
//   3. P and dS, rounded to bf16, are the A operands of dv += P^T dO and
//      dk += dS^T Q straight from the accumulator registers; dk, dv stay
//      in registers over all the block's tiles;
//   4. dS goes to shared memory, and after a barrier the warps form dq for
//      the tile over the block's 128 samples (ldmatrix, mma.sync) and add
//      it into a float32 dq with vector atomics (one add a chunk).
// At the end dk, dv and dpos are added into the outputs with atomics (the
// query runs of one chunk share them), and the table accumulator's
// entries that were touched. The order of those sums changes from run to
// run; the tests allow for it relative to the largest |gradient|.
//
// Resident warps: at stage 0 (table 111 x 111) a bf16 block takes about
// 110 KB of shared memory, most of it the table (bf16) and its float32
// gradient, so two blocks (16 warps) fit an SM; at the narrower stages the
// registers (at most 128 a thread) allow two as well.
//
// The float32 instance serves the card-vs-CPU checks: the same blocks and
// the same ownership of scores, its products on the CUDA cores in full
// float32 through shared memory, and the table read from device memory
// through the L1 cache.
//
// Layout: q, out, dout (BG, H, W, Cg); k, v (BG, Ns, Cg); pos (BG, Ns, 2)
// fp32 as (y, x); table (g, h_g, th, tw); lse (BG, h_g, H*W) fp32; q, k, v,
// table, out and dout in one dtype, fp32 or bf16; dq (BG, H, W, Cg), dk,
// dv (BG, Ns, Cg), dpos (BG, Ns, 2) and dtable (g, h_g, th, tw) fp32 and
// zero on entry. Cg = h_g * 32.
//
// Attribution build (timed only, used nowhere): -DK2_NO_BIAS_GRAD leaves
// out step 2's table and dpos gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "fragments.cuh"

namespace {

constexpr int HC = 32;               // head width
constexpr int WARPS = 8;             // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int NC = 16 * WARPS;       // samples a block: 16 a warp
constexpr int QT = 64;               // queries a tile
constexpr int QH = 32;               // queries a pass of steps 1-3
constexpr int WAVES = 4;             // the grid aims at this many blocks a resident slot
constexpr unsigned FULL = 0xffffffffu;
static_assert(QT * 4 == THREADS, "four threads a query load its lse and D");
static_assert(WARPS == 8 && QT == 64, "step 4 gives each warp 16 queries x 16 channels");

// Byte offsets of the shared-memory arrays of one block.
template <typename T>
struct Smem {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int RS = BF16 ? HC + 8 : HC + 1;  // row stride of K, V (elements)
  static constexpr int TS = BF16 ? HC : HC + 1;      // of Q, dO: bf16 rows are swizzled
  static constexpr int SS = BF16 ? NC + 8 : NC + 1;  // row stride of P, dS [query][sample]
  size_t tbl, dtbl, ks, vs, qs, dos, ps, dss, lse, dd, yq, xq, total;
  __host__ __device__ Smem(int th, int tw) {
    tbl = 0;  // the table, bf16 only
    dtbl = align16(tbl + (BF16 ? (size_t)th * tw * sizeof(T) : 0));
    ks = align16(dtbl + (size_t)th * tw * sizeof(float));
    vs = align16(ks + (size_t)NC * RS * sizeof(T));
    qs = align16(vs + (BF16 ? 0 : (size_t)NC * RS * sizeof(T)));  // V: float32 only
    dos = align16(qs + (size_t)QT * TS * sizeof(T));
    ps = align16(dos + (size_t)QT * TS * sizeof(T));
    dss = align16(ps + (BF16 ? 0 : (size_t)QT * SS * sizeof(T)));  // P: float32 only
    lse = align16(dss + (size_t)QT * SS * sizeof(T));
    dd = lse + QT * sizeof(float);
    yq = dd + QT * sizeof(float);
    xq = yq + QT * sizeof(float);
    total = xq + QT * sizeof(float);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Table coordinate ((query - sample) * 0.5 + 1) * 0.5 * (size - 1).
__device__ __forceinline__ float tap_coord(float query, float sample, float span) {
  return __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(query, sample), 0.5f), 1.f), 0.5f),
                   span);
}

// The query (of a pass's QH) in column n of the pass's n8 tile j. A
// thread holds columns 2tq and 2tq + 1 of the four tiles: the 8
// consecutive queries 8tq .. 8tq + 7, so that along a query row its taps
// walk the table from left to right (step 2).
__device__ __forceinline__ int pass_query(int j, int n) { return 8 * (n >> 1) + 2 * j + (n & 1); }

// Two neighbouring float32 sums into device memory (8-byte aligned).
__device__ __forceinline__ void add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// Element offset of row r, 16-byte chunk c of a bf16 Q or dO tile: rows of
// 32 channels, the chunks of row r XOR-ed with (r / 8) % 4. The 8 rows one
// ldmatrix matrix reads are 2j + {0, 1} + {0, 8, 16, 24} (pass_query), so
// unswizzled rows 8 apart would share a bank group: a 4-way conflict.
__device__ __forceinline__ int tile_off(int r, int c) { return r * HC + ((c ^ ((r >> 3) & 3)) << 3); }

// Rows [row0, row0 + n) of one head's 32 channels of a (rows, Cg) array
// into shared rows of stride RS (bf16 SWIZZLE: tile_off's layout); rows at
// or past `limit` are zero.
template <typename T, int RS, bool SWIZZLE = false>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int n, int limit,
                                          int Cg, int h) {
  constexpr int V = 16 / (int)sizeof(T);  // elements a 16-byte load
  for (int i = threadIdx.x; i < n * (HC / V); i += THREADS) {
    const int r = i / (HC / V), c = (i % (HC / V)) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * Cg + h * HC + c);
    if constexpr (SWIZZLE) {
      static_assert(sizeof(T) == 2 && RS == HC, "swizzled tiles are bf16 rows of 32");
      *reinterpret_cast<uint4*>(dst + tile_off(r, c / 8)) = val;
    } else if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst + r * RS + c) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int j = 0; j < V; ++j) dst[r * RS + c + j] = e[j];
    }
  }
}

// grid: (query runs, chunks * h_g, BG); block: THREADS.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
deform_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ pos,
                       const T* __restrict__ table, const T* __restrict__ out,
                       const float* __restrict__ lse, const T* __restrict__ dout,
                       float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dpos, float* __restrict__ dtable,
                       int H, int W, int Ns, int Cg, int h_g, int g, int th, int tw,
                       int tiles_per_block, float y_denom, float x_denom, float scale) {
  constexpr bool BF16 = Smem<T>::BF16;
  constexpr int RS = Smem<T>::RS, TS = Smem<T>::TS, SS = Smem<T>::SS;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> lay(th, tw);
  T* tbl_s = reinterpret_cast<T*>(smem + lay.tbl);
  [[maybe_unused]] float* dtbl = reinterpret_cast<float*>(smem + lay.dtbl);
  T* ks = reinterpret_cast<T*>(smem + lay.ks);
  T* vs = reinterpret_cast<T*>(smem + lay.vs);
  T* qs = reinterpret_cast<T*>(smem + lay.qs);
  T* dos = reinterpret_cast<T*>(smem + lay.dos);
  T* ps = reinterpret_cast<T*>(smem + lay.ps);
  T* dss = reinterpret_cast<T*>(smem + lay.dss);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* d_s = reinterpret_cast<float*>(smem + lay.dd);
  float* yq_s = reinterpret_cast<float*>(smem + lay.yq);
  float* xq_s = reinterpret_cast<float*>(smem + lay.xq);

  const int bg = blockIdx.z, h = blockIdx.y % h_g, chunk = blockIdx.y / h_g;
  const int HW = H * W;
  const int n_base = chunk * NC;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, (HW + QT - 1) / QT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column pair

  // ---- the table, zeroed accumulators, this chunk's K (and V) ----
  const size_t tbl_off = ((size_t)(bg % g) * h_g + h) * th * tw;
  if constexpr (BF16)
    for (int i = threadIdx.x; i < th * tw; i += THREADS) tbl_s[i] = table[tbl_off + i];
  const T* tb = BF16 ? tbl_s : table + tbl_off;
  for (int i = threadIdx.x; i < th * tw; i += THREADS) dtbl[i] = 0.f;
  const T* kg = k + (size_t)bg * Ns * Cg;
  const T* vg = v + (size_t)bg * Ns * Cg;
  load_rows<T, RS>(ks, kg, n_base, NC, Ns, Cg, h);
  if constexpr (!BF16) load_rows<T, RS>(vs, vg, n_base, NC, Ns, Cg, h);

  // a thread's two samples: rows gq and gq + 8 of its warp's 16
  const int s_loc[2] = {warp * 16 + gq, warp * 16 + gq + 8};
  bool s_live[2];
  float py[2], px[2], gy[2] = {0.f, 0.f}, gx[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n_base + s_loc[r];
    s_live[r] = n < Ns;
    const float2 p = s_live[r] ? reinterpret_cast<const float2*>(pos)[(size_t)bg * Ns + n]
                               : make_float2(0.f, 0.f);
    py[r] = p.x;
    px[r] = p.y;
  }
  [[maybe_unused]] const float ay = 0.25f * (th - 1), ax = 0.25f * (tw - 1);  // -d fy / d pos_y
  const float spy = (float)(th - 1), spx = (float)(tw - 1);
  __syncthreads();

  // bf16: K and V slabs (16 samples x 32 channels) as A fragments, kept
  uint32_t aK[2][4], aV[2][4];
  if constexpr (BF16) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s_loc[i & 1], c = 16 * kk + 2 * tq + 8 * (i >> 1);
        aK[kk][i] = *reinterpret_cast<const uint32_t*>(ks + s * RS + c);
        const int n = n_base + s;
        aV[kk][i] = n < Ns ? *reinterpret_cast<const uint32_t*>(vg + (size_t)n * Cg + h * HC + c)
                           : 0u;
      }
    }
  }

  // dk, dv of the warp's 16 samples x 32 channels, in mma C layout:
  // [channel tile n][r]: sample row gq + 8 (r >> 1), channel 8n + 2tq + (r & 1)
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dka[n][r] = dva[n][r] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int m_tile = tile * QT;
    // ---- the tile's Q and dO; per query lse, D = dO·O and coordinates ----
    {
      const T* qg = q + (size_t)bg * HW * Cg;
      const T* dg = dout + (size_t)bg * HW * Cg;
      load_rows<T, TS, BF16>(qs, qg, m_tile, QT, HW, Cg, h);
      load_rows<T, TS, BF16>(dos, dg, m_tile, QT, HW, Cg, h);
      const int ql = threadIdx.x / 4, part = threadIdx.x % 4, m = m_tile + ql;
      float d = 0.f;
      if (m < HW) {
        const size_t row = ((size_t)bg * HW + m) * Cg + h * HC + part * 8;
#pragma unroll
        for (int c = 0; c < 8; ++c) d = fmaf(to_f(dout[row + c]), to_f(out[row + c]), d);
      }
      d += __shfl_xor_sync(FULL, d, 1);
      d += __shfl_xor_sync(FULL, d, 2);
      if (part == 0) {
        d_s[ql] = d;
        lse_s[ql] = m < HW ? lse[((size_t)bg * h_g + h) * HW + m] : CUDART_INF_F;
        yq_s[ql] = m < HW ? query_coord(m / W, y_denom) : 0.f;
        xq_s[ql] = m < HW ? query_coord(m % W, x_denom) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int qh = 0; qh < QT; qh += QH) {
      // ---- 1. S^T and dP^T: [query tile j][r]: sample row gq + 8 (r >> 1),
      //         query qh + pass_query(j, 2tq + (r & 1)) ----
      float sa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sa[j][r] = da[j][r] = 0.f;
      if constexpr (BF16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = tile_off(qh + pass_query(j, lane & 7), lane >> 3);
          uint32_t b[4];
          ldsm_x4(b, qs + off);
          mma(sa[j], aK[0], b[0], b[1]);
          mma(sa[j], aK[1], b[2], b[3]);
          ldsm_x4(b, dos + off);
          mma(da[j], aV[0], b[0], b[1]);
          mma(da[j], aV[1], b[2], b[3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int s = s_loc[r >> 1], ql = qh + pass_query(j, 2 * tq + (r & 1));
            float acc = 0.f, accd = 0.f;
#pragma unroll 8
            for (int c = 0; c < HC; ++c) {
              acc = fmaf(to_f(ks[s * RS + c]), to_f(qs[ql * TS + c]), acc);
              accd = fmaf(to_f(vs[s * RS + c]), to_f(dos[ql * TS + c]), accd);
            }
            sa[j][r] = acc;
            da[j][r] = accd;
          }
      }

      // ---- 2. bias, P, dS; the bias gradient. Along a query row a
      //         thread's taps of one sample move right through the table
      //         (about 0.43 columns a query at every stage of the flagship):
      //         the table gradient is summed in registers over a run of
      //         queries of one row and one pair of columns, and added into
      //         the shared accumulator when the run moves on ----
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        [[maybe_unused]] float run_yq = CUDART_INF_F, wy0 = 0.f, wy1 = 0.f, acc0 = 0.f,
                               acc1 = 0.f;
        [[maybe_unused]] int run_y0 = 0, run_x0 = 0;
        // column x of the run (summed over its queries) into rows y0, y0 + 1
        [[maybe_unused]] auto flush = [&](int x, float v) {
          if (v == 0.f || x < 0 || x >= tw) return;
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const int yy = run_y0 + dy;
            if (yy < 0 || yy >= th) continue;
            atomicAdd(dtbl + yy * tw + x, (dy ? wy1 : wy0) * v);
          }
        };
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 2 * i + e, ql = qh + pass_query(j, 2 * tq + e);
            const float yq = yq_s[ql];
            const float fy = tap_coord(yq, py[i], spy);
            const float fx = tap_coord(xq_s[ql], px[i], spx);
            const float y0f = floorf(fy), x0f = floorf(fx);
            const float ty = fy - y0f, tx = fx - x0f;
            const int y0 = (int)y0f, x0 = (int)x0f;
            float t[2][2], bias = 0.f;
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
              for (int dx = 0; dx < 2; ++dx) {
                const int yy = y0 + dy, xx = x0 + dx;
                const bool in = yy >= 0 && yy < th && xx >= 0 && xx < tw;
                t[dy][dx] = in ? to_f(tb[yy * tw + xx]) : 0.f;
                if (in) bias = fmaf((dy ? ty : 1.f - ty) * (dx ? tx : 1.f - tx), t[dy][dx], bias);
              }
            const float p = s_live[i] ? __expf(fmaf(sa[j][r], scale, bias) - lse_s[ql]) : 0.f;
            const float ds = p * (da[j][r] - d_s[ql]);
            sa[j][r] = p;
            da[j][r] = ds;
#ifndef K2_NO_BIAS_GRAD
            gy[i] = fmaf(ds, (1.f - tx) * (t[1][0] - t[0][0]) + tx * (t[1][1] - t[0][1]), gy[i]);
            gx[i] = fmaf(ds, (1.f - ty) * (t[0][1] - t[0][0]) + ty * (t[1][1] - t[1][0]), gx[i]);
            if (yq != run_yq || (unsigned)(x0 - run_x0) > 1u) {  // a new run
              flush(run_x0, acc0);
              flush(run_x0 + 1, acc1);
              run_yq = yq;
              run_y0 = y0;
              wy0 = 1.f - ty;
              wy1 = ty;
              run_x0 = x0;
              acc0 = acc1 = 0.f;
            } else if (x0 == run_x0 + 1) {  // the run moves one column on
              flush(run_x0, acc0);
              acc0 = acc1;
              acc1 = 0.f;
              run_x0 = x0;
            }
            acc0 = fmaf(ds, 1.f - tx, acc0);
            acc1 = fmaf(ds, tx, acc1);
#endif
          }
#ifndef K2_NO_BIAS_GRAD
        flush(run_x0, acc0);
        flush(run_x0 + 1, acc1);
#endif
      }

      // ---- 3. dv += P^T dO, dk += dS^T Q over this pass's queries; dS kept ----
      if constexpr (BF16) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t aP[4] = {pack_bf16(sa[2 * kk][0], sa[2 * kk][1]),
                                  pack_bf16(sa[2 * kk][2], sa[2 * kk][3]),
                                  pack_bf16(sa[2 * kk + 1][0], sa[2 * kk + 1][1]),
                                  pack_bf16(sa[2 * kk + 1][2], sa[2 * kk + 1][3])};
          const uint32_t aS[4] = {pack_bf16(da[2 * kk][0], da[2 * kk][1]),
                                  pack_bf16(da[2 * kk][2], da[2 * kk][3]),
                                  pack_bf16(da[2 * kk + 1][0], da[2 * kk + 1][1]),
                                  pack_bf16(da[2 * kk + 1][2], da[2 * kk + 1][3])};
#pragma unroll
          for (int cp = 0; cp < 2; ++cp) {
            const int off = tile_off(qh + pass_query(2 * kk + ((lane >> 3) & 1), lane & 7),
                                     2 * cp + (lane >> 4));
            uint32_t b[4];
            ldsm_x4_t(b, dos + off);
            mma(dva[2 * cp], aP, b[0], b[1]);
            mma(dva[2 * cp + 1], aP, b[2], b[3]);
            ldsm_x4_t(b, qs + off);
            mma(dka[2 * cp], aS, b[0], b[1]);
            mma(dka[2 * cp + 1], aS, b[2], b[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dss[(qh + pass_query(j, 2 * tq + (r & 1))) * SS + s_loc[r >> 1]] =
                __float2bfloat16(da[j][r]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int ql = qh + pass_query(j, 2 * tq + (r & 1));
            ps[ql * SS + s_loc[r >> 1]] = sa[j][r];
            dss[ql * SS + s_loc[r >> 1]] = da[j][r];
          }
        __syncwarp();  // a warp's dv, dk read its own samples' P and dS
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int s = s_loc[r >> 1], c = 8 * n + 2 * tq + (r & 1);
            float av = dva[n][r], ak = dka[n][r];
            for (int ql = qh; ql < qh + QH; ++ql) {
              av = fmaf(to_f(ps[ql * SS + s]), to_f(dos[ql * TS + c]), av);
              ak = fmaf(to_f(dss[ql * SS + s]), to_f(qs[ql * TS + c]), ak);
            }
            dva[n][r] = av;
            dka[n][r] = ak;
          }
      }
    }
    __syncthreads();  // every warp's dS is in shared memory

    // ---- 4. dq of the tile: warp -> 16 queries x 16 channels, over NC samples ----
    {
      const int q0 = 16 * (warp & 3), c0 = 16 * (warp >> 2);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if constexpr (BF16) {
        const int row = (lane & 7) + 8 * ((lane >> 3) & 1), col = 8 * (lane >> 4);
#pragma unroll
        for (int kk = 0; kk < NC / 16; ++kk) {
          uint32_t a[4], b[4];
          ldsm_x4(a, dss + (q0 + row) * SS + 16 * kk + col);
          ldsm_x4_t(b, ks + (16 * kk + row) * RS + c0 + col);
          mma(acc[0], a, b[0], b[1]);
          mma(acc[1], a, b[2], b[3]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int ql = q0 + gq + 8 * (r >> 1), c = c0 + 8 * n + 2 * tq + (r & 1);
            float a = 0.f;
            for (int s = 0; s < NC; ++s) a = fmaf(to_f(dss[ql * SS + s]), to_f(ks[s * RS + c]), a);
            acc[n][r] = a;
          }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = m_tile + q0 + gq + 8 * rr;
        if (m < HW) {
          float* dst = dq + ((size_t)bg * HW + m) * Cg + h * HC + c0 + 2 * tq;
#pragma unroll
          for (int n = 0; n < 2; ++n)
            add2(dst + 8 * n, acc[n][2 * rr] * scale, acc[n][2 * rr + 1] * scale);
        }
      }
    }
    __syncthreads();  // the next tile overwrites Q, dO and dS
  }

  // ---- flush: dk, dv, dpos of the warp's samples; the touched table entries ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    gy[i] += __shfl_xor_sync(FULL, gy[i], 1);
    gy[i] += __shfl_xor_sync(FULL, gy[i], 2);
    gx[i] += __shfl_xor_sync(FULL, gx[i], 1);
    gx[i] += __shfl_xor_sync(FULL, gx[i], 2);
    if (!s_live[i]) continue;
    const size_t n = (size_t)bg * Ns + n_base + s_loc[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t off = n * Cg + h * HC + 8 * c + 2 * tq;
      add2(dk + off, dka[c][2 * i] * scale, dka[c][2 * i + 1] * scale);
      add2(dv + off, dva[c][2 * i], dva[c][2 * i + 1]);
    }
#ifndef K2_NO_BIAS_GRAD
    if (tq == 0) add2(dpos + 2 * n, -ay * gy[i], -ax * gx[i]);
#endif
  }
  for (int i = threadIdx.x; i < th * tw; i += THREADS)
    if (dtbl[i] != 0.f) atomicAdd(dtable + tbl_off + i, dtbl[i]);
}

template <typename T>
cudaError_t prepare(int th, int tw, size_t* smem) {
  int dev = 0, max_smem = 0;
  *smem = Smem<T>(th, tw).total;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (*smem > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(deform_attn_bwd_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// Blocks of K2 resident on one SM (0 if a block does not fit).
template <typename T>
int resident_blocks(int th, int tw) {
  size_t smem = 0;
  int n = 0;
  if (prepare<T>(th, tw, &smem) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, deform_attn_bwd_kernel<T>, THREADS,
                                                    smem) != cudaSuccess)
    return 0;
  return n;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* pos,
                   const void* table, const void* out, const float* lse, const void* dout,
                   float* dq, float* dk, float* dv, float* dpos, float* dtable, int BG, int H,
                   int W, int Ns, int Cg, int g, int h_g, int th, int tw, int hn, int wn,
                   float scale, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<T>(th, tw, &smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, deform_attn_bwd_kernel<T>,
                                                           THREADS, smem)) != cudaSuccess)
    return err;
  // split each (batch*group, head, chunk)'s query tiles into runs, so that
  // about WAVES blocks a resident slot cover the card
  const int tiles = (H * W + QT - 1) / QT, chunks = (Ns + NC - 1) / NC;
  const int groups = BG * h_g * chunks;
  const int want = WAVES * sms * (per_sm > 0 ? per_sm : 1);
  int runs = want / groups;
  runs = runs < 1 ? 1 : (runs > tiles ? tiles : runs);
  const int per_run = (tiles + runs - 1) / runs;
  runs = (tiles + per_run - 1) / per_run;
  const float y_denom = (float)(hn > 1 ? hn - 1 : 1);
  const float x_denom = (float)(wn > 1 ? wn - 1 : 1);
  const dim3 grid(runs, chunks * h_g, BG);
  deform_attn_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<const T*>(table), static_cast<const T*>(out), lse,
      static_cast<const T*>(dout), dq, dk, dv, dpos, dtable, H, W, Ns, Cg, h_g, g, th, tw,
      per_run, y_denom, x_denom, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int dat_deform_attn_bwd(const void* q, const void* k, const void* v, const float* pos,
                        const void* table, const void* out, const float* lse, const void* dout,
                        float* dq, float* dk, float* dv, float* dpos, float* dtable, int BG,
                        int H, int W, int Ns, int Cg, int g, int h_g, int th, int tw, int hn,
                        int wn, float scale, int dtype, void* stream) {
  if (Cg != h_g * HC) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, pos, table, out, lse, dout, dq, dk, dv, dpos, dtable, BG,
                              H, W, Ns, Cg, g, h_g, th, tw, hn, wn, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, pos, table, out, lse, dout, dq, dk, dv, dpos,
                                      dtable, BG, H, W, Ns, Cg, g, h_g, th, tw, hn, wn, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block takes (any Ns).
long long dat_deform_attn_bwd_smem_bytes(int dtype, int th, int tw) {
  return dtype == 0 ? (long long)Smem<float>(th, tw).total
                    : (long long)Smem<__nv_bfloat16>(th, tw).total;
}

// Blocks resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// each has 8 warps.
int dat_deform_attn_bwd_resident_blocks(int dtype, int th, int tw) {
  return dtype == 0 ? resident_blocks<float>(th, tw) : resident_blocks<__nv_bfloat16>(th, tw);
}

int dat_deform_attn_bwd_warps_per_block() { return WARPS; }

const char* dat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
