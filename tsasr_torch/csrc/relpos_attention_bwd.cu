// Fused relative-position self-attention, backward, f32, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/attention_pallas.py::_bwd_kernel (driven by
// _fused_bwd_call). With s_ij = (q_u_i.k_j + q_v_i.p_{T-1-i+j}) * scale
// + am_ij + kp_j, P = softmax_j(s), Pd = P * keep / (1-rate) and
// out = Pd @ v, it computes from do = d(loss)/d(out):
//
//   dv_j   = sum_i Pd_ij do_i
//   dP_ij  = keep_ij / (1-rate) * (do_i . v_j)
//   dS_ij  = P_ij (dP_ij - D_i) * scale,   D_i = do_i . out_i
//   dq_u_i = sum_j dS_ij k_j               dk_j = sum_i dS_ij q_u_i
//   dq_v_i = sum_j dS_ij p_{T-1-i+j}
//   dp_r   = sum_b sum_{i-j = T-1-r} dS_ij q_v_i
//
// D_i = sum_j P_ij dP_ij equals do_i . out_i, the JAX kernel's "row".
// The probabilities are recomputed as exp(s - m_i) / l_i from the row
// statistics the forward wrote (max m, 1 / sum l; the TPU kernel
// recomputed the softmax instead); the dropout mask is regenerated from
// the same Philox draw as the forward (philox.cuh), never stored.
//
// Passes (each a kernel, all on one stream):
// 1. rows: D = rowsum(do * out), one warp per row;
// 2. dq: one block per (query tile, head, batch), looping over key
//    tiles, emits dq_u and dq_v;
// 3. dkv: one block per (key tile, head, batch), looping over query
//    tiles, emits dk and dv;
// 4. dp: one block per (tile of 32 relative positions r, head, batch),
//    looping over the query tiles whose keys j = i + r - (T-1) lie in
//    [0, T), writes a per-batch partial of dp;
// 5. dp sum: adds the B partials in batch order.
// The TPU kernel carried dp across a sequential grid axis; Hopper blocks
// run in no order, so the batch sum is a second pass over per-batch
// partials: deterministic, no atomics. The un-shift is the forward's
// index offset (score (i, j) <-> p row T-1-i+j), no roll network.
//
// Layout and tiling follow the forward: tiles of 32 x 32, 4 warps, a
// warp owns 8 rows of the tile and a lane one column; rows in shared
// memory are padded to Dh+1 floats. Every pair is recomputed in each of
// passes 2-4 (three f32 dots of length Dh each), so this backward does
// about 3x the score work of the forward, plus its four products.
//
// What bounds it on an H100: 16 * B*H*T^2*Dh f32 operations or so
// (the dots plus the four products) at the f32 rate against reading
// q_u, q_v, k, v, do, out, p and writing five gradients; at B8 H4 T208
// Dh64 that is ~0.18 ms of f32 FMAs against ~0.01 ms of bytes, so
// operations bound it. As in the forward it is latency-bound at these
// sizes (few waves of 4-warp blocks, scores through shared memory).
// Tensor cores and fusing the three recomputes are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kTile = 32;                  // rows and columns per tile
constexpr int kWarps = 4;
constexpr int kRows = kTile / kWarps;      // tile rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kWin = 2 * kTile - 1;        // window of p (or k, v) rows
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float *qu, *qv, *k, *v, *p, *kp, *am, *out, *stats, *dout;
  const long long* seed;
  uint32_t thresh;
  float keep_scale, scale;
  float *delta, *dqu, *dqv, *dk, *dv, *dp_part, *dp;
  int B, H, T, Dh;
};

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int first, int n, int limit, int Dh,
                                          int ld) {
  // dst[r * ld + c] = src[(first + r) * Dh + c] for rows inside [0, limit)
  for (int e = threadIdx.x; e < n * Dh; e += kThreads) {
    const int r = e / Dh, c = e - r * Dh, g = first + r;
    dst[r * ld + c] = (g >= 0 && g < limit) ? src[(size_t)g * Dh + c] : 0.f;
  }
}

// dS and Pd of one pair, or zeros when (i, j) lies outside the lattice.
struct PairGrad {
  float ds, pd;
};

__device__ __forceinline__ PairGrad pair_grad(const Args& a, int b, int h,
                                              int i, int j, float ac,
                                              float bd, float dpd,
                                              float2 st_i, float delta_i,
                                              uint64_t seed) {
  PairGrad g{0.f, 0.f};
  if (i < 0 || i >= a.T || j < 0 || j >= a.T) return g;
  const float s = (ac + bd) * a.scale + a.am[(size_t)i * a.T + j] +
                  a.kp[(size_t)b * a.T + j];
  const float prob = expf(s - st_i.x) * st_i.y;
  float dprob = dpd;
  g.pd = prob;
  if (a.seed != nullptr) {
    const bool keep = tsasr::dropout_keep(seed, a.thresh, b, h, i, j);
    g.pd = keep ? prob * a.keep_scale : 0.f;
    dprob = keep ? dpd * a.keep_scale : 0.f;
  }
  g.ds = prob * (dprob - delta_i) * a.scale;
  return g;
}

size_t smem_floats(int n_rows, int dh) { return (size_t)n_rows * (dh + 1); }

// (row max, 1 / row sum) of the forward's softmax for row index `row`
__device__ __forceinline__ float2 row_stats(const Args& a, size_t row) {
  return make_float2(a.stats[2 * row], a.stats[2 * row + 1]);
}

// ---------------------------------------------------------------- pass 1
__global__ void __launch_bounds__(kThreads) rows_kernel(Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kWarps + warp;
  if (row >= (size_t)a.B * a.H * a.T) return;
  float acc = 0.f;
  for (int d = lane; d < a.Dh; d += 32)
    acc += a.dout[row * a.Dh + d] * a.out[row * a.Dh + d];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) a.delta[row] = acc;
}

// ---------------------------------------------------------------- pass 2
template <int DC>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int Dh = a.Dh, ld = Dh + 1, T = a.T;
  float* s_qu = smem;                       // kTile x ld (query tile)
  float* s_qv = s_qu + kTile * ld;
  float* s_do = s_qv + kTile * ld;
  float* s_k = s_do + kTile * ld;           // kTile x ld (key tile)
  float* s_v = s_k + kTile * ld;
  float* s_p = s_v + kTile * ld;            // kWin x ld

  const int i0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
  const size_t bh = ((size_t)b * a.H + h) * T;
  const float* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;

  load_rows(s_qu, a.qu + bh * Dh, i0, kTile, T, Dh, ld);
  load_rows(s_qv, a.qv + bh * Dh, i0, kTile, T, Dh, ld);
  load_rows(s_do, a.dout + bh * Dh, i0, kTile, T, Dh, ld);
  float2 st_q[kRows];
  float delta_q[kRows], gqu[kRows][DC], gqv[kRows][DC];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = min(i0 + r0 + q, T - 1);
    st_q[q] = row_stats(a, bh + i);
    delta_q[q] = a.delta[bh + i];
#pragma unroll
    for (int c = 0; c < DC; ++c) gqu[q][c] = gqv[q][c] = 0.f;
  }

  for (int j0 = 0; j0 < T; j0 += kTile) {
    __syncthreads();
    load_rows(s_k, a.k + bh * Dh, j0, kTile, T, Dh, ld);
    load_rows(s_v, a.v + bh * Dh, j0, kTile, T, Dh, ld);
    // local p row pr is global row T - kTile - i0 + j0 + pr; query row r
    // and key lane need local row kTile-1-r+lane
    load_rows(s_p, p_h, T - kTile - i0 + j0, kWin, 2 * T - 1, Dh, ld);
    __syncthreads();

    float ac[kRows], bd[kRows], dpd[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) ac[q] = bd[q] = dpd[q] = 0.f;
    const float* k_row = s_k + lane * ld;
    const float* v_row = s_v + lane * ld;
    const float* p_row = s_p + (kTile - 1 - r0 + lane) * ld;
    for (int d = 0; d < Dh; ++d) {
      const float kd = k_row[d], vd = v_row[d];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = (r0 + q) * ld + d;
        ac[q] = fmaf(s_qu[r], kd, ac[q]);
        bd[q] = fmaf(s_qv[r], p_row[d - q * ld], bd[q]);
        dpd[q] = fmaf(s_do[r], vd, dpd[q]);
      }
    }
    float ds[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      ds[q] = pair_grad(a, b, h, i0 + r0 + q, j0 + lane, ac[q], bd[q],
                        dpd[q], st_q[q], delta_q[q], seed).ds;

    const int kmax = min(kTile, T - j0);
    for (int jj = 0; jj < kmax; ++jj) {
      float kj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        kj[c] = d < Dh ? s_k[jj * ld + d] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float g = __shfl_sync(kFull, ds[q], jj);
        const float* pr = s_p + (kTile - 1 - r0 - q + jj) * ld;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          gqu[q][c] = fmaf(g, kj[c], gqu[q][c]);
          if (d < Dh) gqv[q][c] = fmaf(g, pr[d], gqv[q][c]);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = i0 + r0 + q;
    if (i >= T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) {
        a.dqu[(bh + i) * Dh + d] = gqu[q][c];
        a.dqv[(bh + i) * Dh + d] = gqv[q][c];
      }
    }
  }
}

// ---------------------------------------------------------------- pass 3
template <int DC>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int Dh = a.Dh, ld = Dh + 1, T = a.T;
  float* s_k = smem;                        // kTile x ld (key tile)
  float* s_v = s_k + kTile * ld;
  float* s_qu = s_v + kTile * ld;           // kTile x ld (query tile)
  float* s_qv = s_qu + kTile * ld;
  float* s_do = s_qv + kTile * ld;
  float* s_p = s_do + kTile * ld;           // kWin x ld

  const int j0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
  const size_t bh = ((size_t)b * a.H + h) * T;
  const float* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;

  load_rows(s_k, a.k + bh * Dh, j0, kTile, T, Dh, ld);
  load_rows(s_v, a.v + bh * Dh, j0, kTile, T, Dh, ld);
  float gk[kRows][DC], gv[kRows][DC];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[q][c] = gv[q][c] = 0.f;

  for (int i0 = 0; i0 < T; i0 += kTile) {
    __syncthreads();
    load_rows(s_qu, a.qu + bh * Dh, i0, kTile, T, Dh, ld);
    load_rows(s_qv, a.qv + bh * Dh, i0, kTile, T, Dh, ld);
    load_rows(s_do, a.dout + bh * Dh, i0, kTile, T, Dh, ld);
    load_rows(s_p, p_h, T - kTile - i0 + j0, kWin, 2 * T - 1, Dh, ld);
    __syncthreads();

    // lane = query i0 + lane; warp row q = key j0 + r0 + q
    const int i = i0 + lane;
    const float2 st_i = row_stats(a, bh + min(i, T - 1));
    const float delta_i = a.delta[bh + min(i, T - 1)];
    float ac[kRows], bd[kRows], dpd[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) ac[q] = bd[q] = dpd[q] = 0.f;
    const float* qu_row = s_qu + lane * ld;
    const float* qv_row = s_qv + lane * ld;
    const float* do_row = s_do + lane * ld;
    // pair (i, j0+r0+q) reads local p row kTile-1-lane+r0+q
    const float* p_row = s_p + (kTile - 1 - lane + r0) * ld;
    for (int d = 0; d < Dh; ++d) {
      const float qud = qu_row[d], qvd = qv_row[d], dod = do_row[d];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = (r0 + q) * ld + d;
        ac[q] = fmaf(qud, s_k[r], ac[q]);
        bd[q] = fmaf(qvd, p_row[q * ld + d], bd[q]);
        dpd[q] = fmaf(dod, s_v[r], dpd[q]);
      }
    }
    PairGrad g[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      g[q] = pair_grad(a, b, h, i, j0 + r0 + q, ac[q], bd[q], dpd[q], st_i,
                       delta_i, seed);

    const int imax = min(kTile, T - i0);
    for (int ii = 0; ii < imax; ++ii) {
      float qi[DC], di[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        qi[c] = d < Dh ? s_qu[ii * ld + d] : 0.f;
        di[c] = d < Dh ? s_do[ii * ld + d] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float ds = __shfl_sync(kFull, g[q].ds, ii);
        const float pd = __shfl_sync(kFull, g[q].pd, ii);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gk[q][c] = fmaf(ds, qi[c], gk[q][c]);
          gv[q][c] = fmaf(pd, di[c], gv[q][c]);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int j = j0 + r0 + q;
    if (j >= T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) {
        a.dk[(bh + j) * Dh + d] = gk[q][c];
        a.dv[(bh + j) * Dh + d] = gv[q][c];
      }
    }
  }
}

// ---------------------------------------------------------------- pass 4
template <int DC>
__global__ void __launch_bounds__(kThreads) dp_kernel(Args a) {
  extern __shared__ float smem[];
  const int Dh = a.Dh, ld = Dh + 1, T = a.T, P = 2 * T - 1;
  float* s_p = smem;                        // kTile x ld (positions)
  float* s_qu = s_p + kTile * ld;           // kTile x ld (query tile)
  float* s_qv = s_qu + kTile * ld;
  float* s_do = s_qv + kTile * ld;
  float* s_k = s_do + kTile * ld;           // kWin x ld (key window)
  float* s_v = s_k + kWin * ld;

  const int rb = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
  const size_t bh = ((size_t)b * a.H + h) * T;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;

  load_rows(s_p, a.p + (size_t)h * P * Dh, rb, kTile, P, Dh, ld);
  float gp[kRows][DC];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
#pragma unroll
    for (int c = 0; c < DC; ++c) gp[q][c] = 0.f;

  // position r pairs query i with key j = i + r - (T-1); the tile's
  // positions rb..rb+31 meet keys in [0, T) for i in [i_lo, i_hi)
  const int i_lo = max(0, T - 1 - (rb + kTile - 1));
  const int i_hi = min(T, 2 * T - 1 - rb);
  for (int i0 = i_lo; i0 < i_hi; i0 += kTile) {
    const int jb = i0 + rb - (T - 1);       // key of (lane 0, row 0)
    __syncthreads();
    load_rows(s_qu, a.qu + bh * Dh, i0, kTile, T, Dh, ld);
    load_rows(s_qv, a.qv + bh * Dh, i0, kTile, T, Dh, ld);
    load_rows(s_do, a.dout + bh * Dh, i0, kTile, T, Dh, ld);
    load_rows(s_k, a.k + bh * Dh, jb, kWin, T, Dh, ld);
    load_rows(s_v, a.v + bh * Dh, jb, kWin, T, Dh, ld);
    __syncthreads();

    // lane = query i0 + lane; warp row q = position rb + r0 + q, whose
    // key sits at window row lane + r0 + q
    const int i = i0 + lane;
    const float2 st_i = row_stats(a, bh + min(i, T - 1));
    const float delta_i = a.delta[bh + min(i, T - 1)];
    float ac[kRows], bd[kRows], dpd[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) ac[q] = bd[q] = dpd[q] = 0.f;
    const float* qu_row = s_qu + lane * ld;
    const float* qv_row = s_qv + lane * ld;
    const float* do_row = s_do + lane * ld;
    const float* k_row = s_k + (lane + r0) * ld;
    const float* v_row = s_v + (lane + r0) * ld;
    for (int d = 0; d < Dh; ++d) {
      const float qud = qu_row[d], qvd = qv_row[d], dod = do_row[d];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        ac[q] = fmaf(qud, k_row[q * ld + d], ac[q]);
        bd[q] = fmaf(qvd, s_p[(r0 + q) * ld + d], bd[q]);
        dpd[q] = fmaf(dod, v_row[q * ld + d], dpd[q]);
      }
    }
    float ds[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      ds[q] = rb + r0 + q < P
                  ? pair_grad(a, b, h, i, jb + lane + r0 + q, ac[q], bd[q],
                              dpd[q], st_i, delta_i, seed).ds
                  : 0.f;

    const int imax = min(kTile, T - i0);
    for (int ii = 0; ii < imax; ++ii) {
      float qi[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        qi[c] = d < Dh ? s_qv[ii * ld + d] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float g = __shfl_sync(kFull, ds[q], ii);
#pragma unroll
        for (int c = 0; c < DC; ++c) gp[q][c] = fmaf(g, qi[c], gp[q][c]);
      }
    }
  }

  float* part = a.dp_part + ((size_t)b * a.H + h) * P * Dh;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = rb + r0 + q;
    if (r >= P) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) part[(size_t)r * Dh + d] = gp[q][c];
    }
  }
}

// ---------------------------------------------------------------- pass 5
__global__ void dp_sum_kernel(Args a) {
  const size_t n = (size_t)a.H * (2 * a.T - 1) * a.Dh;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < a.B; ++b) acc += a.dp_part[(size_t)b * n + e];
    a.dp[e] = acc;
  }
}

template <int DC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t sm_dq = sizeof(float) * smem_floats(5 * kTile + kWin, a.Dh);
  const size_t sm_dp = sizeof(float) * smem_floats(4 * kTile + 2 * kWin, a.Dh);
  static bool attribute_set = false;
  if (!attribute_set) {
    const int dq_max = (int)(sizeof(float) * smem_floats(5 * kTile + kWin, 32 * DC));
    const int dp_max = (int)(sizeof(float) * smem_floats(4 * kTile + 2 * kWin, 32 * DC));
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_max);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dkv_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_max);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dp_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, dp_max);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const size_t rows = (size_t)a.B * a.H * a.T;
  rows_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (a.T + kTile - 1) / kTile;
  dq_kernel<DC><<<dim3(tiles, a.H, a.B), kThreads, sm_dq, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<DC><<<dim3(tiles, a.H, a.B), kThreads, sm_dq, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int ptiles = (2 * a.T - 1 + kTile - 1) / kTile;
  dp_kernel<DC><<<dim3(ptiles, a.H, a.B), kThreads, sm_dp, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dp_sum_kernel<<<264, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Inputs as the forward's (q_u, q_v, k, v, out, dout: (B, H, T, Dh);
// p: (H, 2T-1, Dh); kp: (B, T); am: (T, T); stats: (B, H, T, 2) from
// the forward; seed: one int64 on the device or null for no dropout). Scratch:
// delta (B, H, T), dp_part (B, H, 2T-1, Dh). Outputs: dqu, dqv, dk, dv
// (B, H, T, Dh), dp (H, 2T-1, Dh). All f32, contiguous, on the current
// device. Returns the CUDA error code of the launches (0 on success).
extern "C" int relpos_attention_bwd(
    const float* qu, const float* qv, const float* k, const float* v,
    const float* p, const float* kp, const float* am, const float* out,
    const float* stats, const float* dout, const long long* seed,
    unsigned thresh, float keep_scale, float* delta, float* dqu, float* dqv,
    float* dk, float* dv, float* dp_part, float* dp, int B, int H, int T,
    int Dh, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || Dh < 1 || Dh > 128 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{qu, qv, k, v, p, kp, am, out, stats, dout, seed, thresh, keep_scale,
         scale, delta, dqu, dqv, dk, dv, dp_part, dp, B, H, T, Dh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((Dh + 31) / 32) {
    case 1: err = launch<1>(a, s); break;
    case 2: err = launch<2>(a, s); break;
    case 3: err = launch<3>(a, s); break;
    default: err = launch<4>(a, s); break;
  }
  return (int)err;
}
