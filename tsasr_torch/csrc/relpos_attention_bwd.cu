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
// Products on the tensor cores, at f32 accuracy. Every product (the
// scores, do.v and the four gradient products) is an m16n8k8 mma.sync in
// 3xTF32 (mma_tf32x3.cuh): each f32 operand is split into a TF32 big part
// and a TF32 remainder, and three TF32 products are summed. Plain 1xTF32
// keeps 10 mantissa bits, ~1e-3 of max |g|, ten times the 1e-4 tolerance
// the kernel is held to; 3xTF32, with each k-step's products added to the
// accumulators in f32, reads closer to f64 than the plain f32 version.
//
// Tiling. Tiles are square, TILE queries by TILE keys: 64 for Dh <= 64,
// 32 for Dh up to 128 (shared memory). Dh is zero-padded in shared memory
// to DP = 32, 64 or 128, so the products' register arrays have
// compile-time sizes. Rows in shared memory are DP + 4 floats apart, so
// the fragment loads of 8 rows x 4 columns hit 32 banks. A block has
// TILE / 8 warps: two per group of 16 query rows, one for each half of
// the tile's keys (8 warps for TILE 64, two on each scheduler of the SM,
// whose mma.sync chains are latency-bound with one). For a tile pair:
//
//   - the positional term is a product, then a skew, as the TPU kernel
//     does it: the pair (i0, j0) reads p rows from T - TILE - i0 + j0 on
//     (2 TILE - 1, padded to 2 TILE: the window); row group g's 16 rows
//     need TILE + 15 of them from window row TILE - 16 - 16 g on, so its
//     two warps compute BD = q_v(16 rows) @ win(TILE + 16 rows)^T, half
//     the columns each, into the group's shared buffer, and read the
//     score term of (row rl, key c) at BD[rl][15 - rl + c];
//   - S = q_u k^T and dO v^T are products; P, the dropout (one Philox per
//     accumulator element) and dS are applied in registers.
//
// Passes, each a kernel, all on one stream:
// 1. rows: D = rowsum(do * out), one warp per row;
// 2. dq: one block per (query tile, h, b) over the key tiles. dS goes into
//    the row group's zeroed skew buffer at [rl][15 - rl + c] (dSk); dq_u
//    += dS k and dq_v += dSk @ win, each warp of the group half the
//    columns of Dh;
// 3. dkv: one block per (key tile, h, b) over the query tiles. Pd and
//    then dS go through one shared TILE x TILE buffer, from which each
//    warp reads them transposed for 16 keys and half the columns:
//    dv += Pd^T do, dk += dS^T q_u;
// 4. dp: per tile diagonal d = (j0 - i0) / TILE. Block (x, h, b) walks
//    diagonal x and then x - nt (nt = ceil(T / TILE)): nt pairs in every
//    block, one wave like dq and dkv. Every pair on a diagonal reads the
//    same window, from p row T - TILE + d TILE, so dp_win += dSk^T q_v
//    accumulates in registers along the diagonal (a warp owns 16 window
//    rows; dSk is read skewed from the dS tile, zero off the band) and the
//    block writes one partial of 2 TILE rows per (b, h, d);
// 5. dp sum: p row r lies in the windows of d_hi = floor((r - T + TILE) /
//    TILE) and d_hi - 1; it adds those partials, d_hi - 1 first, each
//    over b in order. The TPU kernel carried dp across a sequential grid
//    axis; Hopper blocks run in no order, so the sum is a second pass:
//    deterministic, no atomics. tests/test_torch_attention_tiling.py
//    mirrors passes 2-5 index for index on the CPU.
//
// Copies: each loop step's tiles and window are loaded with cp.async
// (tile_helpers.cuh, shared with the forward; 16 B a thread when
// Dh % 4 == 0 and the rows are aligned, else 4 B),
// double-buffered, so the next step's copies overlap this step's mma.
// Rows outside [0, T) and columns past Dh are zero-filled by the copy.
// The masks am and kp are read from L2 into registers, all of a tile's
// first, so the loads overlap the products.
//
// What bounds it on an H100: ~16 B*H*T^2*Dh operations (the scores' two
// products, do.v and the four gradient products) at the 3xTF32 rate,
// 495 / 3 TFLOP/s, against reading q_u, q_v, k, v, do, out, p and
// writing five gradients at 3.35 TB/s; at B8 H4 T208 Dh64 that is
// 0.0086 ms of operations against 0.0054 ms of bytes. The kernel
// recomputes every score in each of passes 2-4, pads T up to whole
// tiles and the window to TILE + 16 columns, and spends ALU time on the
// TF32 splits and fragment loads from shared memory (no ldmatrix, no
// wgmma), so it runs far from that bound: at these sizes one wave of
// blocks, latency-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"
#include "philox.cuh"
#include "tile_helpers.cuh"

namespace {

using tsasr::c_col;
using tsasr::c_row;
using tsasr::cp_async_commit;
using tsasr::cp_async_wait;
using tsasr::FragA;
using tsasr::group_sync;
using tsasr::load_a;
using tsasr::load_rows;
using tsasr::mma_tf32x3_row;
using tsasr::row_group;
using tsasr::warp_half;
using tsasr::warp_id;

constexpr int kRowWarps = 4;               // pass 1: one warp per row
constexpr int kWarpRows = 16;              // query rows of a row group
constexpr int kSmemLimit = 232448;         // bytes a block may ask for
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float *qu, *qv, *k, *v, *p, *kp, *am, *out, *stats, *dout;
  const long long* seed;
  uint32_t thresh;
  float keep_scale, scale;
  float *delta, *dqu, *dqv, *dk, *dv, *dp_part, *dp;
  int B, H, T, Dh;
  bool vec;                                // 16-byte copies are aligned
  int h0;                                  // the first head's model index
};

// DP: padded head dim; NR: row groups of 16 in a tile (2 NR warps)
template <int DP, int NR>
struct Cfg {
  static constexpr int kTile = kWarpRows * NR;
  static constexpr int kWarps = 2 * NR;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWin = 2 * kTile;   // a pair's p rows (2 TILE - 1)
  static constexpr int kBW = kTile + kWarpRows;  // a row group's (TILE + 15)
  static constexpr int kNB = kBW / 8;      // its n-tiles, half to each warp
  static constexpr int kWK = kTile / 2;    // keys of a warp's scores
  static constexpr int kNKW = kWK / 8;
  static constexpr int kNK = kTile / 8;    // k-steps over a tile
  static constexpr int kND = DP / 8;       // n-tiles over the head dim
  static constexpr int kNDH = kND / 2;     // a warp's half of them
  static constexpr int kLd = DP + 4;
  static constexpr int kLdB = kBW + 4;
  static constexpr int kLdX = kTile + 4;
  static constexpr int kTileF = kTile * kLd;
  static constexpr int kWinF = kWin * kLd;
  // the row groups' BD / dSk buffers, or (dkv, dp) the block's dS tile
  static constexpr int kScratchF = NR * kWarpRows * kLdB > kTile * kLdX
                                       ? NR * kWarpRows * kLdB
                                       : kTile * kLdX;
  // fixed tiles + two stages + scratch, in floats
  static constexpr int kDqStage = 2 * kTileF + kWinF;   // k, v, window
  static constexpr int kDkvStage = 3 * kTileF + kWinF;  // q_u, q_v, do, win
  static constexpr int kDpStage = 5 * kTileF;           // q_u, q_v, do, k, v
  static constexpr int kDqF = 3 * kTileF + 2 * kDqStage + kScratchF;
  static constexpr int kDkvF = 2 * kTileF + 2 * kDkvStage + kScratchF;
  static constexpr int kDpF = kWinF + 2 * kDpStage + kScratchF;
  static_assert(kNB % 2 == 0 && kND % 2 == 0 && kWin == kWarps * 16,
                "warp shares");
  static_assert(4 * kDqF <= kSmemLimit && 4 * kDkvF <= kSmemLimit &&
                    4 * kDpF <= kSmemLimit,
                "shared memory of a block");
};

// ---------------------------------------------------------- score tile
// (row max, 1 / row sum, D) of this lane's two accumulator rows
struct RowStats {
  float m[2], linv[2], delta[2];
};

__device__ __forceinline__ RowStats row_stats(const Args& a, size_t bh,
                                              int i_first) {
  RowStats st;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t row = bh + min(i_first + c_row(2 * q), a.T - 1);
    st.m[q] = a.stats[2 * row];
    st.linv[q] = a.stats[2 * row + 1];
    st.delta[q] = a.delta[row];
  }
  return st;
}

// dS and Pd of this warp's scores, (16 query rows i0 + 16 g ...) x (TILE
// / 2 keys j0 + half TILE / 2 ...), in accumulator layout; zeros outside
// the lattice. sB is the row group's 16 x (TILE + 16) buffer; it holds BD
// on return.
template <int DP, int NR>
__device__ __forceinline__ void score_tile(
    const Args& a, const float* sQu, const float* sQv, const float* sDo,
    const float* sK, const float* sV, const float* sP, float* sB, int i0,
    int j0, int b, int h, const RowStats& st, uint64_t seed,
    float (&ds)[Cfg<DP, NR>::kNKW][4], float (&pd)[Cfg<DP, NR>::kNKW][4]) {
  using C = Cfg<DP, NR>;
  const int T = a.T;
  const int r0 = row_group<NR>() * kWarpRows, c0 = warp_half<NR>() * C::kWK;
  const int first = C::kTile - kWarpRows - r0;   // the group's window row 0
  // The masks of this lane's scores, loaded unconditionally (indices
  // clamped into the lattice, elements outside it are dropped below)
  // and first, so the loads from L2 overlap the products instead of
  // waiting one by one behind the lattice test.
  float am[C::kNKW][4], kp[C::kNKW][2];
#pragma unroll
  for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = min(i0 + r0 + c_row(e), T - 1);
      const int j = min(j0 + c0 + nt * 8 + c_col(e), T - 1);
      am[nt][e] = a.am[(size_t)i * T + j];
      if (e < 2) kp[nt][e] = a.kp[(size_t)b * T + j];
    }
  {
    constexpr int kHalf = C::kNB / 2;
    const int nb0 = warp_half<NR>() * kHalf;
    float bd[kHalf][4] = {};
    for (int kk = 0; kk < C::kND; ++kk) {
      const FragA q = load_a([&](int m, int k) {
        return sQv[(r0 + m) * C::kLd + kk * 8 + k];
      });
      mma_tf32x3_row(bd, q, [&](int nb, int k, int n) {
        return sP[(first + (nb0 + nb) * 8 + n) * C::kLd + kk * 8 + k];
      });
    }
#pragma unroll
    for (int nb = 0; nb < kHalf; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sB[c_row(e) * C::kLdB + (nb0 + nb) * 8 + c_col(e)] = bd[nb][e];
  }

#pragma unroll
  for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[nt][e] = pd[nt][e] = 0.f;
  for (int kk = 0; kk < C::kND; ++kk) {            // S = q_u k^T
    const FragA q = load_a([&](int m, int k) {
      return sQu[(r0 + m) * C::kLd + kk * 8 + k];
    });
    mma_tf32x3_row(ds, q, [&](int nt, int k, int n) {
      return sK[(c0 + nt * 8 + n) * C::kLd + kk * 8 + k];
    });
  }
  for (int kk = 0; kk < C::kND; ++kk) {            // dO v^T
    const FragA g = load_a([&](int m, int k) {
      return sDo[(r0 + m) * C::kLd + kk * 8 + k];
    });
    mma_tf32x3_row(pd, g, [&](int nt, int k, int n) {
      return sV[(c0 + nt * 8 + n) * C::kLd + kk * 8 + k];
    });
  }
  group_sync<NR>();                                // BD of both halves

#pragma unroll
  for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = c_row(e), c = c0 + nt * 8 + c_col(e), q = e >> 1;
      const int i = i0 + r0 + rl, j = j0 + c;
      float g_ds = 0.f, g_pd = 0.f;
      if (i < T && j < T) {
        const float s =
            (ds[nt][e] + sB[rl * C::kLdB + kWarpRows - 1 - rl + c]) *
                a.scale +
            am[nt][e] + kp[nt][e & 1];
        const float prob = expf(s - st.m[q]) * st.linv[q];
        float dprob = pd[nt][e];
        g_pd = prob;
        if (a.seed != nullptr) {
          const bool keep =
              tsasr::dropout_keep(seed, a.thresh, b, a.h0 + h, i, j);
          g_pd = keep ? prob * a.keep_scale : 0.f;
          dprob = keep ? dprob * a.keep_scale : 0.f;
        }
        g_ds = prob * (dprob - st.delta[q]) * a.scale;
      }
      ds[nt][e] = g_ds;
      pd[nt][e] = g_pd;
    }
}

// x (this warp's scores) into the block's TILE x TILE buffer
template <int DP, int NR>
__device__ __forceinline__ void store_tile(
    float* X, const float (&x)[Cfg<DP, NR>::kNKW][4]) {
  using C = Cfg<DP, NR>;
  const int r0 = row_group<NR>() * kWarpRows, c0 = warp_half<NR>() * C::kWK;
#pragma unroll
  for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      X[(r0 + c_row(e)) * C::kLdX + c0 + nt * 8 + c_col(e)] = x[nt][e];
}

// acc (16 rows from row0, ND n-tiles from column col0) into dst rows
// [0, limit) of width Dh
template <int ND>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[ND][4],
                                           int row0, int limit, int col0,
                                           int Dh) {
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + c_row(e), d = col0 + nd * 8 + c_col(e);
      if (r < limit && d < Dh) dst[(size_t)r * Dh + d] = acc[nd][e];
    }
}

// ---------------------------------------------------------------- pass 1
__global__ void __launch_bounds__(kRowWarps * 32) rows_kernel(Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kRowWarps + warp;
  if (row >= (size_t)a.B * a.H * a.T) return;
  float acc = 0.f;
  for (int d = lane; d < a.Dh; d += 32)
    acc += a.dout[row * a.Dh + d] * a.out[row * a.Dh + d];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) a.delta[row] = acc;
}

// ---------------------------------------------------------------- pass 2
template <int DP, int NR>
__global__ void __launch_bounds__(Cfg<DP, NR>::kThreads, 1)
    dq_kernel(Args a) {
  using C = Cfg<DP, NR>;
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, Dh = a.Dh, nt = (T + C::kTile - 1) / C::kTile;
  const int i0 = blockIdx.x * C::kTile, h = blockIdx.y, b = blockIdx.z;
  const int r0 = row_group<NR>() * kWarpRows;
  const int d0 = warp_half<NR>() * C::kNDH * 8;  // this warp's columns
  const size_t bh = ((size_t)b * a.H + h) * T;
  const float* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;
  float* sQu = smem;
  float* sQv = sQu + C::kTileF;
  float* sDo = sQv + C::kTileF;
  float* stages = sDo + C::kTileF;               // k, v, window
  float* sB = stages + 2 * C::kDqStage + r0 * C::kLdB;

  auto load_keys = [&](int s, int j0) {
    float* st = stages + s * C::kDqStage;
    load_rows<DP, C::kThreads>(st, a.k + bh * Dh, j0, C::kTile, T, Dh, a.vec);
    load_rows<DP, C::kThreads>(st + C::kTileF, a.v + bh * Dh, j0, C::kTile,
                               T, Dh, a.vec);
    load_rows<DP, C::kThreads>(st + 2 * C::kTileF, p_h,
                               T - C::kTile - i0 + j0, C::kWin, 2 * T - 1,
                               Dh, a.vec);
  };
  load_rows<DP, C::kThreads>(sQu, a.qu + bh * Dh, i0, C::kTile, T, Dh, a.vec);
  load_rows<DP, C::kThreads>(sQv, a.qv + bh * Dh, i0, C::kTile, T, Dh, a.vec);
  load_rows<DP, C::kThreads>(sDo, a.dout + bh * Dh, i0, C::kTile, T, Dh,
                             a.vec);
  load_keys(0, 0);
  cp_async_commit();
  const RowStats st = row_stats(a, bh, i0 + r0);
  const int first = C::kTile - kWarpRows - r0;
  float gu[C::kNDH][4] = {}, gv[C::kNDH][4] = {};

  for (int jt = 0; jt < nt; ++jt) {
    if (jt + 1 < nt) {
      load_keys((jt + 1) & 1, (jt + 1) * C::kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = stages + (jt & 1) * C::kDqStage;
    const float* sV = sK + C::kTileF;
    const float* sP = sK + 2 * C::kTileF;
    float ds[C::kNKW][4], pd[C::kNKW][4];
    score_tile<DP, NR>(a, sQu, sQv, sDo, sK, sV, sP, sB, i0, jt * C::kTile,
                       b, h, st, seed, ds, pd);
    // dS into the group's zeroed skew buffer: dSk[rl][15 - rl + c]
    group_sync<NR>();
    for (int e = warp_half<NR>() * 32 + (threadIdx.x & 31);
         e < kWarpRows * C::kLdB; e += 64)
      sB[e] = 0.f;
    group_sync<NR>();
    const int c0 = warp_half<NR>() * C::kWK;
#pragma unroll
    for (int n = 0; n < C::kNKW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sB[c_row(e) * C::kLdB + kWarpRows - 1 - c_row(e) + c0 + n * 8 +
           c_col(e)] = ds[n][e];
    group_sync<NR>();
    for (int kk = 0; kk < C::kNK; ++kk) {        // dq_u += dS k
      const FragA x = load_a([&](int m, int k) {
        return sB[m * C::kLdB + kWarpRows - 1 - m + kk * 8 + k];
      });
      mma_tf32x3_row(gu, x, [&](int nd, int k, int n) {
        return sK[(kk * 8 + k) * C::kLd + d0 + nd * 8 + n];
      });
    }
    for (int kk = 0; kk < C::kNB; ++kk) {        // dq_v += dSk win
      const FragA x = load_a([&](int m, int k) {
        return sB[m * C::kLdB + kk * 8 + k];
      });
      mma_tf32x3_row(gv, x, [&](int nd, int k, int n) {
        return sP[(first + kk * 8 + k) * C::kLd + d0 + nd * 8 + n];
      });
    }
    __syncthreads();
  }
  store_rows(a.dqu + bh * Dh, gu, i0 + r0, T, d0, Dh);
  store_rows(a.dqv + bh * Dh, gv, i0 + r0, T, d0, Dh);
}

// dst += X^T Y for this warp's 16 keys (columns of X from 16 g) and half
// of Y's columns, over the TILE rows of X and Y
template <int DP, int NR>
__device__ __forceinline__ void add_transposed_product(
    float (&dst)[Cfg<DP, NR>::kNDH][4], const float* X, const float* Y) {
  using C = Cfg<DP, NR>;
  const int r0 = row_group<NR>() * kWarpRows;
  const int d0 = warp_half<NR>() * C::kNDH * 8;
  for (int kk = 0; kk < C::kNK; ++kk) {
    const FragA x = load_a([&](int m, int k) {
      return X[(kk * 8 + k) * C::kLdX + r0 + m];
    });
    mma_tf32x3_row(dst, x, [&](int nd, int k, int n) {
      return Y[(kk * 8 + k) * C::kLd + d0 + nd * 8 + n];
    });
  }
}

// ---------------------------------------------------------------- pass 3
template <int DP, int NR>
__global__ void __launch_bounds__(Cfg<DP, NR>::kThreads, 1)
    dkv_kernel(Args a) {
  using C = Cfg<DP, NR>;
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, Dh = a.Dh, nt = (T + C::kTile - 1) / C::kTile;
  const int j0 = blockIdx.x * C::kTile, h = blockIdx.y, b = blockIdx.z;
  const int r0 = row_group<NR>() * kWarpRows;
  const size_t bh = ((size_t)b * a.H + h) * T;
  const float* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;
  float* sK = smem;
  float* sV = sK + C::kTileF;
  float* stages = sV + C::kTileF;                // q_u, q_v, do, window
  float* X = stages + 2 * C::kDkvStage;          // dS tile, or BD buffers
  float* sB = X + r0 * C::kLdB;

  auto load_queries = [&](int s, int i0) {
    float* st = stages + s * C::kDkvStage;
    load_rows<DP, C::kThreads>(st, a.qu + bh * Dh, i0, C::kTile, T, Dh,
                               a.vec);
    load_rows<DP, C::kThreads>(st + C::kTileF, a.qv + bh * Dh, i0, C::kTile,
                               T, Dh, a.vec);
    load_rows<DP, C::kThreads>(st + 2 * C::kTileF, a.dout + bh * Dh, i0,
                               C::kTile, T, Dh, a.vec);
    load_rows<DP, C::kThreads>(st + 3 * C::kTileF, p_h,
                               T - C::kTile - i0 + j0, C::kWin, 2 * T - 1,
                               Dh, a.vec);
  };
  load_rows<DP, C::kThreads>(sK, a.k + bh * Dh, j0, C::kTile, T, Dh, a.vec);
  load_rows<DP, C::kThreads>(sV, a.v + bh * Dh, j0, C::kTile, T, Dh, a.vec);
  load_queries(0, 0);
  cp_async_commit();
  float gk[C::kNDH][4] = {}, gv[C::kNDH][4] = {};

  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) {
      load_queries((it + 1) & 1, (it + 1) * C::kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = it * C::kTile;
    const float* sQu = stages + (it & 1) * C::kDkvStage;
    const float* sQv = sQu + C::kTileF;
    const float* sDo = sQu + 2 * C::kTileF;
    const float* sP = sQu + 3 * C::kTileF;
    const RowStats st = row_stats(a, bh, i0 + r0);
    float ds[C::kNKW][4], pd[C::kNKW][4];
    score_tile<DP, NR>(a, sQu, sQv, sDo, sK, sV, sP, sB, i0, j0, b, h, st,
                       seed, ds, pd);
    __syncthreads();                             // X held the BD buffers
    store_tile<DP, NR>(X, pd);
    __syncthreads();
    add_transposed_product<DP, NR>(gv, X, sDo);  // dv += Pd^T do
    __syncthreads();
    store_tile<DP, NR>(X, ds);
    __syncthreads();
    add_transposed_product<DP, NR>(gk, X, sQu);  // dk += dS^T q_u
    __syncthreads();
  }
  const int d0 = warp_half<NR>() * C::kNDH * 8;
  store_rows(a.dk + bh * Dh, gk, j0 + r0, T, d0, Dh);
  store_rows(a.dv + bh * Dh, gv, j0 + r0, T, d0, Dh);
}

// ---------------------------------------------------------------- pass 4
template <int DP, int NR>
__global__ void __launch_bounds__(Cfg<DP, NR>::kThreads, 1)
    dp_kernel(Args a) {
  using C = Cfg<DP, NR>;
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, Dh = a.Dh, nt = (T + C::kTile - 1) / C::kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = row_group<NR>() * kWarpRows;
  const int wr0 = warp_id() * 16;                // this warp's window rows
  const size_t bh = ((size_t)b * a.H + h) * T;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;
  float* sP = smem;                              // the diagonal's window
  float* stages = sP + C::kWinF;                 // q_u, q_v, do, k, v
  float* X = stages + 2 * C::kDpStage;
  float* sB = X + r0 * C::kLdB;

  auto load_pair = [&](int s, int i0, int j0) {
    float* st = stages + s * C::kDpStage;
    const float* src[5] = {a.qu, a.qv, a.dout, a.k, a.v};
#pragma unroll
    for (int x = 0; x < 5; ++x)
      load_rows<DP, C::kThreads>(st + x * C::kTileF, src[x] + bh * Dh,
                                 x < 3 ? i0 : j0, C::kTile, T, Dh, a.vec);
  };

  // block x walks diagonal x (nt - x pairs), then x - nt (x pairs): nt
  // pairs in every block, one window each
  for (int d = blockIdx.x; d > -nt; d -= nt) {
    load_rows<DP, C::kThreads>(sP, a.p + (size_t)h * (2 * T - 1) * Dh,
                               T - C::kTile + d * C::kTile, C::kWin,
                               2 * T - 1, Dh, a.vec);
    const int it_lo = max(0, -d), it_hi = min(nt, nt - d);
    load_pair(0, it_lo * C::kTile, (it_lo + d) * C::kTile);
    cp_async_commit();
    float acc[C::kND][4] = {};

    for (int it = it_lo; it < it_hi; ++it) {
      const int s = (it - it_lo) & 1;
      if (it + 1 < it_hi) {
        load_pair(s ^ 1, (it + 1) * C::kTile, (it + 1 + d) * C::kTile);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int i0 = it * C::kTile;
      const float* sQu = stages + s * C::kDpStage;
      const float* sQv = sQu + C::kTileF;
      const RowStats st = row_stats(a, bh, i0 + r0);
      float ds[C::kNKW][4], pd[C::kNKW][4];
      score_tile<DP, NR>(a, sQu, sQv, sQu + 2 * C::kTileF,
                         sQu + 3 * C::kTileF, sQu + 4 * C::kTileF, sP, sB, i0,
                         i0 + d * C::kTile, b, h, st, seed, ds, pd);
      __syncthreads();
      store_tile<DP, NR>(X, ds);
      __syncthreads();
      // dp_win += dSk^T q_v, dSk[r][col] = dS[r][col - (TILE - 1) + r]
      for (int kk = 0; kk < C::kNK; ++kk) {
        // rows 8 kk.. meet columns wr0..wr0+15 only inside the band
        if (8 * kk + 7 < C::kTile - 16 - wr0 || 8 * kk > 2 * C::kTile - 2 - wr0)
          continue;
        const FragA x = load_a([&](int m, int k) {
          const int r = kk * 8 + k, c = wr0 + m - (C::kTile - 1) + r;
          return (c >= 0 && c < C::kTile) ? X[r * C::kLdX + c] : 0.f;
        });
        mma_tf32x3_row(acc, x, [&](int nd, int k, int n) {
          return sQv[(kk * 8 + k) * C::kLd + nd * 8 + n];
        });
      }
      __syncthreads();
    }
    float* part = a.dp_part +
                  (((size_t)b * a.H + h) * (2 * nt - 1) + d + nt - 1) *
                      C::kWin * Dh;
    store_rows(part, acc, wr0, C::kWin, 0, Dh);
  }
}

// ---------------------------------------------------------------- pass 5
__global__ void dp_sum_kernel(Args a, int tile) {
  const int T = a.T, P = 2 * T - 1, nt = (T + tile - 1) / tile;
  const size_t n = (size_t)a.H * P * a.Dh;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % a.Dh), r = (int)((e / a.Dh) % P);
    const int h = (int)(e / ((size_t)P * a.Dh));
    const int u = r - (T - tile);
    const int d_hi = u >= 0 ? u / tile : -((tile - 1 - u) / tile);
    float acc = 0.f;
    for (int d = d_hi - 1; d <= d_hi; ++d) {
      const int wr = r - (T - tile + d * tile);
      if (d < -(nt - 1) || d > nt - 1 || wr < 0 || wr >= 2 * tile) continue;
      for (int b = 0; b < a.B; ++b)
        acc += a.dp_part[((((size_t)b * a.H + h) * (2 * nt - 1) + d + nt - 1) *
                              (2 * tile) + wr) * a.Dh + c];
    }
    a.dp[e] = acc;
  }
}

template <int DP, int NR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<DP, NR>;
  static bool attribute_set = false;
  cudaError_t err;
  if (!attribute_set) {
    err = cudaFuncSetAttribute(dq_kernel<DP, NR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * C::kDqF);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dkv_kernel<DP, NR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 4 * C::kDkvF);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dp_kernel<DP, NR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 4 * C::kDpF);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const size_t rows = (size_t)a.B * a.H * a.T;
  rows_kernel<<<(unsigned)((rows + kRowWarps - 1) / kRowWarps),
                kRowWarps * 32, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((a.T + C::kTile - 1) / C::kTile, a.H, a.B);
  dq_kernel<DP, NR><<<grid, C::kThreads, 4 * C::kDqF, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<DP, NR><<<grid, C::kThreads, 4 * C::kDkvF, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dp_kernel<DP, NR><<<grid, C::kThreads, 4 * C::kDpF, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dp_sum_kernel<<<264, 256, 0, stream>>>(a, C::kTile);
  return cudaGetLastError();
}

int tile_for(int Dh) {
  return Dh <= 64 ? Cfg<64, 4>::kTile : Cfg<128, 2>::kTile;
}

bool aligned16(const void* x) { return ((uintptr_t)x & 15) == 0; }

// C = A @ B for row-major A (M x K) and B (K x N), one warp per 16 x 8
// tile of C, through the 3xTF32 helper (a test of its fragment layout)
__global__ void tf32x3_matmul_kernel(const float* a, const float* b,
                                     float* c, int M, int N, int K) {
  const int m0 = blockIdx.x * 16, n0 = blockIdx.y * 8;
  float acc[1][4] = {};
  for (int k0 = 0; k0 < K; k0 += 8) {
    const FragA x = load_a([&](int m, int k) {
      return (m0 + m < M && k0 + k < K) ? a[(size_t)(m0 + m) * K + k0 + k]
                                        : 0.f;
    });
    mma_tf32x3_row(acc, x, [&](int, int k, int n) {
      return (k0 + k < K && n0 + n < N) ? b[(size_t)(k0 + k) * N + n0 + n]
                                        : 0.f;
    });
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = m0 + c_row(e), col = n0 + c_col(e);
    if (r < M && col < N) c[(size_t)r * N + col] = acc[0][e];
  }
}

}  // namespace

// Inputs as the forward's (q_u, q_v, k, v, out, dout: (B, H, T, Dh);
// p: (H, 2T-1, Dh); kp: (B, T); am: (T, T); stats: (B, H, T, 2) from
// the forward; seed: one int64 on the device or null for no dropout).
// Scratch: delta (B, H, T), dp_part of relpos_attention_bwd_dp_part_floats
// floats. Outputs: dqu, dqv, dk, dv (B, H, T, Dh), dp (H, 2T-1, Dh). All
// f32, contiguous, on the current device. h0: the first head's index
// among the model's, as the forward's. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int relpos_attention_bwd(
    const float* qu, const float* qv, const float* k, const float* v,
    const float* p, const float* kp, const float* am, const float* out,
    const float* stats, const float* dout, const long long* seed,
    unsigned thresh, float keep_scale, float* delta, float* dqu, float* dqv,
    float* dk, float* dv, float* dp_part, float* dp, int B, int H, int T,
    int Dh, float scale, void* stream, int h0) {
  if (B < 1 || H < 1 || T < 1 || Dh < 1 || Dh > 128 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = Dh % 4 == 0 && aligned16(qu) && aligned16(qv) &&
                   aligned16(k) && aligned16(v) && aligned16(p) &&
                   aligned16(dout);
  Args a{qu, qv, k, v, p, kp, am, out, stats, dout, seed, thresh, keep_scale,
         scale, delta, dqu, dqv, dk, dv, dp_part, dp, B, H, T, Dh, vec, h0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Dh <= 32)
    err = launch<32, 4>(a, s);
  else if (Dh <= 64)
    err = launch<64, 4>(a, s);
  else
    err = launch<128, 2>(a, s);
  return (int)err;
}

// Floats of relpos_attention_bwd's dp_part scratch: one partial of 2 TILE
// window rows per (b, h, tile diagonal).
extern "C" long long relpos_attention_bwd_dp_part_floats(int B, int H, int T,
                                                         int Dh) {
  const long long tile = tile_for(Dh), nt = (T + tile - 1) / tile;
  return (long long)B * H * (2 * nt - 1) * 2 * tile * Dh;
}

// c = a @ b through the 3xTF32 mma helper (a: M x K, b: K x N, row-major
// f32 on the current device), for tests. Returns the CUDA error code.
extern "C" int relpos_tf32x3_matmul_test(const float* a, const float* b,
                                         float* c, int M, int N, int K,
                                         void* stream) {
  if (M < 1 || N < 1 || K < 1 || (N + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  tf32x3_matmul_kernel<<<dim3((M + 15) / 16, (N + 7) / 8), 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, b, c, M, N,
                                                              K);
  return (int)cudaGetLastError();
}

// ===================================================================== bf16
// The bf16 variant: q_u, q_v, k, v, p, out and do in bf16, the gradients
// in bf16, the masks and the statistics f32. It rounds where the JAX
// kernel rounds with bf16 operands (_bwd_kernel with cdt = bf16): every
// product takes bf16 operands and sums in f32 (mma_bf16.cuh); dv =
// bf16(Pd)^T do; dP = do v^T and the softmax jacobian in f32; D_i =
// sum_j P_ij dP_ij, the JAX kernel's "row", in f32 from the scores (with
// a bf16 out, do_i . out_i would carry out's rounding into every dS of
// the row, coherently: on peaked rows it doubled the gradients' error
// against f64 in the plain version); dS rounded to bf16 once, which is
// both the JAX kernel's ds (for dq_u and dk) and its un-shifted dbdf (for
// dq_v and dp: the un-shift only moves elements); dp summed over the
// batch in f32 and rounded to bf16 once.
//
// What bounds it on an H100: ~16 B H T^2 Dh operations of products at the
// bf16 tensor-core peak (989 TFLOP/s) against the bytes of the bf16
// operands, outputs and f32 masks at 3.35 TB/s; at B8 H4 T208 Dh64, 0.0014
// ms of operations against 0.0025 ms of bytes.
//
// The resident route (relpos_attention_bwd_bf16) computes each score
// once, as the TPU kernel computes its probs once per (h, batch block) in
// VMEM and derives all five gradients from them: each score element's
// three products, its expf and its Philox draw happen once per backward.
// Three launches:
//
//   1. rows (rows16_kernel): a block takes TQ = 16 query rows of one
//      (b, h) and streams three sequences of 64-row chunks through one
//      ring of cp.async stages (Rows16: 4 warps, 2 stages): the window of
//      p rows, k, then v. As the resident forward, the window's products
//      q_v win^T are stored skewed into the f32 score rows S (window row w
//      meets row r at key w + r - 15) and q_u k^T is added in place; dP =
//      do v^T goes to a second set of f32 rows G. Then a warp a row: s + am
//      + kp, P = exp(s - m) / l from the forward's statistics, the keep
//      bit, Pd and the dropped dP, P and dP back in place, Pd (bf16) to a
//      (B, H, T, roundup(T, 64)) scratch; D exactly over the row; dS =
//      bf16(P (dP - D) scale) to a second such scratch. 16 T 8 bytes of
//      rows a block (52 KB at T 408): 832 blocks at B8 H4 T408, where the
//      long route's passes run one wave of 128.
//   2. columns (cols16_kernel), one launch of 3 nt blocks a (h, b) (nt =
//      ceil(T / TILE), TILE 64 at Dh <= 64, 32 above; the long route's
//      tiles and warps, two a row group of 16, each half of Dh), each over
//      its tile pairs in order, the score tiles read from the scratch:
//      block x < nt takes key tile x, dv += Pd^T do and dk += dS^T q_u (dS
//      and Pd read transposed by ldmatrix); block nt + x query tile x,
//      dq_u += dS k and dq_v += dSk win (dSk[r][w] = dS[r][w + r - 15]
//      read skewed from the dS tile, the window of 2 TILE p rows from T -
//      TILE - i0 + j0);
//      block 2 nt + x walks tile diagonals x and x - nt as the long
//      route's dp pass does, dp_win += dSk^T q_v, one f32 partial of 2
//      TILE window rows per (b, h, diagonal). No score product, no expf,
//      no Philox draw here.
//   3. dp sum (dp16_sum_kernel): p row r adds the partials of the two
//      diagonals whose windows hold it, each over b in order.
// Every sum across blocks runs in a fixed order (no atomics): two calls
// give identical bits. tests/test_torch_attention_tiling.py mirrors the
// three passes index for index on the CPU (tiled_backward_bf16).
//
// What bounds the resident route: the rows pass holds 16 rows of f32 P
// and dP beside its tiles, so T is at most relpos_attention_bwd_bf16_max_t
// (1600 at Dh 33-64, 1696 at Dh <= 32, 1424 above; 227 KB a block); the
// scratch is 4 B H T roundup(T, 64) bytes, written once and read 2.5
// times (23.4 MB at B8 H4 T408, 8.8 MB at B3 T408: inside the 50 MB L2).
// At these sizes both passes are latency-bound: at T 408 the rows
// block's 79 KB leave an SM two blocks (8 warps), each serial over its 21
// chunks; the columns blocks run two an SM (128 registers).
//
// Sweep (chip_attention_ab.py --backward over edited copies of this
// source, H100 80GB HBM3 700.00 W; device ms, profiler, dropout 0; B8 T101
// / B8 T208 / B8 T408 / B6 T208 / B3 T408, all H4 Dh64): the layout
// chosen .0254 / .0535 / .1648 / .0481 / .0745 (rows pass .0888 at B8
// T408, columns .0607, dp sum .0099); dq_u and dq_v in the rows pass over
// a second k and window stream (dS and dSk laid in bf16 over S and G):
// .0270 / .0541 / .1906 / .0477 / .0968; that with 8 warps: 0.86-1.14x of
// it (behind at T 208: two blocks an SM by registers); 3 stages 0.84-1.04x;
// chunks of 32 0.92-1.19x; the chosen layout with 8 warps .0246 / .0578 /
// .1516 / .0523 / .0672 (ahead at T 408, behind at T 208); the first
// elementwise sweep folded into the v chunks' epilogues (k and v chunks in
// turn, P and dP from the mma registers): .0264 / .0584 / .1680 / .0514 /
// .0810, behind everywhere: the time is in the chunk loop's latency, not
// in the sweeps.
//
// The long route (relpos_attention_bwd_bf16_long), past max_t: five
// passes, which hold no row of scores: (1) delta, a sweep over the
// keys of each query tile with the score and dP products; (2)-(4) the
// f32 kernel's dq, dkv and dp passes, tiles in bf16 (rows DP + 8
// elements apart), fragments by ldmatrix where the rows are contiguous
// and by functors on the skewed reads, each recomputing every score of
// its tile pairs; (5) the dp sum. One wave of blocks, latency-bound.

#include "mma_bf16.cuh"

namespace {

using tsasr::bf16;
using tsasr::FragA16;
using tsasr::ldsm_a;
using tsasr::ldsm_a_trans;
using tsasr::load_a16;
using tsasr::load_rows16;
using tsasr::mma_row_kmajor;
using tsasr::mma_row_nmajor;
using tsasr::pair_sync;

struct Args16 {
  const bf16 *qu, *qv, *k, *v, *p, *dout;
  const float *kp, *am, *stats;
  const long long* seed;
  uint32_t thresh;
  float keep_scale, scale;
  float* delta;
  bf16 *dqu, *dqv, *dk, *dv;
  float* dp_part;
  bf16* dp;
  int B, H, T, Dh;
  bool vec;                                // 16-byte copies are aligned
  bf16 *ds, *pd;                           // the resident route's scratch
  int h0;                                  // the first head's model index
};

// DP: padded head dim; NR: row groups of 16 in a tile (2 NR warps). Tile
// sizes in bf16 elements, the byte counts named so.
template <int DP, int NR>
struct Cfg16 {
  static constexpr int kTile = kWarpRows * NR;
  static constexpr int kWarps = 2 * NR;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWin = 2 * kTile;
  static constexpr int kBW = kTile + kWarpRows;
  static constexpr int kNB = kBW / 8;
  static constexpr int kWK = kTile / 2;
  static constexpr int kNKW = kWK / 8;
  static constexpr int kND = DP / 8;
  static constexpr int kNDH = kND / 2;
  static constexpr int kLd = DP + 8;
  static constexpr int kLdB = kBW + 4;     // f32 BD buffer rows (floats)
  static constexpr int kLdS = kBW + 8;     // bf16 dS skew buffer rows
  static constexpr int kLdX = kTile + 8;   // bf16 Pd / dS tile rows
  static constexpr int kTileE = kTile * kLd;
  static constexpr int kWinE = kWin * kLd;
  static constexpr int kScratchBytes =
      4 * NR * kWarpRows * kLdB > 2 * kTile * kLdX ? 4 * NR * kWarpRows * kLdB
                                                   : 2 * kTile * kLdX;
  static constexpr int kDqStage = 2 * kTileE + kWinE;    // k, v, window
  static constexpr int kDkvStage = 3 * kTileE + kWinE;   // q_u, q_v, do, win
  static constexpr int kDpStage = 5 * kTileE;            // q_u, q_v, do, k, v
  static constexpr int kDqTiles = 3 * kTileE + 2 * kDqStage;
  static constexpr int kDkvTiles = 2 * kTileE + 2 * kDkvStage;
  static constexpr int kDpTiles = kWinE + 2 * kDpStage;
  static constexpr int kDqBytes = 2 * kDqTiles + kScratchBytes;
  static constexpr int kDkvBytes = 2 * kDkvTiles + kScratchBytes;
  static constexpr int kDpBytes = 2 * kDpTiles + kScratchBytes;
  static_assert(kND % 2 == 0 && kWin == kWarps * 16 && kBW % 16 == 0,
                "warp shares");
  static_assert(2 * kWarpRows * kLdS <= 4 * kWarpRows * kLdB,
                "dS skew buffer in the BD buffer");
  static_assert(kDqBytes <= kSmemLimit && kDkvBytes <= kSmemLimit &&
                    kDpBytes <= kSmemLimit,
                "shared memory of a block");
};

__device__ __forceinline__ RowStats row_stats16(const Args16& a, size_t bh,
                                                int i_first, bool delta) {
  RowStats st;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t row = bh + min(i_first + c_row(2 * q), a.T - 1);
    st.m[q] = a.stats[2 * row];
    st.linv[q] = a.stats[2 * row + 1];
    st.delta[q] = delta ? a.delta[row] : 0.f;
  }
  return st;
}

// This warp's scores as score_tile has them, from bf16 tiles: Pd, and dS
// = P (dP - D) scale, or with kRaw P dP (pass 1's terms of D). sB is the
// row group's f32 16 x (TILE + 16) buffer; it holds BD on return.
template <int DP, int NR, bool kRaw>
__device__ __forceinline__ void score_tile16(
    const Args16& a, const bf16* sQu, const bf16* sQv, const bf16* sDo,
    const bf16* sK, const bf16* sV, const bf16* sP, float* sB, int i0,
    int j0, int b, int h, const RowStats& st, uint64_t seed,
    float (&ds)[Cfg16<DP, NR>::kNKW][4],
    float (&pd)[Cfg16<DP, NR>::kNKW][4]) {
  using C = Cfg16<DP, NR>;
  const int T = a.T;
  const int grp = row_group<NR>();
  const int r0 = grp * kWarpRows, c0 = warp_half<NR>() * C::kWK;
  const int first = C::kTile - kWarpRows - r0;
  float am[C::kNKW][4], kp[C::kNKW][2];
#pragma unroll
  for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = min(i0 + r0 + c_row(e), T - 1);
      const int j = min(j0 + c0 + nt * 8 + c_col(e), T - 1);
      am[nt][e] = a.am[(size_t)i * T + j];
      if (e < 2) kp[nt][e] = a.kp[(size_t)b * T + j];
    }
  {
    constexpr int kHalf = C::kNB / 2;
    const int nb0 = warp_half<NR>() * kHalf;
    float bd[kHalf][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_row_nmajor<kHalf>(bd, ldsm_a(sQv + r0 * C::kLd + kk * 16, C::kLd),
                            sP + (first + nb0 * 8) * C::kLd + kk * 16,
                            C::kLd);
#pragma unroll
    for (int nb = 0; nb < kHalf; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sB[c_row(e) * C::kLdB + (nb0 + nb) * 8 + c_col(e)] = bd[nb][e];
  }
#pragma unroll
  for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[nt][e] = pd[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {           // S = q_u k^T, dO v^T
    mma_row_nmajor<C::kNKW>(ds, ldsm_a(sQu + r0 * C::kLd + kk * 16, C::kLd),
                            sK + c0 * C::kLd + kk * 16, C::kLd);
    mma_row_nmajor<C::kNKW>(pd, ldsm_a(sDo + r0 * C::kLd + kk * 16, C::kLd),
                            sV + c0 * C::kLd + kk * 16, C::kLd);
  }
  pair_sync(grp);                                  // BD of both halves

#pragma unroll
  for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = c_row(e), c = c0 + nt * 8 + c_col(e), q = e >> 1;
      const int i = i0 + r0 + rl, j = j0 + c;
      float g_ds = 0.f, g_pd = 0.f;
      if (i < T && j < T) {
        const float s =
            (ds[nt][e] + sB[rl * C::kLdB + kWarpRows - 1 - rl + c]) *
                a.scale +
            am[nt][e] + kp[nt][e & 1];
        const float prob = expf(s - st.m[q]) * st.linv[q];
        float dprob = pd[nt][e];
        g_pd = prob;
        if (a.seed != nullptr) {
          const bool keep =
              tsasr::dropout_keep(seed, a.thresh, b, a.h0 + h, i, j);
          g_pd = keep ? prob * a.keep_scale : 0.f;
          dprob = keep ? dprob * a.keep_scale : 0.f;
        }
        g_ds = kRaw ? prob * dprob : prob * (dprob - st.delta[q]) * a.scale;
      }
      ds[nt][e] = g_ds;
      pd[nt][e] = g_pd;
    }
}

// x (this warp's scores) rounded into the block's bf16 TILE x TILE buffer
template <int DP, int NR>
__device__ __forceinline__ void store_tile16(
    bf16* X, const float (&x)[Cfg16<DP, NR>::kNKW][4]) {
  using C = Cfg16<DP, NR>;
  const int r0 = row_group<NR>() * kWarpRows, c0 = warp_half<NR>() * C::kWK;
#pragma unroll
  for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      X[(r0 + c_row(e)) * C::kLdX + c0 + nt * 8 + c_col(e)] =
          __float2bfloat16_rn(x[nt][e]);
}

template <int ND>
__device__ __forceinline__ void store_rows16(bf16* dst,
                                             const float (&acc)[ND][4],
                                             int row0, int limit, int col0,
                                             int Dh) {
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + c_row(e), d = col0 + nd * 8 + c_col(e);
      if (r < limit && d < Dh)
        dst[(size_t)r * Dh + d] = __float2bfloat16_rn(acc[nd][e]);
    }
}

// ------------------------------------------------------- passes 1 and 2
// One block per (query tile, h, b) over the key tiles. kDelta: pass 1,
// D_i = sum_j P_ij dP_ij into delta (the two halves of a row group summed
// in a fixed order); else pass 2, dq_u and dq_v.
template <int DP, int NR, bool kDelta>
__global__ void __launch_bounds__(Cfg16<DP, NR>::kThreads, 1)
    dq16_kernel(Args16 a) {
  using C = Cfg16<DP, NR>;
  extern __shared__ __align__(16) unsigned char smem16[];
  const int T = a.T, Dh = a.Dh, nt = (T + C::kTile - 1) / C::kTile;
  const int i0 = blockIdx.x * C::kTile, h = blockIdx.y, b = blockIdx.z;
  const int grp = row_group<NR>(), half = warp_half<NR>();
  const int r0 = grp * kWarpRows;
  const int d0 = half * C::kNDH * 8;             // this warp's columns
  const size_t bh = ((size_t)b * a.H + h) * T;
  const bf16* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;
  bf16* sQu = reinterpret_cast<bf16*>(smem16);
  bf16* sQv = sQu + C::kTileE;
  bf16* sDo = sQv + C::kTileE;
  bf16* stages = sDo + C::kTileE;                // k, v, window
  float* sB = reinterpret_cast<float*>(smem16 + 2 * C::kDqTiles) +
              r0 * C::kLdB;
  bf16* sS = reinterpret_cast<bf16*>(sB);        // dS skew buffer

  auto load_keys = [&](int s, int j0) {
    bf16* st = stages + s * C::kDqStage;
    load_rows16<DP, C::kThreads>(st, a.k + bh * Dh, j0, C::kTile, T, Dh,
                                 a.vec);
    load_rows16<DP, C::kThreads>(st + C::kTileE, a.v + bh * Dh, j0, C::kTile,
                                 T, Dh, a.vec);
    load_rows16<DP, C::kThreads>(st + 2 * C::kTileE, p_h,
                                 T - C::kTile - i0 + j0, C::kWin, 2 * T - 1,
                                 Dh, a.vec);
  };
  load_rows16<DP, C::kThreads>(sQu, a.qu + bh * Dh, i0, C::kTile, T, Dh,
                               a.vec);
  load_rows16<DP, C::kThreads>(sQv, a.qv + bh * Dh, i0, C::kTile, T, Dh,
                               a.vec);
  load_rows16<DP, C::kThreads>(sDo, a.dout + bh * Dh, i0, C::kTile, T, Dh,
                               a.vec);
  load_keys(0, 0);
  cp_async_commit();
  const RowStats st = row_stats16(a, bh, i0 + r0, !kDelta);
  const int first = C::kTile - kWarpRows - r0;
  float gu[C::kNDH][4] = {}, gv[C::kNDH][4] = {};
  float dsum[2] = {0.f, 0.f};

  for (int jt = 0; jt < nt; ++jt) {
    if (jt + 1 < nt) {
      load_keys((jt + 1) & 1, (jt + 1) * C::kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = stages + (jt & 1) * C::kDqStage;
    const bf16* sV = sK + C::kTileE;
    const bf16* sP = sK + 2 * C::kTileE;
    float ds[C::kNKW][4], pd[C::kNKW][4];
    score_tile16<DP, NR, kDelta>(a, sQu, sQv, sDo, sK, sV, sP, sB, i0,
                                 jt * C::kTile, b, h, st, seed, ds, pd);
    if (kDelta) {
#pragma unroll
      for (int n = 0; n < C::kNKW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] += ds[n][e];
      __syncthreads();
      continue;
    }
    // bf16 dS into the group's zeroed skew buffer: dSk[rl][15 - rl + c]
    pair_sync(grp);
    for (int e = half * 32 + (threadIdx.x & 31); e < kWarpRows * C::kLdS;
         e += 64)
      sS[e] = __float2bfloat16(0.f);
    pair_sync(grp);
    const int c0 = half * C::kWK;
#pragma unroll
    for (int n = 0; n < C::kNKW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sS[c_row(e) * C::kLdS + kWarpRows - 1 - c_row(e) + c0 + n * 8 +
           c_col(e)] = __float2bfloat16_rn(ds[n][e]);
    pair_sync(grp);
#pragma unroll
    for (int kk = 0; kk < C::kTile / 16; ++kk) {  // dq_u += dS k
      const FragA16 x = load_a16([&](int m, int k) {
        return sS[m * C::kLdS + kWarpRows - 1 - m + kk * 16 + k];
      });
      mma_row_kmajor<C::kNDH>(gu, x, sK + kk * 16 * C::kLd + d0, C::kLd);
    }
#pragma unroll
    for (int kk = 0; kk < C::kBW / 16; ++kk)      // dq_v += dSk win
      mma_row_kmajor<C::kNDH>(gv, ldsm_a(sS + kk * 16, C::kLdS),
                              sP + (first + kk * 16) * C::kLd + d0, C::kLd);
    __syncthreads();
  }
  if (kDelta) {
    float* red = reinterpret_cast<float*>(stages);  // idle after the loop
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      dsum[q] += __shfl_xor_sync(0xffffffffu, dsum[q], 1);
      dsum[q] += __shfl_xor_sync(0xffffffffu, dsum[q], 2);
      red[((2 * grp + half) * 2 + q) * 32 + lane] = dsum[q];
    }
    pair_sync(grp);
    if (half == 0 && tsasr::lane_t() == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = i0 + r0 + tsasr::lane_g() + 8 * q;
        if (i < T)
          a.delta[bh + i] = red[((2 * grp) * 2 + q) * 32 + lane] +
                            red[((2 * grp + 1) * 2 + q) * 32 + lane];
      }
    }
    return;
  }
  store_rows16(a.dqu + bh * Dh, gu, i0 + r0, T, d0, Dh);
  store_rows16(a.dqv + bh * Dh, gv, i0 + r0, T, d0, Dh);
}

// ---------------------------------------------------------------- pass 3
template <int DP, int NR>
__global__ void __launch_bounds__(Cfg16<DP, NR>::kThreads, 1)
    dkv16_kernel(Args16 a) {
  using C = Cfg16<DP, NR>;
  extern __shared__ __align__(16) unsigned char smem16[];
  const int T = a.T, Dh = a.Dh, nt = (T + C::kTile - 1) / C::kTile;
  const int j0 = blockIdx.x * C::kTile, h = blockIdx.y, b = blockIdx.z;
  const int r0 = row_group<NR>() * kWarpRows;
  const int d0 = warp_half<NR>() * C::kNDH * 8;
  const size_t bh = ((size_t)b * a.H + h) * T;
  const bf16* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;
  bf16* sK = reinterpret_cast<bf16*>(smem16);
  bf16* sV = sK + C::kTileE;
  bf16* stages = sV + C::kTileE;                 // q_u, q_v, do, window
  unsigned char* scratch = smem16 + 2 * C::kDkvTiles;
  bf16* X = reinterpret_cast<bf16*>(scratch);    // Pd or dS tile
  float* sB = reinterpret_cast<float*>(scratch) + r0 * C::kLdB;

  auto load_queries = [&](int s, int i0) {
    bf16* st = stages + s * C::kDkvStage;
    load_rows16<DP, C::kThreads>(st, a.qu + bh * Dh, i0, C::kTile, T, Dh,
                                 a.vec);
    load_rows16<DP, C::kThreads>(st + C::kTileE, a.qv + bh * Dh, i0,
                                 C::kTile, T, Dh, a.vec);
    load_rows16<DP, C::kThreads>(st + 2 * C::kTileE, a.dout + bh * Dh, i0,
                                 C::kTile, T, Dh, a.vec);
    load_rows16<DP, C::kThreads>(st + 3 * C::kTileE, p_h,
                                 T - C::kTile - i0 + j0, C::kWin, 2 * T - 1,
                                 Dh, a.vec);
  };
  load_rows16<DP, C::kThreads>(sK, a.k + bh * Dh, j0, C::kTile, T, Dh, a.vec);
  load_rows16<DP, C::kThreads>(sV, a.v + bh * Dh, j0, C::kTile, T, Dh, a.vec);
  load_queries(0, 0);
  cp_async_commit();
  float gk[C::kNDH][4] = {}, gv[C::kNDH][4] = {};

  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) {
      load_queries((it + 1) & 1, (it + 1) * C::kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = it * C::kTile;
    const bf16* sQu = stages + (it & 1) * C::kDkvStage;
    const bf16* sQv = sQu + C::kTileE;
    const bf16* sDo = sQu + 2 * C::kTileE;
    const bf16* sP = sQu + 3 * C::kTileE;
    const RowStats st = row_stats16(a, bh, i0 + r0, true);
    float ds[C::kNKW][4], pd[C::kNKW][4];
    score_tile16<DP, NR, false>(a, sQu, sQv, sDo, sK, sV, sP, sB, i0, j0, b,
                                h, st, seed, ds, pd);
    __syncthreads();                             // X held the BD buffers
    store_tile16<DP, NR>(X, pd);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::kTile / 16; ++kk)   // dv += Pd^T do
      mma_row_kmajor<C::kNDH>(gv, ldsm_a_trans(X + kk * 16 * C::kLdX + r0,
                                               C::kLdX),
                              sDo + kk * 16 * C::kLd + d0, C::kLd);
    __syncthreads();
    store_tile16<DP, NR>(X, ds);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::kTile / 16; ++kk)   // dk += dS^T q_u
      mma_row_kmajor<C::kNDH>(gk, ldsm_a_trans(X + kk * 16 * C::kLdX + r0,
                                               C::kLdX),
                              sQu + kk * 16 * C::kLd + d0, C::kLd);
    __syncthreads();
  }
  store_rows16(a.dk + bh * Dh, gk, j0 + r0, T, d0, Dh);
  store_rows16(a.dv + bh * Dh, gv, j0 + r0, T, d0, Dh);
}

// ---------------------------------------------------------------- pass 4
template <int DP, int NR>
__global__ void __launch_bounds__(Cfg16<DP, NR>::kThreads, 1)
    dp16_kernel(Args16 a) {
  using C = Cfg16<DP, NR>;
  extern __shared__ __align__(16) unsigned char smem16[];
  const int T = a.T, Dh = a.Dh, nt = (T + C::kTile - 1) / C::kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = row_group<NR>() * kWarpRows;
  const int wr0 = warp_id() * 16;                // this warp's window rows
  const size_t bh = ((size_t)b * a.H + h) * T;
  const uint64_t seed = a.seed ? (uint64_t)a.seed[0] : 0;
  bf16* sP = reinterpret_cast<bf16*>(smem16);    // the diagonal's window
  bf16* stages = sP + C::kWinE;                  // q_u, q_v, do, k, v
  unsigned char* scratch = smem16 + 2 * C::kDpTiles;
  bf16* X = reinterpret_cast<bf16*>(scratch);
  float* sB = reinterpret_cast<float*>(scratch) + r0 * C::kLdB;

  auto load_pair = [&](int s, int i0, int j0) {
    bf16* st = stages + s * C::kDpStage;
    const bf16* src[5] = {a.qu, a.qv, a.dout, a.k, a.v};
#pragma unroll
    for (int x = 0; x < 5; ++x)
      load_rows16<DP, C::kThreads>(st + x * C::kTileE, src[x] + bh * Dh,
                                   x < 3 ? i0 : j0, C::kTile, T, Dh, a.vec);
  };

  for (int d = blockIdx.x; d > -nt; d -= nt) {
    load_rows16<DP, C::kThreads>(sP, a.p + (size_t)h * (2 * T - 1) * Dh,
                                 T - C::kTile + d * C::kTile, C::kWin,
                                 2 * T - 1, Dh, a.vec);
    const int it_lo = max(0, -d), it_hi = min(nt, nt - d);
    load_pair(0, it_lo * C::kTile, (it_lo + d) * C::kTile);
    cp_async_commit();
    float acc[C::kND][4] = {};

    for (int it = it_lo; it < it_hi; ++it) {
      const int s = (it - it_lo) & 1;
      if (it + 1 < it_hi) {
        load_pair(s ^ 1, (it + 1) * C::kTile, (it + 1 + d) * C::kTile);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int i0 = it * C::kTile;
      const bf16* sQu = stages + s * C::kDpStage;
      const bf16* sQv = sQu + C::kTileE;
      const RowStats st = row_stats16(a, bh, i0 + r0, true);
      float ds[C::kNKW][4], pd[C::kNKW][4];
      score_tile16<DP, NR, false>(a, sQu, sQv, sQu + 2 * C::kTileE,
                                  sQu + 3 * C::kTileE, sQu + 4 * C::kTileE,
                                  sP, sB, i0, i0 + d * C::kTile, b, h, st,
                                  seed, ds, pd);
      __syncthreads();
      store_tile16<DP, NR>(X, ds);
      __syncthreads();
      // dp_win += dSk^T q_v, dSk[r][col] = dS[r][col - (TILE - 1) + r]
#pragma unroll
      for (int kk = 0; kk < C::kTile / 16; ++kk) {
        // rows 16 kk.. meet columns wr0..wr0+15 only inside the band
        if (16 * kk + 15 < C::kTile - 16 - wr0 ||
            16 * kk > 2 * C::kTile - 2 - wr0)
          continue;
        const FragA16 x = load_a16([&](int m, int k) {
          const int r = kk * 16 + k, c = wr0 + m - (C::kTile - 1) + r;
          return (c >= 0 && c < C::kTile) ? X[r * C::kLdX + c]
                                          : __float2bfloat16(0.f);
        });
        mma_row_kmajor<C::kND>(acc, x, sQv + kk * 16 * C::kLd, C::kLd);
      }
      __syncthreads();
    }
    float* part = a.dp_part +
                  (((size_t)b * a.H + h) * (2 * nt - 1) + d + nt - 1) *
                      C::kWin * Dh;
    store_rows(part, acc, wr0, C::kWin, 0, Dh);
  }
}

// ---------------------------------------------------------------- pass 5
__global__ void dp16_sum_kernel(Args16 a, int tile) {
  const int T = a.T, P = 2 * T - 1, nt = (T + tile - 1) / tile;
  const size_t n = (size_t)a.H * P * a.Dh;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % a.Dh), r = (int)((e / a.Dh) % P);
    const int h = (int)(e / ((size_t)P * a.Dh));
    const int u = r - (T - tile);
    const int d_hi = u >= 0 ? u / tile : -((tile - 1 - u) / tile);
    float acc = 0.f;
    for (int d = d_hi - 1; d <= d_hi; ++d) {
      const int wr = r - (T - tile + d * tile);
      if (d < -(nt - 1) || d > nt - 1 || wr < 0 || wr >= 2 * tile) continue;
      for (int b = 0; b < a.B; ++b)
        acc += a.dp_part[((((size_t)b * a.H + h) * (2 * nt - 1) + d + nt - 1) *
                              (2 * tile) + wr) * a.Dh + c];
    }
    a.dp[e] = __float2bfloat16_rn(acc);
  }
}

template <int DP, int NR>
cudaError_t launch16(const Args16& a, cudaStream_t stream) {
  using C = Cfg16<DP, NR>;
  static bool attribute_set = false;
  cudaError_t err;
  if (!attribute_set) {
    err = cudaFuncSetAttribute(dq16_kernel<DP, NR, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kDqBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq16_kernel<DP, NR, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::kDqBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dkv16_kernel<DP, NR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::kDkvBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dp16_kernel<DP, NR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::kDpBytes);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const dim3 grid((a.T + C::kTile - 1) / C::kTile, a.H, a.B);
  dq16_kernel<DP, NR, true><<<grid, C::kThreads, C::kDqBytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq16_kernel<DP, NR, false><<<grid, C::kThreads, C::kDqBytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv16_kernel<DP, NR><<<grid, C::kThreads, C::kDkvBytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dp16_kernel<DP, NR><<<grid, C::kThreads, C::kDpBytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dp16_sum_kernel<<<264, 256, 0, stream>>>(a, C::kTile);
  return cudaGetLastError();
}

// ------------------------------------------------- the resident route
// The rows pass's shape (the resident forward's: 16 query rows, 4 warps,
// chunks of 64 rows, 2 stages). DP: padded head dim; sizes in bf16
// elements unless named in bytes.
template <int DP>
struct Rows16 {
  static constexpr int kTileQ = kWarpRows;           // query rows of a block
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kChunk = 64;                  // rows of a stage
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = 4;               // an SM's, for registers
  static constexpr int kLd = DP + 8;
  static constexpr int kNC = kChunk / 8 / kWarps;   // a warp's n-tiles of a chunk
  static constexpr int kRows = kTileQ / kWarps;      // a warp's rows, elementwise
  static constexpr int kTileBytes =
      2 * (3 * kTileQ + kStages * kChunk) * kLd;     // q_u, q_v, do, stages
  static_assert(kNC >= 1 && kNC * 8 * kWarps == kChunk, "a chunk's n-tiles");
  static_assert(kRows >= 1 && kRows * kWarps == kTileQ, "elementwise rows");
  static_assert(kStages >= 2 && kChunk % 16 == 0, "stages");
};

// keys padded to whole k-steps; the f32 rows' stride (16-byte rows); the
// scratch's rows: whole 64-key tiles
__host__ __device__ constexpr int rows16_tpad(int T) {
  return (T + 15) / 16 * 16;
}
__host__ __device__ constexpr int rows16_ld(int T) {
  return rows16_tpad(T) + 4;
}
__host__ __device__ constexpr int scratch_ld(int T) {
  return (T + 63) / 64 * 64;
}

// a rows block's shared memory: f32 P and dP rows beside its tiles
template <int DP>
size_t rows16_bytes(int T) {
  return 8 * (size_t)Rows16<DP>::kTileQ * rows16_ld(T) +
         Rows16<DP>::kTileBytes;
}

// the largest T whose rows block fits kSmemLimit
template <int DP>
int rows16_max_t() {
  const int ld =
      (kSmemLimit - Rows16<DP>::kTileBytes) / (8 * Rows16<DP>::kTileQ);
  return (ld - 4) / 16 * 16;
}

// dst[r * (DP + 8) + c] = src[(first + r) * Dh + c] for r < N, c < DP,
// zeros outside rows [0, limit) and columns [0, Dh), by 16-byte cp.async
// (Dh % 8 == 0, 16-byte aligned rows), the trip count known (NT threads a
// block), so the copies of a chunk unroll (the resident forward's copy)
template <int DP, int NT, int N>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int first, int limit, int Dh) {
  constexpr int kChunks = DP / 8, kPer = N * kChunks / NT;
  static_assert(kPer * NT == N * kChunks, "copies a thread");
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / kChunks, c = (e % kChunks) * 8, g = first + r;
    const bool ok = g >= 0 && g < limit && c < Dh;
    tsasr::cp_async16_raw(dst + r * (DP + 8) + c,
                          ok ? src + (ptrdiff_t)g * Dh + c : src, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(Rows16<DP>::kThreads,
                                 Rows16<DP>::kMinBlocks)
    rows16_kernel(Args16 a) {
  using C = Rows16<DP>;
  extern __shared__ __align__(16) unsigned char smem16[];
  const int T = a.T, Dh = a.Dh, ldS = rows16_ld(T), Tg = scratch_ld(T);
  const int i0 = blockIdx.x * C::kTileQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = ((size_t)b * a.H + h) * T;
  const bf16* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  float* S = reinterpret_cast<float*>(smem16);   // scores, then P
  float* G = S + C::kTileQ * ldS;                // dP, then dropped dP
  bf16* sQu = reinterpret_cast<bf16*>(G + C::kTileQ * ldS);
  bf16* sQv = sQu + C::kTileQ * C::kLd;
  bf16* sDo = sQv + C::kTileQ * C::kLd;
  bf16* stages = sDo + C::kTileQ * C::kLd;
  // window row w is p row T - TQ - i0 + w and meets row r at key w + r -
  // (TQ - 1); the block's rows use w in [0, T + TQ - 1)
  const int nW = (T + C::kTileQ - 1 + C::kChunk - 1) / C::kChunk;
  const int nK = (T + C::kChunk - 1) / C::kChunk;
  // chunk q: the window [0, nW), k [k1, v1), v [v1, nQ)
  const int k1 = nW, v1 = nW + nK, nQ = nW + 2 * nK;

  auto load_chunk = [&](int q) {
    bf16* st = stages + (q % C::kStages) * C::kChunk * C::kLd;
    const bool win = q < k1;
    const int x0 = (q - (q < k1 ? 0 : q < v1 ? k1 : v1)) * C::kChunk;
    const bf16* src = win ? p_h : (q < v1 ? a.k : a.v) + bh * Dh;
    const int first = win ? T - C::kTileQ - i0 + x0 : x0;
    const int limit = win ? 2 * T - 1 : T;
    if (a.vec)
      stage_rows<DP, C::kThreads, C::kChunk>(st, src, first, limit, Dh);
    else
      load_rows16<DP, C::kThreads>(st, src, first, C::kChunk, limit, Dh,
                                   false);
  };
  load_rows16<DP, C::kThreads>(sQu, a.qu + bh * Dh, i0, C::kTileQ, T, Dh,
                               a.vec);
  load_rows16<DP, C::kThreads>(sQv, a.qv + bh * Dh, i0, C::kTileQ, T, Dh,
                               a.vec);
  load_rows16<DP, C::kThreads>(sDo, a.dout + bh * Dh, i0, C::kTileQ, T, Dh,
                               a.vec);
  load_chunk(0);
  cp_async_commit();
#pragma unroll
  for (int q = 1; q < C::kStages - 1; ++q) {
    if (q < nQ) load_chunk(q);
    cp_async_commit();
  }

  FragA16 qf[DP / 16];                 // q_v, then q_u, then do
  for (int q = 0; q < nQ; ++q) {       // the scores and dP, each product once
    cp_async_wait<C::kStages - 2>();
    __syncthreads();                   // chunk q landed; chunk q - 1's stage free
    if (q + C::kStages - 1 < nQ) load_chunk(q + C::kStages - 1);
    cp_async_commit();
    const bf16* st = stages + (q % C::kStages) * C::kChunk * C::kLd;
    const bf16* rows = q < k1 ? sQv : q < v1 ? sQu : sDo;
    if (q == 0 || q == k1 || q == v1)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        qf[kk] = ldsm_a(rows + kk * 16, C::kLd);
    // this warp's first window row or key of the chunk
    const int x0 = (q - (q < k1 ? 0 : q < v1 ? k1 : v1)) * C::kChunk +
                   warp * C::kNC * 8;
    if (x0 >= (q < k1 ? T + C::kTileQ - 1 : T)) continue;
    float acc[C::kNC][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_row_nmajor<C::kNC>(acc, qf[kk],
                             st + warp * C::kNC * 8 * C::kLd + kk * 16,
                             C::kLd);
    if (q < k1) {                      // q_v win^T to its skewed place
#pragma unroll
      for (int nb = 0; nb < C::kNC; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = c_row(e);
          const int c = x0 + nb * 8 + c_col(e) + r - (C::kTileQ - 1);
          if (c >= 0 && c < T) S[r * ldS + c] = acc[nb][e];
        }
    } else if (q < v1) {               // + q_u k^T: every load before a store
      float bd[C::kNC][4];
#pragma unroll
      for (int nb = 0; nb < C::kNC; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = x0 + nb * 8 + c_col(e);
          bd[nb][e] = x < T ? S[c_row(e) * ldS + x] : 0.f;
        }
#pragma unroll
      for (int nb = 0; nb < C::kNC; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = x0 + nb * 8 + c_col(e);
          if (x < T)
            S[c_row(e) * ldS + x] = (acc[nb][e] + bd[nb][e]) * a.scale;
        }
    } else {                           // dP = do v^T
#pragma unroll
      for (int nb = 0; nb < C::kNC; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = x0 + nb * 8 + c_col(e);
          if (x < T) G[c_row(e) * ldS + x] = acc[nb][e];
        }
    }
  }
  __syncthreads();                     // S and G whole

  // Elementwise, a warp a row: this warp's rows side by side, kCols
  // columns a lane at a time, and in each step every load before any
  // store (as the resident forward's softmax). Rows past T store nothing.
  constexpr int kCols = 2;
  const bool drop = a.seed != nullptr;
  const uint64_t seed = drop ? (uint64_t)a.seed[0] : 0;
  const float* kp = a.kp + (size_t)b * T;
  const float* am[C::kRows];
  float *srow[C::kRows], *grow[C::kRows];
  float m[C::kRows], linv[C::kRows], dsum[C::kRows];
#pragma unroll
  for (int k = 0; k < C::kRows; ++k) {
    const int r = warp + k * C::kWarps;
    const size_t ic = bh + min(i0 + r, T - 1);
    srow[k] = S + r * ldS;
    grow[k] = G + r * ldS;
    am[k] = a.am + (size_t)min(i0 + r, T - 1) * T;
    m[k] = a.stats[2 * ic];
    linv[k] = a.stats[2 * ic + 1];
    dsum[k] = 0.f;
  }
  // 1. P = exp(s - m) / l, the keep bit, Pd to the scratch, the dropped
  //    dP; P and dP back in place, D's terms
  for (int c0 = lane; c0 < T; c0 += 32 * kCols) {
    float x[kCols][C::kRows], g[kCols][C::kRows], amc[kCols][C::kRows];
    float kpc[kCols], pd[kCols][C::kRows];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = min(c0 + 32 * j, T - 1);
      kpc[j] = __ldg(kp + c);
#pragma unroll
      for (int k = 0; k < C::kRows; ++k) {
        amc[j][k] = __ldg(am[k] + c);
        x[j][k] = srow[k][c];
        g[j][k] = grow[k][c];
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + 32 * j;
#pragma unroll
      for (int k = 0; k < C::kRows; ++k) {
        const int i = i0 + warp + k * C::kWarps;
        // (s + am) + kp, the plain version's order
        const float pr =
            expf(x[j][k] + amc[j][k] + kpc[j] - m[k]) * linv[k];
        float pdr = pr, dpr = g[j][k];
        if (drop) {
          const bool keep =
              tsasr::dropout_keep(seed, a.thresh, b, a.h0 + h, i, c);
          pdr = keep ? pr * a.keep_scale : 0.f;
          dpr = keep ? dpr * a.keep_scale : 0.f;
        }
        x[j][k] = pr;
        g[j][k] = dpr;
        pd[j][k] = pdr;
        if (c < T) dsum[k] += pr * dpr;
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + 32 * j;
      if (c < T)
#pragma unroll
        for (int k = 0; k < C::kRows; ++k) {
          const int i = i0 + warp + k * C::kWarps;
          srow[k][c] = x[j][k];
          grow[k][c] = g[j][k];
          if (i < T) a.pd[(bh + i) * Tg + c] = __float2bfloat16_rn(pd[j][k]);
        }
    }
  }
#pragma unroll
  for (int k = 0; k < C::kRows; ++k)
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      dsum[k] += __shfl_xor_sync(0xffffffffu, dsum[k], d);
  // 2. dS = bf16(P (dP - D) scale) to the scratch, zeros (and Pd's) from
  //    T to Tg; each lane reads only what it stored in 1
  for (int c0 = lane; c0 < Tg; c0 += 32 * kCols) {
    float x[kCols][C::kRows], g[kCols][C::kRows];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = min(c0 + 32 * j, T - 1);
#pragma unroll
      for (int k = 0; k < C::kRows; ++k) {
        x[j][k] = srow[k][c];
        g[j][k] = grow[k][c];
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + 32 * j;
#pragma unroll
      for (int k = 0; k < C::kRows; ++k) {
        const int i = i0 + warp + k * C::kWarps;
        if (i >= T || c >= Tg) continue;
        a.ds[(bh + i) * Tg + c] = __float2bfloat16_rn(
            c < T ? x[j][k] * (g[j][k] - dsum[k]) * a.scale : 0.f);
        if (c >= T) a.pd[(bh + i) * Tg + c] = __float2bfloat16(0.f);
      }
    }
  }
}

// The columns pass's tiles: the long route's dkv and dp tiles (Cfg16),
// the score tiles read from the scratch; sizes in bf16 elements unless
// named in bytes
template <int DP, int NR>
struct Cols16 {
  using C = Cfg16<DP, NR>;
  static constexpr int kXE = C::kTile * C::kLdX;     // a dS or Pd tile
  static constexpr int kDkvStage = 2 * kXE + 2 * C::kTileE;  // dS, Pd, q_u, do
  static constexpr int kDqStage = kXE + C::kTileE + C::kWinE;  // dS, k, window
  static constexpr int kDpStage = kXE + C::kTileE;           // dS, q_v
  static constexpr int kDkvBytes = 2 * 2 * kDkvStage;
  static constexpr int kDqBytes = 2 * 2 * kDqStage;
  static constexpr int kDpBytes = 2 * (C::kWinE + 2 * kDpStage);
  static constexpr int kBytes =
      kDkvBytes > kDqBytes ? (kDkvBytes > kDpBytes ? kDkvBytes : kDpBytes)
                           : (kDqBytes > kDpBytes ? kDqBytes : kDpBytes);
  static_assert(kBytes <= kSmemLimit, "shared memory of a block");
};

// dst[r * (TILE + 8) + c] = src[(i0 + r) * Tg + j0 + c] for r, c < TILE,
// zeros for rows from T on: a tile of the scratch by 16-byte cp.async
template <int TILE, int NT>
__device__ __forceinline__ void load_scratch(bf16* dst, const bf16* src,
                                             int i0, int j0, int T, int Tg) {
  constexpr int kChunks = TILE / 8;
  for (int e = threadIdx.x; e < TILE * kChunks; e += NT) {
    const int r = e / kChunks, c = (e % kChunks) * 8, g = i0 + r;
    const bool ok = g < T;
    tsasr::cp_async16_raw(dst + r * (TILE + 8) + c,
                          ok ? src + (size_t)g * Tg + j0 + c : src, ok);
  }
}

template <int DP, int NR>
__global__ void __launch_bounds__(Cfg16<DP, NR>::kThreads, 2)
    cols16_kernel(Args16 a) {
  using C = Cfg16<DP, NR>;
  using X = Cols16<DP, NR>;
  extern __shared__ __align__(16) unsigned char smem16[];
  const int T = a.T, Dh = a.Dh, nt = (T + C::kTile - 1) / C::kTile;
  const int Tg = scratch_ld(T);
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = row_group<NR>() * kWarpRows;
  const size_t bh = ((size_t)b * a.H + h) * T;
  const bf16* ds = a.ds + bh * Tg;
  const bf16* pd = a.pd + bh * Tg;
  bf16* tiles = reinterpret_cast<bf16*>(smem16);

  if ((int)blockIdx.x < nt) {          // dk, dv of one key tile
    const int j0 = blockIdx.x * C::kTile;
    const int d0 = warp_half<NR>() * C::kNDH * 8;  // this warp's columns
    auto load_queries = [&](int s, int i0) {
      bf16* st = tiles + s * X::kDkvStage;
      load_scratch<C::kTile, C::kThreads>(st, ds, i0, j0, T, Tg);
      load_scratch<C::kTile, C::kThreads>(st + X::kXE, pd, i0, j0, T, Tg);
      load_rows16<DP, C::kThreads>(st + 2 * X::kXE, a.qu + bh * Dh, i0,
                                   C::kTile, T, Dh, a.vec);
      load_rows16<DP, C::kThreads>(st + 2 * X::kXE + C::kTileE,
                                   a.dout + bh * Dh, i0, C::kTile, T, Dh,
                                   a.vec);
    };
    load_queries(0, 0);
    cp_async_commit();
    float gk[C::kNDH][4] = {}, gv[C::kNDH][4] = {};
    for (int it = 0; it < nt; ++it) {
      if (it + 1 < nt) {
        load_queries((it + 1) & 1, (it + 1) * C::kTile);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sS = tiles + (it & 1) * X::kDkvStage;
      const bf16* sPd = sS + X::kXE;
      const bf16* sQu = sS + 2 * X::kXE;
      const bf16* sDo = sQu + C::kTileE;
#pragma unroll
      for (int kk = 0; kk < C::kTile / 16; ++kk) {
        // dv += Pd^T do, dk += dS^T q_u
        mma_row_kmajor<C::kNDH>(gv, ldsm_a_trans(sPd + kk * 16 * C::kLdX + r0,
                                                 C::kLdX),
                                sDo + kk * 16 * C::kLd + d0, C::kLd);
        mma_row_kmajor<C::kNDH>(gk, ldsm_a_trans(sS + kk * 16 * C::kLdX + r0,
                                                 C::kLdX),
                                sQu + kk * 16 * C::kLd + d0, C::kLd);
      }
      __syncthreads();
    }
    store_rows16(a.dk + bh * Dh, gk, j0 + r0, T, d0, Dh);
    store_rows16(a.dv + bh * Dh, gv, j0 + r0, T, d0, Dh);
    return;
  }

  if ((int)blockIdx.x < 2 * nt) {      // dq_u, dq_v of one query tile
    const int i0 = (blockIdx.x - nt) * C::kTile;
    const int d0 = warp_half<NR>() * C::kNDH * 8;  // this warp's columns
    const int first = C::kTile - kWarpRows - r0;   // the group's window row 0
    const bf16* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
    auto load_keys = [&](int s, int j0) {
      bf16* st = tiles + s * X::kDqStage;
      load_scratch<C::kTile, C::kThreads>(st, ds, i0, j0, T, Tg);
      load_rows16<DP, C::kThreads>(st + X::kXE, a.k + bh * Dh, j0, C::kTile,
                                   T, Dh, a.vec);
      load_rows16<DP, C::kThreads>(st + X::kXE + C::kTileE, p_h,
                                   T - C::kTile - i0 + j0, C::kWin, 2 * T - 1,
                                   Dh, a.vec);
    };
    load_keys(0, 0);
    cp_async_commit();
    float gu[C::kNDH][4] = {}, gv[C::kNDH][4] = {};
    for (int jt = 0; jt < nt; ++jt) {
      if (jt + 1 < nt) {
        load_keys((jt + 1) & 1, (jt + 1) * C::kTile);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sS = tiles + (jt & 1) * X::kDqStage;
      const bf16* sK = sS + X::kXE;
      const bf16* sP = sK + C::kTileE;
#pragma unroll
      for (int kk = 0; kk < C::kTile / 16; ++kk)   // dq_u += dS k
        mma_row_kmajor<C::kNDH>(gu, ldsm_a(sS + r0 * C::kLdX + kk * 16,
                                           C::kLdX),
                                sK + kk * 16 * C::kLd + d0, C::kLd);
      // dq_v += dSk win, dSk[rl][w] = dS[rl][w - 15 + rl] read skewed
#pragma unroll
      for (int kk = 0; kk < C::kBW / 16; ++kk) {
        const FragA16 x = load_a16([&](int m, int k) {
          const int c = kk * 16 + k - (kWarpRows - 1 - m);
          return (c >= 0 && c < C::kTile) ? sS[(r0 + m) * C::kLdX + c]
                                          : __float2bfloat16(0.f);
        });
        mma_row_kmajor<C::kNDH>(gv, x, sP + (first + kk * 16) * C::kLd + d0,
                                C::kLd);
      }
      __syncthreads();
    }
    store_rows16(a.dqu + bh * Dh, gu, i0 + r0, T, d0, Dh);
    store_rows16(a.dqv + bh * Dh, gv, i0 + r0, T, d0, Dh);
    return;
  }

  // dp's partials along tile diagonals blockIdx.x - 2 nt and - 3 nt
  const int wr0 = warp_id() * 16;                // this warp's window rows
  bf16* sP = tiles;                              // the diagonal's window
  bf16* stages = sP + C::kWinE;                  // dS, q_v
  auto load_pair = [&](int s, int i0, int j0) {
    bf16* st = stages + s * X::kDpStage;
    load_scratch<C::kTile, C::kThreads>(st, ds, i0, j0, T, Tg);
    load_rows16<DP, C::kThreads>(st + X::kXE, a.qv + bh * Dh, i0, C::kTile,
                                 T, Dh, a.vec);
  };
  for (int d = (int)blockIdx.x - 2 * nt; d > -nt; d -= nt) {
    load_rows16<DP, C::kThreads>(sP, a.p + (size_t)h * (2 * T - 1) * Dh,
                                 T - C::kTile + d * C::kTile, C::kWin,
                                 2 * T - 1, Dh, a.vec);
    const int it_lo = max(0, -d), it_hi = min(nt, nt - d);
    load_pair(0, it_lo * C::kTile, (it_lo + d) * C::kTile);
    cp_async_commit();
    float acc[C::kND][4] = {};
    for (int it = it_lo; it < it_hi; ++it) {
      const int s = (it - it_lo) & 1;
      if (it + 1 < it_hi) {
        load_pair(s ^ 1, (it + 1) * C::kTile, (it + 1 + d) * C::kTile);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sS = stages + s * X::kDpStage;
      const bf16* sQv = sS + X::kXE;
      // dp_win += dSk^T q_v, dSk[r][col] = dS[r][col - (TILE - 1) + r]
#pragma unroll
      for (int kk = 0; kk < C::kTile / 16; ++kk) {
        // rows 16 kk.. meet columns wr0..wr0+15 only inside the band
        if (16 * kk + 15 < C::kTile - 16 - wr0 ||
            16 * kk > 2 * C::kTile - 2 - wr0)
          continue;
        const FragA16 x = load_a16([&](int m, int k) {
          const int r = kk * 16 + k, c = wr0 + m - (C::kTile - 1) + r;
          return (c >= 0 && c < C::kTile) ? sS[r * C::kLdX + c]
                                          : __float2bfloat16(0.f);
        });
        mma_row_kmajor<C::kND>(acc, x, sQv + kk * 16 * C::kLd, C::kLd);
      }
      __syncthreads();
    }
    float* part = a.dp_part +
                  (((size_t)b * a.H + h) * (2 * nt - 1) + d + nt - 1) *
                      C::kWin * Dh;
    store_rows(part, acc, wr0, C::kWin, 0, Dh);
  }
}

template <int DP, int NR>
cudaError_t launch_res16(const Args16& a, cudaStream_t stream) {
  using R = Rows16<DP>;
  using C = Cfg16<DP, NR>;
  const size_t bytes = rows16_bytes<DP>(a.T);
  if (a.T > rows16_max_t<DP>() || bytes > (size_t)kSmemLimit)
    return cudaErrorInvalidValue;                // the long route's T
  static bool attribute_set = false;
  cudaError_t err;
  if (!attribute_set) {
    err = cudaFuncSetAttribute(rows16_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cols16_kernel<DP, NR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Cols16<DP, NR>::kBytes);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int nt = (a.T + C::kTile - 1) / C::kTile;
  rows16_kernel<DP><<<dim3((a.T + R::kTileQ - 1) / R::kTileQ, a.H, a.B),
                      R::kThreads, bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cols16_kernel<DP, NR><<<dim3(3 * nt, a.H, a.B), C::kThreads,
                          Cols16<DP, NR>::kBytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dp16_sum_kernel<<<264, 256, 0, stream>>>(a, C::kTile);
  return cudaGetLastError();
}

Args16 bf16_args(const __nv_bfloat16* qu, const __nv_bfloat16* qv,
                 const __nv_bfloat16* k, const __nv_bfloat16* v,
                 const __nv_bfloat16* p, const float* kp, const float* am,
                 const float* stats, const __nv_bfloat16* dout,
                 const long long* seed, unsigned thresh, float keep_scale,
                 float* delta, __nv_bfloat16* dqu, __nv_bfloat16* dqv,
                 __nv_bfloat16* dk, __nv_bfloat16* dv, float* dp_part,
                 __nv_bfloat16* dp, int B, int H, int T, int Dh,
                 float scale, int h0) {
  const bool vec = Dh % 8 == 0 && aligned16(qu) && aligned16(qv) &&
                   aligned16(k) && aligned16(v) && aligned16(p) &&
                   aligned16(dout);
  return Args16{qu,  qv,  k,  v,  p,       dout, kp, am, stats,
                seed, thresh, keep_scale, scale, delta, dqu, dqv, dk, dv,
                dp_part, dp, B, H, T, Dh, vec, nullptr, nullptr, h0};
}

bool bf16_shape_ok(int B, int H, int T, int Dh) {
  return B >= 1 && H >= 1 && T >= 1 && Dh >= 1 && Dh <= 128 && B <= 65535 &&
         H <= 65535;
}

}  // namespace

// The bf16 backward, resident route: q_u, q_v, k, v, out, dout (B, H, T,
// Dh) and p (H, 2T-1, Dh) in bf16; kp, am and stats f32 as
// relpos_attention_bwd's. Scratch: delta (B, H, T) f32, not read;
// dp_part of relpos_attention_bwd_bf16_scratch_floats floats (dp's
// partials, then bf16 dS and Pd). Outputs dqu, dqv, dk, dv (B, H, T, Dh)
// and dp (H, 2T-1, Dh) in bf16. out is not read: D comes from the scores.
// T at most relpos_attention_bwd_bf16_max_t(Dh), else
// cudaErrorInvalidValue. Returns the CUDA error code of the launches (0
// on success).
extern "C" int relpos_attention_bwd_bf16(
    const __nv_bfloat16* qu, const __nv_bfloat16* qv, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const __nv_bfloat16* p, const float* kp,
    const float* am, const float* stats, const __nv_bfloat16* dout,
    const long long* seed, unsigned thresh, float keep_scale, float* delta,
    __nv_bfloat16* dqu, __nv_bfloat16* dqv, __nv_bfloat16* dk,
    __nv_bfloat16* dv, float* dp_part, __nv_bfloat16* dp, int B, int H,
    int T, int Dh, float scale, void* stream, int h0) {
  if (!bf16_shape_ok(B, H, T, Dh)) return (int)cudaErrorInvalidValue;
  Args16 a = bf16_args(qu, qv, k, v, p, kp, am, stats, dout, seed, thresh,
                       keep_scale, delta, dqu, dqv, dk, dv, dp_part, dp, B,
                       H, T, Dh, scale, h0);
  a.ds = reinterpret_cast<bf16*>(
      dp_part + relpos_attention_bwd_dp_part_floats(B, H, T, Dh));
  a.pd = a.ds + (size_t)B * H * T * scratch_ld(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh <= 32) return (int)launch_res16<32, 4>(a, s);
  if (Dh <= 64) return (int)launch_res16<64, 4>(a, s);
  return (int)launch_res16<128, 2>(a, s);
}

// The largest T the resident route takes at head dim Dh (1..128; 0
// otherwise): past it, relpos_attention_bwd_bf16_long.
extern "C" int relpos_attention_bwd_bf16_max_t(int Dh) {
  if (Dh < 1 || Dh > 128) return 0;
  if (Dh <= 32) return rows16_max_t<32>();
  if (Dh <= 64) return rows16_max_t<64>();
  return rows16_max_t<128>();
}

// Floats of the resident route's scratch (its dp_part argument): dp's
// partials (relpos_attention_bwd_dp_part_floats, a multiple of 4), then
// bf16 dS and Pd, (B, H, T, roundup(T, 64)) each.
extern "C" long long relpos_attention_bwd_bf16_scratch_floats(int B, int H,
                                                              int T,
                                                              int Dh) {
  return relpos_attention_bwd_dp_part_floats(B, H, T, Dh) +
         (long long)B * H * T * scratch_ld(T);
}

// The bf16 backward, long route (five passes), any T: the
// arguments of relpos_attention_bwd_bf16, with delta (B, H, T) f32 and
// dp_part of relpos_attention_bwd_dp_part_floats floats.
extern "C" int relpos_attention_bwd_bf16_long(
    const __nv_bfloat16* qu, const __nv_bfloat16* qv, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const __nv_bfloat16* p, const float* kp,
    const float* am, const float* stats, const __nv_bfloat16* dout,
    const long long* seed, unsigned thresh, float keep_scale, float* delta,
    __nv_bfloat16* dqu, __nv_bfloat16* dqv, __nv_bfloat16* dk,
    __nv_bfloat16* dv, float* dp_part, __nv_bfloat16* dp, int B, int H,
    int T, int Dh, float scale, void* stream, int h0) {
  if (!bf16_shape_ok(B, H, T, Dh)) return (int)cudaErrorInvalidValue;
  const Args16 a = bf16_args(qu, qv, k, v, p, kp, am, stats, dout, seed,
                             thresh, keep_scale, delta, dqu, dqv, dk, dv,
                             dp_part, dp, B, H, T, Dh, scale, h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh <= 32) return (int)launch16<32, 4>(a, s);
  if (Dh <= 64) return (int)launch16<64, 4>(a, s);
  return (int)launch16<128, 2>(a, s);
}
