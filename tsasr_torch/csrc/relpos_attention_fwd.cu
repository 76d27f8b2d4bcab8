// Fused relative-position self-attention, forward, f32, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/attention_pallas.py::_fwd_kernel (driven by
// _fused_fwd_call), dropout included. It computes, per (batch b, head h):
//
//   out = dropout(softmax((q_u k^T + shift(q_v p^T)) * scale + am_add
//                         + kp_add)) @ v
//
// where shift is the Transformer-XL rel-shift: score (i, j) uses the
// positional row p[T-1-i+j]. The TPU kernel realised that shift with a
// log-depth shifter of lane rolls; here it is a product with a window of
// p rows followed by a skew read (below).
//
// Dropout: the TPU kernel drew its mask from the TPU's own generator,
// reseeded in the backward. Here each (b, h, i, j) draws word 0 of a
// Philox4x32-10 keyed by the seed (philox.cuh); kept probabilities are
// scaled by 1/(1-rate). The backward kernel (relpos_attention_bwd.cu)
// regenerates the same mask, so none is stored. The softmax denominator
// sums the undropped probabilities, as the JAX kernel's softmax does
// before its dropout.
//
// For the backward, the kernel can also write each row's softmax
// statistics, stats (B, H, T, 2) = (row max m, 1 / row sum l) of the
// scaled, masked scores: the backward then recomputes the probabilities
// as exp(s - m) / l. One log-sum-exp m + log(l) would not do: on a row
// whose keys are all masked, m is about -1e9, where an f32 ulp is 64 and
// log(l) is lost.
//
// Products on the tensor cores, at f32 accuracy: S = q_u k^T, the
// positional product and O += P v are m16n8k8 mma.sync in 3xTF32
// (mma_tf32x3.cuh; each k-step's three products summed from zero, then
// added in f32). Plain 1xTF32 would read ~1e-3 of max |out|.
//
// Tiling. A block takes TQ = 32 query rows of one (b, h) and walks the
// keys in tiles of TK = 32. It has two warps per group of 16 query rows,
// one for each half (16 keys) of every key tile: each warp keeps its own
// online softmax state (row max m, row sum l, O = sum P v over all of Dh)
// over its half of the keys, so a row's max and sum stay within a quad of
// lanes (2 shuffles) and the two halves are merged once at the end through
// shared memory: m = max(m0, m1), w = exp(m_half - m), l = l0 w0 + l1 w1,
// O = O0 w0 + O1 w1. A warp whose keys so far all lie past T has m = -inf
// and weight 0 (its exp is guarded against -inf - -inf). Dh is zero-padded
// to DP = 32, 64 or 128 in shared memory, rows DP + 4 floats apart, so
// fragment loads of 8 rows x 4 columns hit 32 banks. Per key tile:
//
//   - the positional term: the pair (i0, j0) reads p rows from
//     T - TQ - i0 + j0 on (TQ + TK - 1, padded to TQ + TK: the window);
//     row group g's 16 rows need TK + 15 of them from window row
//     TQ - 16 - 16 g on, so its two warps compute BD = q_v(16 rows) @
//     win(TK + 16 rows)^T, half the columns each, into the group's shared
//     buffer, and read the score term of (row rl, key c) at
//     BD[rl][15 - rl + c];
//   - S = q_u k^T for the warp's 16 keys, the masks, the online softmax
//     and the dropout (one Philox per element) in registers;
//   - O += P v with P straight from the accumulators: the A operand wants
//     columns t and t + 4 where a lane holds 2t and 2t + 1, so the k-step
//     takes the keys in the order 2 (k % 4) + k / 4 and reads v's rows in
//     that order (load_a_acc, acc_key): no shuffle, no shared memory.
//
// TQ = 32 (two row groups, 4 warps, 94 KB of shared memory at DP 64: two
// blocks an SM). Timed on an H100 against 16-row blocks (2 warps, three
// an SM) at the serving and training shapes, 32 rows were as fast or
// faster at every shape but one, B8 H4 T301, where they lose 3-4 %; even
// where 32 rows leave SMs idle (128 blocks at B8 H4 T101), the key tiles
// and windows they share outweigh the SMs 16 rows would fill.
//
// Copies: the k, v and window tiles of each key tile are loaded with
// cp.async (tile_helpers.cuh; 16 B a thread when Dh % 4 == 0 and the rows
// are aligned, else 4 B), double-buffered, so the next tile's copies
// overlap this tile's products. Rows outside [0, T) and columns past Dh
// are zero-filled. The masks am and kp of a tile are read into registers,
// indices clamped into [0, T), before the products, so their loads
// overlap them; elements past T are dropped from the softmax.
//
// What bounds it on an H100: at B8 H4 T101 Dh64 it moves about 4 MB (q_u,
// q_v, k, v, out, p, the masks) and does 6 B H T^2 Dh = 125 MFLOP of
// products (S, the positional term, P v): 0.0013 ms of bytes at 3.35 TB/s
// against 0.0008 ms of operations at the 3xTF32 rate, 495 / 3 TFLOP/s.
// The kernel pads T to whole tiles and the positional product to TK + 16
// columns, splits every operand into TF32 parts at each fragment load
// from shared memory (no ldmatrix, no wgmma), and at these sizes runs one
// wave of small blocks: latency-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"
#include "philox.cuh"
#include "tile_helpers.cuh"

namespace {

using tsasr::acc_key;
using tsasr::c_col;
using tsasr::c_row;
using tsasr::cp_async_commit;
using tsasr::cp_async_wait;
using tsasr::FragA;
using tsasr::group_sync;
using tsasr::lane_g;
using tsasr::lane_t;
using tsasr::load_a;
using tsasr::load_a_acc;
using tsasr::load_rows;
using tsasr::mma_tf32x3_row;
using tsasr::row_group;
using tsasr::warp_half;

constexpr int kWarpRows = 16;              // query rows of a row group
constexpr int kTileK = 32;                 // keys of a key tile
constexpr int kSmemLimit = 232448;         // bytes a block may ask for

struct Args {
  const float *qu, *qv, *k, *v, *p, *kp, *am;
  float *out, *stats;
  const long long* seed;
  uint32_t thresh;
  float keep_scale, scale;
  int H, T, Dh;
  bool vec;                                // 16-byte copies are aligned
  int h0;                                  // the first head's model index
};

constexpr int kNR = 2;                     // row groups of a query tile

// DP: padded head dim
template <int DP>
struct Cfg {
  static constexpr int kTileQ = kWarpRows * kNR;
  static constexpr int kWarps = 2 * kNR;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWin = kTileQ + kTileK;   // a pair's p rows
  static constexpr int kBW = kTileK + kWarpRows; // a row group's (TK + 15)
  static constexpr int kNB = kBW / 8;      // its n-tiles, half to each warp
  static constexpr int kWK = kTileK / 2;   // keys of a warp
  static constexpr int kNKW = kWK / 8;
  static constexpr int kND = DP / 8;       // n-tiles over the head dim
  static constexpr int kLd = DP + 4;
  static constexpr int kLdB = kBW + 4;
  static constexpr int kQF = kTileQ * kLd;
  static constexpr int kKF = kTileK * kLd;
  static constexpr int kStage = 2 * kKF + kWin * kLd;   // k, v, window
  static constexpr int kF = 2 * kQF + 2 * kStage + kNR * kWarpRows * kLdB;
  // a warp's final state for the merge, in lane order: O, m, l
  static constexpr int kMergeW = 32 * (4 * kND + 4);
  static_assert(kNB % 2 == 0 && kND % 2 == 0, "warp shares");
  static_assert(2 * kNR * kMergeW <= 2 * kStage, "merge fits the stages");
  static_assert(4 * kF <= kSmemLimit, "shared memory of a block");
};

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads)
    relpos_attention_fwd_kernel(Args a) {
  using C = Cfg<DP>;
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, Dh = a.Dh, nk = (T + kTileK - 1) / kTileK;
  const int i0 = blockIdx.x * C::kTileQ, h = blockIdx.y, b = blockIdx.z;
  const int grp = row_group<kNR>(), half = warp_half<kNR>();
  const int r0 = grp * kWarpRows, c0 = half * C::kWK;
  const int first = C::kTileQ - kWarpRows - r0;  // the group's window row 0
  const size_t bh = ((size_t)b * a.H + h) * T;
  const float* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  const bool drop = a.seed != nullptr;
  const uint64_t seed = drop ? (uint64_t)a.seed[0] : 0;
  float* sQu = smem;
  float* sQv = sQu + C::kQF;
  float* stages = sQv + C::kQF;                  // k, v, window
  float* sB = stages + 2 * C::kStage + r0 * C::kLdB;

  auto load_keys = [&](int s, int j0) {
    float* st = stages + s * C::kStage;
    load_rows<DP, C::kThreads>(st, a.k + bh * Dh, j0, kTileK, T, Dh, a.vec);
    load_rows<DP, C::kThreads>(st + C::kKF, a.v + bh * Dh, j0, kTileK, T,
                               Dh, a.vec);
    load_rows<DP, C::kThreads>(st + 2 * C::kKF, p_h,
                               T - C::kTileQ - i0 + j0, C::kWin, 2 * T - 1,
                               Dh, a.vec);
  };
  load_rows<DP, C::kThreads>(sQu, a.qu + bh * Dh, i0, C::kTileQ, T, Dh,
                             a.vec);
  load_rows<DP, C::kThreads>(sQv, a.qv + bh * Dh, i0, C::kTileQ, T, Dh,
                             a.vec);
  load_keys(0, 0);
  cp_async_commit();

  // rows g and g + 8 of the group: running max, this lane's share of the
  // running sum, and O over this warp's keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[C::kND][4] = {};

  for (int jt = 0; jt < nk; ++jt) {
    const int j0 = jt * kTileK;
    // the masks of this lane's scores, indices clamped into the lattice
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
    if (jt + 1 < nk) {
      load_keys((jt + 1) & 1, j0 + kTileK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = stages + (jt & 1) * C::kStage;
    const float* sV = sK + C::kKF;
    const float* sP = sK + 2 * C::kKF;

    {                                            // BD, half the columns
      constexpr int kHalf = C::kNB / 2;
      const int nb0 = half * kHalf;
      float bd[kHalf][4] = {};
      for (int kk = 0; kk < C::kND; ++kk) {
        const FragA q = load_a([&](int r, int k) {
          return sQv[(r0 + r) * C::kLd + kk * 8 + k];
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
    float s[C::kNKW][4] = {};
    for (int kk = 0; kk < C::kND; ++kk) {        // S = q_u k^T
      const FragA q = load_a([&](int r, int k) {
        return sQu[(r0 + r) * C::kLd + kk * 8 + k];
      });
      mma_tf32x3_row(s, q, [&](int nt, int k, int n) {
        return sK[(c0 + nt * 8 + n) * C::kLd + kk * 8 + k];
      });
    }
    group_sync<kNR>();                           // BD of both halves

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = c_row(e), c = c0 + nt * 8 + c_col(e);
        s[nt][e] = j0 + c < T
                       ? (s[nt][e] + sB[rl * C::kLdB + kWarpRows - 1 - rl + c]) *
                                 a.scale +
                             am[nt][e] + kp[nt][e & 1]
                       : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float mu[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 1));
      mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 2));
      // no key below T yet: every exp below is of -inf, so 0, not NaN
      mu[q] = mx[q] == -INFINITY ? 0.f : mx[q];
      const float corr = expf(m[q] - mu[q]);
      l[q] *= corr;
#pragma unroll
      for (int nd = 0; nd < C::kND; ++nd) {
        o[nd][2 * q] *= corr;
        o[nd][2 * q + 1] *= corr;
      }
      m[q] = mx[q];
    }
    // P into s: l sums the undropped probabilities, P v the dropped ones
#pragma unroll
    for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(s[nt][e] - mu[e >> 1]);
        l[e >> 1] += pr;
        s[nt][e] = pr;
        const int i = i0 + r0 + c_row(e), j = j0 + c0 + nt * 8 + c_col(e);
        if (drop && i < T && j < T)
          s[nt][e] = tsasr::dropout_keep(seed, a.thresh, b, a.h0 + h, i, j)
                         ? pr * a.keep_scale
                         : 0.f;
      }
#pragma unroll
    for (int nt = 0; nt < C::kNKW; ++nt) {       // O += P v
      const FragA x = load_a_acc(s[nt]);
      mma_tf32x3_row(o, x, [&](int nd, int k, int n) {
        return sV[(c0 + nt * 8 + acc_key(k)) * C::kLd + nd * 8 + n];
      });
    }
    __syncthreads();                             // stage and sB consumed
  }

  // merge the two halves of each row group through the (idle) stages
  const int lane = threadIdx.x & 31;
  float* mine = stages + (2 * grp + half) * C::kMergeW;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    l[q] += __shfl_xor_sync(0xffffffffu, l[q], 1);
    l[q] += __shfl_xor_sync(0xffffffffu, l[q], 2);
    mine[(4 * C::kND + q) * 32 + lane] = m[q];
    mine[(4 * C::kND + 2 + q) * 32 + lane] = l[q];
  }
#pragma unroll
  for (int nd = 0; nd < C::kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(4 * nd + e) * 32 + lane] = o[nd][e];
  group_sync<kNR>();
  // both warps read both states, half 0's first, so they agree bit for bit
  const float* s0 = stages + 2 * grp * C::kMergeW;
  const float* s1 = s0 + C::kMergeW;
  float w0[2], w1[2], inv[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float m0 = s0[(4 * C::kND + q) * 32 + lane];
    const float m1 = s1[(4 * C::kND + q) * 32 + lane];
    const float mm = fmaxf(m0, m1);              // finite: key 0 is in half 0
    w0[q] = expf(m0 - mm);
    w1[q] = expf(m1 - mm);
    inv[q] = 1.f / (s0[(4 * C::kND + 2 + q) * 32 + lane] * w0[q] +
                    s1[(4 * C::kND + 2 + q) * 32 + lane] * w1[q]);
    const int i = i0 + r0 + lane_g() + 8 * q;
    if (a.stats != nullptr && half == 0 && lane_t() == 0 && i < T) {
      a.stats[2 * (bh + i)] = mm;
      a.stats[2 * (bh + i) + 1] = inv[q];
    }
  }
  // this warp writes half of Dh's n-tiles
  for (int nd = half * C::kND / 2; nd < (half + 1) * C::kND / 2; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = e >> 1, i = i0 + r0 + c_row(e), d = nd * 8 + c_col(e);
      const int x = (4 * nd + e) * 32 + lane;
      if (i < T && d < Dh)
        a.out[(bh + i) * Dh + d] =
            (s0[x] * w0[q] + s1[x] * w1[q]) * inv[q];
    }
}

template <int DP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<DP>;
  // Above 48 KB a block gets dynamic shared memory only on request
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        relpos_attention_fwd_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * C::kF);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const dim3 grid((a.T + C::kTileQ - 1) / C::kTileQ, a.H, B);
  relpos_attention_fwd_kernel<DP>
      <<<grid, C::kThreads, 4 * C::kF, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* x) { return ((uintptr_t)x & 15) == 0; }

// keep[b, h, i, j] = 1 iff the dropout keeps (b, h, i, j): the mask the
// attention kernels draw, written out for tests.
__global__ void dropout_mask_kernel(const long long* __restrict__ seed_ptr,
                                    uint32_t thresh,
                                    unsigned char* __restrict__ keep, int B,
                                    int H, int T, int h0) {
  const uint64_t seed = (uint64_t)seed_ptr[0];
  const size_t n = (size_t)B * H * T * T;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(e % T), i = (int)((e / T) % T);
    const int h = (int)((e / ((size_t)T * T)) % H);
    const int b = (int)(e / ((size_t)T * T * H));
    keep[e] = tsasr::dropout_keep(seed, thresh, b, h0 + h, i, j) ? 1 : 0;
  }
}

// c = (a @ b) @ d for row-major a (M x K), b (K x N), d (N x P), N <= 64:
// one warp per 16 rows x 8 columns of c. The intermediate a @ b goes from
// the accumulators into the A operand as the kernel's P does (a test of
// load_a_acc and acc_key).
__global__ void tf32x3_chain_kernel(const float* a, const float* b,
                                    const float* d, float* c, int M, int N,
                                    int K, int P) {
  constexpr int kN = 8;                          // n-tiles of a @ b
  const int m0 = blockIdx.x * 16, p0 = blockIdx.y * 8;
  float x[kN][4] = {};
  for (int k0 = 0; k0 < K; k0 += 8) {
    const FragA f = load_a([&](int r, int k) {
      return (m0 + r < M && k0 + k < K) ? a[(size_t)(m0 + r) * K + k0 + k]
                                        : 0.f;
    });
    mma_tf32x3_row(x, f, [&](int nt, int k, int n) {
      const int col = nt * 8 + n;
      return (k0 + k < K && col < N) ? b[(size_t)(k0 + k) * N + col] : 0.f;
    });
  }
  float acc[1][4] = {};
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
    const FragA f = load_a_acc(x[nt]);
    mma_tf32x3_row(acc, f, [&](int, int k, int n) {
      const int r = nt * 8 + acc_key(k);
      return (r < N && p0 + n < P) ? d[(size_t)r * P + p0 + n] : 0.f;
    });
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = m0 + c_row(e), col = p0 + c_col(e);
    if (r < M && col < P) c[(size_t)r * P + col] = acc[0][e];
  }
}

}  // namespace

// q_u, q_v, k, v, out: (B, H, T, Dh); p: (H, 2T-1, Dh); kp: (B, T);
// am: (T, T); all f32, contiguous, on the current device. stats
// (B, H, T, 2) may be null. seed: one int64 on the device, or null for no dropout;
// thresh = floor(rate * 2^32), keep_scale = 1 / (1 - rate); h0: the
// first head's index among the model's (a tensor-parallel rank launches
// heads h0..h0+H-1), which the dropout counts heads from. Returns the
// CUDA error code of the launch (0 on success). 1 <= Dh <= 128.
extern "C" int relpos_attention_fwd(const float* qu, const float* qv,
                                    const float* k, const float* v,
                                    const float* p, const float* kp,
                                    const float* am, float* out, float* stats,
                                    unsigned thresh, float keep_scale,
                                    const long long* seed, int B, int H,
                                    int T, int Dh, float scale,
                                    void* stream, int h0) {
  if (B < 1 || H < 1 || T < 1 || Dh < 1 || Dh > 128 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = Dh % 4 == 0 && aligned16(qu) && aligned16(qv) &&
                   aligned16(k) && aligned16(v) && aligned16(p);
  Args a{qu, qv, k, v, p, kp, am, out, stats, seed, thresh, keep_scale,
         scale, H, T, Dh, vec, h0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Dh <= 32)
    err = launch<32>(a, B, s);
  else if (Dh <= 64)
    err = launch<64>(a, B, s);
  else
    err = launch<128>(a, B, s);
  return (int)err;
}

// keep: (B, H, T, T) uint8, written 1 where the dropout keeps an element,
// the heads counted from h0.
extern "C" int relpos_dropout_mask(const long long* seed, unsigned thresh,
                                   unsigned char* keep, int B, int H, int T,
                                   void* stream, int h0) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  dropout_mask_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, thresh, keep, B, H, T, h0);
  return (int)cudaGetLastError();
}

// c = (a @ b) @ d through the 3xTF32 helper, the intermediate routed from
// the accumulators into the A operand (a: M x K, b: K x N, d: N x P,
// row-major f32 on the current device; N <= 64), for tests. Returns the
// CUDA error code.
extern "C" int relpos_tf32x3_chain_test(const float* a, const float* b,
                                        const float* d, float* c, int M,
                                        int N, int K, int P, void* stream) {
  if (M < 1 || N < 1 || N > 64 || K < 1 || P < 1 || (P + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  tf32x3_chain_kernel<<<dim3((M + 15) / 16, (P + 7) / 8), 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, b, d, c, M,
                                                             N, K, P);
  return (int)cudaGetLastError();
}

// ===================================================================== bf16
// The bf16 forward (relpos_attention_fwd_bf16): q_u, q_v, k, v, p and the
// output in bf16, the masks and the statistics f32. It computes the JAX
// _fwd_kernel with bf16 operands (v.dtype bf16) and rounds where it
// rounds: every product takes bf16 operands and sums in f32 (mma_bf16.cuh,
// one m16n8k16 mma a k-step of 16); the positional scores stay f32 through
// the rel-shift (the TPU kernel's roll runs in f32); the scores, masks,
// softmax and dropout scaling are f32; the probabilities are normalised by
// the row's max m and sum l over all keys and only then rounded to bf16,
// P = bf16(exp(s - m) / l * keep / (1 - rate)), before the product with v;
// the output is rounded to bf16 once. The keep decision of (b, h, i, j) is
// the f32 kernel's Philox draw, and the statistics (m, 1 / l) mean what
// they mean there: the bf16 backward reads them.
//
// What bounds it on an H100: at B8 H4 T101 Dh64 it moves about 2.2 MB
// (bf16 operands and output, f32 masks and statistics) and does 6 B H
// T^2 Dh = 125 MFLOP of products: 0.00066 ms of bytes at 3.35 TB/s against
// 0.00013 ms at the bf16 tensor-core peak (989 TFLOP/s): bytes. At these
// sizes a block's serial chain of copies, barriers and products sets the
// time, not the bytes.
//
// The resident kernel (relpos_attention_fwd_bf16_resident_kernel) keeps
// each block's rows of scores whole in shared memory, as the TPU kernel
// keeps its (BB, Tp, Tp) tile in VMEM, so every product is done once and
// the rounding stays where JAX puts it. A block takes TQ query rows of one
// (b, h) and streams three sequences of CHUNK-row chunks through one ring
// of cp.async stages (Res16 below: TQ 16, CHUNK 64, 2 stages), each row
// copied once: the window of p rows, then k, then v.
//
//   1. The positional term: window row w (p row T - TQ - i0 + w) meets
//      query row r at key c = w + r - (TQ - 1). Each row group of 16
//      computes q_v(16 rows) @ window^T over its own T + 15 window rows,
//      its warps side by side over each chunk's n-tiles, and stores every
//      product straight to its skewed place in the f32 score buffer S
//      (TQ rows, roundup(T, 16) + 4 floats apart). No column beyond the
//      group's T + 15 is computed (the two-pass kernel computed TK + 16
//      for every TK keys) and no separate buffer is read back.
//   2. S = (q_u k^T + S) * scale, each k chunk's products added in place
//      by the lanes that hold them.
//   3. The softmax, one warp a row: the masks am (its row, coalesced) and
//      kp added once, the exact row max, exp(s - m) stored back and
//      summed, the statistics written, then P = bf16(e / l, dropped)
//      written over the row's own first half (bf16 P row r starts where
//      the f32 row r does: rows 2 (roundup(T, 16) + 4) elements apart,
//      16-byte aligned, and an ldmatrix phase's 8 rows hit 8 bank groups).
//      The first v chunks are already in flight.
//   4. O = P v over the v chunks in key order, k-steps of 16, P by
//      ldmatrix, each warp over its row group and its share of Dh's
//      n-tiles: no cross-warp merge. The output is rounded once.
//
// Against the two-pass kernel below, per key: the q_u k^T and positional
// products once instead of twice and no padded window columns (about 24
// mma.sync a warp per 32 keys instead of 48), k and the window copied once
// (v once, as before), the masks read once and coalesced, one barrier per
// chunk of CHUNK rows (about 3 T / CHUNK + 2 in all) instead of 2
// per 32 keys in each of two passes, no pair barrier and no merge.
//
// Sweep (chip_attention_ab.py over edited copies of this source, H100
// 80GB HBM3 700.00 W; device ms, profiler, dropout 0; B8 T101 / B8 T208 /
// B8 T408 / B6 T208 / B3 T408, all H4 Dh64; the two-pass kernel .0153 /
// .0304 / .0987 / .0291 / .0530):
//   TQ 16, 4 warps, chunks of 64, 2 stages (chosen): .0084 / .0179 /
//     .0521 / .0149 / .0232;
//   3 stages: .0082 / .0183 / .0582 / .0145 / .0225 (3 blocks an SM at
//     T408, from 4);
//   chunks of 32: .0096 / .0180 / .0548 / .0158 / .0263; of 128: .0082 /
//     .0172 / .0605 / .0142 / .0231;
//   8 warps (at most 80 registers): .0082 / .0238 / .0591 / .0164 /
//     .0255;
//   TQ 32, 8 warps: .0083 / .0157 / .0477 / .0156 / .0245: ahead at B8,
//     behind at the training buckets' own batches, where the bf16 path
//     runs.
// Stamps (thread 0's clock64, in an edited copy) put a block's time in
// its dependent latency chains, not in waiting for copies: at B3
// T408 a block takes 37 k cycles, 10.7 k in the window chunks, 8.4 k in
// the k chunks, 11.2 k in the softmax and 7.5 k in P v; issuing the
// chunks' cp.async 7.2 k of them (21 chunks), waiting for them 1.4 k. So
// the softmax's loops and the k chunks load everything before they store
// (the compiler cannot tell the rows apart and would run each element's
// load, arithmetic and store in turn), the chunk copies unroll, and bulk
// copies (cp.async.bulk, one a row, tried) lose: one warp's lanes issue
// them one after another.
//
// The long route. A block needs 4 TQ (roundup(T, 16) + 4) bytes of scores
// beside its q tiles and stages, at most 227 KB: TQ = 16 rows hold T up
// to 3264 keys at Dh 33-64 (3424 at Dh <= 32, 2944 at Dh 65-128;
// relpos_attention_fwd_bf16_max_t). Past that the wrapper launches the
// two-pass kernel (relpos_attention_fwd_bf16_long), which holds no row of
// scores: it decides by T before the launch. The port's model (Dh 64, 25
// frames a second) reaches the long route at 3265 frames, a 130.6 s
// utterance; every shorter T fits, because the buffer grows by 64 bytes a
// key and nothing else in the block grows with T.
//
// The two-pass kernel (relpos_attention_fwd_bf16_two_pass_kernel) keeps
// the f32 kernel's tiling: 32 query rows a block, key tiles of 32, two
// warps a row group, each over half of every key tile. Pass 1 takes the
// scores' products and each row's max and sum (online, no v), the two
// warps of a row group merge them (and write the statistics); pass 2
// takes the products again (the same scores, bit for bit), the normalised,
// dropped probabilities, and O += bf16(P) v; the halves' O are added at
// the end. Tiles are bf16 in shared memory (rows DP + 8 elements apart),
// q_v, q_u, the window, k and v by ldmatrix (.trans for v), P straight
// from the accumulators (pack_acc).

#include "mma_bf16.cuh"

namespace {

using tsasr::bf16;
using tsasr::FragA16;
using tsasr::ldsm_a;
using tsasr::load_rows16;
using tsasr::mma_row_kmajor;
using tsasr::mma_row_nmajor;
using tsasr::pack_acc;
using tsasr::pair_sync;

struct Args16 {
  const bf16 *qu, *qv, *k, *v, *p;
  const float *kp, *am;
  bf16* out;
  float* stats;
  const long long* seed;
  uint32_t thresh;
  float keep_scale, scale;
  int H, T, Dh;
  bool vec;                                // 16-byte copies are aligned
  int h0;                                  // the first head's model index
};

// DP: padded head dim; sizes in bf16 elements unless named in floats
template <int DP>
struct Cfg16 {
  static constexpr int kTileQ = kWarpRows * kNR;
  static constexpr int kWarps = 2 * kNR;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWin = kTileQ + kTileK;   // a pair's p rows
  static constexpr int kBW = kTileK + kWarpRows; // a row group's (TK + 15)
  static constexpr int kNB = kBW / 8;      // its n-tiles, half to each warp
  static constexpr int kWK = kTileK / 2;   // keys of a warp: one k-step
  static constexpr int kNKW = kWK / 8;
  static constexpr int kND = DP / 8;       // n-tiles over the head dim
  static constexpr int kLd = DP + 8;
  static constexpr int kLdB = kBW + 4;     // the f32 BD buffer's rows
  static constexpr int kQE = kTileQ * kLd;
  static constexpr int kKE = kTileK * kLd;
  static constexpr int kStage = 2 * kKE + kWin * kLd;   // k, v, window
  static constexpr int kTileBytes = 2 * (2 * kQE + 2 * kStage);
  static constexpr int kBytes = kTileBytes + 4 * kNR * kWarpRows * kLdB;
  static constexpr int kMergeW = 32 * 4 * kND;   // a warp's O, in floats
  static_assert(kNB % 2 == 0 && kND % 2 == 0 && kWK == 16, "warp shares");
  static_assert(4 * 2 * kNR * kMergeW <= 2 * 2 * kStage,
                "merge fits the stages");
  static_assert(kBytes <= kSmemLimit, "shared memory of a block");
};

template <int DP>
__global__ void __launch_bounds__(Cfg16<DP>::kThreads)
    relpos_attention_fwd_bf16_two_pass_kernel(Args16 a) {
  using C = Cfg16<DP>;
  extern __shared__ __align__(16) unsigned char smem16[];
  const int T = a.T, Dh = a.Dh, nk = (T + kTileK - 1) / kTileK;
  const int i0 = blockIdx.x * C::kTileQ, h = blockIdx.y, b = blockIdx.z;
  const int grp = row_group<kNR>(), half = warp_half<kNR>();
  const int r0 = grp * kWarpRows, c0 = half * C::kWK;
  const int first = C::kTileQ - kWarpRows - r0;  // the group's window row 0
  const size_t bh = ((size_t)b * a.H + h) * T;
  const bf16* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  const bool drop = a.seed != nullptr;
  const uint64_t seed = drop ? (uint64_t)a.seed[0] : 0;
  bf16* sQu = reinterpret_cast<bf16*>(smem16);
  bf16* sQv = sQu + C::kQE;
  bf16* stages = sQv + C::kQE;                   // k, v, window
  float* sB = reinterpret_cast<float*>(smem16 + C::kTileBytes) +
              r0 * C::kLdB;

  // k and the window for the scores; v too in the second pass
  auto load_keys = [&](int s, int j0, bool with_v) {
    bf16* st = stages + s * C::kStage;
    load_rows16<DP, C::kThreads>(st, a.k + bh * Dh, j0, kTileK, T, Dh, a.vec);
    if (with_v)
      load_rows16<DP, C::kThreads>(st + C::kKE, a.v + bh * Dh, j0, kTileK,
                                   T, Dh, a.vec);
    load_rows16<DP, C::kThreads>(st + 2 * C::kKE, p_h,
                                 T - C::kTileQ - i0 + j0, C::kWin, 2 * T - 1,
                                 Dh, a.vec);
  };
  load_rows16<DP, C::kThreads>(sQu, a.qu + bh * Dh, i0, C::kTileQ, T, Dh,
                               a.vec);
  load_rows16<DP, C::kThreads>(sQv, a.qv + bh * Dh, i0, C::kTileQ, T, Dh,
                               a.vec);

  // rows g and g + 8 of the group: the max and this lane's share of the
  // sum of this warp's keys (pass 1), then the row's max and 1 / sum
  // over all keys; O over this warp's keys (pass 2)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
  float o[C::kND][4] = {};
  const int lane = threadIdx.x & 31;
  float* merge = reinterpret_cast<float*>(stages);  // idle between passes

  for (int pass = 0; pass < 2; ++pass) {
    load_keys(0, 0, pass == 1);
    cp_async_commit();
    for (int jt = 0; jt < nk; ++jt) {
      const int j0 = jt * kTileK;
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
      if (jt + 1 < nk) {
        load_keys((jt + 1) & 1, j0 + kTileK, pass == 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sK = stages + (jt & 1) * C::kStage;
      const bf16* sV = sK + C::kKE;
      const bf16* sP = sK + 2 * C::kKE;

      {                                          // BD, half the columns
        constexpr int kHalf = C::kNB / 2;
        const int nb0 = half * kHalf;
        float bd[kHalf][4] = {};
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_row_nmajor<kHalf>(bd,
                                ldsm_a(sQv + r0 * C::kLd + kk * 16, C::kLd),
                                sP + (first + nb0 * 8) * C::kLd + kk * 16,
                                C::kLd);
#pragma unroll
        for (int nb = 0; nb < kHalf; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sB[c_row(e) * C::kLdB + (nb0 + nb) * 8 + c_col(e)] = bd[nb][e];
      }
      float s[C::kNKW][4] = {};
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)       // S = q_u k^T
        mma_row_nmajor<C::kNKW>(s,
                                ldsm_a(sQu + r0 * C::kLd + kk * 16, C::kLd),
                                sK + c0 * C::kLd + kk * 16, C::kLd);
      pair_sync(grp);                            // BD of both halves
#pragma unroll
      for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = c_row(e), c = c0 + nt * 8 + c_col(e);
          s[nt][e] =
              j0 + c < T
                  ? (s[nt][e] + sB[rl * C::kLdB + kWarpRows - 1 - rl + c]) *
                            a.scale +
                        am[nt][e] + kp[nt][e & 1]
                  : -INFINITY;
        }

      if (pass == 0) {                           // the row's max and sum
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 1));
          mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 2));
          // no key below T yet: every exp below is of -inf, so 0, not NaN
          const float mu = mx[q] == -INFINITY ? 0.f : mx[q];
          l[q] *= expf(m[q] - mu);
#pragma unroll
          for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
            for (int e = 2 * q; e < 2 * q + 2; ++e)
              l[q] += expf(s[nt][e] - mu);
          m[q] = mx[q];
        }
      } else {                                   // O += bf16(P) v
#pragma unroll
        for (int nt = 0; nt < C::kNKW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = e >> 1;
            const float pr = expf(s[nt][e] - m[q]) * inv[q];
            const int i = i0 + r0 + c_row(e), j = j0 + c0 + nt * 8 + c_col(e);
            s[nt][e] = drop && i < T && j < T
                           ? (tsasr::dropout_keep(seed, a.thresh, b,
                                                  a.h0 + h, i, j)
                                  ? pr * a.keep_scale
                                  : 0.f)
                           : pr;
          }
        mma_row_kmajor<C::kND>(o, pack_acc(s[0], s[1]), sV + c0 * C::kLd,
                               C::kLd);
      }
      __syncthreads();                           // stage and sB consumed
    }
    if (pass == 1) break;

    // the two halves' (max, sum) merged, in one order in both warps
    float* mine = merge + (2 * grp + half) * 128;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      l[q] += __shfl_xor_sync(0xffffffffu, l[q], 1);
      l[q] += __shfl_xor_sync(0xffffffffu, l[q], 2);
      mine[q * 32 + lane] = m[q];
      mine[(2 + q) * 32 + lane] = l[q];
    }
    pair_sync(grp);
    const float* s0 = merge + 2 * grp * 128;
    const float* s1 = s0 + 128;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float m0 = s0[q * 32 + lane], m1 = s1[q * 32 + lane];
      const float mm = fmaxf(m0, m1);            // finite: key 0 is in half 0
      inv[q] = 1.f / (s0[(2 + q) * 32 + lane] * expf(m0 - mm) +
                      s1[(2 + q) * 32 + lane] * expf(m1 - mm));
      m[q] = mm;
      const int i = i0 + r0 + lane_g() + 8 * q;
      if (a.stats != nullptr && half == 0 && lane_t() == 0 && i < T) {
        a.stats[2 * (bh + i)] = mm;
        a.stats[2 * (bh + i) + 1] = inv[q];
      }
    }
    __syncthreads();                             // merge read: stages free
  }

  // O = the two halves' sums, half 0's first, each warp half of Dh
  float* mine = merge + (2 * grp + half) * C::kMergeW;
#pragma unroll
  for (int nd = 0; nd < C::kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(4 * nd + e) * 32 + lane] = o[nd][e];
  pair_sync(grp);
  const float* s0 = merge + 2 * grp * C::kMergeW;
  const float* s1 = s0 + C::kMergeW;
  for (int nd = half * C::kND / 2; nd < (half + 1) * C::kND / 2; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + r0 + c_row(e), d = nd * 8 + c_col(e);
      const int x = (4 * nd + e) * 32 + lane;
      if (i < T && d < Dh)
        a.out[(bh + i) * Dh + d] = __float2bfloat16_rn(s0[x] + s1[x]);
    }
}

template <int DP>
cudaError_t launch16(const Args16& a, int B, cudaStream_t stream) {
  using C = Cfg16<DP>;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        relpos_attention_fwd_bf16_two_pass_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const dim3 grid((a.T + C::kTileQ - 1) / C::kTileQ, a.H, B);
  relpos_attention_fwd_bf16_two_pass_kernel<DP>
      <<<grid, C::kThreads, C::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// dst[r * (DP + 8) + c] = src[(first + r) * Dh + c] for r < N, c < DP,
// zeros outside rows [0, limit) and columns [0, Dh), by 16-byte cp.async
// (Dh % 8 == 0, 16-byte aligned rows): load_rows16 with its trip count
// known (NT threads a block), so the copies of a chunk unroll
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

// The resident kernel's shape, from the sweep in the header comment. DP:
// padded head dim; sizes in bf16 elements unless named in bytes
template <int DP>
struct Res16 {
  static constexpr int kTileQ = 16;                  // query rows of a block
  static constexpr int kNR = kTileQ / kWarpRows;     // row groups
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kU = kWarps / kNR;            // warps of a row group
  static constexpr int kChunk = 64;                  // rows of a stage
  static constexpr int kStages = 2;
  static constexpr int kLd = DP + 8;
  static constexpr int kNC = kChunk / 8 / kU;   // a warp's n-tiles of a chunk
  static constexpr int kND = DP / 8;            // n-tiles over the head dim
  static constexpr int kNDW = kND >= kU ? kND / kU : 1;   // a warp's of them
  static constexpr int kRows = kTileQ / kWarps;      // a warp's softmax rows
  static constexpr int kTileBytes =
      2 * (2 * kTileQ + kStages * kChunk) * kLd;     // q_u, q_v, the stages
  static_assert(kTileQ % kWarpRows == 0 && kWarps % kNR == 0, "row groups");
  static_assert(kNC >= 1 && kNC * 8 * kU == kChunk, "a chunk's n-tiles");
  static_assert(kND % kU == 0 || kND < kU, "Dh's n-tiles");
  static_assert(kRows >= 1 && kRows * kWarps == kTileQ, "softmax rows");
  static_assert(kStages >= 2 && kChunk % 16 == 0, "stages");
};

// keys padded to whole k-steps, and the f32 score rows' stride: a multiple
// of 4 floats whose quarter is odd (16-byte rows, conflict-free ldmatrix
// of the bf16 P rows laid over them)
__host__ __device__ constexpr int res16_tpad(int T) {
  return (T + 15) / 16 * 16;
}
__host__ __device__ constexpr int res16_ld(int T) { return res16_tpad(T) + 4; }

template <int DP>
size_t res16_bytes(int T) {
  return 4 * (size_t)Res16<DP>::kTileQ * res16_ld(T) + Res16<DP>::kTileBytes;
}

// the largest T whose block fits kSmemLimit
template <int DP>
int res16_max_t() {
  const int ld = (kSmemLimit - Res16<DP>::kTileBytes) / (4 * Res16<DP>::kTileQ);
  return (ld - 4) / 16 * 16;
}

template <int DP>
__global__ void __launch_bounds__(Res16<DP>::kThreads, 1)
    relpos_attention_fwd_bf16_resident_kernel(Args16 a) {
  using C = Res16<DP>;
  extern __shared__ __align__(16) unsigned char smem16[];
  const int T = a.T, Dh = a.Dh, Tp = res16_tpad(T), ldS = res16_ld(T);
  const int ldP = 2 * ldS;                       // bf16 P rows over S rows
  const int i0 = blockIdx.x * C::kTileQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp % C::kNR, u = warp / C::kNR, r0 = grp * kWarpRows;
  const size_t bh = ((size_t)b * a.H + h) * T;
  const bf16* p_h = a.p + (size_t)h * (2 * T - 1) * Dh;
  float* S = reinterpret_cast<float*>(smem16);
  bf16* P = reinterpret_cast<bf16*>(smem16);
  bf16* sQu = reinterpret_cast<bf16*>(smem16 + 4 * (size_t)C::kTileQ * ldS);
  bf16* sQv = sQu + C::kTileQ * C::kLd;
  bf16* stages = sQv + C::kTileQ * C::kLd;
  // window row w is p row T - TQ - i0 + w; the block's rows use w in
  // [0, T + TQ - 1), row group g's in [lo, lo + T + 15)
  const int lo = C::kTileQ - kWarpRows - r0;
  const int nW = (T + C::kTileQ - 1 + C::kChunk - 1) / C::kChunk;
  const int nK = (T + C::kChunk - 1) / C::kChunk;
  const int nQ = nW + nK + (Tp + C::kChunk - 1) / C::kChunk;

  // chunk q of the window, then k, then v, into its stage
  auto load_chunk = [&](int q) {
    bf16* st = stages + (q % C::kStages) * C::kChunk * C::kLd;
    const bf16* src = q < nW        ? p_h
                      : q < nW + nK ? a.k + bh * Dh
                                    : a.v + bh * Dh;
    const int first = q < nW        ? T - C::kTileQ - i0 + q * C::kChunk
                      : q < nW + nK ? (q - nW) * C::kChunk
                                    : (q - nW - nK) * C::kChunk;
    const int limit = q < nW ? 2 * T - 1 : T;
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
  load_chunk(0);
  cp_async_commit();
#pragma unroll
  for (int q = 1; q < C::kStages - 1; ++q) {
    if (q < nQ) load_chunk(q);
    cp_async_commit();
  }

  FragA16 qf[DP / 16];             // the group's rows of q_v, then of q_u
  float o[C::kNDW][4] = {};
  for (int q = 0; q < nQ; ++q) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();                 // chunk q landed; chunk q - 1's stage free
    if (q + C::kStages - 1 < nQ) load_chunk(q + C::kStages - 1);
    cp_async_commit();
    const bf16* st = stages + (q % C::kStages) * C::kChunk * C::kLd;
    if (q < nW + nK) {                           // the scores
      const bool win = q < nW;
      if (q == 0 || q == nW)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          qf[kk] = ldsm_a((win ? sQv : sQu) + r0 * C::kLd + kk * 16, C::kLd);
      // this warp's first window row or key of the chunk
      const int x0 = (win ? q : q - nW) * C::kChunk + u * C::kNC * 8;
      if (win ? x0 + C::kNC * 8 > lo && x0 < lo + T + kWarpRows - 1
              : x0 < T) {
        float acc[C::kNC][4] = {};
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_row_nmajor<C::kNC>(acc, qf[kk],
                                 st + u * C::kNC * 8 * C::kLd + kk * 16,
                                 C::kLd);
        if (win) {                               // to its skewed place
#pragma unroll
          for (int nb = 0; nb < C::kNC; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r0 + c_row(e);
              const int c = x0 + nb * 8 + c_col(e) + r - (C::kTileQ - 1);
              if (c >= 0 && c < T) S[r * ldS + c] = acc[nb][e];
            }
        } else {               // added in place: every load before a store
          float bd[C::kNC][4];
#pragma unroll
          for (int nb = 0; nb < C::kNC; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = x0 + nb * 8 + c_col(e);
              bd[nb][e] = x < T ? S[(r0 + c_row(e)) * ldS + x] : 0.f;
            }
#pragma unroll
          for (int nb = 0; nb < C::kNC; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = x0 + nb * 8 + c_col(e);
              if (x < T)
                S[(r0 + c_row(e)) * ldS + x] =
                    (acc[nb][e] + bd[nb][e]) * a.scale;
            }
        }
      }
      continue;
    }
    if (q == nW + nK) {                          // the softmax, a warp a row
      // This warp's rows side by side, kCols columns a lane at a time, and
      // in each step every load before any store: the compiler cannot
      // tell the rows apart, and would otherwise run each element's
      // load, arithmetic and store in turn.
      constexpr int kCols = 2;
      const bool drop = a.seed != nullptr;
      const uint64_t seed = drop ? (uint64_t)a.seed[0] : 0;
      const float* kp = a.kp + (size_t)b * T;
      const float* am[C::kRows];
      float* row[C::kRows];
      float mx[C::kRows], l[C::kRows], inv[C::kRows];
#pragma unroll
      for (int k = 0; k < C::kRows; ++k) {
        const int r = warp + k * C::kWarps;
        row[k] = S + r * ldS;
        am[k] = a.am + (size_t)min(i0 + r, T - 1) * T;
        mx[k] = -INFINITY;
        l[k] = 0.f;
      }
      for (int c0 = lane; c0 < T; c0 += 32 * kCols) {   // the masks, the max
        float x[kCols][C::kRows], amc[kCols][C::kRows], kpc[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = min(c0 + 32 * j, T - 1);
          kpc[j] = __ldg(kp + c);
#pragma unroll
          for (int k = 0; k < C::kRows; ++k) {
            amc[j][k] = __ldg(am[k] + c);
            x[j][k] = row[k][c];
          }
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (c0 + 32 * j < T)
#pragma unroll
            for (int k = 0; k < C::kRows; ++k) {
              // (s + am) + kp, the plain version's order: on a row whose
              // keys are all masked the scores keep an ulp of 64 or 128
              x[j][k] = x[j][k] + amc[j][k] + kpc[j];
              row[k][c0 + 32 * j] = x[j][k];
              mx[k] = fmaxf(mx[k], x[j][k]);
            }
      }
#pragma unroll
      for (int k = 0; k < C::kRows; ++k) {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], d));
        if (mx[k] == -INFINITY) mx[k] = 0.f;     // no exp(-inf + inf)
      }
      for (int c0 = lane; c0 < T; c0 += 32 * kCols) {   // exp(s - m), the sum
        float x[kCols][C::kRows];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int k = 0; k < C::kRows; ++k)
            x[j][k] = row[k][min(c0 + 32 * j, T - 1)];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (c0 + 32 * j < T)
#pragma unroll
            for (int k = 0; k < C::kRows; ++k) {
              x[j][k] = expf(x[j][k] - mx[k]);
              row[k][c0 + 32 * j] = x[j][k];
              l[k] += x[j][k];
            }
      }
#pragma unroll
      for (int k = 0; k < C::kRows; ++k) {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          l[k] += __shfl_xor_sync(0xffffffffu, l[k], d);
        inv[k] = 1.f / l[k];
        const int i = i0 + warp + k * C::kWarps;
        if (a.stats != nullptr && lane == 0 && i < T) {
          a.stats[2 * (bh + i)] = mx[k];
          a.stats[2 * (bh + i) + 1] = inv[k];
        }
      }
      // P over each row's first half: the step from c0 writes the floats
      // (c0 - lane) / 2 .. (c0 - lane) / 2 + 32 kCols / 2 - 1, which this
      // step or an earlier one has read
      for (int c0 = lane; c0 - lane < Tp; c0 += 32 * kCols) {
        float pr[kCols][C::kRows];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int k = 0; k < C::kRows; ++k)
            pr[j][k] = row[k][min(c0 + 32 * j, T - 1)];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + 32 * j;
#pragma unroll
          for (int k = 0; k < C::kRows; ++k) {
            const int i = i0 + warp + k * C::kWarps;
            pr[j][k] = c < T ? pr[j][k] * inv[k] : 0.f;
            if (drop && c < T && i < T)
              pr[j][k] = tsasr::dropout_keep(seed, a.thresh, b, a.h0 + h, i, c)
                             ? pr[j][k] * a.keep_scale
                             : 0.f;
          }
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int k = 0; k < C::kRows; ++k)
            if (c0 + 32 * j < Tp)
              reinterpret_cast<bf16*>(row[k])[c0 + 32 * j] =
                  __float2bfloat16_rn(pr[j][k]);
      }
      __syncthreads();                           // P whole
    }
    if (u * C::kNDW < C::kND) {                  // O += P v, in key order
      const int v0 = (q - nW - nK) * C::kChunk;
#pragma unroll
      for (int ks = 0; ks < C::kChunk / 16; ++ks)
        if (v0 + 16 * ks < Tp)
          mma_row_kmajor<C::kNDW>(
              o, ldsm_a(P + r0 * ldP + v0 + 16 * ks, ldP),
              st + 16 * ks * C::kLd + u * C::kNDW * 8, C::kLd);
    }
  }
  if (u * C::kNDW >= C::kND) return;
#pragma unroll
  for (int nd = 0; nd < C::kNDW; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + r0 + c_row(e), d = (u * C::kNDW + nd) * 8 + c_col(e);
      if (i < T && d < Dh)
        a.out[(bh + i) * Dh + d] = __float2bfloat16_rn(o[nd][e]);
    }
}

template <int DP>
cudaError_t launch_res16(const Args16& a, int B, cudaStream_t stream) {
  using C = Res16<DP>;
  const size_t bytes = res16_bytes<DP>(a.T);
  if (a.T > res16_max_t<DP>() || bytes > (size_t)kSmemLimit)
    return cudaErrorInvalidValue;                // the long route's T
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        relpos_attention_fwd_bf16_resident_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const dim3 grid((a.T + C::kTileQ - 1) / C::kTileQ, a.H, B);
  relpos_attention_fwd_bf16_resident_kernel<DP>
      <<<grid, C::kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// c = a @ b for bf16 a (M x K) and b (K x N), row-major, M, N, K
// multiples of 16, K <= 64, f32 out: one block, one warp per 16 rows of
// c, the operands staged in shared memory and read by the route `mode`
// selects (a test of the fragment layouts): 0 ldmatrix a row-major, b
// k-major (.trans); 1 a from its transpose (.trans), b from its
// transpose (n-major); 2 the functor loaders; 3 the accumulator route,
// c = (a @ I) @ b with the first product's n-tiles packed as the A
// operand of the second.
constexpr int kTestMax = 64;
__global__ void bf16_matmul_test_kernel(const bf16* a, const bf16* b,
                                        float* c, int M, int N, int K,
                                        int mode) {
  constexpr int ld = kTestMax + 8;
  __shared__ __align__(16) bf16 sA[kTestMax * ld], sAt[kTestMax * ld];
  __shared__ __align__(16) bf16 sBk[kTestMax * ld], sBn[kTestMax * ld];
  __shared__ __align__(16) bf16 sI[kTestMax * ld];
  for (int e = threadIdx.x; e < kTestMax * kTestMax; e += blockDim.x) {
    const int r = e / kTestMax, q = e % kTestMax;
    const bf16 zero = __float2bfloat16(0.f);
    sA[r * ld + q] = r < M && q < K ? a[r * K + q] : zero;
    sAt[q * ld + r] = sA[r * ld + q];
    sBk[r * ld + q] = r < K && q < N ? b[r * N + q] : zero;
    sBn[q * ld + r] = sBk[r * ld + q];
    sI[r * ld + q] = __float2bfloat16(r == q ? 1.f : 0.f);
  }
  __syncthreads();
  const int m0 = (threadIdx.x >> 5) * 16;
  if (m0 >= M) return;
  float acc[kTestMax / 8][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    FragA16 x;
    if (mode == 0 || mode == 3) {
      x = ldsm_a(sA + m0 * ld + k0, ld);
    } else if (mode == 1) {
      x = tsasr::ldsm_a_trans(sAt + k0 * ld + m0, ld);
    } else {
      x = tsasr::load_a16([&](int r, int q) { return sA[(m0 + r) * ld + k0 + q]; });
    }
    if (mode == 3) {
      // x @ I[k0:k0+16, :] -> the n-tiles of columns k0..k0+15 of a, back
      // into an A operand
      float t[2][4] = {};
      mma_row_kmajor<2>(t, x, sI + k0 * ld + k0, ld);
      x = pack_acc(t[0], t[1]);
    }
    if (mode == 1) {
      mma_row_nmajor<kTestMax / 8>(acc, x, sBn + k0, ld);
    } else if (mode == 2) {
#pragma unroll
      for (int n = 0; n < kTestMax / 8; ++n)
        tsasr::mma_bf16(acc[n], x, tsasr::load_b16([&](int q, int col) {
          return sBk[(k0 + q) * ld + n * 8 + col];
        }));
    } else {
      mma_row_kmajor<kTestMax / 8>(acc, x, sBk + k0 * ld, ld);
    }
  }
#pragma unroll
  for (int n = 0; n < kTestMax / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + c_row(e), col = n * 8 + c_col(e);
      if (r < M && col < N) c[r * N + col] = acc[n][e];
    }
}

}  // namespace

namespace {

Args16 bf16_args(const __nv_bfloat16* qu, const __nv_bfloat16* qv,
                 const __nv_bfloat16* k, const __nv_bfloat16* v,
                 const __nv_bfloat16* p, const float* kp, const float* am,
                 __nv_bfloat16* out, float* stats, unsigned thresh,
                 float keep_scale, const long long* seed, int H, int T,
                 int Dh, float scale, int h0) {
  const bool vec = Dh % 8 == 0 && aligned16(qu) && aligned16(qv) &&
                   aligned16(k) && aligned16(v) && aligned16(p);
  return Args16{qu, qv, k, v, p, kp, am, out, stats, seed, thresh,
                keep_scale, scale, H, T, Dh, vec, h0};
}

bool bf16_shape_ok(int B, int H, int T, int Dh) {
  return B >= 1 && H >= 1 && T >= 1 && Dh >= 1 && Dh <= 128 && B <= 65535 &&
         H <= 65535;
}

}  // namespace

// The bf16 forward: q_u, q_v, k, v, out (B, H, T, Dh) and p (H, 2T-1,
// Dh) in bf16; kp (B, T), am (T, T) and stats (B, H, T, 2, may be null)
// f32; the rest as relpos_attention_fwd. The resident kernel: T at most
// relpos_attention_fwd_bf16_max_t(Dh), else cudaErrorInvalidValue. Returns
// the CUDA error code of the launch (0 on success). 1 <= Dh <= 128.
extern "C" int relpos_attention_fwd_bf16(
    const __nv_bfloat16* qu, const __nv_bfloat16* qv, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const __nv_bfloat16* p, const float* kp,
    const float* am, __nv_bfloat16* out, float* stats, unsigned thresh,
    float keep_scale, const long long* seed, int B, int H, int T, int Dh,
    float scale, void* stream, int h0) {
  if (!bf16_shape_ok(B, H, T, Dh)) return (int)cudaErrorInvalidValue;
  const Args16 a = bf16_args(qu, qv, k, v, p, kp, am, out, stats, thresh,
                             keep_scale, seed, H, T, Dh, scale, h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh <= 32) return (int)launch_res16<32>(a, B, s);
  if (Dh <= 64) return (int)launch_res16<64>(a, B, s);
  return (int)launch_res16<128>(a, B, s);
}

// The largest T the resident kernel takes at head dim Dh (1..128; 0
// otherwise): past it, relpos_attention_fwd_bf16_long.
extern "C" int relpos_attention_fwd_bf16_max_t(int Dh) {
  if (Dh < 1 || Dh > 128) return 0;
  if (Dh <= 32) return res16_max_t<32>();
  if (Dh <= 64) return res16_max_t<64>();
  return res16_max_t<128>();
}

// The two-pass kernel, any T: the arguments of relpos_attention_fwd_bf16.
extern "C" int relpos_attention_fwd_bf16_long(
    const __nv_bfloat16* qu, const __nv_bfloat16* qv, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const __nv_bfloat16* p, const float* kp,
    const float* am, __nv_bfloat16* out, float* stats, unsigned thresh,
    float keep_scale, const long long* seed, int B, int H, int T, int Dh,
    float scale, void* stream, int h0) {
  if (!bf16_shape_ok(B, H, T, Dh)) return (int)cudaErrorInvalidValue;
  const Args16 a = bf16_args(qu, qv, k, v, p, kp, am, out, stats, thresh,
                             keep_scale, seed, H, T, Dh, scale, h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh <= 32) return (int)launch16<32>(a, B, s);
  if (Dh <= 64) return (int)launch16<64>(a, B, s);
  return (int)launch16<128>(a, B, s);
}

// c = a @ b through the bf16 mma helper by route `mode` (0-3, see
// bf16_matmul_test_kernel; a: M x K, b: K x N bf16 row-major, c f32; M, N,
// K multiples of 16 up to 64), for tests. Returns the CUDA error code.
extern "C" int relpos_bf16_matmul_test(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b, float* c,
                                       int M, int N, int K, int mode,
                                       void* stream) {
  if (M < 16 || N < 16 || K < 16 || M > kTestMax || N > kTestMax ||
      K > kTestMax || M % 16 || N % 16 || K % 16 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  bf16_matmul_test_kernel<<<1, 32 * (kTestMax / 16), 0,
                            static_cast<cudaStream_t>(stream)>>>(a, b, c, M,
                                                                 N, K, mode);
  return (int)cudaGetLastError();
}
