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
// log-depth shifter of lane rolls; here it is an index offset into a
// window of p rows kept in shared memory.
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
// Design (simple and right first):
// - one block of 4 warps per (query tile of 32 rows, head, batch);
// - a loop over key tiles of 32 keys with an online (flash-style) f32
//   softmax, so any T works and no (T, T) score matrix touches memory;
// - the q_u/q_v tile, the k/v tile and the 63 p rows that one
//   (query tile, key tile) pair needs sit in shared memory; rows of
//   q, k and p are padded to Dh+1 floats so a warp reading one column
//   across 32 rows hits 32 different banks;
// - a warp owns 8 query rows, a lane owns one key of the tile for the
//   scores and Dh/32 output columns for the running P @ V sum;
// - plain f32 FMAs, no TF32, to stay within the f32 tolerance of the
//   plain PyTorch version (relpos_attention_reference).
// Masked keys get the additive -1e9 exactly as the JAX kernel adds
// kp_add and am_add; keys beyond T are left out of the softmax.
//
// What bounds it on an H100: at the serving shapes (B=8, H=4, T=101,
// Dh=64) it moves about 4 MB (q_u, q_v, k, v, out) and does about
// 6*B*H*T^2*Dh = 125 MFLOP, i.e. a few microseconds at the card's memory
// rate or f32 FMA rate. It is launch- and latency-bound there: 128 blocks
// of 4 warps, one wave. The score loop reads shared memory more often
// than it does FMAs. With dropout each score also costs one Philox (10
// rounds of two 32-bit multiplies). Tensor cores (wgmma with TF32 or
// bf16 operands), TMA loads and larger query tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kTileQ = 32;                 // query rows per block
constexpr int kTileK = 32;                 // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kTileQ / kWarps;     // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPRows = kTileQ + kTileK - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

size_t smem_bytes(int dh) {
  const int ld = dh + 1;
  return sizeof(float) *
         ((size_t)(2 * kTileQ + kTileK + kPRows) * ld + (size_t)kTileK * dh);
}

// DC = ceil(Dh / 32): output columns per lane.
template <int DC>
__global__ void __launch_bounds__(kThreads)
relpos_attention_fwd_kernel(const float* __restrict__ qu,
                            const float* __restrict__ qv,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ p,
                            const float* __restrict__ kp,
                            const float* __restrict__ am,
                            float* __restrict__ out,
                            float* __restrict__ stats,
                            uint32_t thresh, float keep_scale,
                            const long long* __restrict__ seed_ptr,
                            int H, int T, int Dh, float scale) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* s_qu = smem;                      // kTileQ x ld
  float* s_qv = s_qu + kTileQ * ld;        // kTileQ x ld
  float* s_k = s_qv + kTileQ * ld;         // kTileK x ld
  float* s_p = s_k + kTileK * ld;          // kPRows x ld
  float* s_v = s_p + kPRows * ld;          // kTileK x Dh

  const int i0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bh = ((size_t)b * H + h) * (size_t)T * Dh;
  const float* p_h = p + (size_t)h * (2 * T - 1) * Dh;
  const float* kp_b = kp + (size_t)b * T;
  const bool drop = seed_ptr != nullptr;
  const uint64_t seed = drop ? (uint64_t)seed_ptr[0] : 0;

  for (int e = tid; e < kTileQ * Dh; e += kThreads) {
    const int r = e / Dh, c = e - r * Dh, i = i0 + r;
    const size_t g = bh + (size_t)i * Dh + c;
    s_qu[r * ld + c] = i < T ? qu[g] : 0.f;
    s_qv[r * ld + c] = i < T ? qv[g] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    m[q] = -INFINITY;
    l[q] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[q][c] = 0.f;
  }

  const int r0 = warp * kRows;             // first local query row of warp
  for (int j0 = 0; j0 < T; j0 += kTileK) {
    __syncthreads();                       // last tile fully consumed
    for (int e = tid; e < kTileK * Dh; e += kThreads) {
      const int r = e / Dh, c = e - r * Dh, j = j0 + r;
      const size_t g = bh + (size_t)j * Dh + c;
      s_k[r * ld + c] = j < T ? k[g] : 0.f;
      s_v[r * Dh + c] = j < T ? v[g] : 0.f;
    }
    // Local p row pr holds global row pbase + pr; query row r and lane
    // (key j0 + lane) need global row T-1-(i0+r)+j0+lane = pbase +
    // (kTileQ-1-r+lane).
    const int pbase = T - kTileQ - i0 + j0;
    for (int e = tid; e < kPRows * Dh; e += kThreads) {
      const int pr = e / Dh, c = e - pr * Dh, g = pbase + pr;
      s_p[pr * ld + c] =
          (g >= 0 && g < 2 * T - 1) ? p_h[(size_t)g * Dh + c] : 0.f;
    }
    __syncthreads();

    float ac[kRows], bd[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) ac[q] = bd[q] = 0.f;
    const float* k_row = s_k + lane * ld;
    const float* p_row = s_p + (kTileQ - 1 - r0 + lane) * ld;
    for (int d = 0; d < Dh; ++d) {
      const float kd = k_row[d];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        ac[q] = fmaf(s_qu[(r0 + q) * ld + d], kd, ac[q]);
        // row r0+q reads p row (kTileQ-1-r0-q+lane): q rows above p_row
        bd[q] = fmaf(s_qv[(r0 + q) * ld + d], p_row[d - q * ld], bd[q]);
      }
    }

    const int j = j0 + lane;
    float e_s[kRows], d_s[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + r0 + q;
      float s = -INFINITY;
      if (j < T) {
        const float am_ij = i < T ? am[(size_t)i * T + j] : 0.f;
        s = (ac[q] + bd[q]) * scale + am_ij + kp_b[j];
      }
      const float m_new = fmaxf(m[q], warp_max(s));
      const float corr = expf(m[q] - m_new);
      e_s[q] = expf(s - m_new);
      l[q] = l[q] * corr + warp_sum(e_s[q]);
      // the P @ V sum takes the dropped probabilities, l the undropped
      d_s[q] = e_s[q];
      if (drop && j < T && i < T)
        d_s[q] = tsasr::dropout_keep(seed, thresh, b, h, i, j)
                     ? e_s[q] * keep_scale : 0.f;
      m[q] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[q][c] *= corr;
    }

    const int kmax = min(kTileK, T - j0);
    for (int jj = 0; jj < kmax; ++jj) {
      float vj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < Dh ? s_v[jj * Dh + d] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float pj = __shfl_sync(kFull, d_s[q], jj);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[q][c] = fmaf(pj, vj[c], acc[q][c]);
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = i0 + r0 + q;
    if (i >= T) continue;
    const float inv = 1.f / l[q];
    if (stats != nullptr && lane == 0) {
      const size_t row = ((size_t)b * H + h) * T + i;
      stats[2 * row] = m[q];
      stats[2 * row + 1] = inv;
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) out[bh + (size_t)i * Dh + d] = acc[q][c] * inv;
    }
  }
}

template <int DC>
cudaError_t launch(const float* qu, const float* qv, const float* k,
                   const float* v, const float* p, const float* kp,
                   const float* am, float* out, float* stats,
                   uint32_t thresh, float keep_scale, const long long* seed,
                   int B, int H, int T, int Dh, float scale,
                   cudaStream_t stream) {
  // Above 48 KB a block gets dynamic shared memory only on request; ask
  // once for the most this instantiation can need (Dh = 32 * DC).
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        relpos_attention_fwd_kernel<DC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(32 * DC));
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const dim3 grid((T + kTileQ - 1) / kTileQ, H, B);
  relpos_attention_fwd_kernel<DC><<<grid, kThreads, smem_bytes(Dh), stream>>>(
      qu, qv, k, v, p, kp, am, out, stats, thresh, keep_scale, seed, H, T, Dh,
      scale);
  return cudaGetLastError();
}

// keep[b, h, i, j] = 1 iff the dropout keeps (b, h, i, j): the mask the
// attention kernels draw, written out for tests.
__global__ void dropout_mask_kernel(const long long* __restrict__ seed_ptr,
                                    uint32_t thresh,
                                    unsigned char* __restrict__ keep, int B,
                                    int H, int T) {
  const uint64_t seed = (uint64_t)seed_ptr[0];
  const size_t n = (size_t)B * H * T * T;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(e % T), i = (int)((e / T) % T);
    const int h = (int)((e / ((size_t)T * T)) % H);
    const int b = (int)(e / ((size_t)T * T * H));
    keep[e] = tsasr::dropout_keep(seed, thresh, b, h, i, j) ? 1 : 0;
  }
}

}  // namespace

// q_u, q_v, k, v, out: (B, H, T, Dh); p: (H, 2T-1, Dh); kp: (B, T);
// am: (T, T); all f32, contiguous, on the current device. stats
// (B, H, T, 2) may be null. seed: one int64 on the device, or null for no dropout;
// thresh = floor(rate * 2^32), keep_scale = 1 / (1 - rate). Returns the
// CUDA error code of the launch (0 on success). 1 <= Dh <= 128.
extern "C" int relpos_attention_fwd(const float* qu, const float* qv,
                                    const float* k, const float* v,
                                    const float* p, const float* kp,
                                    const float* am, float* out, float* stats,
                                    unsigned thresh, float keep_scale,
                                    const long long* seed, int B, int H,
                                    int T, int Dh, float scale,
                                    void* stream) {
  if (B < 1 || H < 1 || T < 1 || Dh < 1 || Dh > 128 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((Dh + 31) / 32) {
    case 1: err = launch<1>(qu, qv, k, v, p, kp, am, out, stats, thresh, keep_scale, seed, B, H, T, Dh, scale, s); break;
    case 2: err = launch<2>(qu, qv, k, v, p, kp, am, out, stats, thresh, keep_scale, seed, B, H, T, Dh, scale, s); break;
    case 3: err = launch<3>(qu, qv, k, v, p, kp, am, out, stats, thresh, keep_scale, seed, B, H, T, Dh, scale, s); break;
    default: err = launch<4>(qu, qv, k, v, p, kp, am, out, stats, thresh, keep_scale, seed, B, H, T, Dh, scale, s); break;
  }
  return (int)err;
}

// keep: (B, H, T, T) uint8, written 1 where the dropout keeps an element.
extern "C" int relpos_dropout_mask(const long long* seed, unsigned thresh,
                                   unsigned char* keep, int B, int H, int T,
                                   void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  dropout_mask_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, thresh, keep, B, H, T);
  return (int)cudaGetLastError();
}
