// RNN-T lattice: loss and the gradients w.r.t. the blank and label
// log-probs, f32, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/rnnt_loss_pallas.py kernels:
// - _rnnt_kernel (the "resident" variant, _pallas_lattice_resident) by
//   rnnt_resident_kernel: both passes in one kernel, the utterance's
//   alpha lattice in shared memory;
// - _rnnt_alpha_slab_kernel and _rnnt_beta_slab_kernel (the "slab"
//   variant, _pallas_lattice_slab) by rnnt_alpha_slab_kernel, which writes
//   alpha and logZ to device memory, and rnnt_beta_slab_kernel, which
//   reads them back for the beta sweep and the gradients.
//
// The math is the JAX kernels' row trick. With b = blank, l = label
// log-probs (B, T, U+1), T_b and U_b the lengths of utterance b:
//
//   alpha[t, :] = cumP + logcumsumexp(c - cumP),
//   c = alpha[t-1, :] + b[t-1, :] (t > 0; row 0 starts from c = [0, NEG..])
//   cumP[u] = sum_{v<u} l[t, v]
//   logZ = alpha[T_b-1, U_b] + b[T_b-1, U_b], loss = -logZ
//   beta[t, :] = sufP + logcumsumexp_right_to_left(d - sufP),
//   d = beta[t+1, :] + b[t, :] (d = [NEG.., b[T_b-1, U_b]] on the last row)
//   sufP[u] = sum_{v>=u} l[t, v]
//   dlpb[t, u] = -exp(alpha + b + beta[t+1, u] - logZ)
//   dlpl[t, u] = -exp(alpha + l + beta[t, u+1] - logZ)
//
// so each row is a prefix sum and a log-cumsum-exp, both scans, and the
// only serial chain is the loop over T.
//
// Design: one block per utterance; its row runs across the block's
// threads (a multiple of 32, at most 1024), and rows wider than the block
// are walked in rounds with the scans' carries, so U+1 has no limit. The
// scans are warp shuffles plus one shared-memory step across warps. Only
// the utterance's own lattice, T_b rows of U_b+1 columns, is visited; the
// gradients of every other cell are written as 0 (the JAX kernels give
// -exp(NEG) = -0 there). The TPU's T-major layout, 128-lane padding and
// blocks of 8-64 utterances were TPU tiling and are not carried over.
// NEG = -1e30 stands in for -inf; logaddexp keeps the JAX guard (both
// operands <= NEG/2 give NEG), so padded cells stay exactly NEG-sized
// and exp() gives 0, never NaN.
//
// Resident or slab (kernels/rnnt_lattice.py::resident_fits states the
// rule): the resident kernel keeps T x (U+1) floats of alpha plus one row
// of scratch in shared memory, so the wrapper picks it when that fits 200
// KB; otherwise the slab pair round-trips alpha through device memory.
//
// What bounds it on an H100: the bytes are 16 per cell (read b and l,
// write both gradients) plus 8 per cell on the slab path (alpha out and
// back), microseconds at 3.35 TB/s for the training shapes. The real
// limit is the T-long serial chain of row scans in each pass (a few
// block-wide synchronisations per row), which no byte or FLOP count sees,
// and one block per utterance leaves most SMs idle at B <= 8.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b), mn = fminf(a, b);
  return mx <= NEG / 2 ? NEG : mx + log1pf(expf(mn - mx));
}

struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
  static constexpr float identity = 0.f;
};

struct LogAdd {
  __device__ float operator()(float a, float b) const { return lae(a, b); }
  static constexpr float identity = NEG;
};

// Inclusive scan of x over the block in threadIdx order; *total gets the
// block's total. s_warp holds 32 floats of scratch.
template <class Op>
__device__ float block_scan(float x, float* s_warp, float* total) {
  Op op;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(y, x);
  }
  __syncthreads();                  // s_warp's last readers are done
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? s_warp[lane] : Op::identity;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = op(y, w);
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = op(s_warp[warp - 1], x);
  *total = s_warp[n_warps - 1];
  return x;
}

struct Utt {
  const float* lpb;    // (T, U1) rows of this utterance
  const float* lpl;
  int T, U1, Tl, Ul;   // Tl in [0, T], Ul in [0, U1-1]
};

__device__ Utt utterance(const float* lpb, const float* lpl, const int* t_lens,
                         const int* u_lens, int T, int U1) {
  const int b = blockIdx.x;
  Utt u;
  u.lpb = lpb + (size_t)b * T * U1;
  u.lpl = lpl + (size_t)b * T * U1;
  u.T = T;
  u.U1 = U1;
  u.Tl = min(max(t_lens[b], 0), T);
  u.Ul = min(max(u_lens[b], 0), U1 - 1);
  return u;
}

// Alpha rows 0..Tl-1 into alpha[t * U1 + u] (shared or device memory; a
// thread reads back only the columns it wrote). Returns logZ in *logz
// (written by the thread that owns column Ul; NEG if Tl == 0 is left to
// the caller's initialisation).
__device__ void alpha_pass(const Utt& a, float* alpha, float* s_warp,
                           float* logz) {
  const int W = a.Ul + 1, nt = blockDim.x;
  for (int t = 0; t < a.Tl; ++t) {
    const float* lpl_t = a.lpl + (size_t)t * a.U1;
    float carry_p = 0.f, carry_l = NEG;
    for (int base = 0; base < W; base += nt) {
      const int u = base + threadIdx.x;
      const bool in = u < W;
      const float p = (in && u < a.Ul) ? lpl_t[u] : 0.f;
      float tot;
      const float incl = block_scan<Sum>(p, s_warp, &tot) + carry_p;
      carry_p += tot;
      const float cum_p = incl - p;                    // exclusive
      float c = NEG;
      if (in) {
        if (t == 0)
          c = u == 0 ? 0.f : NEG;
        else
          c = alpha[(size_t)(t - 1) * a.U1 + u] +
              a.lpb[(size_t)(t - 1) * a.U1 + u];
      }
      float y = lae(carry_l, block_scan<LogAdd>(c - cum_p, s_warp, &tot));
      carry_l = lae(carry_l, tot);
      if (in) {
        const float row = cum_p + y;
        alpha[(size_t)t * a.U1 + u] = row;
        if (t == a.Tl - 1 && u == a.Ul)
          *logz = row + a.lpb[(size_t)t * a.U1 + u];
      }
    }
  }
}

// Beta sweep over rows Tl-1..0 and the gradients of every cell. s_beta
// holds one row (U1 floats): beta[t+1] while row t is built, then
// beta[t], which the label gradient reads one column to the right.
__device__ void beta_pass(const Utt& a, const float* alpha, float logz,
                          float* s_beta, float* s_warp, float* dlpb,
                          float* dlpl) {
  const int W = a.Ul + 1, nt = blockDim.x;
  for (int t = a.Tl - 1; t >= 0; --t) {
    const float* lpb_t = a.lpb + (size_t)t * a.U1;
    const float* lpl_t = a.lpl + (size_t)t * a.U1;
    const bool last = t == a.Tl - 1;
    float carry_p = 0.f, carry_l = NEG;
    for (int base = 0; base < W; base += nt) {
      const int e = base + threadIdx.x, u = W - 1 - e;  // right to left
      const bool in = e < W;
      const float p = (in && u < a.Ul) ? lpl_t[u] : 0.f;
      float tot;
      const float suf_p = block_scan<Sum>(p, s_warp, &tot) + carry_p;
      carry_p += tot;
      float d = NEG, beta_t1 = NEG;
      if (in) {
        if (last) {
          d = u == a.Ul ? lpb_t[u] : NEG;
          beta_t1 = u == a.Ul ? 0.f : NEG;
        } else {
          beta_t1 = s_beta[u];
          d = beta_t1 + lpb_t[u];
        }
      }
      const float y =
          lae(carry_l, block_scan<LogAdd>(d - suf_p, s_warp, &tot));
      carry_l = lae(carry_l, tot);
      const float beta = suf_p + y;
      float g_b = 0.f;
      if (in) {
        const float al = alpha[(size_t)t * a.U1 + u];
        g_b = -expf(al + lpb_t[u] + beta_t1 - logz);
        s_beta[u] = beta;      // only this thread reads or writes s_beta[u]
      }
      __syncthreads();         // this round's beta[t] is visible
      if (in) {
        float g_l = 0.f;
        if (u < a.Ul)
          g_l = -expf(alpha[(size_t)t * a.U1 + u] + lpl_t[u] +
                      s_beta[u + 1] - logz);
        dlpb[(size_t)t * a.U1 + u] = g_b;
        dlpl[(size_t)t * a.U1 + u] = g_l;
      }
    }
    __syncthreads();           // row t is complete before row t-1 reads it
  }
  // cells outside the utterance's lattice
  for (size_t e = threadIdx.x; e < (size_t)a.T * a.U1; e += nt) {
    const int t = (int)(e / a.U1), u = (int)(e % a.U1);
    if (t >= a.Tl || u > a.Ul) dlpb[e] = dlpl[e] = 0.f;
  }
}

__global__ void rnnt_resident_kernel(const float* lpb, const float* lpl,
                                     const int* t_lens, const int* u_lens,
                                     float* loss, float* dlpb, float* dlpl,
                                     int T, int U1) {
  extern __shared__ float smem[];
  float* s_alpha = smem;                        // T x U1
  float* s_beta = s_alpha + (size_t)T * U1;     // U1
  float* s_warp = s_beta + U1;                  // 32
  float* s_logz = s_warp + 32;                  // 1
  const Utt a = utterance(lpb, lpl, t_lens, u_lens, T, U1);
  if (threadIdx.x == 0) *s_logz = NEG;
  __syncthreads();
  alpha_pass(a, s_alpha, s_warp, s_logz);
  __syncthreads();
  const float logz = *s_logz;
  if (threadIdx.x == 0) loss[blockIdx.x] = -logz;
  const size_t off = (size_t)blockIdx.x * T * U1;
  beta_pass(a, s_alpha, logz, s_beta, s_warp, dlpb + off, dlpl + off);
}

__global__ void rnnt_alpha_slab_kernel(const float* lpb, const float* lpl,
                                       const int* t_lens, const int* u_lens,
                                       float* alpha, float* logz, float* loss,
                                       int T, int U1) {
  __shared__ float s_warp[32];
  __shared__ float s_logz;
  const Utt a = utterance(lpb, lpl, t_lens, u_lens, T, U1);
  if (threadIdx.x == 0) s_logz = NEG;
  __syncthreads();
  alpha_pass(a, alpha + (size_t)blockIdx.x * T * U1, s_warp, &s_logz);
  __syncthreads();
  if (threadIdx.x == 0) {
    logz[blockIdx.x] = s_logz;
    loss[blockIdx.x] = -s_logz;
  }
}

__global__ void rnnt_beta_slab_kernel(const float* lpb, const float* lpl,
                                      const int* t_lens, const int* u_lens,
                                      const float* alpha, const float* logz,
                                      float* dlpb, float* dlpl, int T,
                                      int U1) {
  extern __shared__ float smem[];
  float* s_beta = smem;                         // U1
  float* s_warp = s_beta + U1;                  // 32
  const Utt a = utterance(lpb, lpl, t_lens, u_lens, T, U1);
  const size_t off = (size_t)blockIdx.x * T * U1;
  beta_pass(a, alpha + off, logz[blockIdx.x], s_beta, s_warp, dlpb + off,
            dlpl + off);
}

int threads_for(int U1) {
  const int n = ((U1 + 31) / 32) * 32;
  return n < 32 ? 32 : (n > 1024 ? 1024 : n);
}

bool valid(int B, int T, int U1) {
  return B >= 1 && T >= 1 && U1 >= 1;
}

}  // namespace

// lpb, lpl, dlpb, dlpl: (B, T, U1) f32; t_lens, u_lens: (B,) int32; loss:
// (B,) f32; all contiguous on the current device. The resident kernel
// needs (T*U1 + U1 + 33) floats of shared memory, at most 227 KB.
// Each entry point returns the CUDA error code of its launch (0 on
// success).
extern "C" int rnnt_lattice_resident(const float* lpb, const float* lpl,
                                     const int* t_lens, const int* u_lens,
                                     float* loss, float* dlpb, float* dlpl,
                                     int B, int T, int U1, void* stream) {
  if (!valid(B, T, U1)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)T * U1 + U1 + 33);
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnnt_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  rnnt_resident_kernel<<<B, threads_for(U1), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      lpb, lpl, t_lens, u_lens, loss, dlpb, dlpl, T, U1);
  return (int)cudaGetLastError();
}

// alpha: (B, T, U1) f32 scratch; logz: (B,) f32.
extern "C" int rnnt_lattice_alpha_slab(const float* lpb, const float* lpl,
                                       const int* t_lens, const int* u_lens,
                                       float* alpha, float* logz, float* loss,
                                       int B, int T, int U1, void* stream) {
  if (!valid(B, T, U1)) return (int)cudaErrorInvalidValue;
  rnnt_alpha_slab_kernel<<<B, threads_for(U1), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      lpb, lpl, t_lens, u_lens, alpha, logz, loss, T, U1);
  return (int)cudaGetLastError();
}

extern "C" int rnnt_lattice_beta_slab(const float* lpb, const float* lpl,
                                      const int* t_lens, const int* u_lens,
                                      const float* alpha, const float* logz,
                                      float* dlpb, float* dlpl, int B, int T,
                                      int U1, void* stream) {
  if (!valid(B, T, U1)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)U1 + 32);
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnnt_beta_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  rnnt_beta_slab_kernel<<<B, threads_for(U1), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      lpb, lpl, t_lens, u_lens, alpha, logz, dlpb, dlpl, T, U1);
  return (int)cudaGetLastError();
}
