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
// Every kernel runs one block per utterance and visits only the
// utterance's own lattice, T_b rows of U_b+1 columns; the gradients of
// every other cell are written as 0 (the JAX kernels give -exp(NEG) = -0
// there). The TPU's T-major layout, 128-lane padding and
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
// The resident and alpha slab kernels (alpha_pass, beta_pass): a row runs
// across the block's threads (a multiple of 32, at most 1024), and rows
// wider than the block are walked in rounds with the scans' carries. The
// scans are warp shuffles plus one shared-memory step across warps, a
// few block-wide barriers per row.
//
// The beta slab kernel (rnnt_beta_slab_kernel) is a warp-level row chain:
// only the log-add scan that needs beta[t+1] stays on the chain. Its
// block has 4 warps with one role each:
// - a producer stages chunks of 32 K columns (lpb, lpl, alpha by
//   cp.async, a few chunks in flight, a ring of slots) and writes each
//   chunk's suffix sums sufP, which do not depend on beta;
// - the chain warp owns a chunk, K consecutive columns a lane, and runs
//   the right-to-left log-sum-exp as (max, scaled sum) pairs: a scan in
//   the lane, a 5-step shuffle scan of the lane totals, one exp per
//   combine and one log per column. beta[t+1] stays in its registers
//   when a row is one chunk: K = 8, 16 or 32 covers 256, 512 or 1024
//   columns. Wider lanes were chosen over splitting a row across chain
//   warps: they lengthen only the in-lane part of a row, where a split
//   adds a barrier between warps to every row. Rows wider than 1024
//   columns are walked in chunks with a carry from the right, beta[t+1]
//   read back from the beta ring, so U+1 is bounded only by shared
//   memory (about 17,000 columns);
// - two gradient warps compute dlpb and dlpl from the slot and a ring of
//   beta rows, behind the chain, and write the zeros around the lattice.
// The roles hand chunks on through per-slot mbarriers; the only
// block-wide barrier comes before the first row.
//
// What bounds them on an H100: the bytes are 16 per cell (read b and l,
// write both gradients) plus 8 per cell on the slab path (alpha out and
// back), microseconds at 3.35 TB/s for the training shapes. The real
// limit is the T-long serial chain of row scans, which no byte or FLOP
// count sees: block-wide barriers in the resident and alpha slab
// kernels; in the beta slab kernel one warp's dependent instructions
// (0.45 us a row at U+1 241 on an H100, PERF.md), with the producer's
// copies about as long. One block per utterance leaves most SMs idle at
// B <= 8.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tile_helpers.cuh"

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

// ----------------------------------------------------- beta slab: row chain
// Chunks staged ahead of the chain (the slot ring), and how many of them
// the producer keeps its copies in flight for (fewer than kSlots).
constexpr int kSlots = 6;
constexpr int kInFlight = 3;
constexpr int kGradWarps = 2;
constexpr int kBetaThreads = 32 * (2 + kGradWarps);

// Beta rows the ring needs when a row is `rounds` chunks: the gradient
// warps lag at most kSlots - 1 chunks behind the chain and read rows t
// and t + 1 of a chunk of row t, so they read rows up to
// ceil((kSlots - 1) / rounds) + 1 above the one the chain writes.
__host__ __device__ constexpr int beta_ring_rows(int rounds) {
  return (kSlots - 1 + rounds - 1) / rounds + 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// release: this thread's earlier writes (and its completed cp.async
// copies) are visible to a thread whose wait sees the phase complete
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}

// acquire: returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// exp and log on the multifunction unit (ex2 / lg2, flushing denormals):
// a few ulps of error, far inside the lattice's f32 tolerance (its
// gradients' exponents are differences of sums ~|logZ|)
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.44269504f));
  return y;
}

__device__ __forceinline__ float fast_log(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y * 0.693147181f;
}

// log(sa e^ma + sb e^mb) as the pair (max, scaled sum), into (ma, sa):
// one exp, of minus the distance between the maxima
__device__ __forceinline__ void pair_add(float& ma, float& sa, float mb,
                                         float sb) {
  const float q = fast_exp(-fabsf(ma - mb));
  sa = ma >= mb ? fmaf(sb, q, sa) : fmaf(sa, q, sb);
  ma = fmaxf(ma, mb);
}

template <int N>
__device__ __forceinline__ void loadv(float (&v)[N], const float* src) {
  #pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(src)[q];
    v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void storev(float* dst, const float (&v)[N]) {
  #pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// The chunks of an utterance in order, by increments (no division in the
// loops): row t from Tl - 1 down, chunk j from the right, slot s and the
// parity of its phase, the beta ring's rows rt = t % rows and rt1 =
// (t + 1) % rows.
struct ChunkWalk {
  int t, j = 0, s = 0, parity = 0, rt, rt1;
  __device__ ChunkWalk(int Tl, int rows)
      : t(Tl - 1), rt(Tl > 0 ? (Tl - 1) % rows : 0), rt1(Tl % rows) {}
  __device__ void next(int R, int rows) {
    if (++s == kSlots) s = 0, parity ^= 1;
    if (++j == R) {
      j = 0;
      --t;
      rt1 = rt;
      rt = rt == 0 ? rows - 1 : rt - 1;
    }
  }
};

// One block per utterance, 4 warps with one role each; a chunk is 32 K
// columns, K consecutive ones a chain lane (beta_slab_cols picks K).
// Chunk c of the utterance is row t = Tl - 1 - c / R, chunk j = c % R from the right,
// columns u = W - (j + 1) kChunk + i (i < kChunk; u < 0 is padding), in
// slot c % kSlots; its beta goes to the beta ring's row t % rows at
// positions p = u + R kChunk - W. A chunk passes full[s] (producer ->
// chain), chained[s] (chain -> gradient warps) and empty[s] (gradient
// warps -> producer), mbarriers whose phase n is the slot's n-th chunk.
template <int K>
__global__ void __launch_bounds__(kBetaThreads)
    rnnt_beta_slab_kernel(const float* lpb, const float* lpl,
                          const int* t_lens, const int* u_lens,
                          const float* alpha, const float* logz,
                          float* dlpb, float* dlpl, int T, int U1) {
  constexpr int kChunk = 32 * K;
  constexpr int kSlotFloats = 4 * kChunk;   // lpb, lpl, alpha, sufP
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* chained = full + kSlots;
  uint64_t* empty = chained + kSlots;
  float* slots = smem + 8 * kSlots;          // 16-byte aligned
  float* ring = slots + kSlots * kSlotFloats;

  const Utt a = utterance(lpb, lpl, t_lens, u_lens, T, U1);
  const size_t off = (size_t)blockIdx.x * T * U1;
  alpha += off;
  dlpb += off;
  dlpl += off;
  const int W = a.Ul + 1, R = (W + kChunk - 1) / kChunk;
  const int RC = R * kChunk, rows = beta_ring_rows(R);
  const int n_chunks = a.Tl * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&chained[s], 32);
      mbar_init(&empty[s], 32 * kGradWarps);
    }
  }
  __syncthreads();   // the only block-wide barrier, before any row

  if (warp == 1) {
    // producer: copies of kInFlight chunks in flight; a chunk's slot is
    // published once its copies landed and its suffix sums are written
    float row_p = 0.f;
    ChunkWalk in(a.Tl, rows), out(a.Tl, rows);
    for (int c = 0; c < n_chunks + kInFlight - 1; ++c) {
      if (c < n_chunks) {
        // the slot's previous chunk (phase parity ^ 1) has been freed
        if (c >= kSlots) mbar_wait(&empty[in.s], in.parity ^ 1);
        const int u0 = W - (in.j + 1) * kChunk;
        float* dst = slots + in.s * kSlotFloats;
        const size_t row = (size_t)in.t * U1;
        #pragma unroll
        for (int m = 0; m < K; ++m) {
          const int i = lane + 32 * m, u = u0 + i;
          const size_t g = row + (u >= 0 ? u : 0);
          tsasr::cp_async4(dst + i, a.lpb + g, u >= 0);
          tsasr::cp_async4(dst + kChunk + i, a.lpl + g, u >= 0);
          tsasr::cp_async4(dst + 2 * kChunk + i, alpha + g, u >= 0);
        }
        in.next(R, rows);
      }
      tsasr::cp_async_commit();
      tsasr::cp_async_wait<kInFlight - 1>();
      const int f = c - (kInFlight - 1);
      if (f < 0) continue;
      __syncwarp();   // the other lanes' copies of chunk f are visible
      const int j = out.j, s = out.s;
      out.next(R, rows);
      const int u0 = W - (j + 1) * kChunk + lane * K;
      float* src = slots + s * kSlotFloats;
      float p[K];
      loadv(p, src + kChunk + lane * K);
      float suf[K];
      float acc = 0.f;
      #pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const int u = u0 + k;
        acc += (u >= 0 && u < a.Ul) ? p[k] : 0.f;
        suf[k] = acc;
      }
      float incl = acc;
      #pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(kFull, incl, o);
        incl += lane + o < 32 ? y : 0.f;
      }
      float excl = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) excl = 0.f;
      if (j == 0) row_p = 0.f;
      #pragma unroll
      for (int k = 0; k < K; ++k) suf[k] = (suf[k] + excl) + row_p;
      row_p += __shfl_sync(kFull, incl, 0);
      storev(src + 3 * kChunk + lane * K, suf);
      mbar_arrive(&full[s]);
    }
  } else if (warp == 0) {
    // the chain: beta[t] = sufP + logcumsumexp_r2l((beta[t+1] + lpb) -
    // sufP), as (max, scaled sum) pairs; beta[t+1] stays in registers
    // when a row is one chunk
    const int p0 = lane * K;
    float bn[K];
    {
      float* r = ring + (size_t)(a.Tl % rows) * RC;
      for (int j = 0; j < R; ++j) {
        const int u0 = W - (j + 1) * kChunk + p0;
        #pragma unroll
        for (int k = 0; k < K; ++k) bn[k] = u0 + k == a.Ul ? 0.f : NEG;
        storev(r + (R - 1 - j) * kChunk + p0, bn);
      }
    }
    float cm, cs;   // the carry from the chunks to the right
    ChunkWalk w(a.Tl, rows);
    for (int c = 0; c < n_chunks; ++c, w.next(R, rows)) {
      const int j = w.j;
      const int u0 = W - (j + 1) * kChunk + p0;
      const int pos = (R - 1 - j) * kChunk + p0;
      if (R > 1) loadv(bn, ring + (size_t)w.rt1 * RC + pos);
      mbar_wait(&full[w.s], w.parity);
      const float* src = slots + w.s * kSlotFloats;
      float b[K], sp[K];
      loadv(b, src + p0);
      loadv(sp, src + 3 * kChunk + p0);
      float pm[K], ps[K];
      float m = NEG, sum = 0.f;
      #pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const float x = u0 + k >= 0 ? (bn[k] + b[k]) - sp[k] : NEG;
        const float q = fast_exp(-fabsf(x - m));
        sum = x > m ? fmaf(sum, q, 1.f) : sum + q;
        m = fmaxf(m, x);
        pm[k] = m;
        ps[k] = sum;
      }
      float im = m, is = sum;
      #pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        // past the last lane, the identity (NEG, 0): adds exactly 0
        const bool in_warp = lane + o < 32;
        const float om = __shfl_down_sync(kFull, im, o);
        const float os = __shfl_down_sync(kFull, is, o);
        pair_add(im, is, in_warp ? om : NEG, in_warp ? os : 0.f);
      }
      float em = __shfl_down_sync(kFull, im, 1);
      float es = __shfl_down_sync(kFull, is, 1);
      if (lane == 31) em = NEG, es = 0.f;
      if (j > 0) pair_add(em, es, cm, cs);   // the chunks to the right
      #pragma unroll
      for (int k = 0; k < K; ++k) {
        float fm = pm[k], fs = ps[k];
        pair_add(fm, fs, em, es);
        bn[k] = (u0 + k >= 0 && fm > NEG / 2) ? sp[k] + (fm + fast_log(fs))
                                               : NEG;
      }
      if (j + 1 < R) {   // the carry of the chunk to the left
        float nm = __shfl_sync(kFull, im, 0);
        float ns = __shfl_sync(kFull, is, 0);
        if (j > 0) pair_add(nm, ns, cm, cs);
        cm = nm;
        cs = ns;
      }
      storev(ring + (size_t)w.rt * RC + pos, bn);
      mbar_arrive(&chained[w.s]);
    }
  } else {
    // gradient warps: rows past the utterance, then each chunk once the
    // chain has its beta, with the row's columns past Ul
    const int g = threadIdx.x - 64, ng = 32 * kGradWarps;
    for (size_t e = (size_t)a.Tl * U1 + g; e < (size_t)T * U1; e += ng)
      dlpb[e] = dlpl[e] = 0.f;
    const float lz = logz[blockIdx.x];
    ChunkWalk w(a.Tl, rows);
    for (int c = 0; c < n_chunks; ++c, w.next(R, rows)) {
      const int j = w.j, s = w.s;
      const int u0 = W - (j + 1) * kChunk;
      const int base = (R - 1 - j) * kChunk;
      const float* b1 = ring + (size_t)w.rt1 * RC + base;
      const float* b0 = ring + (size_t)w.rt * RC + base;
      const float* src = slots + s * kSlotFloats;
      float* gb = dlpb + (size_t)w.t * U1;
      float* gl = dlpl + (size_t)w.t * U1;
      mbar_wait(&chained[s], w.parity);
      constexpr int kPer = kChunk / (32 * kGradWarps);
      float eb[kPer], el[kPer];
      #pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int i = g + q * ng;
        const int i1 = i + 1 < kChunk || j > 0 ? i + 1 : i;  // in the row
        const float al = src[2 * kChunk + i];
        eb[q] = al + src[i] + b1[i] - lz;
        el[q] = al + src[kChunk + i] + b0[i1] - lz;
      }
      #pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int u = u0 + g + q * ng;
        if (u < 0) continue;
        gb[u] = -fast_exp(eb[q]);
        gl[u] = u < a.Ul ? -fast_exp(el[q]) : 0.f;
      }
      if (j == 0)
        for (int u = W + g; u < U1; u += ng) gb[u] = gl[u] = 0.f;
      mbar_arrive(&empty[s]);
    }
  }
}

// Shared memory of the beta slab kernel at K columns a lane: barriers,
// the slot ring, and the beta ring at its largest over the rounds a row
// of at most U1 columns can take.
size_t beta_slab_smem(int U1, int K) {
  const int chunk = 32 * K;
  size_t ring = 0;
  for (int r = 1; r <= (U1 + chunk - 1) / chunk; ++r)
    ring = std::max(ring, (size_t)beta_ring_rows(r) * r * chunk);
  return sizeof(float) * (8 * kSlots + (size_t)kSlots * 4 * chunk + ring);
}

constexpr size_t kMaxSmem = 227 * 1024;

// Columns a lane: the least K that holds a row of U1 columns in one chunk
// (8 up to 256 columns, 16 up to 512, else 32); 8 when 32's shared memory
// would not fit.
int beta_slab_cols(int U1) {
  const int K = U1 <= 256 ? 8 : U1 <= 512 ? 16 : 32;
  return beta_slab_smem(U1, K) <= kMaxSmem ? K : 8;
}

template <int K>
int launch_beta_slab(const float* lpb, const float* lpl, const int* t_lens,
                     const int* u_lens, const float* alpha,
                     const float* logz, float* dlpb, float* dlpl, int B,
                     int T, int U1, cudaStream_t stream) {
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnnt_beta_slab_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const size_t smem = beta_slab_smem(U1, K);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  rnnt_beta_slab_kernel<K><<<B, kBetaThreads, smem, stream>>>(
      lpb, lpl, t_lens, u_lens, alpha, logz, dlpb, dlpl, T, U1);
  return (int)cudaGetLastError();
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
  const auto st = static_cast<cudaStream_t>(stream);
  switch (beta_slab_cols(U1)) {
    case 32:
      return launch_beta_slab<32>(lpb, lpl, t_lens, u_lens, alpha, logz,
                                  dlpb, dlpl, B, T, U1, st);
    case 16:
      return launch_beta_slab<16>(lpb, lpl, t_lens, u_lens, alpha, logz,
                                  dlpb, dlpl, B, T, U1, st);
    default:
      return launch_beta_slab<8>(lpb, lpl, t_lens, u_lens, alpha, logz,
                                 dlpb, dlpl, B, T, U1, st);
  }
}
