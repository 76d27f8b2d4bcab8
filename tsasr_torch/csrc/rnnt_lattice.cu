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
// rule): the resident kernel keeps the utterance's alpha lattice (T rows
// of U+1 floats rounded up to 4) in shared memory beside its rings
// (resident_smem), so the wrapper picks it when that fits 227 KB;
// otherwise the slab pair round-trips alpha through device memory.
//
// All three kernels are warp-level row chains: only the log-add scan that
// needs the previous row stays on the chain. A block has up to 4 warps
// with one role each:
// - a producer stages chunks of 32 K columns (by cp.async, a few chunks
//   in flight, a ring of slots) and writes each chunk's prefix sums
//   (cumP from the left for alpha, sufP from the right for beta), which
//   do not depend on the chain;
// - the chain warp owns a chunk, K consecutive columns a lane, and runs
//   the log-sum-exp as (max, scaled sum) pairs: a scan in the lane, a
//   5-step shuffle scan of the lane totals, one exp per combine and one
//   log per column. The previous row stays in its registers when a row
//   is one chunk: K = 8, 16 or 32 covers 256, 512 or 1024 columns (the
//   alpha chain also takes K = 4 up to 128). Wider
//   lanes were chosen over splitting a row across chain warps: they
//   lengthen only the in-lane part of a row, where a split adds a
//   barrier between warps to every row. Wider rows are walked in chunks
//   with a carry, the previous row read back from where the chain wrote
//   it (the resident alpha, the beta ring, the alpha slab's device
//   memory), so U+1 is bounded only by shared memory (beta) or not at
//   all (the alpha slab);
// - two gradient warps compute dlpb and dlpl from the slot, alpha and a
//   ring of beta rows, behind the beta chain, and write the zeros around
//   the lattice.
// The roles hand chunks on through per-slot mbarriers. The alpha slab
// kernel (rnnt_alpha_slab_kernel) runs the alpha chain alone (alpha_roles,
// 2 warps: the gradient warps have nothing to do there, since the beta
// slab writes every gradient cell), into device memory rows U+1 apart,
// the layout the beta slab reads, by scalar stores (U+1 is rarely a
// multiple of 4); its shared memory is the slot ring and one staging
// chunk, and its
// block-wide barriers come before the first row and after the last (for
// logZ). The beta slab kernel (rnnt_beta_slab_kernel) runs the beta chain
// alone, its slots also staging alpha from device memory; its only
// block-wide barrier comes before the first row. The resident kernel
// (rnnt_resident_kernel) runs the alpha chain (alpha_roles) into shared
// memory while the gradient warps write the zeros, then the beta chain
// (beta_roles, a copy of the beta slab's roles with alpha read from
// shared memory): one block-wide barrier before the first row and one
// between the passes, each pass with mbarriers of its own. The beta slab
// keeps its own code: calling a copy shared with the resident kernel, the
// same source, compiled 17 % slower at U+1 241 on an H100. The alpha slab
// calls the resident kernel's alpha_roles: a copy of it read the same.
//
// What bounds them on an H100: the bytes are 16 per cell (read b and l,
// write both gradients) plus 8 per cell on the slab path (alpha out and
// back), microseconds at 3.35 TB/s for the training shapes. The real
// limit is the T-long serial chain of row scans, which no byte or FLOP
// count sees: one warp's dependent instructions (0.45 us a beta row at
// U+1 241 on an H100, PERF.md), with the producer's copies about as long.
// One block per utterance leaves most SMs idle at B <= 8.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tile_helpers.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// ------------------------------------------------------------- row chains
// Chunks staged ahead of the chain (the slot ring), and how many of them
// the producer keeps its copies in flight for (fewer than kSlots).
constexpr int kSlots = 6;
constexpr int kInFlight = 3;
constexpr int kGradWarps = 2;
constexpr int kChainThreads = 32 * (2 + kGradWarps);

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

// A lane's K columns u0 .. u0 + K - 1 (u0 a multiple of 4) of a row
// whose neighbours lie `stride` floats away: as float4 when kVec (stride
// a multiple of 4, rows 16-byte aligned), else float by float. Columns
// at or past the stride belong to no row: they are not stored, and load
// as NEG.
template <int K, bool kVec>
__device__ __forceinline__ void store_cols(float* row, int u0, int stride,
                                           const float (&v)[K]) {
  #pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const int u = u0 + 4 * q;
    if constexpr (kVec) {
      if (u < stride)
        *reinterpret_cast<float4*>(row + u) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        if (u + e < stride) row[u + e] = v[4 * q + e];
    }
  }
}

template <int K, bool kVec>
__device__ __forceinline__ void load_cols(float (&v)[K], const float* row,
                                          int u0, int stride) {
  #pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const int u = u0 + 4 * q;
    if constexpr (kVec) {
      float4 x = make_float4(NEG, NEG, NEG, NEG);
      if (u < stride) x = *reinterpret_cast<const float4*>(row + u);
      v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z,
      v[4 * q + 3] = x.w;
    } else {
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        v[4 * q + e] = u + e < stride ? row[u + e] : NEG;
    }
  }
}

// The chunks of an utterance's alpha pass in order, by increments: row t
// from 0 up, chunk j from the left, slot s and the parity of its phase.
struct AlphaWalk {
  int t = 0, j = 0, s = 0, parity = 0;
  __device__ void next(int R) {
    if (++s == kSlots) s = 0, parity ^= 1;
    if (++j == R) j = 0, ++t;
  }
};

// The alpha chain, run by warps 0 (the chain) and 1 (the producer) of a
// block: rows 0 .. Tl - 1 of alpha into alpha[t * stride + u], shared or
// device memory, and logZ into *logz by the lane that owns column Ul of
// row Tl - 1 (the caller sets NEG first, for Tl = 0). A lane stores its
// own K columns (kVec as for store_cols), or with kStaged puts them in
// the chunk of shared memory at `stage` and stores columns q 32 + lane
// (q < K) of the lattice, coalesced; the chain reads back alpha[t-1] of
// its own columns, after a __syncwarp when staged. Chunk c of
// the utterance is row t = c / R, chunk j = c % R from the left, columns
// u = j kChunk + i (i < kChunk; u > Ul is padding), in slot c % kSlots:
// lpb of row t - 1 (0 at t = 0), lpl of row t and their exclusive prefix
// sums cumP. A chunk passes full[s] (producer -> chain) and empty[s]
// (chain -> producer), mbarriers whose phase n is the slot's n-th chunk.
template <int K, bool kVec, bool kStaged = false>
__device__ void alpha_roles(const Utt& a, float* alpha, int stride,
                            float* logz, float* slots, uint64_t* full,
                            uint64_t* empty, float* stage = nullptr) {
  constexpr int kChunk = 32 * K;
  constexpr int kSlotFloats = 3 * kChunk;   // lpb[t-1], lpl[t], cumP
  const int W = a.Ul + 1, R = (W + kChunk - 1) / kChunk;
  const int n_chunks = a.Tl * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 1) {
    // producer: copies of kInFlight chunks in flight; a chunk's slot is
    // published once its copies landed and its prefix sums are written
    float row_p = 0.f;
    AlphaWalk in, out;
    for (int c = 0; c < n_chunks + kInFlight - 1; ++c) {
      if (c < n_chunks) {
        // the slot's previous chunk (phase parity ^ 1) has been freed
        if (c >= kSlots) mbar_wait(&empty[in.s], in.parity ^ 1);
        const int u0 = in.j * kChunk;
        float* dst = slots + in.s * kSlotFloats;
        const float* b = a.lpb + (size_t)(in.t > 0 ? in.t - 1 : 0) * a.U1;
        const float* l = a.lpl + (size_t)in.t * a.U1;
        #pragma unroll
        for (int m = 0; m < K; ++m) {
          const int i = lane + 32 * m, u = u0 + i;
          const bool ok = u < W;
          const int g = ok ? u : 0;
          tsasr::cp_async4(dst + i, b + g, ok && in.t > 0);
          tsasr::cp_async4(dst + kChunk + i, l + g, ok);
        }
        in.next(R);
      }
      tsasr::cp_async_commit();
      tsasr::cp_async_wait<kInFlight - 1>();
      const int f = c - (kInFlight - 1);
      if (f < 0) continue;
      __syncwarp();   // the other lanes' copies of chunk f are visible
      const int j = out.j, s = out.s;
      out.next(R);
      const int u0 = j * kChunk + lane * K;
      float* src = slots + s * kSlotFloats;
      float p[K];
      loadv(p, src + kChunk + lane * K);
      float cum[K];
      float acc = 0.f;
      #pragma unroll
      for (int k = 0; k < K; ++k) {
        cum[k] = acc;
        acc += u0 + k < a.Ul ? p[k] : 0.f;
      }
      float incl = acc;
      #pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, o);
        incl += lane >= o ? y : 0.f;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      if (j == 0) row_p = 0.f;
      #pragma unroll
      for (int k = 0; k < K; ++k) cum[k] = (cum[k] + excl) + row_p;
      row_p += __shfl_sync(kFull, incl, 31);
      storev(src + 2 * kChunk + lane * K, cum);
      mbar_arrive(&full[s]);
    }
  } else if (warp == 0) {
    // the chain: alpha[t] = cumP + logcumsumexp((alpha[t-1] + lpb[t-1]) -
    // cumP), as (max, scaled sum) pairs; alpha[t-1] stays in registers
    // when a row is one chunk
    const int p0 = lane * K;
    const float lpb_end =
        a.Tl > 0 ? a.lpb[(size_t)(a.Tl - 1) * a.U1 + a.Ul] : 0.f;
    float an[K];
    float cm = NEG, cs = 0.f;   // the carry from the chunks to the left
    AlphaWalk w;
    for (int c = 0; c < n_chunks; ++c, w.next(R)) {
      const int j = w.j, t = w.t;
      const int u0 = j * kChunk + p0;
      if (t == 0) {
        #pragma unroll
        for (int k = 0; k < K; ++k) an[k] = u0 + k == 0 ? 0.f : NEG;
      } else if (R > 1) {
        load_cols<K, kVec>(an, alpha + (size_t)(t - 1) * stride, u0, stride);
      }
      mbar_wait(&full[w.s], w.parity);
      const float* src = slots + w.s * kSlotFloats;
      float b[K], cp[K];
      loadv(b, src + p0);
      loadv(cp, src + 2 * kChunk + p0);
      mbar_arrive(&empty[w.s]);
      float pm[K], ps[K];
      float m = NEG, sum = 0.f;
      #pragma unroll
      for (int k = 0; k < K; ++k) {
        const float x = u0 + k < W ? (an[k] + b[k]) - cp[k] : NEG;
        const float q = fast_exp(-fabsf(x - m));
        sum = x > m ? fmaf(sum, q, 1.f) : sum + q;
        m = fmaxf(m, x);
        pm[k] = m;
        ps[k] = sum;
      }
      float im = m, is = sum;
      #pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        // below lane 0, the identity (NEG, 0): adds exactly 0
        const bool in_warp = lane >= o;
        const float om = __shfl_up_sync(kFull, im, o);
        const float os = __shfl_up_sync(kFull, is, o);
        pair_add(im, is, in_warp ? om : NEG, in_warp ? os : 0.f);
      }
      float em = __shfl_up_sync(kFull, im, 1);
      float es = __shfl_up_sync(kFull, is, 1);
      if (lane == 0) em = NEG, es = 0.f;
      if (j > 0) pair_add(em, es, cm, cs);   // the chunks to the left
      #pragma unroll
      for (int k = 0; k < K; ++k) {
        float fm = pm[k], fs = ps[k];
        pair_add(fm, fs, em, es);
        an[k] = (u0 + k < W && fm > NEG / 2) ? cp[k] + (fm + fast_log(fs))
                                              : NEG;
      }
      if (j + 1 < R) {   // the carry of the chunk to the right
        float nm = __shfl_sync(kFull, im, 31);
        float ns = __shfl_sync(kFull, is, 31);
        if (j > 0) pair_add(nm, ns, cm, cs);
        cm = nm;
        cs = ns;
      }
      if constexpr (kStaged) {
        storev(stage + p0, an);
        __syncwarp();
        float* row = alpha + (size_t)t * stride + j * kChunk;
        #pragma unroll
        for (int q = 0; q < K; ++q) {
          const int i = q * 32 + lane;
          if (j * kChunk + i < W) row[i] = stage[i];
        }
        __syncwarp();   // read before the next chunk is staged
      } else {
        store_cols<K, kVec>(alpha + (size_t)t * stride, u0, stride, an);
      }
      if (t == a.Tl - 1) {
        #pragma unroll
        for (int k = 0; k < K; ++k)
          if (u0 + k == a.Ul) *logz = an[k] + lpb_end;
      }
    }
  }
}

// The chunks of an utterance's beta pass in order, by increments (no
// division in the loops): row t from Tl - 1 down, chunk j from the right,
// slot s and the parity of its phase, the beta ring's rows rt = t % rows
// and rt1 = (t + 1) % rows.
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

// The beta slab kernel: one block per utterance, 4 warps with one role
// each; a chunk is 32 K columns, K consecutive ones a chain lane
// (beta_slab_cols picks K). Chunk c of the utterance is row t = Tl - 1 -
// c / R, chunk j = c % R from the right,
// columns u = W - (j + 1) kChunk + i (i < kChunk; u < 0 is padding), in
// slot c % kSlots; its beta goes to the beta ring's row t % rows at
// positions p = u + R kChunk - W. A chunk passes full[s] (producer ->
// chain), chained[s] (chain -> gradient warps) and empty[s] (gradient
// warps -> producer), mbarriers whose phase n is the slot's n-th chunk.
template <int K>
__global__ void __launch_bounds__(kChainThreads)
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

// The resident kernel's beta pass, run by all 4 warps of a block: the beta
// slab kernel's roles (above) with alpha read from shared memory, rows
// `stride` apart, by the gradient warps, so a slot holds lpb, lpl and
// sufP, 3 chunks; the kernel writes the zeros around the lattice itself.
template <int K>
__device__ void beta_roles(const Utt& a, const float* alpha, int stride,
                           const float* logz, float* slots, float* ring,
                           uint64_t* full, uint64_t* chained,
                           uint64_t* empty, float* dlpb, float* dlpl) {
  constexpr int kChunk = 32 * K;
  constexpr int kSlotFloats = 3 * kChunk;   // lpb, lpl, sufP
  const int U1 = a.U1;
  const int W = a.Ul + 1, R = (W + kChunk - 1) / kChunk;
  const int RC = R * kChunk, rows = beta_ring_rows(R);
  const int n_chunks = a.Tl * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

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
      storev(src + 2 * kChunk + lane * K, suf);
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
      loadv(sp, src + 2 * kChunk + p0);
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
    // gradient warps: each chunk once the chain has its beta
    const int g = threadIdx.x - 64, ng = 32 * kGradWarps;
    const float lz = *logz;
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
        const int u = u0 + i;
        const float al = alpha[(size_t)w.t * stride + (u >= 0 ? u : 0)];
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
      mbar_arrive(&empty[s]);
    }
  }
}

// The resident kernel's shared memory, in floats: a header (the alpha
// pass's full and empty mbarriers, the beta pass's full, chained and
// empty ones, then logZ), the slot ring (3 chunks a slot in both
// passes), the resident alpha (T rows of alpha_stride(U1)), the beta
// ring.
constexpr int kResidentHeader = 64;
static_assert(2 * 5 * kSlots + 1 <= kResidentHeader,
              "the header holds 5 kSlots mbarriers and logZ");

// Row stride of the resident alpha: U1 rounded up to 4 floats, so the
// chain's stores of a lane's K columns are aligned float4s.
__host__ __device__ inline int alpha_stride(int U1) { return (U1 + 3) & ~3; }

// Both passes of an utterance in one block, alpha resident in shared
// memory.
template <int K>
__global__ void __launch_bounds__(kChainThreads)
    rnnt_resident_kernel(const float* lpb, const float* lpl,
                         const int* t_lens, const int* u_lens, float* loss,
                         float* dlpb, float* dlpl, int T, int U1) {
  constexpr int kChunk = 32 * K;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_logz = smem + 2 * 5 * kSlots;
  float* slots = smem + kResidentHeader;
  float* s_alpha = slots + kSlots * 3 * kChunk;
  const int S = alpha_stride(U1);
  float* ring = s_alpha + (size_t)T * S;

  const Utt a = utterance(lpb, lpl, t_lens, u_lens, T, U1);
  const size_t off = (size_t)blockIdx.x * T * U1;
  dlpb += off;
  dlpl += off;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&bar[s], 32);                          // alpha: full
      mbar_init(&bar[kSlots + s], 32);                 // alpha: empty
      mbar_init(&bar[2 * kSlots + s], 32);             // beta: full
      mbar_init(&bar[3 * kSlots + s], 32);             // beta: chained
      mbar_init(&bar[4 * kSlots + s], 32 * kGradWarps);  // beta: empty
    }
    *s_logz = NEG;
  }
  __syncthreads();   // barriers and logZ set, before any row
  if (threadIdx.x < 64) {
    alpha_roles<K, true>(a, s_alpha, S, s_logz, slots, bar, bar + kSlots);
  } else {
    // meanwhile the gradient warps write the zeros around the lattice:
    // rows past Tl, then the columns past Ul of the others
    const int g = threadIdx.x - 64, ng = 32 * kGradWarps, W = a.Ul + 1;
    for (size_t e = (size_t)a.Tl * U1 + g; e < (size_t)T * U1; e += ng)
      dlpb[e] = dlpl[e] = 0.f;
    for (int t = 0; W < U1 && t < a.Tl; ++t)
      for (int u = W + g; u < U1; u += ng)
        dlpb[(size_t)t * U1 + u] = dlpl[(size_t)t * U1 + u] = 0.f;
  }
  __syncthreads();   // alpha and logZ complete, every slot free
  if (threadIdx.x == 0) loss[blockIdx.x] = -*s_logz;
  beta_roles<K>(a, s_alpha, S, s_logz, slots, ring, bar + 2 * kSlots,
                      bar + 3 * kSlots, bar + 4 * kSlots, dlpb, dlpl);
}

// The alpha slab kernel's shared memory, in floats: a header (the full
// and empty mbarriers, then logZ), the slot ring (3 chunks a slot), and
// the chain's staging chunk.
constexpr int kAlphaSlabHeader = 32;
static_assert(2 * 2 * kSlots + 1 <= kAlphaSlabHeader,
              "the header holds 2 kSlots mbarriers and logZ");

// The alpha pass of an utterance alone, alpha into device memory rows U1
// apart (the beta slab kernel reads that layout), logZ and the loss. Up
// to K = 8 a chunk's alpha is staged and stored coalesced: 0.2209 against
// 0.2688 ms at B3 T408 U+1 241 on an H100, where at K = 16 and 32 that
// read 9 and 15 % slower than each lane storing its own columns.
template <int K>
__global__ void __launch_bounds__(64)
    rnnt_alpha_slab_kernel(const float* lpb, const float* lpl,
                           const int* t_lens, const int* u_lens,
                           float* alpha, float* logz, float* loss, int T,
                           int U1) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_logz = smem + 2 * 2 * kSlots;
  float* slots = smem + kAlphaSlabHeader;

  const Utt a = utterance(lpb, lpl, t_lens, u_lens, T, U1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&bar[s], 32);            // full
      mbar_init(&bar[kSlots + s], 32);   // empty
    }
    *s_logz = NEG;                       // stays so when Tl = 0
  }
  __syncthreads();   // barriers and logZ set, before any row
  alpha_roles<K, false, (K <= 8)>(
      a, alpha + (size_t)blockIdx.x * T * U1, U1, s_logz, slots, bar,
      bar + kSlots, slots + kSlots * 3 * 32 * K);
  __syncthreads();   // logZ written
  if (threadIdx.x == 0) {
    logz[blockIdx.x] = *s_logz;
    loss[blockIdx.x] = -*s_logz;
  }
}

// Floats of the beta ring at its largest over the rounds a row of at most
// U1 columns can take in chunks of `chunk` columns.
size_t beta_ring_floats(int U1, int chunk) {
  size_t ring = 0;
  for (int r = 1; r <= (U1 + chunk - 1) / chunk; ++r)
    ring = std::max(ring, (size_t)beta_ring_rows(r) * r * chunk);
  return ring;
}

// Shared memory of the beta slab kernel at K columns a lane: barriers,
// the slot ring, and the beta ring.
size_t beta_slab_smem(int U1, int K) {
  const int chunk = 32 * K;
  return sizeof(float) * (8 * kSlots + (size_t)kSlots * 4 * chunk +
                          beta_ring_floats(U1, chunk));
}

// Shared memory of the resident kernel at K columns a lane (the layout
// above rnnt_resident_kernel).
size_t resident_smem_at(int T, int U1, int K) {
  const int chunk = 32 * K;
  return sizeof(float) * (kResidentHeader + (size_t)kSlots * 3 * chunk +
                          (size_t)T * alpha_stride(U1) +
                          beta_ring_floats(U1, chunk));
}

constexpr size_t kMaxSmem = 227 * 1024;

// Columns a lane: the least K that holds a row of U1 columns in one chunk
// (8 up to 256 columns, 16 up to 512, else 32); the beta slab and the
// resident kernel fall back to 8 when their shared memory at that K would
// not fit.
int chain_cols(int U1) { return U1 <= 256 ? 8 : U1 <= 512 ? 16 : 32; }

// The alpha slab kernel keeps no alpha on chip, so its shared memory (at
// most 77,952 bytes, at K = 32) fits at every K: 4 up to 128 columns, as
// the resident kernel, then the least K whose chunk holds a row; rows
// wider than 1024 columns take chunks of 1024. kernels/rnnt_lattice.py::
// alpha_slab_cols mirrors it.
int alpha_slab_cols(int U1) { return U1 <= 128 ? 4 : chain_cols(U1); }

size_t alpha_slab_smem(int K) {
  return sizeof(float) *
         (kAlphaSlabHeader + (size_t)(kSlots * 3 + 1) * 32 * K);
}

int beta_slab_cols(int U1) {
  const int K = chain_cols(U1);
  return beta_slab_smem(U1, K) <= kMaxSmem ? K : 8;
}

// The resident kernel takes the alpha slab's K, K = 4 up to 128 columns
// included (a shorter in-lane scan on the chain: 18 % less time at B96
// T104 U+1 61 on an H100).
int resident_cols(int T, int U1) {
  const int K = alpha_slab_cols(U1);
  return K <= 8 || resident_smem_at(T, U1, K) <= kMaxSmem ? K : 8;
}

size_t resident_smem(int T, int U1) {
  return resident_smem_at(T, U1, resident_cols(T, U1));
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
  rnnt_beta_slab_kernel<K><<<B, kChainThreads, smem, stream>>>(
      lpb, lpl, t_lens, u_lens, alpha, logz, dlpb, dlpl, T, U1);
  return (int)cudaGetLastError();
}

template <int K>
int launch_alpha_slab(const float* lpb, const float* lpl, const int* t_lens,
                      const int* u_lens, float* alpha, float* logz,
                      float* loss, int B, int T, int U1,
                      cudaStream_t stream) {
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnnt_alpha_slab_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  rnnt_alpha_slab_kernel<K><<<B, 64, alpha_slab_smem(K), stream>>>(
      lpb, lpl, t_lens, u_lens, alpha, logz, loss, T, U1);
  return (int)cudaGetLastError();
}

template <int K>
int launch_resident(const float* lpb, const float* lpl, const int* t_lens,
                    const int* u_lens, float* loss, float* dlpb, float* dlpl,
                    int B, int T, int U1, cudaStream_t stream) {
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnnt_resident_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const size_t smem = resident_smem_at(T, U1, K);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  rnnt_resident_kernel<K><<<B, kChainThreads, smem, stream>>>(
      lpb, lpl, t_lens, u_lens, loss, dlpb, dlpl, T, U1);
  return (int)cudaGetLastError();
}

bool valid(int B, int T, int U1) {
  return B >= 1 && T >= 1 && U1 >= 1;
}

}  // namespace

// lpb, lpl, dlpb, dlpl: (B, T, U1) f32; t_lens, u_lens: (B,) int32; loss:
// (B,) f32; all contiguous on the current device. The resident kernel
// needs rnnt_lattice_resident_smem(T, U1) bytes of shared memory, at most
// 227 KB. Each entry point returns the CUDA error code of its launch (0
// on success).
extern "C" int rnnt_lattice_resident(const float* lpb, const float* lpl,
                                     const int* t_lens, const int* u_lens,
                                     float* loss, float* dlpb, float* dlpl,
                                     int B, int T, int U1, void* stream) {
  if (!valid(B, T, U1)) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (resident_cols(T, U1)) {
    case 32:
      return launch_resident<32>(lpb, lpl, t_lens, u_lens, loss, dlpb, dlpl,
                                 B, T, U1, st);
    case 16:
      return launch_resident<16>(lpb, lpl, t_lens, u_lens, loss, dlpb, dlpl,
                                 B, T, U1, st);
    case 4:
      return launch_resident<4>(lpb, lpl, t_lens, u_lens, loss, dlpb, dlpl,
                                B, T, U1, st);
    default:
      return launch_resident<8>(lpb, lpl, t_lens, u_lens, loss, dlpb, dlpl,
                                B, T, U1, st);
  }
}

// Bytes of shared memory the resident kernel asks for at (T, U1) (-1 for
// shapes no kernel takes); kernels/rnnt_lattice.py::resident_smem mirrors
// it.
extern "C" long long rnnt_lattice_resident_smem(int T, int U1) {
  return valid(1, T, U1) ? (long long)resident_smem(T, U1) : -1;
}

// alpha: (B, T, U1) f32 scratch (rows past t_lens and columns past
// u_lens + 1 are left unwritten or hold NEG); logz: (B,) f32.
extern "C" int rnnt_lattice_alpha_slab(const float* lpb, const float* lpl,
                                       const int* t_lens, const int* u_lens,
                                       float* alpha, float* logz, float* loss,
                                       int B, int T, int U1, void* stream) {
  if (!valid(B, T, U1)) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (alpha_slab_cols(U1)) {
    case 32:
      return launch_alpha_slab<32>(lpb, lpl, t_lens, u_lens, alpha, logz,
                                   loss, B, T, U1, st);
    case 16:
      return launch_alpha_slab<16>(lpb, lpl, t_lens, u_lens, alpha, logz,
                                   loss, B, T, U1, st);
    case 8:
      return launch_alpha_slab<8>(lpb, lpl, t_lens, u_lens, alpha, logz,
                                  loss, B, T, U1, st);
    default:
      return launch_alpha_slab<4>(lpb, lpl, t_lens, u_lens, alpha, logz,
                                  loss, B, T, U1, st);
  }
}

// Columns a lane of the alpha slab kernel's chain owns at U1 (-1 for
// U1 < 1); kernels/rnnt_lattice.py::alpha_slab_cols mirrors it.
extern "C" int rnnt_lattice_alpha_slab_cols(int U1) {
  return valid(1, 1, U1) ? alpha_slab_cols(U1) : -1;
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
