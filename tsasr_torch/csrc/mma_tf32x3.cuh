// f32-accurate products on Hopper's tensor cores: 3xTF32 mma.sync.
//
// A TF32 product keeps 10 mantissa bits of each operand, about 1e-3 of
// the result. Splitting each f32 operand x into big = tf32(x) and small =
// tf32(x - big) and summing a_small b_big + a_big b_small + a_big b_big
// keeps ~21 bits (the dropped a_small b_small is ~2^-22 of the product),
// so the result is as close to the f32 product as a plain f32 dot. This
// is what CUTLASS's OpMultiplyAddFastF32 does on sm_80 and later.
//
// Layout of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, for lane
// = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, m x k): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x n):  b0 (t, g), b1 (t+4, g)
//   C (16 x 8, m x n): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// The loaders take a functor at(row, col) that returns the element, so a
// caller reads shared memory row-major, transposed or skewed, with zeros
// where it likes.

#pragma once
#include <stdint.h>

namespace tsasr {

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 does for finite x, in two integer operations
// (the cvt also handles NaN and infinity, which no operand here is)
__device__ __forceinline__ uint32_t rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_bits(x);
  small = rna_bits(x - __uint_as_float(big));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// at(m, k) for m in [0, 16), k in [0, 8)
template <class F>
__device__ __forceinline__ FragA load_a(F at) {
  const int g = lane_g(), t = lane_t();
  FragA a;
  split_tf32(at(g, t), a.big[0], a.small[0]);
  split_tf32(at(g + 8, t), a.big[1], a.small[1]);
  split_tf32(at(g, t + 4), a.big[2], a.small[2]);
  split_tf32(at(g + 8, t + 4), a.big[3], a.small[3]);
  return a;
}

// at(k, n) for k in [0, 8), n in [0, 8)
template <class F>
__device__ __forceinline__ FragB load_b(F at) {
  const int g = lane_g(), t = lane_t();
  FragB b;
  split_tf32(at(t, g), b.big[0], b.small[0]);
  split_tf32(at(t + 4, g), b.big[1], b.small[1]);
  return b;
}

// (row, column) of accumulator element e in [0, 4) of this lane
__device__ __forceinline__ int c_row(int e) { return lane_g() + 8 * (e >> 1); }
__device__ __forceinline__ int c_col(int e) { return 2 * lane_t() + (e & 1); }

// An accumulator n-tile X (16 x 8) as the A operand of a product X @ Y,
// without moving data: a lane holds X columns 2t and 2t+1 where A wants
// columns t and t+4, so the k-step takes X's columns in the order
// acc_key(k) = 2 (k % 4) + k / 4, and the B operand reads Y's rows in
// that same order (at(k, n) = Y[acc_key(k)][n]). The sum over k is the
// same sum.
__device__ __forceinline__ FragA load_a_acc(const float (&x)[4]) {
  FragA a;
  split_tf32(x[0], a.big[0], a.small[0]);    // (g, 2t)     as (g, t)
  split_tf32(x[2], a.big[1], a.small[1]);    // (g+8, 2t)   as (g+8, t)
  split_tf32(x[1], a.big[2], a.small[2]);    // (g, 2t+1)   as (g, t+4)
  split_tf32(x[3], a.big[3], a.small[3]);    // (g+8, 2t+1) as (g+8, t+4)
  return a;
}

__device__ __forceinline__ int acc_key(int k) { return 2 * (k & 3) + (k >> 2); }

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a b_n for a row of N n-tiles, b_n(k, c) = at(n, k, c), in
// 3xTF32. Each k-step's three products are summed on the tensor core from
// zero, small terms first, and only then added to d in f32: the tensor
// core's own accumulation truncates, and over a long k loop into one
// accumulator that bias adds up (to ~1e-5 of the sum over a few hundred
// keys) where round-to-nearest f32 adds do not. The n-tiles go in groups:
// all B fragments of a group are loaded first, then each of the three
// products runs over the whole group, so no mma waits on the one before.
template <int N, class F>
__device__ __forceinline__ void mma_tf32x3_row(float (&d)[N][4],
                                               const FragA& a, F at) {
  constexpr int G = N <= 10 ? N : 8;
  static_assert(N % G == 0, "n-tiles in whole groups");
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += G) {
    FragB b[G];
    float t[G][4];
#pragma unroll
    for (int n = 0; n < G; ++n) {
      b[n] = load_b([&](int k, int c) { return at(n0 + n, k, c); });
#pragma unroll
      for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < G; ++n) mma_tf32(t[n], a.small, b[n].big);
#pragma unroll
    for (int n = 0; n < G; ++n) mma_tf32(t[n], a.big, b[n].small);
#pragma unroll
    for (int n = 0; n < G; ++n) mma_tf32(t[n], a.big, b[n].big);
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n0 + n][e] += t[n][e];
  }
}

}  // namespace tsasr
