// bf16 products on Hopper's tensor cores: mma.sync m16n8k16 with f32
// accumulation, and the copies and fragment loads of bf16 tiles.
//
// The bf16 attention kernels round where the JAX kernels round with bf16
// operands: each product takes bf16 operands and sums in f32 (one mma a
// k-step of 16, where the f32 kernels' 3xTF32 takes three of 8).
//
// Layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for lane
// = 4 g + t (g = lane / 4, t = lane % 4); each 32-bit register holds two
// bf16, the lower k (or column) in the low half:
//   A (16 x 16, m x k): a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1),
//                       a2 (g, 2t+8..2t+9), a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n):  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C (16 x 8, m x n):  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// So two accumulator n-tiles side by side (16 x 16) are, packed to bf16,
// the A operand of a product over those 16 columns (pack_acc), with no
// data movement.
//
// Fragments come from shared memory by ldmatrix where a tile's rows are
// 16-byte aligned and contiguous (ldsm_*: row-major A, B stored n-major,
// and with .trans B stored k-major or A stored k-major), and by functors
// at(row, col) returning one bf16 where the read is skewed (the
// rel-shift's diagonals), as the f32 kernels' loaders do. Rows of a bf16
// tile are DP + 8 elements apart: 16-byte aligned, and an 8-row ldmatrix
// phase (rows 16 (DP / 8 + 1) bytes apart) touches 8 distinct 16-byte
// bank groups for DP = 32, 64, 128.

#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace tsasr {

using bf16 = __nv_bfloat16;

struct FragA16 {
  uint32_t r[4];
};

struct FragB16 {
  uint32_t r[2];
};

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two f32 rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// at(m, k) for m in [0, 16), k in [0, 16)
template <class F>
__device__ __forceinline__ FragA16 load_a16(F at) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  FragA16 a;
  a.r[0] = pack2(at(g, 2 * t), at(g, 2 * t + 1));
  a.r[1] = pack2(at(g + 8, 2 * t), at(g + 8, 2 * t + 1));
  a.r[2] = pack2(at(g, 2 * t + 8), at(g, 2 * t + 9));
  a.r[3] = pack2(at(g + 8, 2 * t + 8), at(g + 8, 2 * t + 9));
  return a;
}

// at(k, n) for k in [0, 16), n in [0, 8)
template <class F>
__device__ __forceinline__ FragB16 load_b16(F at) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  FragB16 b;
  b.r[0] = pack2(at(2 * t, g), at(2 * t + 1, g));
  b.r[1] = pack2(at(2 * t + 8, g), at(2 * t + 9, g));
  return b;
}

// Accumulator n-tiles x0 (columns 0-7) and x1 (8-15) as an A operand
__device__ __forceinline__ FragA16 pack_acc(const float (&x0)[4],
                                            const float (&x1)[4]) {
  FragA16 a;
  a.r[0] = pack2f(x0[0], x0[1]);
  a.r[1] = pack2f(x0[2], x0[3]);
  a.r[2] = pack2f(x1[0], x1[1]);
  a.r[3] = pack2f(x1[2], x1[3]);
  return a;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A (16 x 16) from a row-major tile: rows m0.., columns k0.., ld elements
__device__ __forceinline__ FragA16 ldsm_a(const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* row = tile + (lane & 15) * ld + (lane >> 4) * 8;
  FragA16 a;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
      : "r"(smem_addr(row))
      : "memory");
  return a;
}

// A (16 x 16) = X^T for X stored k-major: X[k][m], rows k0.., columns m0..
__device__ __forceinline__ FragA16 ldsm_a_trans(const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  // lanes 0-7: a0 (k 0-7, m 0-7), 8-15: a1 (m 8-15), 16-23: a2 (k 8-15),
  // 24-31: a3 (k 8-15, m 8-15)
  const bf16* row = tile + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                    ((lane >> 3) & 1) * 8;
  FragA16 a;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
      : "r"(smem_addr(row))
      : "memory");
  return a;
}

// B n-tiles n0 and n0 + 1 (k 16 x n 16) for B stored n-major: Y[n][k],
// rows n0.., columns k0..
__device__ __forceinline__ void ldsm_b_pair(const bf16* tile, int ld,
                                            FragB16& b0, FragB16& b1) {
  const int lane = threadIdx.x & 31;
  // lanes 0-7: (n 0-7, k 0-7), 8-15: (n 0-7, k 8-15), 16-23: (n 8-15,
  // k 0-7), 24-31: (n 8-15, k 8-15)
  const bf16* row = tile + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                    ((lane >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
      : "r"(smem_addr(row))
      : "memory");
}

// B n-tiles n0 and n0 + 1 for B stored k-major: Y[k][n], rows k0..,
// columns n0..
__device__ __forceinline__ void ldsm_b_pair_trans(const bf16* tile, int ld,
                                                  FragB16& b0, FragB16& b1) {
  const int lane = threadIdx.x & 31;
  // lanes 0-7: (k 0-7, n 0-7), 8-15: (k 8-15, n 0-7), 16-23: (k 0-7,
  // n 8-15), 24-31: (k 8-15, n 8-15)
  const bf16* row = tile + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                    (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
      : "r"(smem_addr(row))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const FragA16& a,
                                         const FragB16& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
        "r"(b.r[1]));
}

// one B n-tile (k 16 x n 8) for B stored n-major: rows n0.., columns k0..
__device__ __forceinline__ FragB16 ldsm_b(const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  // lanes 0-7: (n 0-7, k 0-7), 8-15: (n 0-7, k 8-15); 16-31 repeat them
  const bf16* row = tile + (lane & 7) * ld + ((lane >> 3) & 1) * 8;
  FragB16 b;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b.r[0]), "=r"(b.r[1])
               : "r"(smem_addr(row))
      : "memory");
  return b;
}

// one B n-tile for B stored k-major: rows k0.., columns n0..
__device__ __forceinline__ FragB16 ldsm_b_trans(const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  // lanes 0-7: (k 0-7, n 0-7), 8-15: (k 8-15, n 0-7); 16-31 repeat them
  const bf16* row = tile + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld;
  FragB16 b;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b.r[0]), "=r"(b.r[1])
      : "r"(smem_addr(row))
      : "memory");
  return b;
}

// d[n] += a Y_n^T for N n-tiles of Y stored n-major (rows n0 + 8 n..,
// columns k0..): the product with a tile of keys, queries or positions.
template <int N>
__device__ __forceinline__ void mma_row_nmajor(float (&d)[N][4],
                                               const FragA16& a,
                                               const bf16* y, int ld) {
#pragma unroll
  for (int n = 0; n + 1 < N; n += 2) {
    FragB16 b0, b1;
    ldsm_b_pair(y + n * 8 * ld, ld, b0, b1);
    mma_bf16(d[n], a, b0);
    mma_bf16(d[n + 1], a, b1);
  }
  if (N % 2) mma_bf16(d[N - 1], a, ldsm_b(y + (N - 1) * 8 * ld, ld));
}

// d[n] += a Y_n for N n-tiles of Y stored k-major (rows k0.., columns
// 8 n..): the product with a tile of values or head-dim rows.
template <int N>
__device__ __forceinline__ void mma_row_kmajor(float (&d)[N][4],
                                               const FragA16& a,
                                               const bf16* y, int ld) {
#pragma unroll
  for (int n = 0; n + 1 < N; n += 2) {
    FragB16 b0, b1;
    ldsm_b_pair_trans(y + n * 8, ld, b0, b1);
    mma_bf16(d[n], a, b0);
    mma_bf16(d[n + 1], a, b1);
  }
  if (N % 2) mma_bf16(d[N - 1], a, ldsm_b_trans(y + (N - 1) * 8, ld));
}

// barrier of the two warps of row group grp (named barriers 1 .. NR), a
// compiler barrier too: shared stores before it are not moved past it
__device__ __forceinline__ void pair_sync(int grp) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + grp) : "memory");
}

// ------------------------------------------------------------ tile copies
__device__ __forceinline__ void cp_async16_raw(void* dst, const void* src,
                                               bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// dst[r * (DP + 8) + c] = src[(first + r) * Dh + c] for r < n, c < DP;
// zeros for rows outside [0, limit) and columns c >= Dh. NT threads share
// the copy: 16-byte cp.async when vec (Dh % 8 == 0, src aligned), else
// plain element stores (visible after the caller's next __syncthreads).
template <int DP, int NT>
__device__ __forceinline__ void load_rows16(bf16* dst, const bf16* src,
                                            int first, int n, int limit,
                                            int Dh, bool vec) {
  constexpr int ld = DP + 8;
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int e = threadIdx.x; e < n * kChunks; e += NT) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8, g = first + r;
      const bool ok = g >= 0 && g < limit && c < Dh;
      cp_async16_raw(dst + r * ld + c, ok ? src + (size_t)g * Dh + c : src,
                     ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * DP; e += NT) {
      const int r = e / DP, c = e - r * DP, g = first + r;
      const bool ok = g >= 0 && g < limit && c < Dh;
      dst[r * ld + c] = ok ? src[(size_t)g * Dh + c] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace tsasr
