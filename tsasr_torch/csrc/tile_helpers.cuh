// Tiles into shared memory for the attention kernels: cp.async copies of
// rows of a (rows, Dh) array, zero-padded, and the barrier of a row
// group's two warps.
//
// Both attention kernels run two warps per group of 16 query rows: warp
// w is in row group w % NR and half w / NR of its group (NR groups a
// block).

#pragma once
#include <stdint.h>

namespace tsasr {

__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }
template <int NR>
__device__ __forceinline__ int row_group() { return warp_id() % NR; }
template <int NR>
__device__ __forceinline__ int warp_half() { return warp_id() / NR; }

// barrier of the two warps of a row group (named barriers 1 .. NR)
template <int NR>
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + row_group<NR>()));
}

// ------------------------------------------------------------ async copies
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r * (DP + 4) + c] = src[(first + r) * Dh + c] for r < n, c < DP;
// zeros for rows outside [0, limit) and for columns c >= Dh. NT threads
// share the copy; 16-byte copies when vec (Dh % 4 == 0, src aligned).
template <int DP, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int first, int n, int limit,
                                          int Dh, bool vec) {
  constexpr int ld = DP + 4;
  if (vec) {
    constexpr int kChunks = DP / 4;
    for (int e = threadIdx.x; e < n * kChunks; e += NT) {
      const int r = e / kChunks, c = (e - r * kChunks) * 4, g = first + r;
      const bool ok = g >= 0 && g < limit && c < Dh;
      cp_async16(dst + r * ld + c, ok ? src + (size_t)g * Dh + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * DP; e += NT) {
      const int r = e / DP, c = e - r * DP, g = first + r;
      const bool ok = g >= 0 && g < limit && c < Dh;
      cp_async4(dst + r * ld + c, ok ? src + (size_t)g * Dh + c : src, ok);
    }
  }
}

}  // namespace tsasr
