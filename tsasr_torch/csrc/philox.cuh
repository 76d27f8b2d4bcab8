// Counter-based Philox4x32-10 (Salmon et al., SC'11), word 0 only.
//
// The fused attention's dropout keys it by the seed and counts it by
// (b, h, i, j): word 0 of philox(ctr = (j, i, h, b), key = (seed low,
// seed high)). The forward and the backward regenerate one mask from it
// bit for bit, and kernels/relpos_attention.py::philox_keep_mask computes
// the same bits in int64 tensor arithmetic.

#pragma once
#include <stdint.h>

namespace tsasr {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c0;
}

// Keep (b, h, i, j) iff its draw is >= thresh = floor(rate * 2^32).
__device__ __forceinline__ bool dropout_keep(uint64_t seed, uint32_t thresh,
                                             int b, int h, int i, int j) {
  return philox_word0((uint32_t)j, (uint32_t)i, (uint32_t)h, (uint32_t)b,
                      (uint32_t)(seed & 0xffffffffull),
                      (uint32_t)(seed >> 32)) >= thresh;
}

}  // namespace tsasr
