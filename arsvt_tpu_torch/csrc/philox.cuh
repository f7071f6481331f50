// Philox4x32-10, the counter-based generator of the attention kernels'
// dropout mask (the plain PyTorch version is arsvt_tpu_torch/ops/dropout.py
// ::keep_bits). Key (seed, b*H + h), counter (query row, key column, 0, 0),
// first output word: an element's bits depend on those four numbers alone,
// so every kernel and every tiling rebuilds the same mask.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t bh,
                                                uint32_t row, uint32_t col) {
  uint32_t c0 = row, c1 = col, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = bh;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}
