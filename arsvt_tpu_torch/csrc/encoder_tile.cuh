// The attention-dropout rule (`keeps`) that every attention kernel draws:
// the forwards (attention_fwd.cuh: #1, #3, #5), the backwards
// (attention_bwd.cuh: #2, #4) and the save-probs backward
// (encoder_attention_savep_bwd.cu: #6).
//
// Attention dropout (the `dropout_rate > 0` branch of each TPU kernel):
// the probability of query row i for key column j of head h in batch item
// b is kept iff philox_bits(seed, b*H + h, i, j) < threshold (philox.cuh)
// and then scaled by inv_keep. The bits depend on those four numbers alone,
// so the forward, both backward launches, the head-major kernels and the
// plain versions (ops/dropout.py::keep_mask) all draw one mask. Each kernel
// takes the branch as a template flag, so a launch without dropout draws
// nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace enc {

struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
};

// Turn a C entry's dropout flag into the kernels' template flag: calls
// launch(std::true_type{}) for 1 and launch(std::false_type{}) for 0;
// any other flag is cudaErrorInvalidValue.
template <class F>
cudaError_t with_dropout(int flag, F&& launch) {
  if (flag == 1) return launch(std::true_type{});
  if (flag == 0) return launch(std::false_type{});
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ bool keeps(const Dropout& drop, uint32_t bh,
                                      int row, int col) {
  return philox_bits(drop.seed, bh, (uint32_t)row, (uint32_t)col) <
         drop.threshold;
}

}  // namespace enc
