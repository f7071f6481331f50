// The attention-dropout rule (`keeps`) that every attention kernel draws:
// the forwards (attention_fwd.cuh: #1, #3, #5), the backwards
// (attention_bwd.cuh: #2, #4) and the save-probs backward
// (encoder_attention_savep_bwd.cu: #6).
//
// Attention dropout (the `dropout_rate > 0` branch of each TPU kernel):
// the probability of query row i for key column j of head h in batch item
// b is kept iff philox_bits(seed, (b0 + b)*H + h0 + h, i, j) < threshold
// (philox.cuh) and then scaled by inv_keep. (b0, H, h0) place the launch in
// the global batch and head set: a rank of a data- or tensor-parallel step
// holds rows b0.. of the microbatch and heads h0.. of H, and a one-process
// call passes (0, its heads, 0). The bits depend on the global indices
// alone, so the forward, both backward launches, the head-major kernels,
// the plain versions (ops/dropout.py::keep_mask) and every rank of a
// parallel step all draw one mask. Each kernel takes the branch as a
// template flag, so a launch without dropout draws nothing.

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
  int b0;     // the launch's first row in the global batch
  int heads;  // the global head count H
  int h0;     // the launch's first head among the H

  // the mask's key word of local batch item b, local head h
  __device__ __forceinline__ uint32_t bh(int b, int h) const {
    return (uint32_t)((b0 + b) * heads + h0 + h);
  }
  // the local (b, h) back from a key word: a kernel that keeps only the
  // key word live through its walk recovers its addresses from it
  __device__ __forceinline__ int batch_of(uint32_t key) const {
    return (int)((key - (uint32_t)h0) / (uint32_t)heads) - b0;
  }
  __device__ __forceinline__ int head_of(uint32_t key) const {
    return (int)((key - (uint32_t)h0) % (uint32_t)heads);
  }
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
