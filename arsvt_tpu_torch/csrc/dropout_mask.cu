// The keep mask of a residual, positional or reference-attention dropout
// site (ops/dropout.py::dropout_mask). It replaces no TPU kernel: JAX draws
// these masks with jax.random.bernoulli (arsvt_tpu/models/vit.py:140-145),
// whose bits are a function of the key alone. The port draws them by the
// attention kernels' rule instead (encoder_tile.cuh::keeps): element
// (b, h, r, c) of a (B, H, R, C) view is kept iff
// philox_bits(seed, (b0 + b)*H' + h0 + h, r, c) < threshold. A residual or
// positional site views x (B, S, D) as (B, 1, S, D), so its key word is the
// global batch row; a reference attention call views its probabilities as
// (B, H, Sq, Sk), so it and kernels #3/#4 draw one mask. The bits depend on
// global indices alone: the card, the CPU's plain version
// (ops/dropout.py::keep_mask) and every rank of a data- or tensor-parallel
// step draw the same mask.
//
// Bound on an H100 SXM: it reads nothing and writes one byte an element
// (3.35 TB/s), but each element runs the ten Philox rounds (about 60 32-bit
// integer operations), so at the port's shapes the integer pipes, not the
// bytes, set its time. One thread an element, a flat grid-stride loop with
// 32-bit index arithmetic (the view holds fewer than 2^31 elements; the
// entry refuses more).

#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_tile.cuh"

namespace {

__global__ void __launch_bounds__(256)
    mask_kernel(uint8_t* __restrict__ out, uint32_t n, uint32_t heads,
                uint32_t rows, uint32_t cols, enc::Dropout drop) {
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t c = i % cols, t = i / cols;
    const uint32_t r = t % rows, bh = t / rows;
    const uint32_t h = bh % heads, b = bh / heads;
    out[i] = enc::keeps(drop, drop.bh((int)b, (int)h), (int)r, (int)c);
  }
}

}  // namespace

// out: a contiguous (batch, heads, rows, cols) uint8 (torch.bool) tensor on
// the device. Keep iff philox_bits(seed, (b0 + b) * mask_heads + h0 + h,
// r, c) < threshold.
extern "C" int arsvt_dropout_mask(void* out, int batch, int heads, int rows,
                                  int cols, uint32_t seed,
                                  uint32_t threshold, int b0, int mask_heads,
                                  int h0, void* stream) {
  const uint64_t n = (uint64_t)batch * heads * rows * cols;
  if (batch < 1 || heads < 1 || rows < 1 || cols < 1 || n > 0x7FFFFFFFull ||
      b0 < 0 || h0 < 0 || h0 + heads > mask_heads)
    return (int)cudaErrorInvalidValue;
  const enc::Dropout drop{seed, threshold, 1.0f, b0, mask_heads, h0};
  const uint32_t threads = 256;
  const uint64_t want = (n + threads - 1) / threads;
  const uint32_t blocks = (uint32_t)(want < 132u * 16u ? want : 132u * 16u);
  mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), (uint32_t)n, (uint32_t)heads,
      (uint32_t)rows, (uint32_t)cols, drop);
  return (int)cudaGetLastError();
}
