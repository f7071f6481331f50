// The dropout sites of the residual, positional and reference-attention
// paths (ops/dropout.py).
//
// arsvt_dropout_apply (ops/dropout.py::dropout_apply, one launch a site's
// forward and one its backward):
// out = keep ? in * s : +0 over a (B, H, R, C) view, in the input's dtype
// (fp32 or bf16). It replaces no TPU kernel: JAX's dropout
// (arsvt_tpu/models/vit.py:140-145) and its reference attention
// (arsvt_tpu/ops/attention.py:44-47) are jax.random.bernoulli and a where
// that XLA fuses into one pass; the port's eager path drew the mask in one
// launch and applied it in three more, and its backward kept the mask and
// ran two or three passes. The backward is the same function of the
// gradient (dx = keep ? g * s : +0), so it replays the mask from the seed
// and nothing is saved.
//
// The rule, shared with the attention kernels (encoder_tile.cuh::keeps):
// element (b, h, r, c) of the view is kept iff
// philox_bits(seed, (b0 + b)*H' + h0 + h, r, c) < threshold. A residual or
// positional site views x (B, S, D) as (B, 1, S, D), so its key word is the
// global batch row; a reference attention call views its probabilities as
// (B, H, Sq, Sk), so it and kernels #3/#4 draw one mask. The bits depend on
// global indices alone: the card, the CPU's plain version
// (ops/dropout.py::keep_mask) and every rank of a data- or tensor-parallel
// step draw the same mask.
//
// Bound on an H100 SXM: the apply kernel moves 4 bytes an element in bf16
// (8 in fp32) at 3.35 TB/s, but each element runs the Philox rounds, so
// at the port's shapes the integer pipes, not the bytes, set its time.
// With the work that depends on the row alone hoisted (`RowBits`), the
// rule costs 27 32-bit multiplies an element on the FMA pipe and 17
// logic operations (16 three-input xors, the compare) on the ALU pipe,
// each pipe 64 a clock on each of 132 SMs: the multiplies set the bound.
//
// Design of the apply kernel: the grid's y dimension walks the B*H*R rows
// of the view (a block loops past 65,535), so the row's key word, its
// index and the row's share of rounds 1-3 and of the key schedule are the
// block's own, computed once a row and never divided per element. Threads
// cover C with 8 contiguous elements each: one 16-byte load and store in
// bf16, two in fp32, streaming (each byte is touched once). A row of C not
// a multiple of 8 (the DETR self-attention's C = 5) or a pointer off 16
// bytes takes the scalar route, one element a thread. The result is
// selected, never multiplied by the mask, so a dropped Inf or NaN gives +0
// as torch.where does, and the scale is one _rn operation (no FMA
// contraction): the eager path's bits to the last place (chip_smoke.py
// phase 3(a)).
//
// It refuses views of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_tile.cuh"

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

// philox_bits(seed, key, row, col) (philox.cuh) with the row's share done
// once a row. The counter starts at (row, col, 0, 0), so round 1 mixes col
// into word 0 alone (a xor), and words 1-3 stay functions of the row until
// round 2 (word 0) and round 3 (word 1) take them; what depends on the row
// alone, and the ten key pairs, are kept here. Round 10 needs only word 0,
// round 9 only the words it feeds, which the compiler prunes.
struct RowBits {
  uint32_t k0[10], k1[10];
  uint32_t r2, r3a, r3b, r3c;

  __device__ __forceinline__ RowBits(uint32_t seed, uint32_t key,
                                     uint32_t row) {
#pragma unroll
    for (uint32_t i = 0; i < 10; ++i) {
      k0[i] = seed + i * kW0;
      k1[i] = key + i * kW1;
    }
    const uint32_t c2 = __umulhi(kM0, row) ^ k1[0];  // round 1's word 2
    const uint32_t c0 = __umulhi(kM1, c2) ^ k0[1];   // round 2's word 0
    r2 = (kM0 * row) ^ k1[1];                        // round 1's word 3
    r3a = (kM1 * c2) ^ k0[2];                        // round 2's word 1
    r3b = __umulhi(kM0, c0) ^ k1[2];
    r3c = kM0 * c0;                                  // round 3's word 3
  }

  __device__ __forceinline__ uint32_t bits(uint32_t col) const {
    const uint32_t w0 = col ^ k0[0];                 // round 1
    uint32_t c2 = __umulhi(kM0, w0) ^ r2;            // round 2
    uint32_t c3 = kM0 * w0;
    uint32_t c0 = __umulhi(kM1, c2) ^ r3a;           // round 3
    uint32_t c1 = kM1 * c2;
    c2 = c3 ^ r3b;
    c3 = r3c;
#pragma unroll
    for (int i = 3; i < 10; ++i) {
      const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
      const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
      c0 = hi1 ^ c1 ^ k0[i];
      c1 = lo1;
      c2 = hi0 ^ c3 ^ k1[i];
      c3 = lo0;
    }
    return c0;
  }
};

__device__ __forceinline__ float apply1(float x, bool keep, float s) {
  return keep ? __fmul_rn(x, s) : 0.0f;
}

__device__ __forceinline__ __nv_bfloat16 apply1(__nv_bfloat16 x, bool keep,
                                                float s) {
  return keep ? __float2bfloat16_rn(__fmul_rn(__bfloat162float(x), s))
              : __ushort_as_bfloat16(0);
}

// 8 elements from column col of the row, 16-byte aligned
template <typename T>
__device__ __forceinline__ void apply8(T* out, const T* in,
                                       const RowBits& row, uint32_t col,
                                       uint32_t threshold, float s) {
  constexpr int kVecs = (int)sizeof(T) / 2;  // 16-byte words of 8 elements
  uint4 raw[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    raw[i] = __ldcs(reinterpret_cast<const uint4*>(in) + i);
  T* v = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = apply1(v[j], row.bits(col + j) < threshold, s);
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    __stcs(reinterpret_cast<uint4*>(out) + i, raw[i]);
}

struct Site {
  enc::Dropout drop;
  uint32_t lines;  // B * H * R rows of the view
  uint32_t heads, rows, cols;
  float scale;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(256)
    apply_kernel(T* __restrict__ out, const T* __restrict__ in, Site s) {
  const uint32_t first = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t = blockIdx.y; t < s.lines; t += gridDim.y) {
    const uint32_t bh = t / s.rows;
    const RowBits row(s.drop.seed,
                      s.drop.bh((int)(bh / s.heads), (int)(bh % s.heads)),
                      t % s.rows);
    const uint32_t base = t * s.cols;
    if constexpr (kVec) {
      for (uint32_t c = first * 8; c < s.cols; c += stride * 8)
        apply8<T>(out + base + c, in + base + c, row, c, s.drop.threshold,
                  s.scale);
    } else {
      for (uint32_t c = first; c < s.cols; c += stride)
        out[base + c] =
            apply1(in[base + c], row.bits(c) < s.drop.threshold, s.scale);
    }
  }
}

template <typename T>
cudaError_t launch_apply(void* out, const void* in, const Site& s, bool vec,
                         cudaStream_t stream) {
  const uint32_t units = vec ? s.cols / 8 : s.cols;
  const uint32_t threads = units >= 256 ? 256 : (units + 31) / 32 * 32;
  const uint32_t gx = (units + threads - 1) / threads;
  const dim3 grid(gx < 65535u ? gx : 65535u,
                  s.lines < 65535u ? s.lines : 65535u);
  T* o = static_cast<T*>(out);
  const T* i = static_cast<const T*>(in);
  if (vec)
    apply_kernel<T, true><<<grid, threads, 0, stream>>>(o, i, s);
  else
    apply_kernel<T, false><<<grid, threads, 0, stream>>>(o, i, s);
  return cudaGetLastError();
}

}  // namespace

// out, in: contiguous (batch, heads, rows, cols) tensors of one dtype on
// the device (dtype 0: fp32, 1: bf16), not overlapping. out = keep ? in *
// scale : +0, one fp32 product rounded once, keep iff philox_bits(seed,
// (b0 + b) * mask_heads + h0 + h, r, c) < threshold.
extern "C" int arsvt_dropout_apply(void* out, const void* in, int dtype,
                                   int batch, int heads, int rows, int cols,
                                   uint32_t seed, uint32_t threshold, int b0,
                                   int mask_heads, int h0, float scale,
                                   void* stream) {
  const uint64_t n = (uint64_t)batch * heads * rows * cols;
  if (out == nullptr || in == nullptr || batch < 1 || heads < 1 ||
      rows < 1 || cols < 1 || n > 0x7FFFFFFFull || b0 < 0 || h0 < 0 ||
      h0 + heads > mask_heads)
    return (int)cudaErrorInvalidValue;
  const Site s{{seed, threshold, 1.0f, b0, mask_heads, h0},
               (uint32_t)batch * heads * rows, (uint32_t)heads,
               (uint32_t)rows, (uint32_t)cols, scale};
  const bool vec = cols % 8 == 0 && (uintptr_t)out % 16 == 0 &&
                   (uintptr_t)in % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_apply<float>(out, in, s, vec, st);
  if (dtype == 1) return (int)launch_apply<__nv_bfloat16>(out, in, s, vec, st);
  return (int)cudaErrorInvalidValue;
}
