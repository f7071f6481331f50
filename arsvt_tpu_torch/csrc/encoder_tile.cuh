// Tile helpers of the direct-layout encoder-attention backward on the CUDA
// cores (encoder_attention_bwd.cu), and the attention-dropout rule
// (`keeps`) that it, the attention forwards (attention_fwd.cuh: #1, #3, #5)
// and the save-probs backward (encoder_attention_savep_bwd.cu) draw.
//
// A block of 128 threads works on one head's 64 columns. Rows of q, k, v,
// O or dO are staged in shared memory as fp32 with a row stride of 68
// floats (16-byte aligned rows, conflict-free float4 reads), and so are
// the 32 x 64 tiles of p, dS or P. Thread (rg, lg) = (tid / 16, tid % 16)
// holds a 4 x 4 tile of a 32 x 64 score tile (rows rg*4+i, columns
// lg+16j) and a 4 x 4 tile of a 32 x 64 output (rows rg*4+i, head dims
// lg*4+j); row sums reduce across the 16 lanes of a half-warp.
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

#include <cuda_bf16.h>
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

constexpr int kHeadDim = 64;
constexpr int kThreads = 128;
constexpr int kTile = 32;    // rows a block owns: queries or keys
constexpr int kChunk = 64;   // rows of the other side per staged chunk
constexpr int kStride = 68;  // floats per staged row: 64 + 4

static_assert(kThreads == (kTile / 4) * 16, "4x4 tiles over 16 lanes");
static_assert(kChunk == 4 * 16 && kHeadDim == 4 * 16, "tile widths");

template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int n = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float x, float) { return x; }

__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// Stage `rows` rows (starting at sequence row `row0`) of one head's 64
// columns into shared memory as fp32; rows at or past `seq` become zeros.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ head_base,
                                      int row0, int rows, int seq,
                                      int64_t row_stride, float* dst) {
  constexpr int n = VecWidth<T>::n;
  constexpr int per_row = kHeadDim / n;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx % per_row) * n;
    float vals[n];
    if (row0 + r < seq) {
      load_vec(head_base + (int64_t)(row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < n; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < n; i += 4) store4(dst + r * kStride + c + i, vals + i);
  }
}

// out[i][j] = scale * <A row rg*4+i, B row lg+16j> over the 64 head dims,
// summed by sequential FMAs in dim order.
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int rg, int lg, float scale,
                                         float out[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < kHeadDim; dd += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg * 4 + i) * kStride + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (lg + 16 * j) * kStride + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i][j] = fmaf(a[i].x, b[j].x, out[i][j]);
        out[i][j] = fmaf(a[i].y, b[j].y, out[i][j]);
        out[i][j] = fmaf(a[i].z, b[j].z, out[i][j]);
        out[i][j] = fmaf(a[i].w, b[j].w, out[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] *= scale;
}

// acc[i][j] += sum over c < kChunk of L[rg*4+i][c] * R[c][lg*4+j].
__device__ __forceinline__ void accumulate(const float* L, const float* R,
                                           int rg, int lg, float acc[4][4]) {
#pragma unroll 4
  for (int c = 0; c < kChunk; c += 4) {
    float4 l4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      l4[i] = *reinterpret_cast<const float4*>(L + (rg * 4 + i) * kStride + c);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 r = *reinterpret_cast<const float4*>(R + (c + t) * kStride + lg * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l = t == 0 ? l4[i].x : t == 1 ? l4[i].y : t == 2 ? l4[i].z : l4[i].w;
        acc[i][0] = fmaf(l, r.x, acc[i][0]);
        acc[i][1] = fmaf(l, r.y, acc[i][1]);
        acc[i][2] = fmaf(l, r.z, acc[i][2]);
        acc[i][3] = fmaf(l, r.w, acc[i][3]);
      }
    }
  }
}

}  // namespace enc
