// Direct-layout encoder attention forward that also writes the normalised
// probabilities, for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_fwd_kernel_direct_savep
// (called through _fwd_direct_savep), with its dropout branch. For each
// batch item b and head h it reads the (S, 64) column blocks of q, k and v straight out
// of the packed (B, S, 3D) projection output and computes with the TPU
// kernel's rounding points:
//   s = q k^T * 64^-1/2 (fp32), m = rowmax(s), p = exp(s - m), l = rowsum(p),
//   P = p / l, written as bf16 (B, H, S, S) whatever the input type T,
//   O = P.to(T) v accumulated in fp32 and cast to T.
// Unlike kernel #1 (encoder_attention_fwd.cu), p is normalised before the
// product and O is not divided afterwards, so the row's max and sum must be
// known before any of O. With dropout (flash_attention.py:762-769) P is
// written before the mask; the P that multiplies v is then zeroed where the
// mask (encoder_tile.cuh::keeps) drops and scaled by 1/keep where it keeps,
// before its rounding to T.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the call reads
// B*S*3D*2 bytes and writes B*S*D*2 + B*H*S^2*2 bytes, and does
// 4*B*H*S^2*d FLOPs. At ViT-B (S=197, D=768, H=12, d=64) and B=32 that is
// 29.0 + 9.7 + 29.8 MB, 20.5 us, against 3.8 GFLOP, 3.9 us: memory-bound,
// and the P write is as large as the qkv read.
//
// Design (kernel #1's, on the CUDA cores): one block of 128 threads per
// (tile of 32 query rows, head, batch item), the q tile and chunks of 64
// keys staged in shared memory as fp32 (encoder_tile.cuh). Pass 1 walks the
// keys once for the row max and sum: each thread keeps a running max and a
// sum rescaled when the max grows, over its own keys, and the 16 lanes of a
// row combine theirs with shuffles. Pass 2 recomputes s, forms P = exp(s -
// m) / l, stores it as bf16 straight from registers (16 lanes write 16
// consecutive keys of a row: 2-byte stores, since a row of 197 bf16 is not
// 16-byte aligned), rounds it to T in shared memory and accumulates P v.
// Rows and keys past S are masked: staged as zeros, keys given P = 0, rows
// not stored.
//
// C interface: arsvt_encoder_attention_savep_fwd launches on the given
// stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "encoder_tile.cuh"

namespace {

using namespace enc;

constexpr int kRows = kTile;   // query rows per block
constexpr int kKeys = kChunk;  // keys per shared-memory chunk
constexpr size_t kSmemBytes =
    sizeof(float) * kStride * (kRows + 2 * kKeys + kRows);

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    encoder_attention_savep_fwd_kernel(const T* __restrict__ qkv,
                                       T* __restrict__ out,
                                       __nv_bfloat16* __restrict__ probs,
                                       int seq, int heads, float scale,
                                       Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * kStride;
  float* Vs = Ks + kKeys * kStride;
  float* Ps = Vs + kKeys * kStride;

  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * heads + h);
  const int d_model = heads * kHeadDim;
  const int64_t row_stride = 3 * (int64_t)d_model;
  const T* base = qkv + (int64_t)b * seq * row_stride;
  const T* q_base = base + h * kHeadDim;
  const T* k_base = base + d_model + h * kHeadDim;
  const T* v_base = base + 2 * d_model + h * kHeadDim;
  __nv_bfloat16* p_base = probs + ((int64_t)b * heads + h) * seq * seq;

  const int rg = threadIdx.x / 16;  // rows rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // keys lg+16j; output dims lg*4+j

  stage(q_base, row0, kRows, seq, row_stride, Qs);

  // pass 1: this thread's running max and rescaled sum over its keys
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // the previous chunk has been read
    stage(k_base, k0, kKeys, seq, row_stride, Ks);
    __syncthreads();
    float s[4][4];
    dot_tile(Qs, Ks, rg, lg, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + lg + 16 * j < seq) cm = fmaxf(cm, s[i][j]);
      if (cm == -INFINITY) continue;  // none of this thread's keys is real
      const float mn = fmaxf(m[i], cm);
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + lg + 16 * j < seq) add += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + add;  // expf(-inf) = 0 at the start
      m[i] = mn;
    }
  }
  // the row's max and sum over the 16 lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mr = m[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
    float lr = m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mr);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lr += __shfl_xor_sync(0xffffffffu, lr, off);
    m[i] = mr;
    l[i] = lr;
  }

  // pass 2: P = exp(s - m) / l, stored as bf16; acc = P.to(T) v
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();
    stage(k_base, k0, kKeys, seq, row_stride, Ks);
    stage(v_base, k0, kKeys, seq, row_stride, Vs);
    __syncthreads();
    float s[4][4];
    dot_tile(Qs, Ks, rg, lg, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + lg + 16 * j;
        const float p = key < seq ? expf(s[i][j] - m[i]) / l[i] : 0.f;
        if (row < seq && key < seq)
          p_base[(int64_t)row * seq + key] = __float2bfloat16(p);
        float p_use = p;
        if constexpr (kDrop)
          p_use = keeps(drop, bh, row, key) ? p * drop.inv_keep : 0.f;
        Ps[(rg * 4 + i) * kStride + lg + 16 * j] = round_to(p_use, T());
      }
    }
    __syncthreads();
    accumulate(Ps, Vs, rg, lg, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + rg * 4 + i;
    if (row >= seq) continue;
    store4(out + ((int64_t)b * seq + row) * d_model + h * kHeadDim + lg * 4,
           acc[i]);
  }
}

template <typename T, bool kDrop>
cudaError_t launch(const void* qkv, void* out, void* probs, int batch,
                   int seq, int heads, Dropout drop, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_savep_fwd_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  encoder_attention_savep_fwd_kernel<T, kDrop><<<grid, kThreads, kSmemBytes,
                                                 stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<__nv_bfloat16*>(probs), seq, heads, scale, drop);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers, 16-byte
// aligned; qkv is a contiguous (batch, seq, 3 * heads * 64) tensor, out a
// contiguous (batch, seq, heads * 64) tensor of the same type, probs a
// contiguous (batch, heads, seq, seq) bfloat16 tensor. dropout 0 or 1;
// with 1, keep iff philox_bits(seed, b * heads + h, row, col) < threshold
// and scale kept probabilities by inv_keep.
extern "C" int arsvt_encoder_attention_savep_fwd(
    const void* qkv, void* out, void* probs, int batch, int seq, int heads,
    int head_dim, uint32_t seed, uint32_t threshold, float inv_keep,
    int dropout, int dtype, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || seq < 1 ||
      heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, inv_keep};
  return (int)with_dropout(dropout, [&](auto flag) {
    constexpr bool kDrop = decltype(flag)::value;
    switch (dtype) {
      case 0:
        return launch<float, kDrop>(qkv, out, probs, batch, seq, heads, drop,
                                    st);
      case 1:
        return launch<__nv_bfloat16, kDrop>(qkv, out, probs, batch, seq,
                                            heads, drop, st);
      default:
        return cudaErrorInvalidValue;
    }
  });
}
