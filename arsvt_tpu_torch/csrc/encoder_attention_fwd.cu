// Direct-layout encoder attention forward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_fwd_kernel_direct
// (called through _fwd_direct), with its dropout branch. For each batch
// item b and head h it reads
// the (S, 64) column blocks of q, k and v straight out of the packed
// (B, S, 3D) projection output, at columns h*64, D + h*64 and 2D + h*64,
// and computes with the TPU kernel's arithmetic order:
//   s = q k^T * 64^-1/2 (fp32), m = rowmax(s), p = exp(s - m), l = rowsum(p),
//   O = (p.to(T) v) / l accumulated in fp32, lse = m + log(l).
// The unnormalised p is rounded to the input type T before the product, and
// the division by l comes after it. O is written into columns h*64 of a
// (B, S, D) output and lse as (B, H, 1, S) fp32: no transpose either way.
// With dropout (flash_attention.py:553-559) the unnormalised p is zeroed
// where the mask drops and scaled by 1/keep where it keeps, before the
// rounding to T and the product; l and lse stay the sums before dropout.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the core reads
// B*S*3D*2 bytes and writes B*S*D*2 + B*H*S*4 bytes, and does 4*B*H*S^2*d
// FLOPs. At ViT-B (S=197, D=768, H=12, d=64) and B=8 that is 9.76 MB and
// 0.954 GFLOP: 2.91 us of memory against 0.96 us of tensor-core time, so
// the kernel is memory-bound; at B=1 the bound is 0.36 us and launch
// latency dominates.
//
// Design (a first, simple one; wgmma/TMA is later work): one block of 128
// threads per (tile of 32 query rows, head, batch item). The q tile and
// chunks of 64 keys of K and V are staged in shared memory as fp32, with
// 16-byte vector loads from the strided head columns (a head's row segment
// is 128 bytes for bf16, 256 for fp32). Two passes over the keys keep the
// arithmetic order above exactly for any sequence length: the first finds
// the row max, the second recomputes s, forms p = exp(s - m), sums l in
// fp32, rounds p to T and accumulates p v in fp32. Rows and keys past S
// (197 is not a multiple of 32 or 64) are masked: staged as zeros, keys
// given p = 0, rows not stored. Each thread holds a 4x4 tile of scores
// (rows rg*4+i, keys lg+16j) and a 4x4 tile of the output (rows rg*4+i,
// dims lg*4+j); row statistics are reduced across the 16 threads of a
// half-warp with shuffles. Scores and products run on the CUDA cores, not
// the tensor cores.
//
// C interface: arsvt_encoder_attention_fwd launches on the given stream,
// allocates nothing and returns cudaGetLastError() (or
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
    encoder_attention_fwd_kernel(const T* __restrict__ qkv,
                                 T* __restrict__ out, float* __restrict__ lse,
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

  const int rg = threadIdx.x / 16;  // rows rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // keys lg+16j; output dims lg*4+j

  stage(q_base, row0, kRows, seq, row_stride, Qs);

  // pass 1: row max over all keys
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // the previous chunk has been read
    stage(k_base, k0, kKeys, seq, row_stride, Ks);
    __syncthreads();
    float s[4][4];
    dot_tile(Qs, Ks, rg, lg, scale, s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + lg + 16 * j < seq)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));

  // pass 2: p = exp(s - m), l = rowsum(p), acc = p.to(T) v
  float l[4] = {0.f, 0.f, 0.f, 0.f};
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
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + lg + 16 * j;
        const float p = key < seq ? expf(s[i][j] - m[i]) : 0.f;
        l[i] += p;
        float p_use = p;
        if constexpr (kDrop)
          p_use = keeps(drop, bh, row0 + rg * 4 + i, key) ? p * drop.inv_keep
                                                           : 0.f;
        Ps[(rg * 4 + i) * kStride + lg + 16 * j] = round_to(p_use, T());
      }
    __syncthreads();
    accumulate(Ps, Vs, rg, lg, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + rg * 4 + i;
    if (row >= seq) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = acc[i][j] / l[i];
    store4(out + ((int64_t)b * seq + row) * d_model + h * kHeadDim + lg * 4, o);
    if (lg == 0) lse[((int64_t)b * heads + h) * seq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, bool kDrop>
cudaError_t launch(const void* qkv, void* out, void* lse, int batch, int seq,
                   int heads, Dropout drop, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_fwd_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  encoder_attention_fwd_kernel<T, kDrop>
      <<<grid, kThreads, kSmemBytes, stream>>>(
          static_cast<const T*>(qkv), static_cast<T*>(out),
          static_cast<float*>(lse), seq, heads, scale, drop);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers, 16-byte
// aligned; qkv is a contiguous (batch, seq, 3 * heads * head_dim) tensor.
// dropout 0 or 1; with 1, keep iff philox_bits(seed, b * heads + h, row,
// col) < threshold and scale kept probabilities by inv_keep.
extern "C" int arsvt_encoder_attention_fwd(const void* qkv, void* out,
                                           void* lse, int batch, int seq,
                                           int heads, int head_dim,
                                           uint32_t seed, uint32_t threshold,
                                           float inv_keep, int dropout,
                                           int dtype, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || seq < 1 ||
      heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, inv_keep};
  return (int)with_dropout(dropout, [&](auto flag) {
    constexpr bool kDrop = decltype(flag)::value;
    switch (dtype) {
      case 0:
        return launch<float, kDrop>(qkv, out, lse, batch, seq, heads, drop,
                                    st);
      case 1:
        return launch<__nv_bfloat16, kDrop>(qkv, out, lse, batch, seq, heads,
                                            drop, st);
      default:
        return cudaErrorInvalidValue;
    }
  });
}
