// Direct-layout encoder attention forward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_fwd_kernel_direct
// (called through _fwd_direct), with its dropout branch. For each batch
// item b and head h it reads the (S, 64) column blocks of q, k and v
// straight out of the packed (B, S, 3D) projection output, at columns
// h*64, D + h*64 and 2D + h*64, and computes with the TPU kernel's
// arithmetic order:
//   s = q k^T * 64^-1/2 (fp32), m = rowmax(s), p = exp(s - m), l = rowsum(p),
//   O = (p.to(T) v) / l accumulated in fp32, lse = m + log(l).
// The unnormalised p is rounded to the input type T before the product, and
// the division by l comes after it. O is written into columns h*64 of a
// (B, S, D) output and lse as (B, H, 1, S) fp32: no transpose either way.
// With dropout (flash_attention.py:553-559) the unnormalised p is zeroed
// where the mask drops and scaled by 1/keep where it keeps, before the
// rounding to T and the product; l and lse stay the sums before dropout.
// The mask is keeps(drop, bh, row, col) of encoder_tile.cuh, a template
// flag (kDrop) keeping the rate-0 launches free of the draw.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the core reads
// B*S*3D*2 bytes and writes B*S*D*2 + B*H*S*4 bytes, and does 4*B*H*S^2*d
// FLOPs. At ViT-B (S=197, D=768, H=12, d=64) and B=32 that is 39.0 MB and
// 3.8 GFLOP: 11.65 us of memory against 3.9 us of tensor-core time, so the
// kernel is memory-bound; at B=1 the bound is 0.36 us and launch latency
// dominates.
//
// Design (attention_fwd.cuh, on warp_tile.cuh's tiles): one block of four
// warps per (64 query rows, head, batch item), 16 rows a warp with Q's
// fragments in registers; K and V chunks of 64 keys staged as bf16 (or
// fp32) by 16-byte cp.async from the strided head columns, one chunk in
// flight while the other is computed; two passes over the keys (the row
// max, then p, l and P V) with both products on tensor-core mma.sync in
// bf16 and P kept in registers; fp32 runs the same tiles on the CUDA
// cores. Keys past S are staged as zeros and given p = 0, rows past S are
// not stored.
//
// C interface: arsvt_encoder_attention_fwd launches on the given stream,
// allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

constexpr int kHeadDim = attn::kEncoderHeadDim;  // 64

template <typename T>
cudaError_t launch(const void* qkv, void* out, void* lse, int batch, int seq,
                   int heads, enc::Dropout drop, int dropout,
                   cudaStream_t stream) {
  const int64_t d_model = (int64_t)heads * kHeadDim, row = 3 * d_model;
  const T* base = static_cast<const T*>(qkv);
  attn::FwdArgs<T> a{};
  a.q = {base, seq * row, kHeadDim, row};
  a.k = {base + d_model, seq * row, kHeadDim, row};
  a.v = {base + 2 * d_model, seq * row, kHeadDim, row};
  a.out = {static_cast<T*>(out), seq * d_model, kHeadDim, d_model};
  a.lse = static_cast<float*>(lse);
  a.heads = heads;
  a.sq = a.sk = a.kv_len = seq;
  a.d = kHeadDim;
  a.scale = 1.0f / sqrtf((float)kHeadDim);
  a.drop = drop;
  return attn::launch_fwd<T, kHeadDim>(a, batch, dropout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers, 16-byte
// aligned; qkv is a contiguous (batch, seq, 3 * heads * head_dim) tensor.
// dropout 0 or 1; with 1, keep iff philox_bits(seed, (b0 + b) * mask_heads
// + h0 + h, row, col) < threshold and scale kept probabilities by
// inv_keep; (b0, mask_heads, h0) place the launch in the global batch and
// head set (encoder_tile.cuh), (0, heads, 0) for a one-process call.
extern "C" int arsvt_encoder_attention_fwd(const void* qkv, void* out,
                                           void* lse, int batch, int seq,
                                           int heads, int head_dim,
                                           uint32_t seed, uint32_t threshold,
                                           float inv_keep, int dropout,
                                           int b0, int mask_heads, int h0,
                                           int dtype, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || seq < 1 ||
      heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b0 < 0 || mask_heads < heads || h0 < 0 || h0 + heads > mask_heads)
    return (int)cudaErrorInvalidValue;
  const enc::Dropout drop{seed, threshold, inv_keep, b0, mask_heads, h0};
  switch (dtype) {
    case 0:
      return (int)launch<float>(qkv, out, lse, batch, seq, heads, drop,
                                dropout, st);
    case 1:
      return (int)launch<__nv_bfloat16>(qkv, out, lse, batch, seq, heads,
                                        drop, dropout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Interface 2 takes the mask's global offsets (b0, mask_heads, h0) after
// the dropout flag; interface 1 had none.
extern "C" int arsvt_attention_version() { return 2; }
