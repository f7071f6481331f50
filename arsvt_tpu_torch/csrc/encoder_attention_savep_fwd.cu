// Direct-layout encoder attention forward that also writes the normalised
// probabilities, for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_fwd_kernel_direct_savep
// (called through _fwd_direct_savep), with its dropout branch. For each
// batch item b and head h it reads the (S, 64) column blocks of q, k and v
// straight out of the packed (B, S, 3D) projection output and computes with
// the TPU kernel's rounding points:
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
// Design (attention_fwd.cuh with kSaveP, the body of #1 and #3, on
// warp_tile.cuh's tensor-core tiles): one block of four warps per (64 query
// rows, head, batch item), 16 rows a warp with Q's fragments in registers;
// K and V chunks of 64 keys staged by 16-byte cp.async from the strided
// head columns in a two-slot ring. Pass 1 walks K for each row's max and
// sum (a running sum per lane, rescaled as its max grows, combined over
// the quad); pass 2 walks K and V, forms P = exp(s - m) / l (the IEEE
// quotient, by an fp64 product with 1 / l: attention_fwd.cuh::div_rn, which
// keeps the loop free of the division's slow-path call), stages each
// warp's 16 x 64 bf16 tile of P in shared memory and writes its rows from
// there, neighbouring lanes on neighbouring keys (a row of 197 bf16 is not
// 4-byte aligned on every row), then applies the dropout select, rounds to
// T as it packs P into the A fragments of P V (P never leaves registers for
// the product) and multiplies on tensor-core mma.sync in bf16; fp32 runs
// the same tiles on the CUDA cores. Keys past S are staged as zeros and
// given P = 0, and neither they nor rows past S are stored.
//
// C interface: arsvt_encoder_attention_savep_fwd launches on the given
// stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

constexpr int kHeadDim = attn::kEncoderHeadDim;  // 64

template <typename T>
cudaError_t launch(const void* qkv, void* out, void* probs, int batch,
                   int seq, int heads, enc::Dropout drop, int dropout,
                   cudaStream_t stream) {
  const int64_t d_model = (int64_t)heads * kHeadDim, row = 3 * d_model;
  const T* base = static_cast<const T*>(qkv);
  attn::FwdArgs<T> a{};
  a.q = {base, seq * row, kHeadDim, row};
  a.k = {base + d_model, seq * row, kHeadDim, row};
  a.v = {base + 2 * d_model, seq * row, kHeadDim, row};
  a.out = {static_cast<T*>(out), seq * d_model, kHeadDim, d_model};
  a.probs = static_cast<__nv_bfloat16*>(probs);
  a.heads = heads;
  a.sq = a.sk = a.kv_len = seq;
  a.d = kHeadDim;
  a.scale = 1.0f / sqrtf((float)kHeadDim);
  a.drop = drop;
  return attn::launch_fwd<T, kHeadDim, true>(a, batch, dropout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers, 16-byte
// aligned; qkv is a contiguous (batch, seq, 3 * heads * 64) tensor, out a
// contiguous (batch, seq, heads * 64) tensor of the same type, probs a
// contiguous (batch, heads, seq, seq) bfloat16 tensor. dropout 0 or 1;
// with 1, keep iff philox_bits(seed, (b0 + b) * mask_heads + h0 + h, row,
// col) < threshold
// and scale kept probabilities by inv_keep.
extern "C" int arsvt_encoder_attention_savep_fwd(
    const void* qkv, void* out, void* probs, int batch, int seq, int heads,
    int head_dim, uint32_t seed, uint32_t threshold, float inv_keep,
    int dropout, int b0, int mask_heads, int h0, int dtype, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || seq < 1 ||
      heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b0 < 0 || mask_heads < heads || h0 < 0 || h0 + heads > mask_heads)
    return (int)cudaErrorInvalidValue;
  const enc::Dropout drop{seed, threshold, inv_keep, b0, mask_heads, h0};
  switch (dtype) {
    case 0:
      return (int)launch<float>(qkv, out, probs, batch, seq, heads, drop,
                                dropout, st);
    case 1:
      return (int)launch<__nv_bfloat16>(qkv, out, probs, batch, seq, heads,
                                        drop, dropout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Interface 2 takes the mask's global offsets (b0, mask_heads, h0) after
// the dropout flag; interface 1 had none.
extern "C" int arsvt_attention_version() { return 2; }
