// Direct-layout encoder attention backward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_bwd_kernel_direct
// (called through _bwd_direct), with its dropout branch. For each batch
// item b and head h it reads the (S, 64) column blocks of q, k and v
// straight out of the packed (B, S, 3D) projection output, and of O and dO
// out of (B, S, D), and computes with the TPU kernel's rounding points:
//   s = q k^T * 64^-1/2 (fp32), p = exp(s - lse),
//   delta = rowsum(O * dO) (fp32), dP = dO v^T (fp32), dS = p * (dP - delta),
//   dq = (dS.to(T) k) * scale, dk = (dS.to(T)^T q) * scale, dv = p.to(T)^T dO,
// every product summed in fp32 and cast to T at the end. dq, dk and dv are
// written into columns h*64 of (B, S, D) outputs: no (B, S, 3D) cotangent
// and no transpose. With dropout (flash_attention.py:662-671) the forward's
// mask is replayed (encoder_tile.cuh::keeps) on dP and on the p that
// multiplies dO: dP = keep ? dP/keep_prob : 0, p_v = keep ? p/keep_prob : 0,
// dv = p_v.to(T)^T dO; delta = rowsum(O * dO) with the dropped-out O, and
// dS = p * (dP - delta) with the p before dropout.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the call reads qkv,
// O, dO and lse and writes dq, dk, dv: at ViT-B (S=197, D=768, H=12) and
// B=32 that is 77.8 MB, 23 us, against 10*B*H*S^2*d = 9.5 GFLOP, 9.6 us of
// tensor-core time, so it is memory-bound. The kernels compute seven
// S x S x 64 products a head (S and dP in the dq kernel; S^T, dP^T, dk and
// dv in the dk/dv kernel), 13.4 GFLOP at that shape, which the tensor cores
// do in 13.5 us.
//
// Design (attention_bwd.cuh, on warp_tile.cuh's tiles): two kernels on one
// stream, no atomics. The dq kernel, one block of four warps per (64 query
// rows, head, batch item), computes delta (also written to a (B, H, S)
// fp32 scratch) and walks the keys in chunks of 64 through a two-slot
// cp.async ring; the dk/dv kernel, one block per (64 keys, head, batch
// item), walks the queries. Every product runs on tensor-core mma.sync in
// bf16 with dS and P kept in registers; fp32 runs the same tiles on the
// CUDA cores.
//
// C interface: arsvt_encoder_attention_bwd launches both kernels on the
// given stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd.cuh"

namespace {

constexpr int kHeadDim = attn::kEncoderHeadDim;  // 64

template <typename T>
cudaError_t launch(const void* qkv, const void* out, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                   int batch, int seq, int heads, enc::Dropout drop,
                   int dropout, cudaStream_t stream) {
  const int64_t d_model = (int64_t)heads * kHeadDim, row = 3 * d_model;
  const T* base = static_cast<const T*>(qkv);
  attn::BwdArgs<T> a{};
  a.q = {base, seq * row, kHeadDim, row};
  a.k = {base + d_model, seq * row, kHeadDim, row};
  a.v = {base + 2 * d_model, seq * row, kHeadDim, row};
  a.o = {static_cast<const T*>(out), seq * d_model, kHeadDim, d_model};
  a.dout = {static_cast<const T*>(dout), seq * d_model, kHeadDim, d_model};
  a.dq = {static_cast<T*>(dq), seq * d_model, kHeadDim, d_model};
  a.dk = {static_cast<T*>(dk), seq * d_model, kHeadDim, d_model};
  a.dv = {static_cast<T*>(dv), seq * d_model, kHeadDim, d_model};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.heads = heads;
  a.sq = a.sk = a.kv_len = seq;
  a.d = kHeadDim;
  a.scale = 1.0f / sqrtf((float)kHeadDim);
  a.drop = drop;
  return attn::launch_bwd<T, kHeadDim>(a, batch, dropout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers, 16-byte
// aligned; qkv is a contiguous (batch, seq, 3 * heads * 64) tensor, out,
// dout, dq, dk and dv contiguous (batch, seq, heads * 64) tensors of the
// same type, lse and delta contiguous (batch, heads, seq) fp32 (delta is
// scratch written by the first kernel and read by the second). dropout,
// seed, threshold and inv_keep as the forward's.
extern "C" int arsvt_encoder_attention_bwd(const void* qkv, const void* out,
                                           const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk,
                                           void* dv, int batch, int seq,
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
      return (int)launch<float>(qkv, out, dout, lse, delta, dq, dk, dv,
                                batch, seq, heads, drop, dropout, st);
    case 1:
      return (int)launch<__nv_bfloat16>(qkv, out, dout, lse, delta, dq, dk,
                                        dv, batch, seq, heads, drop, dropout,
                                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Interface 2 takes the mask's global offsets (b0, mask_heads, h0) after
// the dropout flag; interface 1 had none.
extern "C" int arsvt_attention_version() { return 2; }
