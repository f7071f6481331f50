// Head-major attention backward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_bwd_kernel (called
// through _bwd_call). For each batch item b and head h it reads q and O,
// dO (Sq, d), k and v (Sk, d) from contiguous (B, H, S, d) tensors and the
// forward's lse (B, H, 1, Sq) fp32, and computes with the TPU kernel's
// rounding points:
//   s = q k^T * scale (fp32); s[:, c] = MASK_VALUE for kv_len <= c < Sk,
//   p = exp(s - lse), delta = rowsum(O * dO) (fp32), dP = dO v^T (fp32),
//   under dropout dP = keep ? dP / keep_prob : 0 and p_v = keep ? p /
//   keep_prob : 0 (else p_v = p), dS = p * (dP - delta),
//   dq = (dS.to(T) k) * scale, dk = (dS.to(T)^T q) * scale,
//   dv = p_v.to(T)^T dO,
// every product summed in fp32 and cast to T at the end. The dropout mask
// is encoder_tile.cuh::keeps, the one the forward kernel drew.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the call reads q, k,
// v, O, dO and lse once and writes dq, dk, dv once. At the detector's
// training shapes in bf16 (B=32) that is 41.2 MB for the DeiT-400 encoder
// (H=25, S=198, d=16), 12.3 us, against 10*B*H*Sq*Sk*d = 5.0 GFLOP, 5 us of
// tensor-core time; 20.6 MB for the DETR cross-attention (H=8, Sq=5,
// Sk=196, d=50), 6.1 us. Both are memory-bound.
//
// Design (attention_bwd.cuh, on warp_tile.cuh's tiles): two kernels on one
// stream, no atomics. The dq kernel, one block of four warps per (64 query
// rows, head, batch item), computes delta (also written to a (B, H, Sq)
// fp32 scratch) and walks the keys in chunks of 64; the dk/dv kernel, one
// block per (64 keys, head, batch item), walks the queries. Every product
// runs on tensor-core mma.sync in bf16 with dS and P kept in registers;
// fp32 runs the same tiles on the CUDA cores. Any d from 1 to 128 is padded
// in shared memory to kDp, d rounded up to 16, 32, 64, 96 or 128 (one
// instantiation each). Rows whose bytes are a multiple of 16 (d = 16, 96,
// 128 in bf16) are staged by cp.async; others (d = 50: 100 bytes a row)
// element by element, many loads in flight. For the DETR cross-attention
// (Sq = 5) the dq kernel has one live warp a (b, h) walking the 196 keys,
// and the dk/dv kernel one live 16-query group in its single chunk. Past
// d = 128 (attention_wide.cuh) both kernels give each block one 64-column
// slice of its outputs: it accumulates S and dP (S^T, dP^T) over all of d
// a 64-deep slice at a time and delta over all of d, then writes its
// slice of dq (or of dk and dv); the slice-0 dq blocks write delta.
//
// C interface: arsvt_flash_attention_bwd launches both kernels on the
// given stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd.cuh"
#include "attention_wide.cuh"

namespace {

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, int batch,
                   int heads, int sq, int sk, int kv_len, int d, float scale,
                   enc::Dropout drop, int dropout, cudaStream_t stream) {
  const int64_t hq = (int64_t)sq * d, hk = (int64_t)sk * d;
  attn::BwdArgs<T> a{};
  a.q = {static_cast<const T*>(q), heads * hq, hq, d};
  a.k = {static_cast<const T*>(k), heads * hk, hk, d};
  a.v = {static_cast<const T*>(v), heads * hk, hk, d};
  a.o = {static_cast<const T*>(o), heads * hq, hq, d};
  a.dout = {static_cast<const T*>(dout), heads * hq, hq, d};
  a.dq = {static_cast<T*>(dq), heads * hq, hq, d};
  a.dk = {static_cast<T*>(dk), heads * hk, hk, d};
  a.dv = {static_cast<T*>(dv), heads * hk, hk, d};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.kv_len = kv_len;
  a.d = d;
  a.scale = scale;
  a.drop = drop;
  if (d <= 16) return attn::launch_bwd<T, 16>(a, batch, dropout, stream);
  if (d <= 32) return attn::launch_bwd<T, 32>(a, batch, dropout, stream);
  if (d <= 64) return attn::launch_bwd<T, 64>(a, batch, dropout, stream);
  if (d <= 96) return attn::launch_bwd<T, 96>(a, batch, dropout, stream);
  if (d <= 128) return attn::launch_bwd<T, 128>(a, batch, dropout, stream);
  return attn::launch_bwd_wide<T>(a, batch, dropout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers to
// contiguous tensors: q, o, dout and dq (batch, heads, sq, head_dim); k, v,
// dk and dv (batch, heads, sk, head_dim); lse (batch, heads, 1, sq) fp32;
// delta (batch, heads, sq) fp32 scratch written by the first kernel and
// read by the second. dropout 0 or 1, as the forward's.
extern "C" int arsvt_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk,
                                         void* dv, int batch, int heads,
                                         int sq, int sk, int kv_len,
                                         int head_dim, float scale,
                                         uint32_t seed, uint32_t threshold,
                                         float inv_keep, int dropout,
                                         int b0, int mask_heads, int h0,
                                         int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || sq < 1 ||
      sk < 1 || kv_len < 1 || kv_len > sk || head_dim < 1 ||
      (dropout != 0 && dropout != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b0 < 0 || mask_heads < heads || h0 < 0 || h0 + heads > mask_heads)
    return (int)cudaErrorInvalidValue;
  const enc::Dropout drop{seed, threshold, inv_keep, b0, mask_heads, h0};
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                batch, heads, sq, sk, kv_len, head_dim,
                                scale, drop, dropout, st);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, batch, heads, sq, sk, kv_len,
                                        head_dim, scale, drop, dropout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Interface 2 takes the mask's global offsets (b0, mask_heads, h0) after
// the dropout flag; interface 1 had none.
extern "C" int arsvt_attention_version() { return 2; }
