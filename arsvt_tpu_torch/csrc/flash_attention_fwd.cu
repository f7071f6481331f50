// Head-major attention forward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_fwd_kernel (called
// through _fwd). For each batch item b and head h it reads q (Sq, d) and
// k, v (Sk, d) from contiguous (B, H, S, d) tensors and computes with the
// TPU kernel's arithmetic order:
//   s = q k^T * scale (fp32); s[:, c] = MASK_VALUE for kv_len <= c < Sk,
//   m = rowmax(s), p = exp(s - m), l = rowsum(p),
//   O = (p.to(T) v) / l accumulated in fp32, lse = m + log(l).
// MASK_VALUE is -0.7 * float32 max, as the TPU kernel's (not -inf), and the
// masked columns take part in the max. The unnormalised p is rounded to the
// input type T before the product, and the division by l comes after it.
// O is written as (B, H, Sq, d) in T, lse as (B, H, 1, Sq) fp32 (the layout
// the backward reads).
//
// Dropout (rate > 0, _fwd_kernel's dropout branch): p stays unnormalised;
// a dropped p becomes 0 and a kept one is multiplied by 1/keep before the
// rounding to T and the p v product; l and lse are the values before
// dropout. Keep iff philox_bits(seed, (b0 + b)*H + h0 + h, row, col) < threshold
// (philox.cuh, through encoder_tile.cuh::keeps), so the backward kernels
// and the plain version rebuild the same mask. The rate-0 kernel is a
// separate instantiation without it.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the kernel reads
// q, k and v once and writes O and lse once, and does 4*B*H*Sq*Sk*d FLOPs.
// At the DeiT-400 encoder (H=25, S=198, d=16) and B=32 in bf16 that is
// 20.9 MB and 2.0 GFLOP: 6.24 us of memory against 2.0 us of tensor-core
// time; the DETR cross-attention (H=8, Sq=5, Sk=196, d=50) reads 10.3 MB
// at B=32. Every path shape is memory-bound, and at B=1 (0.1-0.3 us) the
// launch and one block's walk over the keys set the time.
//
// Design (attention_fwd.cuh, on warp_tile.cuh's tiles): one block of four
// warps per (64 query rows, head, batch item), 16 rows a warp with Q's
// fragments in registers; both products on tensor-core mma.sync in bf16,
// P kept in registers; fp32 runs the same tiles on the CUDA cores. Any d
// from 1 to 128 is padded in shared memory to kDp, d rounded up to 16, 32,
// 64, 96 or 128 (one instantiation each); the padded columns of q and k
// are zeros and the scale stays the caller's 1/sqrt(d). Rows whose bytes
// are a multiple of 16 (d = 16, 96, 128 in bf16) are staged by cp.async
// from the contiguous slab, one chunk of 64 keys in flight while the other
// is computed; others (d = 50 in bf16 is 100 bytes, odd d) element by
// element, 16 loads in flight a thread. Columns past Sk (tile padding) are
// staged as zeros, left out of the max and given p = 0. Past d = 128
// (attention_wide.cuh) each block owns 64 rows and one 64-column slice of
// O: it accumulates the scores over all of d a 64-deep slice at a time,
// then multiplies by its slice of V, so any d runs with the same
// arithmetic; the slice-0 block writes lse.
//
// C interface: arsvt_flash_attention_fwd launches on the given stream,
// allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "attention_wide.cuh"

namespace {

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int heads, int sq, int sk,
                   int kv_len, int d, float scale, enc::Dropout drop,
                   int dropout, cudaStream_t stream) {
  const int64_t hq = (int64_t)sq * d, hk = (int64_t)sk * d;
  attn::FwdArgs<T> a{};
  a.q = {static_cast<const T*>(q), heads * hq, hq, d};
  a.k = {static_cast<const T*>(k), heads * hk, hk, d};
  a.v = {static_cast<const T*>(v), heads * hk, hk, d};
  a.out = {static_cast<T*>(out), heads * hq, hq, d};
  a.lse = static_cast<float*>(lse);
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.kv_len = kv_len;
  a.d = d;
  a.scale = scale;
  a.drop = drop;
  if (d <= 16) return attn::launch_fwd<T, 16>(a, batch, dropout, stream);
  if (d <= 32) return attn::launch_fwd<T, 32>(a, batch, dropout, stream);
  if (d <= 64) return attn::launch_fwd<T, 64>(a, batch, dropout, stream);
  if (d <= 96) return attn::launch_fwd<T, 96>(a, batch, dropout, stream);
  if (d <= 128) return attn::launch_fwd<T, 128>(a, batch, dropout, stream);
  return attn::launch_fwd_wide<T>(a, batch, dropout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers to
// contiguous tensors: q (batch, heads, sq, head_dim), k and v (batch,
// heads, sk, head_dim); out like q, lse (batch, heads, 1, sq) fp32.
// dropout 0 or 1; with 1, keep iff philox_bits(seed, ...) < threshold and
// scale kept probabilities by inv_keep.
extern "C" int arsvt_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int batch, int heads, int sq, int sk,
                                         int kv_len, int head_dim,
                                         float scale, uint32_t seed,
                                         uint32_t threshold, float inv_keep,
                                         int dropout, int b0, int mask_heads,
                                         int h0, int dtype,
                                         void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || sq < 1 ||
      sk < 1 || kv_len < 1 || kv_len > sk || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b0 < 0 || mask_heads < heads || h0 < 0 || h0 + heads > mask_heads)
    return (int)cudaErrorInvalidValue;
  const enc::Dropout drop{seed, threshold, inv_keep, b0, mask_heads, h0};
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, out, lse, batch, heads, sq, sk,
                                kv_len, head_dim, scale, drop, dropout, st);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, out, lse, batch, heads, sq,
                                        sk, kv_len, head_dim, scale, drop,
                                        dropout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Interface 2 takes the mask's global offsets (b0, mask_heads, h0) after
// the dropout flag; interface 1 had none.
extern "C" int arsvt_attention_version() { return 2; }
