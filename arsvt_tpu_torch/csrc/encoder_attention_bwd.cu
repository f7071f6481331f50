// Direct-layout encoder attention backward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_bwd_kernel_direct
// (called through _bwd_direct), with its dropout branch. For each batch
// item b and head h it reads the (S, 64) column blocks of q, k and v straight out of
// the packed (B, S, 3D) projection output, and of O and dO out of (B, S, D),
// and computes with the TPU kernel's rounding points:
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
// tensor-core time, so it is memory-bound.
//
// Design (a first, simple one on the CUDA cores; tensor cores are later
// work). The sums over query rows (dk, dv) and over keys (dq) are kept
// deterministic with no atomics: two kernels, each rebuilding p from lse.
//   1. attn_bwd_dq_kernel, one block of 128 threads per (tile of 32 query
//      rows, head, batch item): stages q, dO and O of its rows, computes
//      delta (which it also writes to a (B, H, S) fp32 scratch), then walks
//      the keys in chunks of 64, forming s, p, dP and dS for its 32 x 64
//      tile and accumulating dS.to(T) k.
//   2. attn_bwd_dkdv_kernel, one block per (tile of 32 keys, head, batch
//      item): stages k and v of its keys, walks the queries in chunks of 64
//      (q, dO, lse and delta from kernel 1), forms the transposed tile of
//      s, p, dP and dS and accumulates p.to(T)^T dO and dS.to(T)^T q.
// Both kernels run on the same stream, so kernel 2 reads the delta that
// kernel 1 wrote. The same sequential FMA order over the 64 head dims gives
// bit-identical s (and so p) in both. Rows and keys past S (197 is not a
// multiple of 32 or 64) are staged as zeros, given p = dS = 0, and not
// stored. Each thread holds a 4x4 tile of the 32 x 64 score tile (rows
// rg*4+i, columns lg+16j) and 4x4 tiles of its outputs (rows rg*4+i, dims
// lg*4+j); row sums reduce across the 16 threads of a half-warp with
// shuffles.
//
// C interface: arsvt_encoder_attention_bwd launches both kernels on the
// given stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "encoder_tile.cuh"

namespace {

using namespace enc;

constexpr int kRows = kTile;   // rows a block owns: queries (dq) or keys (dk/dv)
constexpr int kCols = kChunk;  // rows of the other side per shared-memory chunk
constexpr size_t kDqSmemBytes =
    sizeof(float) * (2 * kRows * kStride + 2 * kCols * kStride +
                     kRows * kStride);
constexpr size_t kDkvSmemBytes =
    sizeof(float) * (2 * kRows * kStride + 2 * kCols * kStride +
                     2 * kRows * kStride + 2 * kCols);

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ out,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse, T* __restrict__ dq,
                       float* __restrict__ delta_out, int seq, int heads,
                       float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kRows * kStride;
  float* Ks = dOs + kRows * kStride;
  float* Vs = Ks + kCols * kStride;
  float* DSs = Vs + kCols * kStride;

  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * heads + h);
  const int d_model = heads * kHeadDim;
  const int64_t qkv_stride = 3 * (int64_t)d_model;
  const T* base = qkv + (int64_t)b * seq * qkv_stride;
  const T* q_base = base + h * kHeadDim;
  const T* k_base = base + d_model + h * kHeadDim;
  const T* v_base = base + 2 * d_model + h * kHeadDim;
  const int64_t o_off = (int64_t)b * seq * d_model + h * kHeadDim;
  const int64_t stat_off = ((int64_t)b * heads + h) * seq;

  const int rg = threadIdx.x / 16;  // rows rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // keys lg+16j; output dims lg*4+j

  stage(q_base, row0, kRows, seq, qkv_stride, Qs);
  stage(dout + o_off, row0, kRows, seq, d_model, dOs);
  stage(out + o_off, row0, kRows, seq, d_model, Ks);  // O, before any K
  __syncthreads();

  // delta = rowsum(O * dO) in fp32
  float delta[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 o = *reinterpret_cast<const float4*>(Ks + (rg * 4 + i) * kStride + lg * 4);
    const float4 g = *reinterpret_cast<const float4*>(dOs + (rg * 4 + i) * kStride + lg * 4);
    delta[i] = o.x * g.x + o.y * g.y + o.z * g.z + o.w * g.w;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], off);
    const int row = row0 + rg * 4 + i;
    lrow[i] = row < seq ? lse[stat_off + row] : 0.f;
    if (lg == 0 && row < seq) delta_out[stat_off + row] = delta[i];
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kCols) {
    __syncthreads();  // the previous chunk (and O) has been read
    stage(k_base, k0, kCols, seq, qkv_stride, Ks);
    stage(v_base, k0, kCols, seq, qkv_stride, Vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile(Qs, Ks, rg, lg, scale, s);
    dot_tile(dOs, Vs, rg, lg, 1.f, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds = 0.f;
        const int key = k0 + lg + 16 * j;
        if (key < seq) {
          const float p = expf(s[i][j] - lrow[i]);
          float dpv = dp[i][j];
          if constexpr (kDrop)
            dpv = keeps(drop, bh, row0 + rg * 4 + i, key) ? dpv * drop.inv_keep
                                                           : 0.f;
          ds = p * (dpv - delta[i]);
        }
        DSs[(rg * 4 + i) * kStride + lg + 16 * j] = round_to(ds, T());
      }
    __syncthreads();
    accumulate(DSs, Ks, rg, lg, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + rg * 4 + i;
    if (row >= seq) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = acc[i][j] * scale;
    store4(dq + o_off + (int64_t)row * d_model + lg * 4, o);
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const T* __restrict__ qkv,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int seq,
                         int heads, float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kRows * kStride;
  float* Qs = Vs + kRows * kStride;
  float* dOs = Qs + kCols * kStride;
  float* Ps = dOs + kCols * kStride;
  float* DSs = Ps + kRows * kStride;
  float* Ls = DSs + kRows * kStride;
  float* Ds = Ls + kCols;

  const int key0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * heads + h);
  const int d_model = heads * kHeadDim;
  const int64_t qkv_stride = 3 * (int64_t)d_model;
  const T* base = qkv + (int64_t)b * seq * qkv_stride;
  const T* q_base = base + h * kHeadDim;
  const T* k_base = base + d_model + h * kHeadDim;
  const T* v_base = base + 2 * d_model + h * kHeadDim;
  const int64_t o_off = (int64_t)b * seq * d_model + h * kHeadDim;
  const int64_t stat_off = ((int64_t)b * heads + h) * seq;

  const int rg = threadIdx.x / 16;  // keys rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // queries lg+16j; output dims lg*4+j

  stage(k_base, key0, kRows, seq, qkv_stride, Ks);
  stage(v_base, key0, kRows, seq, qkv_stride, Vs);

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kCols) {
    __syncthreads();  // the previous chunk has been read
    stage(q_base, q0, kCols, seq, qkv_stride, Qs);
    stage(dout + o_off, q0, kCols, seq, d_model, dOs);
    for (int t = threadIdx.x; t < kCols; t += kThreads) {
      const bool valid = q0 + t < seq;
      Ls[t] = valid ? lse[stat_off + q0 + t] : 0.f;
      Ds[t] = valid ? delta[stat_off + q0 + t] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile(Ks, Qs, rg, lg, scale, s);   // s^T: keys x queries
    dot_tile(Vs, dOs, rg, lg, 1.f, dp);   // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lg + 16 * j;
        float p_v = 0.f, ds = 0.f;
        if (q0 + c < seq) {
          const float p = expf(s[i][j] - Ls[c]);
          float dpv = dp[i][j];
          p_v = p;
          if constexpr (kDrop) {
            const bool keep = keeps(drop, bh, q0 + c, key0 + rg * 4 + i);
            dpv = keep ? dpv * drop.inv_keep : 0.f;
            p_v = keep ? p * drop.inv_keep : 0.f;
          }
          ds = p * (dpv - Ds[c]);
        }
        Ps[(rg * 4 + i) * kStride + c] = round_to(p_v, T());
        DSs[(rg * 4 + i) * kStride + c] = round_to(ds, T());
      }
    __syncthreads();
    accumulate(Ps, dOs, rg, lg, dv_acc);
    accumulate(DSs, Qs, rg, lg, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + rg * 4 + i;
    if (key >= seq) continue;
    float k_out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) k_out[j] = dk_acc[i][j] * scale;
    const int64_t at = o_off + (int64_t)key * d_model + lg * 4;
    store4(dk + at, k_out);
    store4(dv + at, dv_acc[i]);
  }
}

template <typename T, bool kDrop>
cudaError_t launch(const void* qkv, const void* out, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                   int batch, int seq, int heads, Dropout drop,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  attn_bwd_dq_kernel<T, kDrop><<<grid, kThreads, kDqSmemBytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), seq, heads, scale,
      drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, kDrop><<<grid, kThreads, kDkvSmemBytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), seq, heads, scale, drop);
  return cudaGetLastError();
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
        return launch<float, kDrop>(qkv, out, dout, lse, delta, dq, dk, dv,
                                    batch, seq, heads, drop, st);
      case 1:
        return launch<__nv_bfloat16, kDrop>(qkv, out, dout, lse, delta, dq,
                                            dk, dv, batch, seq, heads, drop,
                                            st);
      default:
        return cudaErrorInvalidValue;
    }
  });
}
