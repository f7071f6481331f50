// Direct-layout encoder attention backward from the saved probabilities,
// for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_bwd_kernel_direct_savep
// (called through _bwd_direct_savep), with its dropout branch. For each
// batch item b and head h it reads the (S, 64) column blocks of q, k and v out of the
// packed (B, S, 3D) projection output, of dO out of (B, S, D), and the
// forward's normalised probabilities P (B, H, S, S) bf16, and computes with
// the TPU kernel's rounding points:
//   p = P (bf16 -> fp32), dP = dO v^T (fp32), delta = rowsum(dP * p),
//   dS = p * (dP - delta),
//   dq = (dS.to(T) k) * scale, dk = (dS.to(T)^T q) * scale, dv = p.to(T)^T dO,
// every product summed in fp32 and cast to T at the end. There is no q k^T,
// no exp, no lse and no O: delta = rowsum(dP * P) equals rowsum(dO * O).
// With dropout (flash_attention.py:836-846) the forward's mask
// (encoder_tile.cuh::keeps) is replayed on dP, dP = keep ? dP/keep_prob : 0,
// before delta = rowsum(dP * P) and dS = P (dP - delta), both with the saved
// P before dropout; dv = p_v.to(T)^T dO with p_v = keep ? P/keep_prob : 0.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the call reads qkv,
// P and dO and writes dq, dk and dv: at ViT-B (S=197, D=768, H=12) and B=32
// that is 29.0 + 29.8 + 9.7 + 29.0 MB, 29.1 us, against 8*B*H*S^2*d =
// 7.6 GFLOP (dP, dq, dk, dv), 7.7 us: memory-bound.
//
// Design (kernel #2's, on the CUDA cores; encoder_tile.cuh). The sums over
// query rows (dk, dv) and over keys (dq) stay deterministic with no atomics:
// two kernels.
//   1. savep_bwd_dq_kernel, one block of 128 threads per (tile of 32 query
//      rows, head, batch item): stages dO of its rows, walks the keys in
//      chunks of 64 once to sum delta = rowsum(dP * P) (also written to a
//      (B, H, S) fp32 scratch), then again forming dP and dS for its
//      32 x 64 tile and accumulating dS.to(T) k. The P tile is staged
//      element by element (a row of 197 bf16 is not 16-byte aligned),
//      consecutive threads on consecutive keys.
//   2. savep_bwd_dkdv_kernel, one block per (tile of 32 keys, head, batch
//      item): stages k and v of its keys, walks the queries in chunks of 64
//      (q, dO and delta from kernel 1, P transposed into keys x queries),
//      forms dP^T and dS^T and accumulates P^T dO and dS.to(T)^T q.
// Both kernels run on the same stream, so kernel 2 reads the delta that
// kernel 1 wrote. Rows and keys past S are staged as zeros (P included), so
// they give dS = 0, and are not stored.
//
// C interface: arsvt_encoder_attention_savep_bwd launches both kernels on
// the given stream, allocates nothing and returns cudaGetLastError() (or
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
    sizeof(float) * kStride * (kRows + 2 * kCols + 2 * kRows);
constexpr size_t kDkvSmemBytes =
    sizeof(float) * (kStride * (2 * kRows + 2 * kCols + 2 * kRows) + kCols);

// P[row0 + r][col0 + c] for r < kRows, c < kCols as fp32 into
// dst[r * kStride + c]; entries past S are zeros.
__device__ __forceinline__ void stage_probs(const __nv_bfloat16* p_head,
                                            int row0, int col0, int seq,
                                            float* dst) {
  for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx % kCols;
    const bool valid = row0 + r < seq && col0 + c < seq;
    dst[r * kStride + c] = valid ? __bfloat162float(
        p_head[(int64_t)(row0 + r) * seq + col0 + c]) : 0.f;
  }
}

// P[q0 + c][key0 + r] for r < kRows (keys), c < kCols (queries) as fp32
// into dst[r * kStride + c]: the transposed tile, read a query row at a
// time; entries past S are zeros.
__device__ __forceinline__ void stage_probs_t(const __nv_bfloat16* p_head,
                                              int q0, int key0, int seq,
                                              float* dst) {
  for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
    const int c = idx / kRows, r = idx % kRows;
    const bool valid = q0 + c < seq && key0 + r < seq;
    dst[r * kStride + c] = valid ? __bfloat162float(
        p_head[(int64_t)(q0 + c) * seq + key0 + r]) : 0.f;
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    savep_bwd_dq_kernel(const T* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ probs,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ delta_out, int seq, int heads,
                        float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* dOs = smem;
  float* Ks = dOs + kRows * kStride;
  float* Vs = Ks + kCols * kStride;
  float* Ps = Vs + kCols * kStride;
  float* DSs = Ps + kRows * kStride;

  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * heads + h);
  const int d_model = heads * kHeadDim;
  const int64_t qkv_stride = 3 * (int64_t)d_model;
  const T* base = qkv + (int64_t)b * seq * qkv_stride;
  const T* k_base = base + d_model + h * kHeadDim;
  const T* v_base = base + 2 * d_model + h * kHeadDim;
  const int64_t o_off = (int64_t)b * seq * d_model + h * kHeadDim;
  const int64_t stat_off = ((int64_t)b * heads + h) * seq;
  const __nv_bfloat16* p_head = probs + stat_off * seq;

  const int rg = threadIdx.x / 16;  // rows rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // keys lg+16j; output dims lg*4+j

  stage(dout + o_off, row0, kRows, seq, d_model, dOs);

  // dP where the mask keeps (scaled), else 0
  auto masked = [&](float dp, int i, int j, int k0) {
    if constexpr (kDrop)
      return keeps(drop, bh, row0 + rg * 4 + i, k0 + lg + 16 * j)
                 ? dp * drop.inv_keep
                 : 0.f;
    return dp;
  };

  // pass 1: delta = rowsum(dP * P) in fp32
  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < seq; k0 += kCols) {
    __syncthreads();  // the previous chunk has been read
    stage(v_base, k0, kCols, seq, qkv_stride, Vs);
    stage_probs(p_head, row0, k0, seq, Ps);
    __syncthreads();
    float dp[4][4];
    dot_tile(dOs, Vs, rg, lg, 1.f, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        delta[i] = fmaf(masked(dp[i][j], i, j, k0),
                        Ps[(rg * 4 + i) * kStride + lg + 16 * j], delta[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], off);
    const int row = row0 + rg * 4 + i;
    if (lg == 0 && row < seq) delta_out[stat_off + row] = delta[i];
  }

  // pass 2: dS = P (dP - delta), acc = dS.to(T) k
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kCols) {
    __syncthreads();
    stage(k_base, k0, kCols, seq, qkv_stride, Ks);
    stage(v_base, k0, kCols, seq, qkv_stride, Vs);
    stage_probs(p_head, row0, k0, seq, Ps);
    __syncthreads();
    float dp[4][4];
    dot_tile(dOs, Vs, rg, lg, 1.f, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (rg * 4 + i) * kStride + lg + 16 * j;
        DSs[at] = round_to(Ps[at] * (masked(dp[i][j], i, j, k0) - delta[i]),
                           T());
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
    savep_bwd_dkdv_kernel(const T* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ probs,
                          const T* __restrict__ dout,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int seq,
                          int heads, float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kRows * kStride;
  float* Qs = Vs + kRows * kStride;
  float* dOs = Qs + kCols * kStride;
  float* Ps = dOs + kCols * kStride;   // P^T: keys x queries
  float* DSs = Ps + kRows * kStride;
  float* Ds = DSs + kRows * kStride;

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
  const __nv_bfloat16* p_head = probs + stat_off * seq;

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
    stage_probs_t(p_head, q0, key0, seq, Ps);
    for (int t = threadIdx.x; t < kCols; t += kThreads)
      Ds[t] = q0 + t < seq ? delta[stat_off + q0 + t] : 0.f;
    __syncthreads();
    float dp[4][4];
    dot_tile(Vs, dOs, rg, lg, 1.f, dp);  // dP^T: keys x queries
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lg + 16 * j;
        const int at = (rg * 4 + i) * kStride + c;
        float dpv = dp[i][j];
        if constexpr (kDrop) {
          // this thread alone reads and writes entry `at` of P^T: dS takes
          // the saved P, dv the dropped-out p_v in its place
          const bool keep = keeps(drop, bh, q0 + c, key0 + rg * 4 + i);
          dpv = keep ? dpv * drop.inv_keep : 0.f;
          DSs[at] = round_to(Ps[at] * (dpv - Ds[c]), T());
          Ps[at] = round_to(keep ? Ps[at] * drop.inv_keep : 0.f, T());
        } else {
          DSs[at] = round_to(Ps[at] * (dpv - Ds[c]), T());
        }
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
cudaError_t launch(const void* qkv, const void* probs, const void* dout,
                   void* delta, void* dq, void* dk, void* dv, int batch,
                   int seq, int heads, Dropout drop, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      savep_bwd_dq_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      savep_bwd_dkdv_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const auto* p = static_cast<const __nv_bfloat16*>(probs);
  savep_bwd_dq_kernel<T, kDrop><<<grid, kThreads, kDqSmemBytes, stream>>>(
      static_cast<const T*>(qkv), p, static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(delta), seq, heads, scale,
      drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  savep_bwd_dkdv_kernel<T, kDrop><<<grid, kThreads, kDkvSmemBytes, stream>>>(
      static_cast<const T*>(qkv), p, static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), seq, heads, scale, drop);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers, 16-byte
// aligned; qkv is a contiguous (batch, seq, 3 * heads * 64) tensor, probs a
// contiguous (batch, heads, seq, seq) bfloat16 tensor, dout, dq, dk and dv
// contiguous (batch, seq, heads * 64) tensors of qkv's type, delta a
// contiguous (batch, heads, seq) fp32 scratch written by the first kernel
// and read by the second. dropout, seed, threshold and inv_keep as the
// forward's.
extern "C" int arsvt_encoder_attention_savep_bwd(
    const void* qkv, const void* probs, const void* dout, void* delta,
    void* dq, void* dk, void* dv, int batch, int seq, int heads,
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
        return launch<float, kDrop>(qkv, probs, dout, delta, dq, dk, dv,
                                    batch, seq, heads, drop, st);
      case 1:
        return launch<__nv_bfloat16, kDrop>(qkv, probs, dout, delta, dq, dk,
                                            dv, batch, seq, heads, drop, st);
      default:
        return cudaErrorInvalidValue;
    }
  });
}
