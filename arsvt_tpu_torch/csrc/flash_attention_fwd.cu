// Head-major attention forward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_fwd_kernel (called
// through _fwd). For each batch item b and head h it reads q (Sq, d) and
// k, v (Sk, d) from contiguous (B, H, S, d) tensors and computes with the
// TPU kernel's arithmetic order:
//   s = q k^T * scale (fp32); s[:, c] = MASK_VALUE for kv_len <= c < Sk,
//   m = rowmax(s), p = exp(s - m), l = rowsum(p),
//   O = (p.to(T) v) / l accumulated in fp32, lse = m + log(l).
// MASK_VALUE is -0.7 * float32 max, as the TPU kernel's (not -inf). The
// unnormalised p is rounded to the input type T before the product, and
// the division by l comes after it. O is written as (B, H, Sq, d) in T,
// lse as (B, H, 1, Sq) fp32 (the layout the backward reads).
//
// Dropout (rate > 0, _fwd_kernel's dropout branch): p stays unnormalised;
// a dropped p becomes 0 and a kept one is multiplied by 1/keep before the
// rounding to T and the p v product; l and lse are the values before
// dropout. Keep iff philox_bits(seed, b*H + h, row, col) < threshold
// (philox.cuh), so the backward kernels and the plain version rebuild the
// same mask. The rate-0 kernel is a separate instantiation without it.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the kernel reads
// q, k and v once and writes O and lse once, and does 4*B*H*Sq*Sk*d FLOPs.
// At the detector's shapes (B=1, bf16) that is 653 KB and 0.13 GFLOP for
// the DeiT-400 encoder (H=25, S=198, d=16), 322 KB for its DETR
// cross-attention (H=8, Sq=5, Sk=196, d=50) and 912 KB for the ViT-B
// detector's (Sq=100, d=96): every one is memory-bound at 0.1-0.3 us,
// far below the few microseconds of a launch, so the path is bound by
// launches and the host that dispatches them, not by this kernel's inner
// loop.
//
// Design (a first, simple one; tensor cores are later work): one block of
// 128 threads per (tile of 32 query rows, head, batch item). The q tile
// and chunks of 64 keys of K and V are staged in shared memory as fp32,
// zero-padded to a head dim Dp = d rounded up to 4, so that the inner
// loops read float4s. The staging copy reads element by element, eight
// loads in flight per thread: a head's slab is contiguous in this layout,
// so neighbouring threads read neighbouring elements (coalesced), and any
// d from 1 to 128 works, 50 and 96 included, whose rows are not 16-byte
// aligned. Two passes over the keys keep the arithmetic order above
// exactly for any Sk: the first finds the row max, the second recomputes
// s, forms p = exp(s - m), sums l in fp32, rounds p to T and accumulates
// p v in fp32. Rows and keys past Sq and Sk are masked: staged as zeros,
// keys given p = 0 and left out of the max, rows not stored. Each thread
// holds a 4x4 tile of scores (rows rg*4+i, keys lg+16j) and the output of
// rows rg*4+i at dims 64c+4lg+j; row statistics are reduced across the 16
// threads of a half-warp with shuffles. At B=1 the grid is small (8
// blocks for the cross-attention, 175 for the encoder on 132 SMs), so one
// block's serial walk over the keys, and the memory latency of its
// staging copies, set the kernel's time rather than bytes or FLOPs.
//
// C interface: arsvt_flash_attention_fwd launches on the given stream,
// allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kRows = 32;     // query rows per block
constexpr int kKeys = 64;     // keys per shared-memory chunk
constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kPStride = kKeys + 4;
// -0.7 * float32 max, rounded once to fp32 as JAX rounds its MASK_VALUE
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

static_assert(kThreads == (kRows / 4) * 16, "4x4 tiles over 16 lanes");
static_assert(kKeys == 4 * 16, "tile widths");

// Shared-memory layout for head dims up to kMaxD (64 or 128).
template <int kMaxD>
struct Layout {
  static constexpr int kQkStride = kMaxD + 4;  // 16-byte aligned rows,
                                               // conflict-free float4 reads
  static constexpr int kVStride = kMaxD;
  static constexpr int kDimGroups = kMaxD / 64;  // float4 output groups/lane
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kRows * kQkStride + kKeys * kQkStride +
                       kKeys * kVStride + kRows * kPStride);
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Stage rows [row0, row0 + rows) of a contiguous (seq, d) slab into shared
// memory as fp32 with `dst_stride` floats a row; columns d .. dp-1 and rows
// at or past `seq` become zeros. Each thread starts kStageLoads loads
// before it stores any, so that many are in flight at once: with one
// load per store the copy waits out a full memory latency per element.
constexpr int kStageLoads = 8;

template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ slab, int row0,
                                      int rows, int seq, int d, int dp,
                                      float* dst, int dst_stride) {
  const int n = rows * dp;
  for (int base = threadIdx.x; base < n; base += kThreads * kStageLoads) {
    float vals[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / dp;
      const int c = idx - r * dp;
      const int row = row0 + r;
      vals[u] = (idx < n && row < seq && c < d)
                    ? to_float(slab[(int64_t)row * d + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / dp;
      if (idx < n) dst[r * dst_stride + idx - r * dp] = vals[u];
    }
  }
}

// s[i][j] = scale * <q row rg*4+i, k row lg+16j> over the dp staged dims.
template <int kStride>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       int rg, int lg, int dp, float scale,
                                       float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int dd = 0; dd < dp; dd += 4) {
    float4 q[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * kStride + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[j] = *reinterpret_cast<const float4*>(Ks + (lg + 16 * j) * kStride + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
        s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
        s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
        s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= scale;
}

template <typename T, int kMaxD, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ out,
                               float* __restrict__ lse, int heads, int sq,
                               int sk, int kv_len, int d, float scale,
                               uint32_t seed, uint32_t threshold,
                               float inv_keep) {
  using L = Layout<kMaxD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * L::kQkStride;
  float* Vs = Ks + kKeys * L::kQkStride;
  float* Ps = Vs + kKeys * L::kVStride;

  const int row0 = blockIdx.x * kRows;
  const int64_t bh = (int64_t)blockIdx.z * heads + blockIdx.y;
  const T* q_slab = q + bh * sq * d;
  const T* k_slab = k + bh * sk * d;
  const T* v_slab = v + bh * sk * d;
  const int dp = (d + 3) & ~3;

  const int rg = threadIdx.x / 16;  // rows rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // keys lg+16j; output dims 64c+4lg+j

  stage(q_slab, row0, kRows, sq, d, dp, Qs, L::kQkStride);

  // pass 1: row max over the Sk keys (masked ones at MASK_VALUE)
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < sk; k0 += kKeys) {
    __syncthreads();  // the previous chunk has been read
    stage(k_slab, k0, kKeys, sk, d, dp, Ks, L::kQkStride);
    __syncthreads();
    float s[4][4];
    scores<L::kQkStride>(Qs, Ks, rg, lg, dp, scale, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + lg + 16 * j;
      if (col < sk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m[i] = fmaxf(m[i], col < kv_len ? s[i][j] : kMaskValue);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));

  // pass 2: p = exp(s - m), l = rowsum(p), acc = p.to(T) v
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][4 * L::kDimGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * L::kDimGroups; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kKeys) {
    __syncthreads();
    stage(k_slab, k0, kKeys, sk, d, dp, Ks, L::kQkStride);
    stage(v_slab, k0, kKeys, sk, d, dp, Vs, L::kVStride);
    __syncthreads();
    float s[4][4];
    scores<L::kQkStride>(Qs, Ks, rg, lg, dp, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + lg + 16 * j;
        const float sij = col < kv_len ? s[i][j] : kMaskValue;
        const float p = col < sk ? expf(sij - m[i]) : 0.f;
        l[i] += p;
        float p_use = p;
        if constexpr (kDropout) {
          const bool keep = philox_bits(seed, (uint32_t)bh,
                                        (uint32_t)(row0 + rg * 4 + i),
                                        (uint32_t)col) < threshold;
          p_use = keep ? p * inv_keep : 0.f;
        }
        Ps[(rg * 4 + i) * kPStride + lg + 16 * j] = round_to(p_use, T());
      }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < L::kDimGroups; ++c) {
      const int dim0 = 64 * c + 4 * lg;
      if (dim0 >= dp) continue;  // past the staged head dims
      for (int kk = 0; kk < kKeys; kk += 4) {
        float4 p4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p4[i] = *reinterpret_cast<const float4*>(Ps + (rg * 4 + i) * kPStride + kk);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (kk + t) * L::kVStride + dim0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y
                          : t == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

  // O rows of d elements are not 16-byte aligned for every d (50, 96 in
  // bf16), so the store is element by element
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + rg * 4 + i;
    if (row >= sq) continue;
    T* out_row = out + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < L::kDimGroups; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dim = 64 * c + 4 * lg + j;
        if (dim < d) store(out_row + dim, acc[i][4 * c + j] / l[i]);
      }
    if (lg == 0) lse[bh * sq + row] = m[i] + logf(l[i]);
  }
}

struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
  bool on;
};

template <typename T, int kMaxD, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int heads, int sq, int sk,
                   int kv_len, int d, float scale, Dropout drop,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<kMaxD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, kMaxD, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  flash_attention_fwd_kernel<T, kMaxD, kDropout>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), heads, sq, sk, kv_len, d, scale,
          drop.seed, drop.threshold, drop.inv_keep);
  return cudaGetLastError();
}

template <typename T, int kMaxD>
cudaError_t launch_for_dropout(const void* q, const void* k, const void* v,
                               void* out, void* lse, int batch, int heads,
                               int sq, int sk, int kv_len, int d,
                               float scale, Dropout drop,
                               cudaStream_t stream) {
  if (drop.on)
    return launch<T, kMaxD, true>(q, k, v, out, lse, batch, heads, sq, sk,
                                  kv_len, d, scale, drop, stream);
  return launch<T, kMaxD, false>(q, k, v, out, lse, batch, heads, sq, sk,
                                 kv_len, d, scale, drop, stream);
}

template <typename T>
cudaError_t launch_for_dim(const void* q, const void* k, const void* v,
                           void* out, void* lse, int batch, int heads,
                           int sq, int sk, int kv_len, int d, float scale,
                           Dropout drop, cudaStream_t stream) {
  // 51,200 B of shared memory for d <= 64, 92,160 B up to 128
  if (d <= 64)
    return launch_for_dropout<T, 64>(q, k, v, out, lse, batch, heads, sq, sk,
                                     kv_len, d, scale, drop, stream);
  return launch_for_dropout<T, kMaxHeadDim>(q, k, v, out, lse, batch, heads,
                                            sq, sk, kv_len, d, scale, drop,
                                            stream);
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
                                         int dropout, int dtype,
                                         void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || sq < 1 ||
      sk < 1 || kv_len < 1 || kv_len > sk || head_dim < 1 ||
      head_dim > kMaxHeadDim || (dropout != 0 && dropout != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, inv_keep, dropout == 1};
  switch (dtype) {
    case 0:
      return (int)launch_for_dim<float>(q, k, v, out, lse, batch, heads, sq,
                                        sk, kv_len, head_dim, scale, drop,
                                        st);
    case 1:
      return (int)launch_for_dim<__nv_bfloat16>(q, k, v, out, lse, batch,
                                                heads, sq, sk, kv_len,
                                                head_dim, scale, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
