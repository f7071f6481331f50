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
// is philox_bits(seed, b*H + h, row, col) < threshold (philox.cuh), the
// one the forward kernel drew.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the call reads q, k,
// v, O, dO and lse once and writes dq, dk, dv once. At the detector's
// training shapes in bf16 (B=32) that is 41.2 MB for the DeiT-400 encoder
// (H=25, S=198, d=16), 12.3 us, against 10*B*H*Sq*Sk*d = 5.0 GFLOP, 5 us of
// tensor-core time; 20.6 MB for the DETR cross-attention (H=8, Sq=5,
// Sk=196, d=50), 6.1 us. Both are memory-bound.
//
// Design (a first, simple one on the CUDA cores, as the direct-layout
// backward; tensor cores are later work). The sums over query rows (dk, dv)
// and over keys (dq) stay deterministic with no atomics: two kernels, each
// rebuilding p from lse.
//   1. flash_bwd_dq_kernel, one block of 128 threads per (tile of 32 query
//      rows, head, batch item): stages q, dO and O of its rows, computes
//      delta (also written to a (B, H, Sq) fp32 scratch), then walks the
//      keys in chunks of 64, forming s, p, dP and dS for its 32 x 64 tile
//      and accumulating dS.to(T) k.
//   2. flash_bwd_dkdv_kernel, one block per (tile of 32 keys, head, batch
//      item): stages k and v of its keys, walks the queries in chunks of 64
//      (q, dO, lse and delta from kernel 1), forms the transposed tile of
//      s, p, dP, p_v and dS, and accumulates p_v.to(T)^T dO and
//      dS.to(T)^T q.
// Both run on the same stream, so kernel 2 reads the delta kernel 1 wrote.
// Tiles are staged in shared memory as fp32, zero-padded to a head dim
// Dp = d rounded up to 4 (element-wise loads, as the forward kernel: rows
// of 50 bf16 are not 16-byte aligned), so the inner loops read float4s.
// Rows and keys past Sq and Sk are staged as zeros, given p = dS = 0 and
// not stored. Each thread holds a 4x4 tile of scores (rows rg*4+i, columns
// lg+16j) and its outputs at rows rg*4+i, dims 64c+4lg+j; row sums reduce
// across the 16 threads of a half-warp with shuffles. For the DETR
// cross-attention (Sq = 5) kernel 2 walks a single, mostly empty chunk of
// 64 queries, and kernel 1 one 32-row tile that walks all 196 keys.
//
// C interface: arsvt_flash_attention_bwd launches both kernels on the
// given stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kRows = 32;     // rows a block owns: queries (dq) or keys (dk/dv)
constexpr int kCols = 64;     // rows of the other side per shared-memory chunk
constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kPStride = kCols + 4;
// -0.7 * float32 max, rounded once to fp32 as JAX rounds its MASK_VALUE
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr int kStageLoads = 8;

static_assert(kThreads == (kRows / 4) * 16, "4x4 tiles over 16 lanes");
static_assert(kCols == 4 * 16, "tile widths");

template <int kMaxD>
struct Layout {
  static constexpr int kStride = kMaxD + 4;  // 16-byte aligned rows
  static constexpr int kDimGroups = kMaxD / 64;
  static constexpr size_t kDqSmemBytes =
      sizeof(float) * (2 * kRows * kStride + 2 * kCols * kStride +
                       kRows * kPStride);
  static constexpr size_t kDkvSmemBytes =
      sizeof(float) * (2 * kRows * kStride + 2 * kCols * kStride +
                       2 * kRows * kPStride + 2 * kCols);
};

struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
  bool on;
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
// at or past `seq` become zeros. kStageLoads loads in flight per thread.
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

// out[i][j] = scale * <A row rg*4+i, B row lg+16j> over the dp staged dims,
// summed by sequential FMAs in dim order.
template <int kStride>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int rg, int lg, int dp, float scale,
                                         float out[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  for (int dd = 0; dd < dp; dd += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg * 4 + i) * kStride + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (lg + 16 * j) * kStride + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i][j] = fmaf(a[i].x, b[j].x, out[i][j]);
        out[i][j] = fmaf(a[i].y, b[j].y, out[i][j]);
        out[i][j] = fmaf(a[i].z, b[j].z, out[i][j]);
        out[i][j] = fmaf(a[i].w, b[j].w, out[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] *= scale;
}

// acc[i][4c+j] += sum over t < kCols of L[rg*4+i][t] * R[t][64c+4lg+j]; L
// has row stride kPStride, R row stride kStride; dims at or past dp are
// skipped (they stay 0).
template <int kMaxD>
__device__ __forceinline__ void accumulate(const float* L, const float* R,
                                           int rg, int lg, int dp,
                                           float acc[4][4 * (kMaxD / 64)]) {
  using Lay = Layout<kMaxD>;
#pragma unroll
  for (int c = 0; c < Lay::kDimGroups; ++c) {
    const int dim0 = 64 * c + 4 * lg;
    if (dim0 >= dp) continue;
    for (int t0 = 0; t0 < kCols; t0 += 4) {
      float4 l4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        l4[i] = *reinterpret_cast<const float4*>(L + (rg * 4 + i) * kPStride + t0);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 r = *reinterpret_cast<const float4*>(
            R + (t0 + t) * Lay::kStride + dim0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float l = t == 0 ? l4[i].x : t == 1 ? l4[i].y
                        : t == 2 ? l4[i].z : l4[i].w;
          acc[i][4 * c + 0] = fmaf(l, r.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(l, r.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(l, r.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(l, r.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// Write rows rg*4+i of a (rows, d) tile: acc * scale, element by element
// (rows of d elements are not 16-byte aligned for every d).
template <typename T, int kMaxD>
__device__ __forceinline__ void store_rows(T* slab, int row0, int seq, int d,
                                           int rg, int lg, float scale,
                                           const float acc[4][4 * (kMaxD / 64)]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + rg * 4 + i;
    if (row >= seq) continue;
    T* dst = slab + (int64_t)row * d;
#pragma unroll
    for (int c = 0; c < kMaxD / 64; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dim = 64 * c + 4 * lg + j;
        if (dim < d) store(dst + dim, acc[i][4 * c + j] * scale);
      }
  }
}

template <typename T, int kMaxD, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        float* __restrict__ delta_out, int heads, int sq,
                        int sk, int kv_len, int d, float scale,
                        uint32_t seed, uint32_t threshold, float inv_keep) {
  using Lay = Layout<kMaxD>;
  constexpr int S = Lay::kStride;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kRows * S;
  float* Ks = dOs + kRows * S;
  float* Vs = Ks + kCols * S;
  float* DSs = Vs + kCols * S;

  const int row0 = blockIdx.x * kRows;
  const int64_t bh = (int64_t)blockIdx.z * heads + blockIdx.y;
  const int64_t q_off = bh * sq * d;
  const T* k_slab = k + bh * sk * d;
  const T* v_slab = v + bh * sk * d;
  const int dp = (d + 3) & ~3;
  const int rg = threadIdx.x / 16;  // rows rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // keys lg+16j; output dims 64c+4lg+j

  stage(q + q_off, row0, kRows, sq, d, dp, Qs, S);
  stage(dout + q_off, row0, kRows, sq, d, dp, dOs, S);
  stage(o + q_off, row0, kRows, sq, d, dp, Ks, S);  // O, before any K
  __syncthreads();

  // delta = rowsum(O * dO) in fp32
  float delta[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    delta[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Lay::kDimGroups; ++c) {
      const int dim0 = 64 * c + 4 * lg;
      if (dim0 >= dp) continue;
      const float4 ov = *reinterpret_cast<const float4*>(Ks + (rg * 4 + i) * S + dim0);
      const float4 gv = *reinterpret_cast<const float4*>(dOs + (rg * 4 + i) * S + dim0);
      delta[i] += ov.x * gv.x + ov.y * gv.y + ov.z * gv.z + ov.w * gv.w;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], off);
    const int row = row0 + rg * 4 + i;
    lrow[i] = row < sq ? lse[bh * sq + row] : 0.f;
    if (lg == 0 && row < sq) delta_out[bh * sq + row] = delta[i];
  }

  float acc[4][4 * Lay::kDimGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * Lay::kDimGroups; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kCols) {
    __syncthreads();  // the previous chunk (and O) has been read
    stage(k_slab, k0, kCols, sk, d, dp, Ks, S);
    stage(v_slab, k0, kCols, sk, d, dp, Vs, S);
    __syncthreads();
    float s[4][4], dpv[4][4];
    dot_tile<S>(Qs, Ks, rg, lg, dp, scale, s);
    dot_tile<S>(dOs, Vs, rg, lg, dp, 1.f, dpv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + lg + 16 * j;
        float ds = 0.f;
        if (col < sk) {
          const float sij = col < kv_len ? s[i][j] : kMaskValue;
          const float p = expf(sij - lrow[i]);
          float dpij = dpv[i][j];
          if constexpr (kDropout) {
            const bool keep = philox_bits(seed, (uint32_t)bh,
                                          (uint32_t)(row0 + rg * 4 + i),
                                          (uint32_t)col) < threshold;
            dpij = keep ? dpij * inv_keep : 0.f;
          }
          ds = p * (dpij - delta[i]);
        }
        DSs[(rg * 4 + i) * kPStride + lg + 16 * j] = round_to(ds, T());
      }
    __syncthreads();
    accumulate<kMaxD>(DSs, Ks, rg, lg, dp, acc);
  }
  store_rows<T, kMaxD>(dq + q_off, row0, sq, d, rg, lg, scale, acc);
}

template <typename T, int kMaxD, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int heads,
                          int sq, int sk, int kv_len, int d, float scale,
                          uint32_t seed, uint32_t threshold,
                          float inv_keep) {
  using Lay = Layout<kMaxD>;
  constexpr int S = Lay::kStride;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kRows * S;
  float* Qs = Vs + kRows * S;
  float* dOs = Qs + kCols * S;
  float* Ps = dOs + kCols * S;
  float* DSs = Ps + kRows * kPStride;
  float* Ls = DSs + kRows * kPStride;
  float* Ds = Ls + kCols;

  const int key0 = blockIdx.x * kRows;
  const int64_t bh = (int64_t)blockIdx.z * heads + blockIdx.y;
  const int64_t q_off = bh * sq * d;
  const int64_t k_off = bh * sk * d;
  const int dp = (d + 3) & ~3;
  const int rg = threadIdx.x / 16;  // keys rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // queries lg+16j; output dims 64c+4lg+j

  stage(k + k_off, key0, kRows, sk, d, dp, Ks, S);
  stage(v + k_off, key0, kRows, sk, d, dp, Vs, S);

  float dk_acc[4][4 * Lay::kDimGroups], dv_acc[4][4 * Lay::kDimGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * Lay::kDimGroups; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kCols) {
    __syncthreads();  // the previous chunk has been read
    stage(q + q_off, q0, kCols, sq, d, dp, Qs, S);
    stage(dout + q_off, q0, kCols, sq, d, dp, dOs, S);
    for (int t = threadIdx.x; t < kCols; t += kThreads) {
      const bool valid = q0 + t < sq;
      Ls[t] = valid ? lse[bh * sq + q0 + t] : 0.f;
      Ds[t] = valid ? delta[bh * sq + q0 + t] : 0.f;
    }
    __syncthreads();
    float s[4][4], dpv[4][4];
    dot_tile<S>(Ks, Qs, rg, lg, dp, scale, s);   // s^T: keys x queries
    dot_tile<S>(Vs, dOs, rg, lg, dp, 1.f, dpv);  // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lg + 16 * j;
        const int key = key0 + rg * 4 + i;
        float p_v = 0.f, ds = 0.f;
        if (q0 + c < sq && key < sk) {
          const float sij = key < kv_len ? s[i][j] : kMaskValue;
          const float p = expf(sij - Ls[c]);
          float dpij = dpv[i][j];
          p_v = p;
          if constexpr (kDropout) {
            const bool keep = philox_bits(seed, (uint32_t)bh,
                                          (uint32_t)(q0 + c),
                                          (uint32_t)key) < threshold;
            dpij = keep ? dpij * inv_keep : 0.f;
            p_v = keep ? p * inv_keep : 0.f;
          }
          ds = p * (dpij - Ds[c]);
        }
        Ps[(rg * 4 + i) * kPStride + c] = round_to(p_v, T());
        DSs[(rg * 4 + i) * kPStride + c] = round_to(ds, T());
      }
    __syncthreads();
    accumulate<kMaxD>(Ps, dOs, rg, lg, dp, dv_acc);
    accumulate<kMaxD>(DSs, Qs, rg, lg, dp, dk_acc);
  }
  store_rows<T, kMaxD>(dk + k_off, key0, sk, d, rg, lg, scale, dk_acc);
  store_rows<T, kMaxD>(dv + k_off, key0, sk, d, rg, lg, 1.f, dv_acc);
}

template <typename T, int kMaxD, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, int batch,
                   int heads, int sq, int sk, int kv_len, int d, float scale,
                   Dropout drop, cudaStream_t stream) {
  using Lay = Layout<kMaxD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, kMaxD, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::kDqSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, kMaxD, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((sq + kRows - 1) / kRows, heads, batch);
  flash_bwd_dq_kernel<T, kMaxD, kDropout>
      <<<grid_q, kThreads, Lay::kDqSmemBytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<T*>(dq), static_cast<float*>(delta), heads, sq, sk,
          kv_len, d, scale, drop.seed, drop.threshold, drop.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((sk + kRows - 1) / kRows, heads, batch);
  flash_bwd_dkdv_kernel<T, kMaxD, kDropout>
      <<<grid_k, kThreads, Lay::kDkvSmemBytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), heads, sq, sk, kv_len, d,
          scale, drop.seed, drop.threshold, drop.inv_keep);
  return cudaGetLastError();
}

template <typename T, int kMaxD>
cudaError_t launch_for_dropout(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int batch, int heads,
                               int sq, int sk, int kv_len, int d, float scale,
                               Dropout drop, cudaStream_t stream) {
  if (drop.on)
    return launch<T, kMaxD, true>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  batch, heads, sq, sk, kv_len, d, scale,
                                  drop, stream);
  return launch<T, kMaxD, false>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 batch, heads, sq, sk, kv_len, d, scale, drop,
                                 stream);
}

template <typename T>
cudaError_t launch_for_dim(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* delta, void* dq, void* dk, void* dv,
                           int batch, int heads, int sq, int sk, int kv_len,
                           int d, float scale, Dropout drop,
                           cudaStream_t stream) {
  // dq: 60,928 B of shared memory for d <= 64, 110,080 B up to 128;
  // dk/dv: 70,144 B and 119,296 B
  if (d <= 64)
    return launch_for_dropout<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                     batch, heads, sq, sk, kv_len, d, scale,
                                     drop, stream);
  return launch_for_dropout<T, kMaxHeadDim>(q, k, v, o, dout, lse, delta, dq,
                                            dk, dv, batch, heads, sq, sk,
                                            kv_len, d, scale, drop, stream);
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
                                         int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || sq < 1 ||
      sk < 1 || kv_len < 1 || kv_len > sk || head_dim < 1 ||
      head_dim > kMaxHeadDim || (dropout != 0 && dropout != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, inv_keep, dropout == 1};
  switch (dtype) {
    case 0:
      return (int)launch_for_dim<float>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, batch, heads, sq, sk, kv_len,
                                        head_dim, scale, drop, st);
    case 1:
      return (int)launch_for_dim<__nv_bfloat16>(q, k, v, o, dout, lse, delta,
                                                dq, dk, dv, batch, heads, sq,
                                                sk, kv_len, head_dim, scale,
                                                drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
