// Direct-layout encoder attention forward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_fwd_kernel_direct
// (called through _fwd_direct). For each batch item b and head h it reads
// the (S, 64) column blocks of q, k and v straight out of the packed
// (B, S, 3D) projection output, at columns h*64, D + h*64 and 2D + h*64,
// and computes with the TPU kernel's arithmetic order:
//   s = q k^T * 64^-1/2 (fp32), m = rowmax(s), p = exp(s - m), l = rowsum(p),
//   O = (p.to(T) v) / l accumulated in fp32, lse = m + log(l).
// The unnormalised p is rounded to the input type T before the product, and
// the division by l comes after it. O is written into columns h*64 of a
// (B, S, D) output and lse as (B, H, 1, S) fp32: no transpose either way.
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

namespace {

constexpr int kHeadDim = 64;
constexpr int kRows = 32;     // query rows per block
constexpr int kKeys = 64;     // keys per shared-memory chunk
constexpr int kThreads = 128;
constexpr int kQkStride = kHeadDim + 4;  // floats; 16-byte aligned rows,
                                         // conflict-free float4 reads
constexpr int kVStride = kHeadDim;
constexpr int kPStride = kKeys + 4;
constexpr size_t kSmemBytes =
    sizeof(float) * (kRows * kQkStride + kKeys * kQkStride +
                     kKeys * kVStride + kRows * kPStride);

static_assert(kThreads == (kRows / 4) * 16, "4x4 tiles over 16 lanes");
static_assert(kKeys == 4 * 16 && kHeadDim == 4 * 16, "tile widths");

template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int n = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float x, float) { return x; }

__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// Stage `rows` rows (starting at sequence row `row0`) of one head's 64
// columns into shared memory as fp32; rows at or past `seq` become zeros.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ head_base,
                                      int row0, int rows, int seq,
                                      int64_t row_stride, float* dst,
                                      int dst_stride) {
  constexpr int n = VecWidth<T>::n;
  constexpr int per_row = kHeadDim / n;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx % per_row) * n;
    float vals[n];
    if (row0 + r < seq) {
      load_vec(head_base + (int64_t)(row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < n; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < n; i += 4) store4(dst + r * dst_stride + c + i, vals + i);
  }
}

// s[i][j] = scale * <q row rg*4+i, k row lg+16j> over the 64 head dims.
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       int rg, int lg, float scale,
                                       float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < kHeadDim; dd += 4) {
    float4 q[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * kQkStride + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[j] = *reinterpret_cast<const float4*>(Ks + (lg + 16 * j) * kQkStride + dd);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    encoder_attention_fwd_kernel(const T* __restrict__ qkv,
                                 T* __restrict__ out, float* __restrict__ lse,
                                 int seq, int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * kQkStride;
  float* Vs = Ks + kKeys * kQkStride;
  float* Ps = Vs + kKeys * kVStride;

  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d_model = heads * kHeadDim;
  const int64_t row_stride = 3 * (int64_t)d_model;
  const T* base = qkv + (int64_t)b * seq * row_stride;
  const T* q_base = base + h * kHeadDim;
  const T* k_base = base + d_model + h * kHeadDim;
  const T* v_base = base + 2 * d_model + h * kHeadDim;

  const int rg = threadIdx.x / 16;  // rows rg*4 .. rg*4+3 of the tile
  const int lg = threadIdx.x % 16;  // keys lg+16j; output dims lg*4+j

  stage(q_base, row0, kRows, seq, row_stride, Qs, kQkStride);

  // pass 1: row max over all keys
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // the previous chunk has been read
    stage(k_base, k0, kKeys, seq, row_stride, Ks, kQkStride);
    __syncthreads();
    float s[4][4];
    scores(Qs, Ks, rg, lg, scale, s);
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
    stage(k_base, k0, kKeys, seq, row_stride, Ks, kQkStride);
    stage(v_base, k0, kKeys, seq, row_stride, Vs, kVStride);
    __syncthreads();
    float s[4][4];
    scores(Qs, Ks, rg, lg, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + lg + 16 * j < seq) ? expf(s[i][j] - m[i]) : 0.f;
        l[i] += p;
        Ps[(rg * 4 + i) * kPStride + lg + 16 * j] = round_to(p, T());
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (rg * 4 + i) * kPStride + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(Vs + (kk + t) * kVStride + lg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y : t == 2 ? p4[i].z : p4[i].w;
          acc[i][0] = fmaf(p, v.x, acc[i][0]);
          acc[i][1] = fmaf(p, v.y, acc[i][1]);
          acc[i][2] = fmaf(p, v.z, acc[i][2]);
          acc[i][3] = fmaf(p, v.w, acc[i][3]);
        }
      }
    }
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

template <typename T>
cudaError_t launch(const void* qkv, void* out, void* lse, int batch, int seq,
                   int heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  encoder_attention_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(lse), seq, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers, 16-byte
// aligned; qkv is a contiguous (batch, seq, 3 * heads * head_dim) tensor.
extern "C" int arsvt_encoder_attention_fwd(const void* qkv, void* out,
                                           void* lse, int batch, int seq,
                                           int heads, int head_dim, int dtype,
                                           void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || seq < 1 ||
      heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(qkv, out, lse, batch, seq, heads, st);
    case 1:
      return (int)launch<__nv_bfloat16>(qkv, out, lse, batch, seq, heads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
