// The tanh GELU, forward and backward (ops/mlp.py::gelu_tanh), element by
// element.
//
// It replaces no Pallas kernel: JAX's gelu_tanh (arsvt_tpu/ops/mlp.py:20-43,
// a custom VJP that saves only u) is jit code that XLA fuses into one pass
// each way. The port ran the same math as eager PyTorch ops, 9 launches
// forward and about 20 backward, each reading and writing the whole tensor.
//
// arsvt_gelu_tanh_fwd reproduces the eager chain of the forward op by op:
// _A*u, *u, *u, u+, _C*, tanh, 1+t, 0.5*u and the final product, each in
// fp32 (PyTorch's opmath for fp32 and bf16) and rounded to the storage
// dtype after every op, as the eager ops round (and as XLA rounds the bf16
// chain JAX traces). arsvt_gelu_tanh_bwd reproduces the fp32 chain of the
// backward, g * (0.5 (1 + t) + 0.5 u (1 - t^2) _C (1 + 3 _A u^2)), in its
// order, and rounds once to u's dtype. Every product and sum is a _rn
// operation (nvcc would contract a * b + c into an FMA, which the eager
// ops round twice), tanhf is the accurate tanh that PyTorch's CUDA tanh
// calls for its float opmath, and the constants are the Python doubles
// cast to float (3 _A folded in double first, as Python folds it). Inf
// and NaN pass through the same IEEE operations: u = -Inf gives NaN, as
// the eager chain does.
//
// Bound on an H100 SXM: bytes. The forward reads u and writes h (4 bytes
// an element in bf16, 8 in fp32), the backward reads u and g and writes du
// (6 and 12 bytes); some 9 and 19 fp32 operations an element (with a tanhf
// each) stay below the card's rate. Design: a grid-stride loop over 16-byte
// vectors (8 bf16 or 4 fp32 values a thread an iteration) where every
// pointer is 16-byte aligned, the last n mod 8 (or 4) elements one a
// thread; element by element for an unaligned pointer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kC = static_cast<float>(0.7978845608028654);  // sqrt(2/pi)
constexpr float kA = static_cast<float>(0.044715);
constexpr float k3A = static_cast<float>(3.0 * 0.044715);
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one eager op's result as stored: rounded to T and read back
template <typename T>
__device__ __forceinline__ float rt(float v) {
  return to_f(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ float gelu_fwd(float u) {
  const float a1 = rt<T>(__fmul_rn(u, kA));    // _A * u
  const float a2 = rt<T>(__fmul_rn(a1, u));    // * u
  const float a3 = rt<T>(__fmul_rn(a2, u));    // * u
  const float a4 = rt<T>(__fadd_rn(u, a3));    // u + ...
  const float a5 = rt<T>(__fmul_rn(a4, kC));   // _C * (...)
  const float t = rt<T>(tanhf(a5));
  const float a6 = rt<T>(__fadd_rn(t, 1.0f));  // 1.0 + t
  const float a7 = rt<T>(__fmul_rn(u, 0.5f));  // 0.5 * u
  return __fmul_rn(a7, a6);                    // rounded by the store
}

__device__ __forceinline__ float gelu_grad(float u) {
  const float b3 = __fmul_rn(__fmul_rn(__fmul_rn(u, kA), u), u);
  const float t = tanhf(__fmul_rn(__fadd_rn(u, b3), kC));
  const float e = __fmul_rn(__fadd_rn(t, 1.0f), 0.5f);  // 0.5 * (1 + t)
  const float f = __fmul_rn(
      __fmul_rn(__fmul_rn(u, 0.5f), __fsub_rn(1.0f, __fmul_rn(t, t))), kC);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(u, k3A), u), 1.0f);
  return __fadd_rn(e, __fmul_rn(f, q));
}

template <typename T, bool kBwd>
__device__ __forceinline__ T one(T u, const T* g, int64_t i) {
  if constexpr (kBwd)
    return from_f<T>(__fmul_rn(to_f(g[i]), gelu_grad(to_f(u))));
  else
    return from_f<T>(gelu_fwd<T>(to_f(u)));
}

// out = gelu(u) (forward) or g * gelu'(u) (backward, g in u's dtype)
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    gelu_kernel(T* __restrict__ out, const T* __restrict__ u,
                const T* __restrict__ g, int64_t n, int vec) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / kVec;
    for (int64_t i = first; i < nv; i += stride) {
      const uint4 ru = reinterpret_cast<const uint4*>(u)[i];
      const T* uv = reinterpret_cast<const T*>(&ru);
      uint4 ro;
      T* ov = reinterpret_cast<T*>(&ro);
      if constexpr (kBwd) {
        const uint4 rg = reinterpret_cast<const uint4*>(g)[i];
        const T* gv = reinterpret_cast<const T*>(&rg);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          ov[j] = from_f<T>(__fmul_rn(to_f(gv[j]), gelu_grad(to_f(uv[j]))));
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) ov[j] = from_f<T>(gelu_fwd<T>(to_f(uv[j])));
      }
      reinterpret_cast<uint4*>(out)[i] = ro;
    }
    done = nv * kVec;
  }
  for (int64_t i = done + first; i < n; i += stride)
    out[i] = one<T, kBwd>(u[i], g, i);
}

template <typename T, bool kBwd>
cudaError_t launch(void* out, const void* u, const void* g, int64_t n,
                   cudaStream_t st) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool vec = (uintptr_t)out % 16 == 0 && (uintptr_t)u % 16 == 0 &&
                   (!kBwd || (uintptr_t)g % 16 == 0);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t work = vec ? (n + kVec - 1) / kVec : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 16;  // resident at 8 blocks an SM, twice
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  gelu_kernel<T, kBwd><<<blocks, kThreads, 0, st>>>(
      static_cast<T*>(out), static_cast<const T*>(u),
      static_cast<const T*>(g), n, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// h = gelu(u), both contiguous with n elements of one dtype (0 fp32, 1
// bf16), not overlapping.
extern "C" int arsvt_gelu_tanh_fwd(void* h, const void* u, int64_t n,
                                   int dtype, void* stream) {
  if (h == nullptr || u == nullptr || n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, false>(h, u, nullptr, n, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, false>(h, u, nullptr, n, st);
  return (int)cudaErrorInvalidValue;
}

// du = g * gelu'(u), all three contiguous with n elements of one dtype, du
// overlapping neither input.
extern "C" int arsvt_gelu_tanh_bwd(void* du, const void* u, const void* g,
                                   int64_t n, int dtype, void* stream) {
  if (du == nullptr || u == nullptr || g == nullptr || n < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, true>(du, u, g, n, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16, true>(du, u, g, n, st);
  return (int)cudaErrorInvalidValue;
}
