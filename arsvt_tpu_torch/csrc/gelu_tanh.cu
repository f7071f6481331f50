// The tanh GELU, forward and backward (ops/mlp.py::gelu_tanh), element by
// element.
//
// It replaces no Pallas kernel: JAX's gelu_tanh (arsvt_tpu/ops/mlp.py:20-43,
// a custom VJP that saves only u) is jit code that XLA fuses into one pass
// each way. The port ran the same math as eager PyTorch ops, 9 launches
// forward and about 20 backward, each reading and writing the whole tensor.
//
// The forward's arithmetic (gelu_fwd) reproduces the eager chain op by op:
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
// (6 and 12 bytes). The backward's ~19 fp32 operations and a tanhf an
// element stay below the card's rate: what holds it back is how the bytes
// stream. A grid-stride loop over two waves of resident blocks, the
// forward's launch, left it at about 81% of the byte bound at (6,304,
// 3,072); a table of gelu'(u) in shared memory (a lookup and a product an
// element), fed through registers or a cp.async ring, was no faster. One
// 16-byte vector of u and g a thread, on as many 256-thread blocks as the
// vectors need, streams as fast as PyTorch's own elementwise kernels, so
// the backward launches that way (norm_variants.py times each of these).
// The forward's chain does not stay below the card's rate in bf16: its
// eight roundings (a convert and a shift each), nine _rn operations and a
// tanhf come to ~50 instructions an element, which at (6,304, 3,072) take
// longer to execute on 132 SMs than the bytes take to move.
//
// So the bf16 forward has two routes, both this arithmetic and so the same
// bits:
//   - the table route (arsvt_gelu_tanh_fwd_table), from
//     ops/mlp.py::TABLE_MIN_ELEMENTS elements up. A bf16 output is a
//     function of the input's 16 bits alone, so the chain is a table of
//     65,536 bf16 values (128 KB). arsvt_gelu_tanh_table fills it on the
//     card, entry i the chain of the bf16 whose bits are i, once a device
//     (the wrapper keeps it). The lookup kernel is persistent, one block of
//     1,024 threads an SM, warp-specialised: a producer warp copies the
//     table into shared memory and streams u through a ring of six 15.5 KB
//     tiles, all by TMA bulk copies that complete on mbarriers; 31 consumer
//     warps look each 16-byte vector up, h = table[bits(u)] an element,
//     store it and release the slot, so the table's fill overlaps the
//     first tiles' loads. The tail and unaligned pointers go
//     element by element through the same table. (norm_variants.py times
//     this kernel without the fill and without the lookups.)
//   - the arithmetic route (arsvt_gelu_tanh_fwd) below the threshold,
//     where that fixed cost is more than the chain's: at B = 1 serving's
//     (197, 3,072), 605,184 elements. The threshold is measured on the
//     card (chip_smoke.py phase 3(c) times both routes by size).
// The fp32 forward (2^32 inputs: no table) and the backward are the
// arithmetic kernel: a grid-stride loop over 16-byte vectors (8 bf16 or 4
// fp32 values a thread an iteration) where every pointer is 16-byte
// aligned, the last n mod 8 (or 4) elements one a thread; element by
// element for an unaligned pointer. The forward caps its grid at twice
// what the card holds at once; the backward's grid covers every vector
// (or element) once, so its loop runs once a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <typename T, bool kBwd>
cudaError_t launch(void* out, const void* u, const void* g, int64_t n,
                   cudaStream_t st) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool vec = (uintptr_t)out % 16 == 0 && (uintptr_t)u % 16 == 0 &&
                   (!kBwd || (uintptr_t)g % 16 == 0);
  const int64_t work = vec ? (n + kVec - 1) / kVec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if constexpr (!kBwd) {  // resident at 8 blocks an SM, twice
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    if (blocks > (int64_t)sms * 16) blocks = (int64_t)sms * 16;
  }
  gelu_kernel<T, kBwd><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<T*>(out), static_cast<const T*>(u),
      static_cast<const T*>(g), n, vec ? 1 : 0);
  return cudaGetLastError();
}

// ------------------------------------------------ the bf16 table route

constexpr int kTableSize = 1 << 16;           // every bf16 bit pattern
constexpr int kTableBytes = kTableSize * 2;   // 128 KB
constexpr int kTableChunks = 4;               // bulk copies of 32 KB
constexpr int kTableThreads = 1024;           // a producer warp, 31 consumers
constexpr int kConsumers = kTableThreads - 32;
constexpr int kTileElems = kConsumers * 8;    // a 16-byte vector a consumer
constexpr int kTileBytes = kTileElems * 2;    // 15.5 KB
constexpr int kRingStages = 6;
constexpr int kTableSmem = kTableBytes + kRingStages * kTileBytes;  // 221 KB

// table[i] = the forward chain of the bf16 whose bits are i
__global__ void __launch_bounds__(kThreads) table_kernel(uint16_t* table) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const __nv_bfloat16 u = __ushort_as_bfloat16(static_cast<uint16_t>(i));
  table[i] = __bfloat16_as_ushort(
      from_f<__nv_bfloat16>(gelu_fwd<__nv_bfloat16>(to_f(u))));
}

// `bytes` from global src to shared dst by the TMA engine, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// two bf16 looked up: the low and the high half of w
__device__ __forceinline__ uint32_t look2(const uint16_t* t, uint32_t w) {
  return static_cast<uint32_t>(t[w & 0xffffu]) |
         (static_cast<uint32_t>(t[w >> 16]) << 16);
}

__device__ __forceinline__ uint4 look8(const uint16_t* t, uint4 v) {
  return make_uint4(look2(t, v.x), look2(t, v.y), look2(t, v.z),
                    look2(t, v.w));
}

// h = table[bits(u)] over n bf16 elements; one block an SM. Warp 0 is the
// producer: its lane 0 copies the table, then streams u's tiles into a
// ring of kRingStages shared-memory slots by TMA bulk copies, each slot
// filled as soon as the consumers have released it (`empty`). Warps 1-31
// are the consumers: once the table and a tile have landed (`full`), each
// thread looks up one 16-byte vector and stores it, and each warp releases
// the slot. Block b takes tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(kTableThreads, 1)
    table_fwd_kernel(uint16_t* __restrict__ h, const uint16_t* __restrict__ u,
                     const uint16_t* __restrict__ table, int64_t n,
                     int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint16_t* s_table = reinterpret_cast<const uint16_t*>(smem);
  uint8_t* ring = smem + kTableBytes;
  // [0] the table, [1 + s] slot s full, [1 + kRingStages + s] slot s empty
  __shared__ __align__(8) uint64_t s_bar[1 + 2 * kRingStages];
  const uint32_t table_bar = hopper::smem_u32(&s_bar[0]);
  auto full = [&](int s) { return hopper::smem_u32(&s_bar[1 + s]); };
  auto empty = [&](int s) {
    return hopper::smem_u32(&s_bar[1 + kRingStages + s]);
  };
  const int64_t nvec = vec ? n / 8 * 8 : 0;  // elements of whole vectors
  const int64_t tiles = (nvec + kTileElems - 1) / kTileElems;
  const int64_t mine = blockIdx.x < tiles
                           ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                           : 0;
  if (threadIdx.x == 0) {
    hopper::mbar_init(table_bar, 1);
    for (int s = 0; s < kRingStages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    if (lane == 0) {
      constexpr int kChunk = kTableBytes / kTableChunks;
      hopper::mbar_expect_tx(table_bar, kTableBytes);
#pragma unroll
      for (int c = 0; c < kTableChunks; ++c)
        bulk_load(hopper::smem_u32(smem) + c * kChunk,
                  table + c * (kChunk / 2), kChunk, table_bar);
      for (int64_t j = 0; j < mine; ++j) {
        const int s = (int)(j % kRingStages);
        if (j >= kRingStages)  // the consumers' release of tile j - stages
          hopper::mbar_wait_or_trap(empty(s),
                                    (uint32_t)((j / kRingStages - 1) & 1));
        const int64_t e0 = (blockIdx.x + j * gridDim.x) * kTileElems;
        const int64_t ne = nvec - e0 < kTileElems ? nvec - e0 : kTileElems;
        hopper::mbar_expect_tx(full(s), (uint32_t)(ne * 2));
        bulk_load(hopper::smem_u32(ring + s * kTileBytes), u + e0,
                  (uint32_t)(ne * 2), full(s));
      }
    }
    __syncwarp();
  } else {
    const int t = threadIdx.x - 32;
    uint4* hv = reinterpret_cast<uint4*>(h);
    hopper::mbar_wait_or_trap(table_bar, 0);
    for (int64_t j = 0; j < mine; ++j) {
      const int s = (int)(j % kRingStages);
      hopper::mbar_wait_or_trap(full(s), (uint32_t)((j / kRingStages) & 1));
      const int64_t e0 = (blockIdx.x + j * gridDim.x) * kTileElems;
      const uint4* tile = reinterpret_cast<const uint4*>(ring + s * kTileBytes);
      if (e0 + t * 8 < nvec) hv[e0 / 8 + t] = look8(s_table, tile[t]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }
  }
  // the tail past the whole vectors, or every element of an unaligned
  // tensor, one a thread; no thread leaves before the table has landed
  hopper::mbar_wait_or_trap(table_bar, 0);
  const int64_t first = (int64_t)blockIdx.x * kTableThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kTableThreads;
  for (int64_t i = nvec + first; i < n; i += stride) h[i] = s_table[u[i]];
}

// the table route's 221 KB of dynamic shared memory, allowed once a device
cudaError_t allow_table_smem() {
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || allowed[dev]) return err;
  err = cudaFuncSetAttribute((const void*)table_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTableSmem);
  allowed[dev] = err == cudaSuccess;
  return err;
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

// table (65,536 bf16, 16-byte aligned): entry i the forward of the bf16
// whose bits are i, by the arithmetic of arsvt_gelu_tanh_fwd.
extern "C" int arsvt_gelu_tanh_table(void* table, void* stream) {
  if (table == nullptr || (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  table_kernel<<<kTableSize / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(table));
  return (int)cudaGetLastError();
}

// h = gelu(u) in bf16 by lookup: h = table[bits(u)], both contiguous with n
// elements, not overlapping; table as arsvt_gelu_tanh_table left it.
extern "C" int arsvt_gelu_tanh_fwd_table(void* h, const void* u,
                                         const void* table, int64_t n,
                                         void* stream) {
  if (h == nullptr || u == nullptr || table == nullptr || n < 1 ||
      (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) err = allow_table_smem();
  if (err != cudaSuccess) return (int)err;
  const bool vec = (uintptr_t)h % 16 == 0 && (uintptr_t)u % 16 == 0;
  const int64_t work = vec ? n / 8 : n;
  const int64_t want = (work + kConsumers - 1) / kConsumers;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : want < sms ? want : sms);
  table_fwd_kernel<<<blocks, kTableThreads, kTableSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(h), static_cast<const uint16_t*>(u),
      static_cast<const uint16_t*>(table), n, vec ? 1 : 0);
  return (int)cudaGetLastError();
}
