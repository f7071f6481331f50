// LayerNorm over the last axis, forward and backward (ops/layernorm.py),
// with fp32 statistics and the closed-form backward of the JAX package's
// custom VJP.
//
// It replaces no Pallas kernel: JAX's LayerNorm (arsvt_tpu/ops/layernorm.py:
// 22-58, `_ln_fwd_math` and `_ln_vjp_bwd`) is jit code that XLA fuses into
// one pass each way. The port ran the same math as eager PyTorch ops, about
// 12 launches forward and 18 backward, most of them reading and writing an
// fp32 temporary of the whole (rows, D) tensor.
//
// arsvt_layer_norm_fwd: y = (x - mean) * rstd * scale + bias, each op in
// fp32 in that order and y rounded once to x's dtype; mean and rstd fp32
// (rows,), the statistics in two passes over the row held in registers
// (mean, then the mean of (x - mean)^2, never E[x^2] - mean^2), rstd =
// rsqrtf(var + eps).
//
// arsvt_layer_norm_bwd, two launches: (1) dx per row, rstd * ((gs -
// mean(gs)) - x̂ * mean(gs * x̂)) with gs = g * scale and x̂ = (x - mean) *
// rstd, rounded once to x's dtype; each block also sums the column partials
// of g * x̂ and of g over its rows and writes them to an fp32 (blocks, D)
// scratch; (2) the scratch summed over blocks into dscale and dbias, in
// scale's dtype, launched as (1)'s programmatic dependent
// (cudaLaunchAttributeProgrammaticStreamSerialization): (1) lets it launch
// as soon as every block of (1) has started, and it waits
// (griddepcontrol.wait) for (1)'s end and writes before it reads, so its
// launch overlaps (1). Every sum runs in a fixed order (warp shuffles, the
// warps of a block one after another, the blocks in index order): no float
// atomics, and two runs give the same bits. One launch, the last block to
// finish found by an integer ticket and summing the partials itself (in
// two levels of groups), measured slower on an H100: that block's serial
// sums took longer than the second launch (norm_variants.py times both).
//
// Types: x (and g, y, dx) fp32 or bf16; scale and bias each fp32 or bf16
// (a training step casts the weights to the compute dtype; serving keeps
// them fp32). Products and sums are _rn operations, so nvcc contracts no
// a * b + c into an FMA that the eager ops round twice.
//
// Bound on an H100 SXM: bytes. A forward reads x once and writes y (4 bytes
// an element in bf16, 8 in fp32) plus 8 bytes a row; a backward reads x and
// g and writes dx (6 bytes an element in bf16, 12 in fp32). The arithmetic,
// some 10 fp32 operations an element each way, is far below the card's
// rate. So the design keeps every element's one read and one write and
// nothing else in device memory: the row stays in registers between its
// passes.
//
// Design: for D <= 1,024 (every preset: 32 ... 1,024) one warp a row.
// Both directions have a vector route, taken where D is a multiple of 8
// (bf16) or 4 (fp32) and the pointers are 16-byte aligned, and an
// element-wise route otherwise. The vector routes are instantiated for the
// number of 16-byte vectors a lane holds (kLoads: in bf16 1 for D = 192, 2
// for 384 and 400, 3 for 768, 4 for 1,024), so no register holds a column
// past D; the element routes hold 32 values a lane. Each direction stages
// its parameters in shared memory once a block, as fp32 (the forward scale
// and bias, the backward scale), and asks for a warp's next row before it
// reduces and writes the current one. The forward runs on a grid of as
// many blocks as the card holds at once (`fwd_capacity`, asked of the
// runtime once a device), each warp taking every step-th row. A lane's
// sums run in the order of its elements and the lanes' in warp_sum's, as
// before, so y, mean and rstd keep their bits. The backward's grid is fixed
// by the rows and the card (`arsvt_layer_norm_bwd_blocks`) and, in bf16 up
// to D = 768, two 256-thread blocks fit an SM. Wider rows (an imported
// checkpoint may be wider) take a block a row, 256 threads, which reads
// the row from memory once a pass; its backward keeps the block's column
// partials in shared memory (D <= 16,384). norm_variants.py times the
// forward without the prefetch (at D = 768 ptxas then spills, at 48
// registers), with more blocks an SM asked of ptxas (it spills) and on a
// grid of a warp a row beside the shipped kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWarpD = 1024;            // the warp path's widest row
constexpr int kPerLane = kMaxWarpD / 32;   // values a lane holds
constexpr int kMaxBlockD = 16384;          // the block path's widest row

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

// scale or bias, fp32 or bf16
struct Param {
  const void* p;
  int bf16;
  __device__ __forceinline__ float operator[](int i) const {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
  }
};

// every lane ends with the same bits: each step adds a pair in both orders
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the block's sum, the warps' sums added in warp order by every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, red[w]);
  return t;
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (kVec == 1) {
    p[0] = from_f<T>(in[0]);
  } else {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = from_f<T>(in[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

struct FwdArgs {
  void* y;
  float* mean;
  float* rstd;
  const void* x;
  Param scale, bias;
  int64_t rows;
  int d;
  float eps;
};

__device__ __forceinline__ float normed(float x, float mean, float rstd,
                                        float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), s), b);
}

// kVec values of T as loaded: one 16-byte vector, or one element
template <typename T, int kVec>
using Raw = std::conditional_t<kVec == 1, T, uint4>;

template <typename T, int kVec>
__device__ __forceinline__ Raw<T, kVec> load_raw(const T* p) {
  if constexpr (kVec == 1)
    return *p;
  else
    return *reinterpret_cast<const uint4*>(p);
}

// value j of a loaded vector, as fp32
template <typename T, int kVec>
__device__ __forceinline__ float val(const Raw<T, kVec>& raw, int j) {
  if constexpr (kVec == 1)
    return to_f(raw);
  else
    return to_f(reinterpret_cast<const T*>(&raw)[j]);
}

// kVec fp32 values of a shared-memory array from element e, e a multiple
// of kVec: 16-byte loads where kVec is a multiple of 4
template <int kVec>
__device__ __forceinline__ void load_shared(const float* p, float* out) {
  if constexpr (kVec % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = p[j];
  }
}

// p's d values into dst as fp32, by the block: 16-byte loads where p is
// 16-byte aligned and d a multiple of the vector, one element a thread
// otherwise
__device__ __forceinline__ void stage(float* dst, Param p, int d) {
  const int per = p.bf16 ? 8 : 4;
  if ((uintptr_t)p.p % 16 == 0 && d % per == 0) {
    const uint4* v = static_cast<const uint4*>(p.p);
    for (int i = threadIdx.x; i < d / per; i += kThreads) {
      const uint4 raw = v[i];
      if (p.bf16) {
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[i * 8 + j] = __bfloat162float(b[j]);
      } else {
        const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[i * 4 + j] = f[j];
      }
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kThreads) dst[c] = p[c];
  }
}

// Row r's x as a lane holds it (vectors (i * 32 + lane) * kVec); nothing
// past the rows
template <typename T, int kVec, int kLoads>
__device__ __forceinline__ void load_row(Raw<T, kVec> (&out)[kLoads],
                                         const FwdArgs& a, int64_t r,
                                         int lane) {
  if (r >= a.rows) return;
  const T* xr = static_cast<const T*>(a.x) + r * a.d;
#pragma unroll
  for (int i = 0; i < kLoads; ++i)
    if ((i * 32 + lane) * kVec < a.d)
      out[i] = load_raw<T, kVec>(xr + (i * 32 + lane) * kVec);
}

// D <= 1,024: one warp a row, 8 rows a block, on a grid sized to what the
// card holds at once, each warp taking rows row, row + step, ... Lane
// `lane` holds the kLoads vectors (i * 32 + lane) * kVec of a row, kLoads
// the fewest that cover D on the vector route (16-byte vectors, kVec 8 in
// bf16 and 4 in fp32: 1 ... 4 loads in bf16), 32 on the element route
// (kVec 1). The block stages scale and bias in shared memory once, as
// fp32, while its warps' first rows are on their way; a warp asks for its
// next row's x before it reduces and writes the current one. The sums run
// in the element order of a lane (i, then j), then across lanes by
// warp_sum.
template <typename T, int kVec, int kLoads>
__global__ void __launch_bounds__(kThreads) ln_fwd_rows(FwdArgs a) {
  constexpr int kWidth = kLoads * kVec * 32;
  __shared__ __align__(16) float s_scale[kWidth];
  __shared__ __align__(16) float s_bias[kWidth];
  const int lane = threadIdx.x & 31;
  const float fd = (float)a.d;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  Raw<T, kVec> nx[kLoads];
  load_row<T, kVec, kLoads>(nx, a, row, lane);
  stage(s_scale, a.scale, a.d);
  stage(s_bias, a.bias, a.d);
  __syncthreads();
  for (; row < a.rows; row += step) {
    Raw<T, kVec> cx[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) cx[i] = nx[i];
    load_row<T, kVec, kLoads>(nx, a, row + step, lane);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if ((i * 32 + lane) * kVec < a.d) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          s = __fadd_rn(s, val<T, kVec>(cx[i], j));
      }
    }
    const float mean = __fdiv_rn(warp_sum(s), fd);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if ((i * 32 + lane) * kVec < a.d) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float t = __fsub_rn(val<T, kVec>(cx[i], j), mean);
          q = __fadd_rn(q, __fmul_rn(t, t));
        }
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), fd), a.eps));
    T* yr = static_cast<T*>(a.y) + row * a.d;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = (i * 32 + lane) * kVec;
      if (e < a.d) {
        float sc[kVec], bi[kVec], o[kVec];
        load_shared<kVec>(s_scale + e, sc);
        load_shared<kVec>(s_bias + e, bi);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          o[j] = normed(val<T, kVec>(cx[i], j), mean, rstd, sc[j], bi[j]);
        store_vec<T, kVec>(yr + e, o);
      }
    }
    if (lane == 0) {
      a.mean[row] = mean;
      a.rstd[row] = rstd;
    }
  }
}

// one block a row, any D; each pass reads the row from memory
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_fwd_block(FwdArgs a) {
  __shared__ float red[kWarps];
  const float fd = (float)a.d;
  for (int64_t row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const T* xr = static_cast<const T*>(a.x) + row * a.d;
    float s = 0.f;
    for (int c = threadIdx.x; c < a.d; c += kThreads)
      s = __fadd_rn(s, to_f(xr[c]));
    const float mean = __fdiv_rn(block_sum(s, red), fd);
    float q = 0.f;
    for (int c = threadIdx.x; c < a.d; c += kThreads) {
      const float t = __fsub_rn(to_f(xr[c]), mean);
      q = __fadd_rn(q, __fmul_rn(t, t));
    }
    const float rstd =
        rsqrtf(__fadd_rn(__fdiv_rn(block_sum(q, red), fd), a.eps));
    T* yr = static_cast<T*>(a.y) + row * a.d;
    for (int c = threadIdx.x; c < a.d; c += kThreads)
      yr[c] = from_f<T>(normed(to_f(xr[c]), mean, rstd, a.scale[c],
                               a.bias[c]));
    if (threadIdx.x == 0) {
      a.mean[row] = mean;
      a.rstd[row] = rstd;
    }
  }
}

struct BwdArgs {
  void* dx;
  float* part_gx;  // (blocks, d): column sums of g * x̂ over a block's rows
  float* part_g;   // (blocks, d): column sums of g
  const void* x;
  const void* g;
  const float* mean;
  const float* rstd;
  Param scale;
  int64_t rows;
  int d;
};

__device__ __forceinline__ float dx_of(float xh, float gs, float rstd,
                                       float m1, float m2) {
  return __fmul_rn(rstd, __fsub_rn(__fsub_rn(gs, m1), __fmul_rn(xh, m2)));
}

// Lets the column-sum kernel, launched after this one as its programmatic
// dependent, start its launch now; it waits for this grid's end and
// writes (griddepcontrol.wait) before it reads the partials.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The warp's column sums acc (lane `lane` holds columns (i * 32 + lane) *
// kVec + j) of every warp, added in warp order into the block's partials.
template <int kVec, int kLoads>
__device__ __forceinline__ void block_partials(const float (&acc)[kLoads][kVec],
                                               float (*red)[kLoads * kVec * 32],
                                               float* out, int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = (i * 32 + lane) * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[warp][e + j] = acc[i][j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float t = red[0][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, red[w][c]);
    out[c] = t;
  }
  __syncthreads();  // red is free again
}

// The vector route, D <= 1,024 a multiple of kVec, 16-byte aligned: one
// warp a row, 8 rows a block; lane `lane` holds the kLoads vectors (i * 32
// + lane) * kVec of a row, kLoads the fewest that cover D (2 for D = 384
// and 400 in bf16, 3 for 768, 4 for 1,024). The block stages scale in
// shared memory once, as fp32. While a warp reduces and writes its row, the
// next row's x, g, mean and rstd are already on their way to its
// registers.
template <typename T, int kVec, int kLoads>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 2 && kLoads <= 3 ? 2 : 1)
    ln_bwd_vec(BwdArgs a) {
  constexpr int kWidth = kLoads * kVec * 32;
  __shared__ float s_scale[kWidth];
  __shared__ float red[kWarps][kWidth];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float fd = (float)a.d;
  for (int c = threadIdx.x; c < a.d; c += kThreads) s_scale[c] = a.scale[c];
  float acc_gx[kLoads][kVec], acc_g[kLoads][kVec];
#pragma unroll
  for (int i = 0; i < kLoads; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc_gx[i][j] = acc_g[i][j] = 0.f;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  uint4 nx[kLoads], ng[kLoads];
  float nmean = 0.f, nrstd = 0.f;
  auto fetch = [&](int64_t r) {
    if (r >= a.rows) return;
    const uint4* xr = reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.x) + r * a.d);
    const uint4* gr = reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.g) + r * a.d);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if ((i * 32 + lane) * kVec < a.d) {
        nx[i] = xr[i * 32 + lane];
        ng[i] = gr[i * 32 + lane];
      }
    }
    nmean = a.mean[r];
    nrstd = a.rstd[r];
  };
  fetch(row);
  launch_dependents();
  __syncthreads();  // s_scale
  for (; row < a.rows; row += step) {
    uint4 cx[kLoads], cg[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      cx[i] = nx[i];
      cg[i] = ng[i];
    }
    const float mean = nmean, rstd = nrstd;
    fetch(row + step);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = (i * 32 + lane) * kVec;
      if (e < a.d) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float g = val<T, kVec>(cg[i], j);
          const float xh = __fmul_rn(__fsub_rn(val<T, kVec>(cx[i], j), mean),
                                     rstd);
          const float gs = __fmul_rn(g, s_scale[e + j]);
          s1 = __fadd_rn(s1, gs);
          s2 = __fadd_rn(s2, __fmul_rn(gs, xh));
          acc_gx[i][j] = __fadd_rn(acc_gx[i][j], __fmul_rn(g, xh));
          acc_g[i][j] = __fadd_rn(acc_g[i][j], g);
        }
      }
    }
    const float m1 = __fdiv_rn(warp_sum(s1), fd);
    const float m2 = __fdiv_rn(warp_sum(s2), fd);
    T* dr = static_cast<T*>(a.dx) + row * a.d;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = (i * 32 + lane) * kVec;
      if (e < a.d) {
        float o[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xh = __fmul_rn(
              __fsub_rn(val<T, kVec>(cx[i], j), mean), rstd);
          const float gs = __fmul_rn(val<T, kVec>(cg[i], j), s_scale[e + j]);
          o[j] = dx_of(xh, gs, rstd, m1, m2);
        }
        store_vec<T, kVec>(dr + e, o);
      }
    }
  }
  block_partials<kVec, kLoads>(acc_gx, red,
                               a.part_gx + (int64_t)blockIdx.x * a.d, a.d);
  block_partials<kVec, kLoads>(acc_g, red,
                               a.part_g + (int64_t)blockIdx.x * a.d, a.d);
}

// The element-wise route, any D <= 1,024 (not a multiple of the vector, or
// an unaligned pointer): one warp a row, lane `lane` holding elements i *
// 32 + lane.
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_bwd_warp(BwdArgs a) {
  constexpr int kLoads = kPerLane;
  __shared__ float red[kWarps][kMaxWarpD];
  const int lane = threadIdx.x & 31;
  const float fd = (float)a.d;
  float acc_gx[kLoads][1], acc_g[kLoads][1];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) acc_gx[i][0] = acc_g[i][0] = 0.f;
  launch_dependents();
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < a.rows; row += (int64_t)gridDim.x * kWarps) {
    const T* xr = static_cast<const T*>(a.x) + row * a.d;
    const T* gr = static_cast<const T*>(a.g) + row * a.d;
    const float mean = a.mean[row], rstd = a.rstd[row];
    float xv[kLoads], gv[kLoads];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = i * 32 + lane;
      if (e < a.d) {
        xv[i] = to_f(xr[e]);
        gv[i] = to_f(gr[e]);
        const float xh = __fmul_rn(__fsub_rn(xv[i], mean), rstd);
        const float gs = __fmul_rn(gv[i], a.scale[e]);
        s1 = __fadd_rn(s1, gs);
        s2 = __fadd_rn(s2, __fmul_rn(gs, xh));
        acc_gx[i][0] = __fadd_rn(acc_gx[i][0], __fmul_rn(gv[i], xh));
        acc_g[i][0] = __fadd_rn(acc_g[i][0], gv[i]);
      }
    }
    const float m1 = __fdiv_rn(warp_sum(s1), fd);
    const float m2 = __fdiv_rn(warp_sum(s2), fd);
    T* dr = static_cast<T*>(a.dx) + row * a.d;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = i * 32 + lane;
      if (e < a.d) {
        const float xh = __fmul_rn(__fsub_rn(xv[i], mean), rstd);
        const float gs = __fmul_rn(gv[i], a.scale[e]);
        dr[e] = from_f<T>(dx_of(xh, gs, rstd, m1, m2));
      }
    }
  }
  block_partials<1, kLoads>(acc_gx, red,
                            a.part_gx + (int64_t)blockIdx.x * a.d, a.d);
  block_partials<1, kLoads>(acc_g, red, a.part_g + (int64_t)blockIdx.x * a.d,
                            a.d);
}

// one block a row, any D up to kMaxBlockD; thread t owns columns t + k *
// kThreads of the block's partials in shared memory
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_bwd_block(BwdArgs a) {
  extern __shared__ float cols[];  // [2][d]
  __shared__ float red[kWarps];
  float* col_gx = cols;
  float* col_g = cols + a.d;
  const float fd = (float)a.d;
  for (int c = threadIdx.x; c < a.d; c += kThreads) col_gx[c] = col_g[c] = 0.f;
  launch_dependents();
  for (int64_t row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const T* xr = static_cast<const T*>(a.x) + row * a.d;
    const T* gr = static_cast<const T*>(a.g) + row * a.d;
    const float mean = a.mean[row], rstd = a.rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < a.d; c += kThreads) {
      const float g = to_f(gr[c]);
      const float xh = __fmul_rn(__fsub_rn(to_f(xr[c]), mean), rstd);
      const float gs = __fmul_rn(g, a.scale[c]);
      s1 = __fadd_rn(s1, gs);
      s2 = __fadd_rn(s2, __fmul_rn(gs, xh));
      col_gx[c] = __fadd_rn(col_gx[c], __fmul_rn(g, xh));
      col_g[c] = __fadd_rn(col_g[c], g);
    }
    const float m1 = __fdiv_rn(block_sum(s1, red), fd);
    const float m2 = __fdiv_rn(block_sum(s2, red), fd);
    T* dr = static_cast<T*>(a.dx) + row * a.d;
    for (int c = threadIdx.x; c < a.d; c += kThreads) {
      const float xh = __fmul_rn(__fsub_rn(to_f(xr[c]), mean), rstd);
      const float gs = __fmul_rn(to_f(gr[c]), a.scale[c]);
      dr[c] = from_f<T>(dx_of(xh, gs, rstd, m1, m2));
    }
  }
  float* pgx = a.part_gx + (int64_t)blockIdx.x * a.d;
  float* pg = a.part_g + (int64_t)blockIdx.x * a.d;
  for (int c = threadIdx.x; c < a.d; c += kThreads) {
    pgx[c] = col_gx[c];
    pg[c] = col_g[c];
  }
}

// dscale[c] = sum_b part_gx[b][c], dbias[c] = sum_b part_g[b][c]: 32
// columns a block, 32 row groups summing every 32nd block row in order,
// then the groups in order. Launched as the row kernel's programmatic
// dependent: it waits here for that grid's end and its writes.
__global__ void __launch_bounds__(1024)
    ln_bwd_cols(const float* __restrict__ part_gx,
                const float* __restrict__ part_g, void* dscale, void* dbias,
                int out_bf16, int nb, int d) {
  __shared__ float s_gx[32][33], s_g[32][33];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < d) {
    for (int r = ty; r < nb; r += 32) {
      a = __fadd_rn(a, part_gx[(int64_t)r * d + c]);
      b = __fadd_rn(b, part_g[(int64_t)r * d + c]);
    }
  }
  s_gx[ty][tx] = a;
  s_g[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < d) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sa = __fadd_rn(sa, s_gx[i][tx]);
      sb = __fadd_rn(sb, s_g[i][tx]);
    }
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(dscale)[c] = __float2bfloat16_rn(sa);
      static_cast<__nv_bfloat16*>(dbias)[c] = __float2bfloat16_rn(sb);
    } else {
      static_cast<float*>(dscale)[c] = sa;
      static_cast<float*>(dbias)[c] = sb;
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

constexpr int kMaxDevices = 64;

// The blocks of ln_fwd_rows<T, kVec, kLoads> that the current device
// holds at once (its SMs times the blocks an SM holds), asked of the
// runtime once a device; 0 on an error.
template <typename T, int kVec, int kLoads>
int fwd_capacity() {
  static int held[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (held[dev] == 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ln_fwd_rows<T, kVec, kLoads>, kThreads, 0) !=
        cudaSuccess)
      return 0;
    held[dev] = per_sm * sm_count();
  }
  return held[dev];
}

// One launch of the row kernel: as many blocks as the card holds at once,
// no more than the rows need.
template <typename T, int kVec, int kLoads>
cudaError_t launch_rows(const FwdArgs& a, cudaStream_t st) {
  const int fit = fwd_capacity<T, kVec, kLoads>();
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = cdiv(a.rows, kWarps);
  ln_fwd_rows<T, kVec, kLoads>
      <<<(unsigned)(want < fit ? want : fit), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// the vector route for kLoads = `loads` (1 ... kPerLane / kVec)
template <typename T, int kLoads = 1>
cudaError_t launch_fwd_vec(const FwdArgs& a, int loads, cudaStream_t st) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if constexpr (kLoads < kPerLane / kVec)
    if (loads > kLoads) return launch_fwd_vec<T, kLoads + 1>(a, loads, st);
  return launch_rows<T, kVec, kLoads>(a, st);
}

template <typename T>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (a.d > kMaxWarpD) {
    const int64_t blocks = a.rows < 65535 ? a.rows : 65535;
    ln_fwd_block<T><<<(unsigned)blocks, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (a.d % kVec == 0 && aligned16(a.x) && aligned16(a.y))
    return launch_fwd_vec<T>(a, (int)cdiv(a.d / kVec, 32), st);
  return launch_rows<T, 1, kPerLane>(a, st);
}

// the vector route's kernel for kLoads = 1 ... kMaxLoads
template <typename T, int kLoads = 1>
const void* vec_kernel(int loads) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kMaxLoads = kPerLane / kVec;
  if constexpr (kLoads < kMaxLoads)
    if (loads > kLoads) return vec_kernel<T, kLoads + 1>(loads);
  return (const void*)ln_bwd_vec<T, kVec, kLoads>;
}

// the backward's kernel for (d, dtype, alignment) and its dynamic shared
// memory
template <typename T>
const void* bwd_kernel(int d, bool vec, size_t* smem) {
  constexpr int kVec = 16 / (int)sizeof(T);
  *smem = 0;
  if (d > kMaxWarpD) {
    *smem = 2 * sizeof(float) * (size_t)d;
    return (const void*)ln_bwd_block<T>;
  }
  if (vec) return vec_kernel<T>((int)cdiv(d / kVec, 32));
  return (const void*)ln_bwd_warp<T>;
}

// blocks of the backward: as many as fit on the card at once (for the
// 16-byte aligned route), no more than the rows need; 0 where the card
// refuses
template <typename T>
int bwd_blocks(int64_t rows, int d) {
  constexpr int kVec = 16 / (int)sizeof(T);
  size_t smem = 0;
  const void* fn = bwd_kernel<T>(d, d % kVec == 0, &smem);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  const int64_t fit = (int64_t)(per_sm > 0 ? per_sm : 1) * sm_count();
  const int64_t need = d > kMaxWarpD ? rows : cdiv(rows, kWarps);
  return (int)(need < fit ? need : fit);
}

// the row kernel, then the column sums as its programmatic dependent
template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, void* dscale, void* dbias,
                       int scale_bf16, int blocks, bool vec,
                       cudaStream_t st) {
  size_t smem = 0;
  const void* fn = bwd_kernel<T>(a.d, vec, &smem);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {const_cast<BwdArgs*>(&a)};
  cudaError_t err =
      cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cdiv(a.d, 32));
  cfg.blockDim = dim3(1024);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ln_bwd_cols,
                           static_cast<const float*>(a.part_gx),
                           static_cast<const float*>(a.part_g), dscale, dbias,
                           scale_bf16, blocks, a.d);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool bwd_vec(int d, int x_dtype, const void* dx, const void* x,
             const void* g) {
  const int vec = x_dtype == 1 ? 8 : 4;
  return d % vec == 0 && aligned16(dx) && aligned16(x) && aligned16(g);
}

}  // namespace

// y (rows, d) in x's dtype, mean and rstd fp32 (rows,); x contiguous (rows,
// d); scale and bias (d,). Dtype codes: 0 fp32, 1 bf16.
extern "C" int arsvt_layer_norm_fwd(void* y, void* mean, void* rstd,
                                    const void* x, const void* scale,
                                    const void* bias, int64_t rows, int d,
                                    int x_dtype, int scale_dtype,
                                    int bias_dtype, float eps, void* stream) {
  if (y == nullptr || mean == nullptr || rstd == nullptr || x == nullptr ||
      scale == nullptr || bias == nullptr || rows < 1 || d < 1 ||
      (x_dtype != 0 && x_dtype != 1) || (scale_dtype != 0 && scale_dtype != 1)
      || (bias_dtype != 0 && bias_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{y,    static_cast<float*>(mean), static_cast<float*>(rstd),
                  x,    Param{scale, scale_dtype}, Param{bias, bias_dtype},
                  rows, d, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x_dtype == 1 ? launch_fwd<__nv_bfloat16>(a, st)
                            : launch_fwd<float>(a, st));
}

// The backward's first kernel's grid for these rows, d and dtype: as many
// blocks as fit on the card at once on the 16-byte aligned route (any
// grid gives the right sums; this one fills the card, and a fixed one
// fixes their order, whichever route runs), no more than the rows need;
// the rows of the scratch that arsvt_layer_norm_bwd takes. 0 where the
// card refuses (d past the block path's shared memory).
extern "C" int arsvt_layer_norm_bwd_blocks(int64_t rows, int d, int x_dtype) {
  if (rows < 1 || d < 1 || d > kMaxBlockD || (x_dtype != 0 && x_dtype != 1))
    return 0;
  return x_dtype == 1 ? bwd_blocks<__nv_bfloat16>(rows, d)
                      : bwd_blocks<float>(rows, d);
}

// dx (rows, d) in x's dtype; dscale and dbias (d,) in scale's dtype; scratch
// fp32 (2, blocks, d) with blocks = arsvt_layer_norm_bwd_blocks(rows, d,
// x_dtype); x and g (rows, d) in one dtype; mean and rstd fp32 (rows,).
extern "C" int arsvt_layer_norm_bwd(void* dx, void* dscale, void* dbias,
                                    void* scratch, int blocks, const void* x,
                                    const void* g, const void* mean,
                                    const void* rstd, const void* scale,
                                    int64_t rows, int d, int x_dtype,
                                    int scale_dtype, void* stream) {
  if (dx == nullptr || dscale == nullptr || dbias == nullptr ||
      scratch == nullptr || x == nullptr || g == nullptr || mean == nullptr ||
      rstd == nullptr || scale == nullptr || rows < 1 || d < 1 ||
      d > kMaxBlockD || blocks < 1 || (x_dtype != 0 && x_dtype != 1) ||
      (scale_dtype != 0 && scale_dtype != 1))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  const BwdArgs a{dx,
                  part,
                  part + (int64_t)blocks * d,
                  x,
                  g,
                  static_cast<const float*>(mean),
                  static_cast<const float*>(rstd),
                  Param{scale, scale_dtype},
                  rows,
                  d};
  const bool vec = bwd_vec(d, x_dtype, dx, x, g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x_dtype == 1
                   ? launch_bwd<__nv_bfloat16>(a, dscale, dbias, scale_dtype,
                                               blocks, vec, st)
                   : launch_bwd<float>(a, dscale, dbias, scale_dtype, blocks,
                                       vec, st));
}
