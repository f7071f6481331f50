// Warp-tile pieces shared by the tensor-core kernels (the fused MLP,
// mlp_tile.cuh, the attention forwards, attention_fwd.cuh, and backwards,
// attention_bwd.cuh).
//
// Products are built from warp tiles: a warp's grid of 16 x 8 fp32
// accumulators += A B^T, with A and B staged in shared memory as they lie
// in device memory ([row][k] or [k][row]), or A already in registers. In
// bf16 each 16 x 8 x 16 step is one tensor-core `mma.sync.m16n8k16` (fp32
// accumulate) fed by ldmatrix. In fp32 the same tiles run on the CUDA cores
// with sequential FMAs over k, so that an fp32 step sums in fp32 as the TPU
// kernels' fp32 dots do. Both keep the accumulator in the mma's layout
// (lane = 4 * g + t holds rows g and g + 8, columns 2t and 2t + 1 of each
// 16 x 8 tile; `frag_row`, `frag_col`), so every epilogue is shared.
//
// Operands are copied from device memory in 16-byte vectors (cp.async)
// along the contiguous dimension where every row is 16-byte aligned, else
// element by element; ragged edges are staged as zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wtile {

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Two neighbouring values of one row, as the mma accumulator holds them.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Row and column of element e (0..3) of a 16 x 8 accumulator in this lane.
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int e) {
  return 2 * (threadIdx.x & 3) + (e & 1);
}

// ------------------------------------------------ asynchronous copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; zeros, with src not read, when
// !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes (one fp32 value) from device to shared memory; zero, with src
// not read, when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// dst[r * dst_ld + c] = src[r * ld + c] for r < rows, c < cols (c
// contiguous in both), copied by 16-byte cp.async; r >= rvalid or c >=
// cvalid give zeros. cols and cvalid are multiples of 8.
template <int kNThreads, typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, int dst_ld,
                                                const T* __restrict__ src,
                                                int64_t ld, int rows,
                                                int cols, int rvalid,
                                                int cvalid) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kNThreads) {
    const int r = idx / per_row, c = (idx % per_row) * kVec;
    const bool ok = r < rvalid && c < cvalid;
    cp_async16(dst + r * dst_ld + c, ok ? src + r * ld + c : src, ok);
  }
}

// dst[r * dst_ld + c] = src[r * ld + c] for r < rows, c < cols, element by
// element (rows of any alignment); r >= rvalid or c >= cvalid give zeros.
// Each thread starts kLoads loads before it stores any, so that many are in
// flight at once (their registers count where the caller holds many).
template <int kNThreads, typename T, int kLoads = 16>
__device__ __forceinline__ void copy_tile_elems(T* dst, int dst_ld,
                                                const T* __restrict__ src,
                                                int64_t ld, int rows,
                                                int cols, int rvalid,
                                                int cvalid) {
  const int n = rows * cols;
  for (int base = threadIdx.x; base < n; base += kNThreads * kLoads) {
    T vals[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kNThreads;
      const int r = idx / cols, c = idx - r * cols;
      vals[u] = (idx < n && r < rvalid && c < cvalid) ? src[r * ld + c]
                                                      : from_float<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kNThreads;
      const int r = idx / cols;
      if (idx < n) dst[r * dst_ld + idx - r * cols] = vals[u];
    }
  }
}

// The same copy for rows of any alignment and width (the fused MLP's
// ragged route): one 4-byte cp.async per element for 4-byte T, zeros
// where !valid, completing with the caller's commit group; element by
// element, synchronously, for 2-byte T (cp.async takes no 2-byte size).
template <int kNThreads, typename T>
__device__ __forceinline__ void copy_tile_ragged(T* dst, int dst_ld,
                                                 const T* __restrict__ src,
                                                 int64_t ld, int rows,
                                                 int cols, int rvalid,
                                                 int cvalid) {
  if constexpr (sizeof(T) == 4) {
    for (int idx = threadIdx.x; idx < rows * cols; idx += kNThreads) {
      const int r = idx / cols, c = idx - r * cols;
      const bool ok = r < rvalid && c < cvalid;
      cp_async4(dst + r * dst_ld + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    copy_tile_elems<kNThreads>(dst, dst_ld, src, ld, rows, cols, rvalid,
                               cvalid);
  }
}

// ------------------------------------------------------------ warp tiles

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float acc[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of one 16 x 16 step: rows 0..15 of A at depth kk..kk+15,
// A at As as [k][m] when kAKM, else as [m][k] (row stride lda).
template <bool kAKM>
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* As,
                                            int lda, int kk) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  // matrix mi: m half mi % 2, k half mi / 2
  if (kAKM)
    ldsm_x4_trans(a, As + (kk + r + (mi >> 1) * 8) * lda + (mi & 1) * 8);
  else
    ldsm_x4(a, As + (r + (mi & 1) * 8) * lda + kk + (mi >> 1) * 8);
}

// The B fragments of kN (even) 8-column tiles at depth kk..kk+15, B at Bs
// as [k][n] when kBKN, else as [n][k] (row stride ldb).
template <int kN, bool kBKN>
__device__ __forceinline__ void load_b_frags(uint32_t (&b)[kN][2],
                                             const __nv_bfloat16* Bs,
                                             int ldb, int kk) {
  static_assert(kN % 2 == 0, "B tiles come in pairs");
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < kN; j += 2) {
    uint32_t f[4];  // matrix mi: k half mi % 2, n half mi / 2
    if (kBKN)
      ldsm_x4_trans(f, Bs + (kk + r + (mi & 1) * 8) * ldb +
                           (j + (mi >> 1)) * 8);
    else
      ldsm_x4(f, Bs + ((j + (mi >> 1)) * 8 + r) * ldb + kk + (mi & 1) * 8);
    b[j][0] = f[0];
    b[j][1] = f[1];
    b[j + 1][0] = f[2];
    b[j + 1][1] = f[3];
  }
}

// One warp's acc[m][j] += A_m B_j^T over kDepth (a multiple of 16), for
// kM 16-row tiles of A and kN (even) 8-column tiles of B. A is at As as
// [k][m] when kAKM, else as [m][k] (row stride lda); B is at Bs as [k][n]
// when kBKN, else as [n][k] (row stride ldb). bf16: per 16-deep step, B's
// fragments are loaded once and each A fragment once (ldmatrix, .trans for
// the [k][.] layouts) for kM * kN tensor-core mma.sync m16n8k16. Row
// strides are multiples of 8 elements and rows start 16-byte aligned.
template <int kM, int kN, int kDepth, bool kAKM, bool kBKN>
__device__ __forceinline__ void warp_mma(float (&acc)[kM][kN][4],
                                         const __nv_bfloat16* As, int lda,
                                         const __nv_bfloat16* Bs, int ldb) {
  static_assert(kDepth % 16 == 0, "warp tile depth");
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 16) {
    uint32_t b[kN][2];
    load_b_frags<kN, kBKN>(b, Bs, ldb, kk);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      uint32_t a[4];
      load_a_frag<kAKM>(a, kAKM ? As + m * 16 : As + m * 16 * lda, lda, kk);
#pragma unroll
      for (int j = 0; j < kN; ++j) mma_bf16(acc[m][j], a, b[j]);
    }
  }
}

// The same for one 16-row tile of A held in registers, one fragment per
// 16-deep step (a[kk / 16], as load_a_frag gives it, or built from a
// 16 x 16 pair of accumulators by pack_a_frag), over the first `steps`
// 16-deep steps (a warp-uniform count; the rest of A is zeros).
template <int kN, int kDepth, bool kBKN>
__device__ __forceinline__ void warp_mma_afrag(
    float (&acc)[kN][4], const uint32_t (&a)[kDepth / 16][4],
    const __nv_bfloat16* Bs, int ldb, int steps = kDepth / 16) {
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 16) {
    if (kk / 16 >= steps) break;
    uint32_t b[kN][2];
    load_b_frags<kN, kBKN>(b, Bs, ldb, kk);
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_bf16(acc[j], a[kk / 16], b[j]);
  }
}

// Accumulator tiles lo (columns 0..7) and hi (8..15) of one 16-row tile,
// rounded to bf16, as the A fragment of a 16-deep step: the accumulator
// and A layouts put the same rows and column pairs in the same lane.
__device__ __forceinline__ void pack_a_frag(uint32_t a[4], const float lo[4],
                                            const float hi[4]) {
  const __nv_bfloat162 v[4] = {
      __floats2bfloat162_rn(lo[0], lo[1]), __floats2bfloat162_rn(lo[2], lo[3]),
      __floats2bfloat162_rn(hi[0], hi[1]), __floats2bfloat162_rn(hi[2], hi[3])};
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const uint32_t*>(&v[i]);
}

// fp32: the same warp tile and accumulator layout on the CUDA cores, one
// FMA per element and depth step, in order of depth.
template <int kM, int kN, int kDepth, bool kAKM, bool kBKN>
__device__ __forceinline__ void warp_mma(float (&acc)[kM][kN][4],
                                         const float* As, int lda,
                                         const float* Bs, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int am = kAKM ? 1 : lda, ak = kAKM ? lda : 1;
  const int bn = kBKN ? 1 : ldb, bk = kBKN ? ldb : 1;
#pragma unroll 4
  for (int k = 0; k < kDepth; ++k) {
    float b[kN][2];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      b[j][0] = Bs[(j * 8 + 2 * t) * bn + k * bk];
      b[j][1] = Bs[(j * 8 + 2 * t + 1) * bn + k * bk];
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float a_lo = As[(m * 16 + g) * am + k * ak];
      const float a_hi = As[(m * 16 + g + 8) * am + k * ak];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        acc[m][j][0] = fmaf(a_lo, b[j][0], acc[m][j][0]);
        acc[m][j][1] = fmaf(a_lo, b[j][1], acc[m][j][1]);
        acc[m][j][2] = fmaf(a_hi, b[j][0], acc[m][j][2]);
        acc[m][j][3] = fmaf(a_hi, b[j][1], acc[m][j][3]);
      }
    }
  }
}

}  // namespace wtile
