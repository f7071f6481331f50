// Tile GEMM pieces shared by the fused-MLP kernels (fused_mlp_fwd.cu,
// fused_mlp_bwd.cu), and the row-tile kernel that both run: #8's forward
// and the dx/du launch of #9 have the same shape.
//
// Products are built from warp tiles (`warp_mma`): a warp's kM x kN grid
// of 16 x 8 fp32 accumulators += A B^T, with A and B staged in shared
// memory as they lie in device memory ([row][k] or [k][row]). In bf16 each
// 16 x 8 x 16 step is one tensor-core `mma.sync.m16n8k16` (fp32
// accumulate) fed by ldmatrix. In fp32 the same tiles run on the CUDA
// cores with sequential FMAs over k, so that an fp32 step sums in fp32 as
// the TPU kernel's fp32 dots do; both keep the accumulator in the mma's
// layout (lane = 4 * g + t holds rows g and g + 8, columns 2t and 2t + 1),
// so every epilogue is shared.
//
// Operands are copied from device memory in 16-byte vectors (cp.async)
// along the contiguous dimension, so D and M must be multiples of 8 (the
// wrapper checks); rows (n) may be anything. Ragged edges are staged as
// zeros and not stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mlp {

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

// tanh GELU and its derivative, in fp32, in the JAX kernel's expression
// order (fused_mlp.py::_gelu, _gelu_grad).
__device__ __forceinline__ float gelu(float u) {
  const float t = tanhf(kGeluC * (u + kGeluA * u * u * u));
  return 0.5f * u * (1.0f + t);
}

// Both from one tanh: gelu(u) into *h, returns gelu'(u).
__device__ __forceinline__ float gelu_and_grad(float u, float* h) {
  const float t = tanhf(kGeluC * (u + kGeluA * u * u * u));
  *h = 0.5f * u * (1.0f + t);
  return 0.5f * (1.0f + t) +
         0.5f * u * (1.0f - t * t) * kGeluC * (1.0f + 3.0f * kGeluA * u * u);
}

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

// Eight bf16 values from a 16-byte aligned address, as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Two neighbouring values of one row, as the mma accumulator holds them.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
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
  static_assert(kN % 2 == 0 && kDepth % 16 == 0, "warp tile shape");
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 16) {
    uint32_t b[kN][2];
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
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      uint32_t a[4];  // matrix mi: m half mi % 2, k half mi / 2
      if (kAKM)
        ldsm_x4_trans(a, As + (kk + r + (mi >> 1) * 8) * lda + m * 16 +
                             (mi & 1) * 8);
      else
        ldsm_x4(a, As + (m * 16 + r + (mi & 1) * 8) * lda + kk +
                       (mi >> 1) * 8);
#pragma unroll
      for (int j = 0; j < kN; ++j) mma_bf16(acc[m][j], a, b[j]);
    }
  }
}

// fp32: the same warp tile and accumulator layout (lane = 4 * g + t holds
// rows g and g + 8, columns 2t and 2t + 1 of each 16 x 8 tile) on the CUDA
// cores, one FMA per element and depth step, in order of depth.
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

// ------------------------------------------------------ the row-tile kernel
//
// One block of 256 threads (8 warps) owns R rows (48 in bf16, 16 in fp32)
// and one slice of the output's columns: all D of them when D <= 768,
// else blockIdx.y's share of ceil(D / 768) equal slices of 128-column
// groups (at most kMaxNg groups, so the accumulator keeps its register
// budget). Its R rows of A (R x D, the full depth) are staged once and stay
// in shared memory; it walks M in chunks of 128:
//   G1: C = A[rows] (R x D) . W_a chunk (D x 128), in depth steps of 64;
//   epilogue on C (R x 128): forward u = C + b1, stored as bf16, h =
//     gelu(u) rounded to T into shared memory (Hs), never to device
//     memory; backward du = C * gelu'(u) from the saved bf16 u, stored as
//     bf16 and, as bf16, into Hs, and h = gelu(u) rounded to T stored for
//     the dw launch (one tanh gives both);
//   G2: Out (R x slice) += Hs (R x 128) . W_b chunk (128 x slice), one
//     128-column output group at a time in two depth halves of 64, the
//     accumulator in registers across all of M.
// A block of a second slice redoes G1 and its epilogue (the TPU kernel
// keeps the whole D in one block; this is the simple way past the
// register budget) and leaves u, du and h to the blocks of slice 0.
// Every step of G1 and G2 reads one 64 (depth) x 128 tile of a weight,
// copied from device memory as it lies there (cp.async, 16-byte vectors)
// into a ring of S slots (6 in bf16, 3 in fp32), S - 1 tiles ahead of the
// one in use; the MMA reads [k][n] tiles through ldmatrix.trans, so no tile
// is transposed on the way in. Warp w computes columns 16w .. 16w + 15 of
// each 128-column group of C and of Out. The staged rows of A bound D:
// row_tile_smem_bytes must fit the 227 KB a block can have (D <= 1,088 in
// bf16, 1,728 in fp32). Forward (#8, fused_mlp.py::_fwd_kernel): A = x, W_a
// = w1 (D, M), W_b = w2 (M, D), out = acc + b2. Backward dx/du (#9's first
// launch, _bwd_dx_kernel): A = dO, W_a = w2^T, W_b = w1^T, dx = acc. At
// ViT-B's n = 6,304, 48-row blocks make 132 blocks: one wave on the H100's
// 132 SMs.

constexpr int kRowThreads = 256;
constexpr int kDepth = 64;   // depth of a weight tile
constexpr int kChunk = 128;  // M per chunk, and columns per output group
constexpr int kMaxNg = 6;    // output groups per block: 6 x 128 = 768 columns
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block
// Row strides of the staged tiles, 8 elements past their width: 16-byte
// aligned, conflict-free ldmatrix rows.
constexpr int kLdKN = kChunk + 8;  // a [k][n] tile: 64 x 128
constexpr int kLdNK = kDepth + 8;  // an [n][k] tile: 128 x 64
constexpr int kSlot = (kDepth * kLdKN > kChunk * kLdNK) ? kDepth * kLdKN
                                                        : kChunk * kLdNK;

// Rows per block (16 per m-tile) and weight tiles in flight: the fp32
// CUDA-core tiles take more registers and twice the bytes per tile.
template <typename T>
struct RowTile {
  static constexpr int kMTiles = 3, kStages = 6;
};
template <>
struct RowTile<float> {
  static constexpr int kMTiles = 1, kStages = 3;
};

template <typename T>
size_t row_tile_smem_bytes(int nk) {
  constexpr int kRows = 16 * RowTile<T>::kMTiles;
  return ((size_t)kRows * (nk * kDepth + 8) + (size_t)kRows * kLdKN +
          (size_t)RowTile<T>::kStages * kSlot) *
         sizeof(T);
}

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kRowThreads, 1)
    row_tile_kernel(const T* __restrict__ a, const T* __restrict__ wa,
                    const T* __restrict__ wb, const float* __restrict__ b1,
                    const float* __restrict__ b2,
                    const __nv_bfloat16* __restrict__ u_in,
                    __nv_bfloat16* __restrict__ u_out,
                    T* __restrict__ h_out, T* __restrict__ out, int n,
                    int D, int M) {
  constexpr int kM = RowTile<T>::kMTiles, kStages = RowTile<T>::kStages;
  constexpr int kRows = 16 * kM;
  constexpr int kLdW = kBwd ? kLdNK : kLdKN;  // weight tiles: [n][k] or [k][n]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = (D + kDepth - 1) / kDepth;  // G1 depth steps
  // G2 output groups: this block's slice of the ceil(D / 128)
  const int ng_all = (D + kChunk - 1) / kChunk;
  const int per_slice = (ng_all + gridDim.y - 1) / gridDim.y;  // <= kMaxNg
  const int grp0 = blockIdx.y * per_slice;
  const int ng = min(per_slice, ng_all - grp0);
  const bool writer = blockIdx.y == 0;  // stores u (fwd) or du and h (bwd)
  const int ldx = nk * kDepth + 8;
  T* Xs = reinterpret_cast<T*>(smem_raw);  // kRows x ldx, zeros past D, n
  T* Hs = Xs + kRows * ldx;                // kRows x kLdKN
  T* Ws = Hs + kRows * kLdKN;              // kStages x kSlot

  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = nk + 2 * ng;
  const int total = (M + kChunk - 1) / kChunk * per_chunk;

  // Weight tile q (in walking order) into its ring slot; one commit group
  // per tile, empty past the end.
  auto enqueue = [&](int q) {
    if (q < total) {
      const int c0 = q / per_chunk * kChunk, s = q % per_chunk;
      T* dst = Ws + (q % kStages) * kSlot;
      if (s < nk) {  // G1 at depth k0, output columns c0 ..
        const int k0 = s * kDepth;
        if (kBwd)  // (n = c, k = d) = w2[c][d]
          copy_tile_async<kRowThreads>(dst, kLdW, wa + (int64_t)c0 * D + k0,
                                       D, kChunk, kDepth, M - c0, D - k0);
        else  // (k = d, n = c) = w1[d][c]
          copy_tile_async<kRowThreads>(dst, kLdW, wa + (int64_t)k0 * M + c0,
                                       M, kDepth, kChunk, D - k0, M - c0);
      } else {  // G2 into output columns d0 .., at depth c0 + h0
        const int d0 = (grp0 + (s - nk) / 2) * kChunk;
        const int h0 = (s - nk) % 2 * kDepth;
        if (kBwd)  // (n = d, k = c) = w1[d][c]
          copy_tile_async<kRowThreads>(dst, kLdW,
                                       wb + (int64_t)d0 * M + c0 + h0, M,
                                       kChunk, kDepth, D - d0, M - c0 - h0);
        else  // (k = c, n = d) = w2[c][d]
          copy_tile_async<kRowThreads>(dst, kLdW,
                                       wb + (int64_t)(c0 + h0) * D + d0, D,
                                       kDepth, kChunk, M - c0 - h0, D - d0);
      }
    }
    cp_async_commit();
  };

  copy_tile_async<kRowThreads>(Xs, ldx, a + (int64_t)row0 * D, D, kRows,
                               nk * kDepth, n - row0, D);  // in group 0
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) enqueue(q);

  // Wait for the next tile (and for every warp to be done with the slot
  // it refills), queue the tile kStages - 1 ahead, return the warp's 16
  // columns of it.
  int q = 0;
  auto next = [&]() -> const T* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    enqueue(q + kStages - 1);
    const T* w = Ws + (q++ % kStages) * kSlot;
    return kBwd ? w + warp * 16 * kLdW : w + warp * 16;
  };

  float acc_o[kMaxNg][kM][2][4];
#pragma unroll
  for (int j = 0; j < kMaxNg; ++j)
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_o[j][m][i][e] = 0.f;

  for (int c0 = 0; c0 < M; c0 += kChunk) {
    // G1: C = A[rows] . W_a[:, c0:c0+128]
    float acc[kM][2][4];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
    for (int k0 = 0; k0 < nk * kDepth; k0 += kDepth)
      warp_mma<kM, 2, kDepth, false, !kBwd>(acc, Xs + k0, ldx, next(), kLdW);

    // epilogue into Hs (and u or du into device memory); the last reads
    // of Hs, in the previous chunk's G2, are behind G1's barriers
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int r = m * 16 + g + 8 * p;
          const int c = warp * 16 + i * 8 + 2 * t;
          const int row = row0 + r, col = c0 + c;
          float h0 = 0.f, h1 = 0.f;
          if (col < M) {  // M is even, so col + 1 < M too
            const int64_t at = (int64_t)row * M + col;
            if (!kBwd) {
              const float u0 = acc[m][i][2 * p] + b1[col];
              const float u1 = acc[m][i][2 * p + 1] + b1[col + 1];
              if (writer && row < n) store2(u_out + at, u0, u1);
              h0 = gelu(u0);
              h1 = gelu(u1);
            } else if (row < n) {
              const float2 uf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(u_in + at));
              float g0, g1;
              const float dg0 = gelu_and_grad(uf.x, &g0);
              const float dg1 = gelu_and_grad(uf.y, &g1);
              const __nv_bfloat162 du = __floats2bfloat162_rn(
                  acc[m][i][2 * p] * dg0, acc[m][i][2 * p + 1] * dg1);
              if (writer) {
                *reinterpret_cast<__nv_bfloat162*>(u_out + at) = du;
                store2(h_out + at, g0, g1);
              }
              const float2 duf = __bfloat1622float2(du);
              h0 = duf.x;
              h1 = duf.y;
            }
          }
          Hs[r * kLdKN + c] = from_float<T>(h0);
          Hs[r * kLdKN + c + 1] = from_float<T>(h1);
        }

    // G2: Out[:, 128j:128j+128] += Hs . W_b[c0:c0+128, 128j:128j+128];
    // Hs is complete behind the first tile's barrier
#pragma unroll
    for (int j = 0; j < kMaxNg; ++j) {
      if (j >= ng) continue;
#pragma unroll
      for (int h0 = 0; h0 < kChunk; h0 += kDepth)
        warp_mma<kM, 2, kDepth, false, !kBwd>(acc_o[j], Hs + h0, kLdKN,
                                              next(), kLdW);
    }
  }
  cp_async_wait<0>();  // the groups still open are empty

#pragma unroll
  for (int j = 0; j < kMaxNg; ++j) {
    if (j >= ng) continue;
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int row = row0 + m * 16 + g + 8 * p;
          const int col = (grp0 + j) * kChunk + warp * 16 + i * 8 + 2 * t;
          if (row >= n || col >= D) continue;  // D is even
          float v0 = acc_o[j][m][i][2 * p], v1 = acc_o[j][m][i][2 * p + 1];
          if (!kBwd) {
            v0 += b2[col];
            v1 += b2[col + 1];
          }
          store2(out + (int64_t)row * D + col, v0, v1);
        }
  }
}

// Launch the row-tile kernel on `stream`: one block per 48 (bf16) or 16
// (fp32) rows and slice of at most kMaxNg output groups.
template <typename T, bool kBwd>
cudaError_t launch_row_tile(const T* a, const T* wa, const T* wb,
                            const float* b1, const float* b2,
                            const __nv_bfloat16* u_in,
                            __nv_bfloat16* u_out, T* h_out, T* out, int n,
                            int D, int M, cudaStream_t stream) {
  const size_t smem = row_tile_smem_bytes<T>((D + kDepth - 1) / kDepth);
  cudaError_t err = cudaFuncSetAttribute(
      row_tile_kernel<T, kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = 16 * RowTile<T>::kMTiles;
  const int groups = (D + kChunk - 1) / kChunk;
  const dim3 grid((n + kRows - 1) / kRows, (groups + kMaxNg - 1) / kMaxNg);
  row_tile_kernel<T, kBwd><<<grid, kRowThreads, smem, stream>>>(
      a, wa, wb, b1, b2, u_in, u_out, h_out, out, n, D, M);
  return cudaGetLastError();
}

// The largest D whose staged rows fit the row-tile kernel's shared memory:
// 1,088 in bf16, 1,728 in fp32.
template <typename T>
int max_d() {
  int nk = 1;
  while (row_tile_smem_bytes<T>(nk + 1) <= kMaxSmem) ++nk;
  return nk * kDepth;
}

// Shapes every fused-MLP entry point takes: n >= 1 rows, D and M positive
// multiples of 8 (16-byte cp.async rows), and D up to max_d.
template <typename T>
bool shapes_ok(int n, int D, int M) {
  return n >= 1 && D >= 8 && M >= 8 && D % 8 == 0 && M % 8 == 0 &&
         D <= max_d<T>();
}

}  // namespace mlp
