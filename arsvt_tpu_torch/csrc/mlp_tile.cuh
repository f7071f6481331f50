// The fused-MLP kernels' own pieces (fused_mlp_fwd.cu, fused_mlp_bwd.cu):
// tanh GELU (which the bf16 wgmma kernels of mlp_gemm.cuh share) and the
// row-tile kernel that both run in fp32, the parity path (#8's forward and
// the dx/du launch of #9 have the same shape). Its products are
// warp_tile.cuh's warp tiles, in fp32 sequential FMAs over the depth on
// the CUDA cores.
//
// Operands are copied from device memory in 16-byte vectors (cp.async)
// along the contiguous dimension where D and M are multiples of 8 and
// every pointer is 16-byte aligned; otherwise (kRagged, any D and M >= 1)
// by one 4-byte cp.async an fp32 element (copy_tile_ragged), with the
// outputs stored one element at a time. Rows (n) may be anything. Ragged
// edges are staged as zeros and not stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "warp_tile.cuh"

namespace mlp {

using namespace wtile;

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

// ------------------------------------------------------ the row-tile kernel
//
// One block of 256 threads (8 warps) owns R = 16 rows and one slice of the
// output's columns: all D of them when D <= 768,
// else blockIdx.y's share of ceil(D / 768) equal slices of 128-column
// groups (at most kMaxNg groups, so the accumulator keeps its register
// budget). Its R rows of A (R x D, the full depth) are staged once and stay
// in shared memory; it walks M in chunks of 128:
//   G1: C = A[rows] (R x D) . W_a chunk (D x 128), in depth steps of 64;
//   epilogue on C (R x 128): forward u = C + b1, stored as bf16, h =
//     gelu(u) into shared memory (Hs), never to device memory; backward
//     du = C * gelu'(u) from the saved bf16 u, stored as bf16 and, as
//     bf16, into Hs, and h = gelu(u) stored for the dw launch (one tanh
//     gives both);
//   G2: Out (R x slice) += Hs (R x 128) . W_b chunk (128 x slice), one
//     128-column output group at a time in two depth halves of 64, the
//     accumulator in registers across all of M.
// A block of a second slice redoes G1 and its epilogue (the TPU kernel
// keeps the whole D in one block; this is the simple way past the
// register budget) and leaves u, du and h to the blocks of slice 0.
// Every step of G1 and G2 reads one 64 (depth) x 128 tile of a weight,
// copied from device memory as it lies there (cp.async, 16-byte vectors)
// into a ring of 3 slots, 2 tiles ahead of the one in use; the [k][n]
// tiles are read transposed, so no tile is transposed on the way in. Warp
// w computes columns 16w .. 16w + 15 of each 128-column group of C and of
// Out. The staged rows of A bound D: row_tile_smem_bytes must fit the 227
// KB a block can have (D <= 1,728). Forward (#8, fused_mlp.py::_fwd_kernel):
// A = x, W_a = w1 (D, M), W_b = w2 (M, D), out = acc + b2. Backward dx/du
// (#9's first launch, _bwd_dx_kernel): A = dO, W_a = w2^T, W_b = w1^T, dx
// = acc.

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

// 16-row m-tiles per block and weight tiles in flight (fp32).
constexpr int kRowMTiles = 1, kRowStages = 3;

template <typename T>
size_t row_tile_smem_bytes(int nk) {
  constexpr int kRows = 16 * kRowMTiles;
  return ((size_t)kRows * (nk * kDepth + 8) + (size_t)kRows * kLdKN +
          (size_t)kRowStages * kSlot) *
         sizeof(T);
}

template <typename T, bool kBwd, bool kRagged>
__global__ void __launch_bounds__(kRowThreads, 1)
    row_tile_kernel(const T* __restrict__ a, const T* __restrict__ wa,
                    const T* __restrict__ wb, const float* __restrict__ b1,
                    const float* __restrict__ b2,
                    const __nv_bfloat16* __restrict__ u_in,
                    __nv_bfloat16* __restrict__ u_out,
                    T* __restrict__ h_out, T* __restrict__ out, int n,
                    int D, int M) {
  constexpr int kM = kRowMTiles, kStages = kRowStages;
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
  auto copy = [](T* dst, int dst_ld, const T* src, int64_t ld, int rows,
                 int cols, int rvalid, int cvalid) {
    if constexpr (kRagged)
      copy_tile_ragged<kRowThreads>(dst, dst_ld, src, ld, rows, cols, rvalid,
                                    cvalid);
    else
      copy_tile_async<kRowThreads>(dst, dst_ld, src, ld, rows, cols, rvalid,
                                   cvalid);
  };

  // Weight tile q (in walking order) into its ring slot; one commit group
  // per tile, empty past the end.
  auto enqueue = [&](int q) {
    if (q < total) {
      const int c0 = q / per_chunk * kChunk, s = q % per_chunk;
      T* dst = Ws + (q % kStages) * kSlot;
      if (s < nk) {  // G1 at depth k0, output columns c0 ..
        const int k0 = s * kDepth;
        if (kBwd)  // (n = c, k = d) = w2[c][d]
          copy(dst, kLdW, wa + (int64_t)c0 * D + k0, D, kChunk, kDepth,
               M - c0, D - k0);
        else  // (k = d, n = c) = w1[d][c]
          copy(dst, kLdW, wa + (int64_t)k0 * M + c0, M, kDepth, kChunk,
               D - k0, M - c0);
      } else {  // G2 into output columns d0 .., at depth c0 + h0
        const int d0 = (grp0 + (s - nk) / 2) * kChunk;
        const int h0 = (s - nk) % 2 * kDepth;
        if (kBwd)  // (n = d, k = c) = w1[d][c]
          copy(dst, kLdW, wb + (int64_t)d0 * M + c0 + h0, M, kChunk, kDepth,
               D - d0, M - c0 - h0);
        else  // (k = c, n = d) = w2[c][d]
          copy(dst, kLdW, wb + (int64_t)(c0 + h0) * D + d0, D, kDepth,
               kChunk, M - c0 - h0, D - d0);
      }
    }
    cp_async_commit();
  };

  copy(Xs, ldx, a + (int64_t)row0 * D, D, kRows, nk * kDepth, n - row0,
       D);  // in group 0
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
          if (kRagged && col < M) {  // element by element; col + 1 may be M
            const int64_t at = (int64_t)row * M + col;
            const bool two = col + 1 < M;
            if (!kBwd) {
              const float u0 = acc[m][i][2 * p] + b1[col];
              const float u1 = two ? acc[m][i][2 * p + 1] + b1[col + 1] : 0.f;
              if (writer && row < n) {
                u_out[at] = __float2bfloat16(u0);
                if (two) u_out[at + 1] = __float2bfloat16(u1);
              }
              h0 = gelu(u0);
              h1 = two ? gelu(u1) : 0.f;
            } else if (row < n) {
              const float u0 = __bfloat162float(u_in[at]);
              const float u1 = two ? __bfloat162float(u_in[at + 1]) : 0.f;
              float g0, g1;
              const float dg0 = gelu_and_grad(u0, &g0);
              const float dg1 = gelu_and_grad(u1, &g1);
              const __nv_bfloat16 du0 =
                  __float2bfloat16(acc[m][i][2 * p] * dg0);
              const __nv_bfloat16 du1 =
                  __float2bfloat16(acc[m][i][2 * p + 1] * dg1);
              if (writer) {
                u_out[at] = du0;
                h_out[at] = from_float<T>(g0);
                if (two) {
                  u_out[at + 1] = du1;
                  h_out[at + 1] = from_float<T>(g1);
                }
              }
              h0 = __bfloat162float(du0);
              h1 = two ? __bfloat162float(du1) : 0.f;
            }
          } else if (col < M) {  // M is even, so col + 1 < M too
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
          if (row >= n || col >= D) continue;  // aligned: D is even
          const bool two = !kRagged || col + 1 < D;
          float v0 = acc_o[j][m][i][2 * p], v1 = acc_o[j][m][i][2 * p + 1];
          if (!kBwd) {
            v0 += b2[col];
            if (two) v1 += b2[col + 1];
          }
          T* dst = out + (int64_t)row * D + col;
          if (!kRagged) {
            store2(dst, v0, v1);
          } else {
            dst[0] = from_float<T>(v0);
            if (two) dst[1] = from_float<T>(v1);
          }
        }
  }
}

template <typename T, bool kBwd, bool kRagged>
cudaError_t launch_row_tile_kernel(const T* a, const T* wa, const T* wb,
                                   const float* b1, const float* b2,
                                   const __nv_bfloat16* u_in,
                                   __nv_bfloat16* u_out, T* h_out, T* out,
                                   int n, int D, int M, cudaStream_t stream) {
  const size_t smem = row_tile_smem_bytes<T>((D + kDepth - 1) / kDepth);
  cudaError_t err = cudaFuncSetAttribute(
      row_tile_kernel<T, kBwd, kRagged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = 16 * kRowMTiles;
  const int groups = (D + kChunk - 1) / kChunk;
  const dim3 grid((n + kRows - 1) / kRows, (groups + kMaxNg - 1) / kMaxNg);
  row_tile_kernel<T, kBwd, kRagged><<<grid, kRowThreads, smem, stream>>>(
      a, wa, wb, b1, b2, u_in, u_out, h_out, out, n, D, M);
  return cudaGetLastError();
}

// Launch the row-tile kernel on `stream`: one block per 16 rows and slice
// of at most kMaxNg output groups; `ragged` (see aligned()) picks the
// element-wise instantiation.
template <typename T, bool kBwd>
cudaError_t launch_row_tile(const T* a, const T* wa, const T* wb,
                            const float* b1, const float* b2,
                            const __nv_bfloat16* u_in,
                            __nv_bfloat16* u_out, T* h_out, T* out, int n,
                            int D, int M, bool ragged, cudaStream_t stream) {
  return ragged ? launch_row_tile_kernel<T, kBwd, true>(
                      a, wa, wb, b1, b2, u_in, u_out, h_out, out, n, D, M,
                      stream)
                : launch_row_tile_kernel<T, kBwd, false>(
                      a, wa, wb, b1, b2, u_in, u_out, h_out, out, n, D, M,
                      stream);
}

// The largest D whose staged rows fit the row-tile kernel's shared memory:
// 1,728 in fp32.
template <typename T>
int max_d() {
  int nk = 1;
  while (row_tile_smem_bytes<T>(nk + 1) <= kMaxSmem) ++nk;
  return nk * kDepth;
}

// Shapes every fused-MLP entry point takes: n, D and M >= 1.
inline bool dims_ok(int n, int D, int M) {
  return n >= 1 && D >= 1 && M >= 1;
}

// Whether a call takes the 16-byte route (cp.async vectors in fp32, TMA in
// bf16): D and M multiples of 8 and every pointer 16-byte aligned. Other
// calls take the ragged route, element by element at the edges of rows.
inline bool aligned(int D, int M, std::initializer_list<const void*> ptrs) {
  if (D % 8 || M % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// ... and, for the row-tile kernel, D up to max_d.
template <typename T>
bool shapes_ok(int n, int D, int M) {
  return dims_ok(n, D, M) && D <= max_d<T>();
}

}  // namespace mlp
