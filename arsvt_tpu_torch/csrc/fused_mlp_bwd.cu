// Fused tanh-GELU MLP backward for Hopper (sm_90a): two launches.
//
// Replaces arsvt_tpu/ops/pallas/fused_mlp.py::_bwd_dx_kernel and
// ::_bwd_dw_kernel (both called through _bwd). From x (n, D), the saved
// bf16 u (n, M), w1 (D, M), w2 (M, D) and dO (n, D) in T (float32 or
// bfloat16) it computes with the TPU kernels' rounding points:
//   launch 1 (dx/du): dh = dO w2^T (fp32 sums), du = dh * gelu'(u) with u
//     read as bf16 and gelu' in fp32, du rounded to bf16 and written
//     (n, M), dx = du_bf16 w1^T (fp32 sums), cast to T; beside du it
//     writes h = gelu(u) (from the same tanh as gelu'), rounded to T;
//   launch 2 (dw): dw1 = x^T du_bf16, db1 = sum over rows of du_bf16 and
//     dw2 = h^T dO; all three summed and written in fp32.
// db2 = sum(dO) is left to the caller, as in the JAX package.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 8*n*D*M FLOPs (four
// products) against the bytes of x, u, w1, w2 and dO read and dx, dw1, db1
// and dw2 written. At ViT-B (D=768, M=3072) and n = 6,304 rows: 119 GFLOP,
// 120.4 us, against 96 MB, 28.7 us: bound by operations.
//
// Design, bf16: mlp_gemm.cuh's wgmma/TMA GEMM, two launches:
//   1. dh = dO w2^T over (n / 128) x (M / 128) tiles, K = D, w2 read
//      K-major as it lies; the epilogue reads u (prefetched into L2) and
//      writes du and h.
//   2. one set of tiles over three products that read only launch 1's du
//      and h and the inputs: dw1 = x^T du (D x M), dw2 = h^T dO (M x D),
//      both over K = n with x, du, h and dO read MN-major as they lie, and
//      dx = du w1^T (n x D, K = M); 128 x 128 tiles, the dw tiles first.
//      The tiles of dw1's first row also sum db1 from the du tiles they
//      stage. The TPU grid's carry of the dw accumulators across row
//      blocks becomes the K loop of one tile; at ViT-B 144 + 144 dw tiles
//      and 300 dx tiles keep the 132 SMs busy without splitting K.
//   The TPU kernel evaluates gelu(u) in its dw step; here launch 1 writes
//   h once, so the dw2 tiles do not each evaluate it.
// fp32 (the parity path):
//   1. mlp_tile.cuh's row-tile kernel with A = dO, W_a = w2^T, W_b = w1^T:
//      one block of 8 warps per 16 rows keeps its rows of dO in shared
//      memory, walks M in chunks of 128, forms du for its chunk (stored as
//      bf16, and kept in shared memory as the left operand) and
//      accumulates du w1^T for all D columns in registers (D > 768: for its
//      slice of ceil(D / 768) equal slices); w2 and w1 stream through a
//      ring of 128 x 64 tiles.
//   2. dw_kernel: one block of 8 warps per 64 x 64 tile of dw1 (blockIdx.z
//      = 0) or of dw2 (blockIdx.z = 1) walks all n rows in steps of 32,
//      copying the rows of x and du (or h and dO) as they lie through a
//      4-step cp.async ring and reading them as transposed operands (a
//      warp tile of 16 x 32 on the CUDA cores, warp_tile.cuh::warp_mma).
//      The dw1 blocks of the first D tile also sum db1 for their 64
//      columns, row by row.
// No atomics, no split over rows: every sum has one owner and a fixed
// order, so the result is deterministic. The second launch reads the du
// and h that the first wrote, on the same stream.
//
// C interface: arsvt_fused_mlp_bwd launches both kernels on the given
// stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_gemm.cuh"
#include "mlp_tile.cuh"

namespace {

using namespace mlp;

constexpr int kDwThreads = 256;
constexpr int kDwTile = 64;    // rows and columns of a dw1 or dw2 tile
constexpr int kDwK = 32;       // rows of n per step
constexpr int kDwStages = 4;   // steps in flight
constexpr int kDwLd = kDwTile + 8;
constexpr int kDwSlot = kDwK * kDwLd;  // elements of one staged operand

template <typename T>
size_t dw_smem_bytes() {
  return 2 * kDwStages * kDwSlot * sizeof(T);
}

template <typename T, bool kRagged>
__global__ void __launch_bounds__(kDwThreads)
    dw_kernel(const T* __restrict__ x, const T* __restrict__ h,
              const __nv_bfloat16* __restrict__ du,
              const T* __restrict__ dout, float* __restrict__ dw1,
              float* __restrict__ db1, float* __restrict__ dw2, int n, int D,
              int M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Per step, 32 rows of each operand as they lie in device memory
  // ([row][column]): A, x (dw1) or h (dw2); B, du (dw1) or dO (dw2). du
  // arrives as bf16 and is widened in its slot.
  T* As_ring = reinterpret_cast<T*>(smem_raw);
  T* Bs_ring = As_ring + kDwStages * kDwSlot;

  const bool second = blockIdx.z == 1;  // dw2 = h^T dO; else dw1 = x^T du
  const int c0 = blockIdx.x * kDwTile;  // M offset
  const int d0 = blockIdx.y * kDwTile;  // D offset
  const bool with_db1 = !second && blockIdx.y == 0;
  const int steps = (n + kDwK - 1) / kDwK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3;   // rows wm*16 .. wm*16+15 of the tile
  const int wn = warp >> 2;  // columns wn*32 .. wn*32+31

  auto copy = [](auto* dst, auto* src, int64_t ld, int rvalid, int cvalid) {
    if constexpr (kRagged)
      copy_tile_ragged<kDwThreads>(dst, kDwLd, src, ld, kDwK, kDwTile, rvalid,
                                   cvalid);
    else
      copy_tile_async<kDwThreads>(dst, kDwLd, src, ld, kDwK, kDwTile, rvalid,
                                  cvalid);
  };
  // one commit group per step, empty past the end (ragged du is copied
  // element by element and is there when the copy returns; its slot was
  // freed by the barrier before the enqueue)
  auto enqueue = [&](int s) {
    if (s < steps) {
      const int r0 = s * kDwK;
      T* as = As_ring + (s % kDwStages) * kDwSlot;
      T* bs = Bs_ring + (s % kDwStages) * kDwSlot;
      if (second) {
        copy(as, h + (int64_t)r0 * M + c0, M, n - r0, M - c0);
        copy(bs, dout + (int64_t)r0 * D + d0, D, n - r0, D - d0);
      } else {
        copy(as, x + (int64_t)r0 * D + d0, D, n - r0, D - d0);
        copy(reinterpret_cast<__nv_bfloat16*>(bs),
             du + (int64_t)r0 * M + c0, M, n - r0, M - c0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) enqueue(s);

  float acc[1][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
  float bias_sum = 0.f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    enqueue(s + kDwStages - 1);
    const T* As = As_ring + (s % kDwStages) * kDwSlot;
    T* Bs = Bs_ring + (s % kDwStages) * kDwSlot;
    if (!second) {  // widen du in place: 8 values a thread
      static_assert(kDwK * kDwTile == 8 * kDwThreads, "one vector a thread");
      const int k = threadIdx.x / (kDwTile / 8);
      const int c = threadIdx.x % (kDwTile / 8) * 8;
      float v[8];
      load8(reinterpret_cast<const __nv_bfloat16*>(Bs) + k * kDwLd + c, v);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 8; ++e) Bs[k * kDwLd + c + e] = from_float<T>(v[e]);
      __syncthreads();
    }
    if (with_db1 && threadIdx.x < kDwTile)
      for (int k = 0; k < kDwK; ++k)
        bias_sum += to_float(Bs[k * kDwLd + threadIdx.x]);
    // A (k = row, m = d or c) and B (k = row, n = c or d), both [k][.]
    warp_mma<1, 4, kDwK, true, true>(acc, As + wm * 16, kDwLd,
                                     Bs + wn * 32, kDwLd);
  }
  cp_async_wait<0>();  // the groups still open are empty

  // rows of the tile run over D (dw1) or M (dw2), columns over the other
  const int i_lim = second ? M - c0 : D - d0;
  const int j_lim = second ? D - d0 : M - c0;
  float* dst = second ? dw2 + (int64_t)c0 * D + d0
                      : dw1 + (int64_t)d0 * M + c0;
  const int ld = second ? D : M;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = wm * 16 + g + 8 * p;
      const int jc = wn * 32 + j * 8 + 2 * t;
      if (i >= i_lim || jc >= j_lim) continue;
      float* at = dst + (int64_t)i * ld + jc;
      if (!kRagged) {  // the limits are even
        store2(at, acc[0][j][2 * p], acc[0][j][2 * p + 1]);
      } else {
        at[0] = acc[0][j][2 * p];
        if (jc + 1 < j_lim) at[1] = acc[0][j][2 * p + 1];
      }
    }
  if (with_db1 && threadIdx.x < kDwTile && c0 + (int)threadIdx.x < M)
    db1[c0 + threadIdx.x] = bias_sum;
}

template <bool kRagged>
cudaError_t launch_dw(const float* x, const float* h,
                      const __nv_bfloat16* du, const float* dout, float* dw1,
                      float* db1, float* dw2, int n, int D, int M,
                      cudaStream_t stream) {
  const size_t smem = dw_smem_bytes<float>();
  const cudaError_t err = cudaFuncSetAttribute(
      dw_kernel<float, kRagged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kDwTile - 1) / kDwTile, (D + kDwTile - 1) / kDwTile,
                  2);
  dw_kernel<float, kRagged><<<grid, kDwThreads, smem, stream>>>(
      x, h, du, dout, dw1, db1, dw2, n, D, M);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const float* x, const __nv_bfloat16* u,
                        const float* w1, const float* w2, const float* dout,
                        float* dx, __nv_bfloat16* du, float* h, float* dw1,
                        float* db1, float* dw2, int n, int D, int M,
                        bool ragged, cudaStream_t stream) {
  cudaError_t err = launch_row_tile<float, true>(
      dout, w2, w1, nullptr, nullptr, u, du, h, dx, n, D, M, ragged, stream);
  if (err != cudaSuccess) return err;
  return ragged ? launch_dw<true>(x, h, du, dout, dw1, db1, dw2, n, D, M,
                                  stream)
                : launch_dw<false>(x, h, du, dout, dw1, db1, dw2, n, D, M,
                                   stream);
}

// bf16: du and h, then dw1 with db1, dw2 and dx. du and h are scratch
// (n, M) the caller allocates.
cudaError_t backward_bf16(const void* x, const void* u, const void* w1,
                          const void* w2, const void* dout, void* dx,
                          void* du, void* h, float* dw1, float* db1,
                          float* dw2, int n, int D, int M, bool ragged,
                          cudaStream_t stream) {
  using mlpg::kBwdDu;
  using mlpg::kBwdGrads;
  using mlpg::launch;
  using mlpg::Params;
  using mlpg::set_maps;
  Params p = {};
  p.n = n, p.D = D, p.M = M;
  cudaError_t err = set_maps(&p, {{dout, n, D}, {w2, M, D}, {du, n, M},
                                   {h, n, M}}, ragged);
  if (err != cudaSuccess) return err;
  p.u_in = static_cast<const __nv_bfloat16*>(u);
  err = launch<kBwdDu>(p, ragged, stream);
  if (err != cudaSuccess) return err;
  Params q = {};
  q.n = n, q.D = D, q.M = M;
  err = set_maps(&q, {{du, n, M}, {w1, D, M}, {x, n, D}, {h, n, M},
                      {dout, n, D}, {dx, n, D}}, ragged);
  if (err != cudaSuccess) return err;
  q.dw1 = dw1, q.db1 = db1, q.dw2 = dw2;
  return launch<kBwdGrads>(q, ragged, stream);
}


}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, dout, dx and h). Pointers
// are device pointers, aligned to their element, to contiguous row-major
// tensors (D and M multiples of 8 with every pointer 16-byte aligned take
// the 16-byte route, other calls the ragged one):
// x, dout and dx (n, D), u and du (n, M) bfloat16, h (n, M) (du and h are
// scratch written by the first launch and read by the second), w1 (D, M),
// w2 (M, D), dw1 (D, M), db1 (M,) and dw2 (M, D) float32.
extern "C" int arsvt_fused_mlp_bwd(const void* x, const void* u,
                                   const void* w1, const void* w2,
                                   const void* dout, void* dx, void* du,
                                   void* h, void* dw1, void* db1, void* dw2,
                                   int n, int D, int M, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dw1f = static_cast<float*>(dw1);
  float* db1f = static_cast<float*>(db1);
  float* dw2f = static_cast<float*>(dw2);
  const bool ragged = !mlp::aligned(D, M, {x, u, w1, w2, dout, dx, du, h,
                                           dw1, dw2});
  switch (dtype) {
    case 0:
      if (!mlp::shapes_ok<float>(n, D, M)) return (int)cudaErrorInvalidValue;
      return (int)launch_fp32(
          static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(u),
          static_cast<const float*>(w1), static_cast<const float*>(w2),
          static_cast<const float*>(dout), static_cast<float*>(dx),
          static_cast<__nv_bfloat16*>(du), static_cast<float*>(h), dw1f,
          db1f, dw2f, n, D, M, ragged, st);
    case 1:
      if (!mlp::dims_ok(n, D, M)) return (int)cudaErrorInvalidValue;
      return (int)backward_bf16(x, u, w1, w2, dout, dx, du, h, dw1f, db1f,
                                dw2f, n, D, M, ragged, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
