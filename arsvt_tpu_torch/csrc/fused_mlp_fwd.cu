// Fused tanh-GELU MLP forward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/fused_mlp.py::_fwd_kernel (called through
// _fwd). For x (n, D), w1 (D, M), w2 (M, D) in T (float32 or bfloat16) and
// fp32 biases it computes with the TPU kernel's rounding points:
//   u = x w1 (fp32 sums) + b1, written as bf16 (n, M) whatever T;
//   h = gelu_tanh(u) from the fp32 u, rounded to T;
//   out = h w2 (fp32 sums) + b2, cast to T.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 4*n*D*M FLOPs against
// the bytes of x, w1, w2 and out in T and u in bf16. At ViT-B (D=768,
// M=3072) and n = 32*197 = 6,304 rows that is 59.5 GFLOP, 60.2 us, against
// 9.7 + 4.7 + 4.7 + 9.7 + 38.7 = 67.5 MB, 20.2 us: bound by operations.
//
// Design, bf16: mlp_gemm.cuh's wgmma/TMA GEMM, two launches: (1) u and h
// over (n / 128) x (M / 128) tiles, K = D, the epilogue adding b1, storing
// u in bf16 and h = gelu(u) in bf16 into a scratch the caller allocates;
// (2) out = h w2 + b2 over (n / 128) x (D / 128) tiles, K = M. h makes one
// round trip through device memory (2 x n*M*2 bytes, 77 MB at ViT-B: 23 us
// at 3.35 TB/s against the 60 us bound) where the TPU kernel keeps it in
// VMEM; in return each product is a grid of hundreds of 128 x 128 tiles
// on wgmma, no block redoes u, and nothing bounds D. h is rounded where
// the TPU kernel rounds it, to T before the second product.
//
// fp32 (the parity path): mlp_tile.cuh's row-tile kernel. One block of 8
// warps owns 16 rows and all D output columns (D > 768: one of
// ceil(D / 768) equal slices of them, each block of a row tile redoing u
// for its slice's product), keeps its rows of x in shared memory and walks
// M in chunks of 128: u for its rows x 128, written as bf16, gelu(u) into
// shared memory, and h w2 for the chunk added into an fp32 accumulator of
// rows x D in registers; w1 and w2 stream through a ring of 64 x 128
// tiles (cp.async), multiplied on the CUDA cores with sequential FMAs.
//
// C interface: arsvt_fused_mlp_fwd launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take); arsvt_fused_mlp_max_d gives the largest D
// that both fused-MLP kernels take in a dtype; arsvt_fused_mlp_version
// names this interface (2: the forward takes the h scratch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_gemm.cuh"
#include "mlp_tile.cuh"

namespace {

using mlpg::kFwdOut;
using mlpg::kFwdU;
using mlpg::launch;
using mlpg::Params;
using mlpg::set_maps;

// bf16: u and h, then out. h is scratch (n, M) the caller allocates.
cudaError_t forward_bf16(const void* x, const void* w1, const float* b1,
                         const void* w2, const float* b2, void* out, void* u,
                         void* h, int n, int D, int M, bool ragged,
                         cudaStream_t stream) {
  Params p = {};
  p.n = n, p.D = D, p.M = M;
  cudaError_t err = set_maps(&p, {{x, n, D}, {w1, D, M}, {u, n, M},
                                   {h, n, M}}, ragged);
  if (err != cudaSuccess) return err;
  p.b1 = b1;
  err = launch<kFwdU>(p, ragged, stream);
  if (err != cudaSuccess) return err;
  Params q = {};
  q.n = n, q.D = D, q.M = M;
  err = set_maps(&q, {{h, n, M}, {w2, M, D}, {out, n, D}}, ragged);
  if (err != cudaSuccess) return err;
  q.b2 = b2;
  return launch<kFwdOut>(q, ragged, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, out and h). Pointers are
// device pointers, aligned to their element, to contiguous row-major
// tensors (D and M multiples of 8 with every pointer 16-byte aligned take
// the 16-byte route, other calls the ragged one): x
// (n, D), w1 (D, M), w2 (M, D), out (n, D), u (n, M) bfloat16, h (n, M)
// scratch (bfloat16 only; may be null in float32), b1 (M,) and b2 (D,)
// float32.
extern "C" int arsvt_fused_mlp_fwd(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, void* u,
                                   void* h, int n, int D, int M, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  const bool ragged = !mlp::aligned(D, M, {x, w1, w2, out, u, h});
  switch (dtype) {
    case 0:
      if (!mlp::shapes_ok<float>(n, D, M)) return (int)cudaErrorInvalidValue;
      return (int)mlp::launch_row_tile<float, false>(
          static_cast<const float*>(x), static_cast<const float*>(w1),
          static_cast<const float*>(w2), b1f, b2f, nullptr,
          static_cast<__nv_bfloat16*>(u), nullptr, static_cast<float*>(out),
          n, D, M, ragged, st);
    case 1:
      if (!mlp::dims_ok(n, D, M) || h == nullptr)
        return (int)cudaErrorInvalidValue;
      return (int)forward_bf16(x, w1, b1f, w2, b2f, out, u, h, n, D, M,
                               ragged, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The largest D the kernels take in dtype: the row-tile kernel's bound in
// float32; 0 in bfloat16, where D has no such bound; -1 for a dtype the
// kernels do not take.
extern "C" int arsvt_fused_mlp_max_d(int dtype) {
  switch (dtype) {
    case 0:
      return mlp::max_d<float>();
    case 1:
      return 0;
    default:
      return -1;
  }
}

extern "C" int arsvt_fused_mlp_version() { return 2; }
