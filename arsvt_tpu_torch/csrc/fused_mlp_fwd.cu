// Fused tanh-GELU MLP forward for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/fused_mlp.py::_fwd_kernel (called through
// _fwd). For x (n, D), w1 (D, M), w2 (M, D) in T (float32 or bfloat16) and
// fp32 biases it computes with the TPU kernel's rounding points:
//   u = x w1 (fp32 sums) + b1, written as bf16 (n, M) whatever T;
//   h = gelu_tanh(u) from the fp32 u, rounded to T;
//   out = h w2 (fp32 sums) + b2, cast to T.
// h never reaches device memory.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 4*n*D*M FLOPs against
// the bytes of x, w1, w2 and out in T and u in bf16. At ViT-B (D=768,
// M=3072) and n = 32*197 = 6,304 rows that is 59.5 GFLOP, 60.2 us, against
// 9.7 + 4.7 + 4.7 + 9.7 + 38.7 = 67.5 MB, 20.2 us: bound by operations.
//
// Design: mlp_tile.cuh's row-tile kernel. One block of 8 warps owns 48
// rows (16 in fp32) and all D output columns (D > 768: one of
// ceil(D / 768) equal slices of them, each block of a row tile redoing
// u for its slice's product), keeps its rows of x in
// shared memory and walks M in chunks of 128. Per chunk it computes u for
// its rows x 128 tile over D, writes u as bf16, puts gelu(u) in T into
// shared memory, and adds h w2 for the chunk into an fp32 accumulator of
// rows x D held in registers (144 a thread at D = 768 in bf16): the TPU
// kernel's carry of the accumulator across M blocks becomes a loop in the
// block, and no block depends on another. w1 and w2 stream through a ring
// of 64 x 128 tiles (6 slots in bf16, 3 in fp32) copied as they lie
// (cp.async). Each warp computes 16 columns of every tile, so each A
// fragment it loads feeds two tensor-core mma.sync m16n8k16 (fragments by
// ldmatrix, .trans for w1 and w2); fp32 products run as the same warp
// tiles on the CUDA cores. No wgmma or TMA yet.
//
// C interface: arsvt_fused_mlp_fwd launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take); arsvt_fused_mlp_max_d gives the largest D
// that both fused-MLP kernels take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tile.cuh"

namespace {

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, void* u, int n,
                   int D, int M, cudaStream_t stream) {
  return mlp::launch_row_tile<T, false>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<const float*>(b1),
      static_cast<const float*>(b2), nullptr,
      static_cast<__nv_bfloat16*>(u), nullptr, static_cast<T*>(out), n, D, M,
      stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2 and out). Pointers are
// device pointers, 16-byte aligned, to contiguous row-major tensors: x
// (n, D), w1 (D, M), w2 (M, D), out (n, D), u (n, M) bfloat16, b1 (M,) and
// b2 (D,) float32.
extern "C" int arsvt_fused_mlp_fwd(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, void* u, int n,
                                   int D, int M, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (!mlp::shapes_ok<float>(n, D, M)) return (int)cudaErrorInvalidValue;
      return (int)launch<float>(x, w1, b1, w2, b2, out, u, n, D, M, st);
    case 1:
      if (!mlp::shapes_ok<__nv_bfloat16>(n, D, M))
        return (int)cudaErrorInvalidValue;
      return (int)launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, u, n, D, M,
                                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype as above; 0 for a dtype the kernels do not take.
extern "C" int arsvt_fused_mlp_max_d(int dtype) {
  switch (dtype) {
    case 0:
      return mlp::max_d<float>();
    case 1:
      return mlp::max_d<__nv_bfloat16>();
    default:
      return 0;
  }
}
