// One-pass AdamW over every fp32 parameter leaf, in one launch, for
// Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/fused_adamw.py::_adamw_kernel (called
// through _adamw_leaf_pallas once per leaf). Per element, in place:
//   g = g * gscale
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * (g * g)
//   upd = (m / bc1) / (sqrt(v / bc2) + eps)   [+ wd * p for decayed leaves]
//   p = p - step * upd
// with [gscale, bc1, bc2, step] read from a device fp32[4], so a step
// needs no host sync. Every operation is written with an _rn intrinsic, so
// nvcc contracts nothing into an FMA and each rounds as the plain PyTorch
// version's separate operations do.
//
// Bound on an H100 SXM (3.35 TB/s): 16 bytes read (g, m, v, p) and 12
// written (m, v, p) per parameter; ViT-B/16's 85.8 M parameters move
// 2.40 GB, 0.72 ms. The arithmetic (about 15 operations a parameter) is
// far below the card's rate.
//
// Design: the leaves are described by a device table of (g, m, v, p
// pointers, numel, first block, decayed), one row per leaf. Each leaf is
// cut into blocks of kElemsPerBlock elements; block i finds its leaf by a
// binary search over the first-block column and walks its elements with
// 256 threads, neighbouring threads on neighbouring elements (coalesced
// 4-byte accesses). One launch covers every leaf of every size: the
// TPU kernel's size and lane rule for picking leaves
// (fused_adamw.py:113-118) only routed launches there and changes no
// number, so it is dropped.
//
// C interface: arsvt_fused_adamw launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElemsPerBlock = kThreads * 8;

// One row of the leaf table, as the wrapper packs it: eight int64 values.
struct Leaf {
  int64_t g, m, v, p;  // device pointers
  int64_t numel;
  int64_t first_block;
  int64_t decayed;
  int64_t unused;
};
static_assert(sizeof(Leaf) == 64, "table rows are eight int64 values");

__global__ void __launch_bounds__(kThreads)
    fused_adamw_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                       const float* __restrict__ scalars, float b1,
                       float one_minus_b1, float b2, float one_minus_b2,
                       float eps, float wd) {
  const int64_t block = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;  // last leaf whose first block <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (leaves[mid].first_block <= block)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf leaf = leaves[lo];
  float* __restrict__ g = reinterpret_cast<float*>(leaf.g);
  float* __restrict__ m = reinterpret_cast<float*>(leaf.m);
  float* __restrict__ v = reinterpret_cast<float*>(leaf.v);
  float* __restrict__ p = reinterpret_cast<float*>(leaf.p);
  const float gscale = scalars[0];
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];
  const float step = scalars[3];
  const bool decayed = leaf.decayed != 0;

  const int64_t begin = (block - leaf.first_block) * kElemsPerBlock;
  const int64_t stop = begin + kElemsPerBlock;
  const int64_t end = stop < leaf.numel ? stop : leaf.numel;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const float gi = __fmul_rn(g[i], gscale);
    const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_minus_b1, gi));
    const float vi = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(one_minus_b2, __fmul_rn(gi, gi)));
    float upd = __fdiv_rn(__fdiv_rn(mi, bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), eps));
    const float pi = p[i];
    if (decayed) upd = __fadd_rn(upd, __fmul_rn(wd, pi));
    p[i] = __fsub_rn(pi, __fmul_rn(step, upd));
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// table: device pointer to n_leaves rows of eight int64 values (see Leaf);
// the rows are ordered by first_block, which starts at 0 and advances by
// ceil(numel / kElemsPerBlock) per leaf; total_blocks is the sum.
// scalars: device fp32[4] = [gscale, bc1, bc2, step].
extern "C" int arsvt_fused_adamw(const void* table, int n_leaves,
                                 long long total_blocks, const void* scalars,
                                 float b1, float b2, float eps, float wd,
                                 float one_minus_b1, float one_minus_b2,
                                 void* stream) {
  if (n_leaves < 1 || total_blocks < 1 || total_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  fused_adamw_kernel<<<(unsigned)total_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), n_leaves,
      static_cast<const float*>(scalars), b1, one_minus_b1, b2, one_minus_b2,
      eps, wd);
  return (int)cudaGetLastError();
}

// Elements one block covers, so the wrapper lays out first_block the same
// way.
extern "C" int arsvt_fused_adamw_elems_per_block() { return kElemsPerBlock; }
