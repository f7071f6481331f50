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
// far below the card's rate, so the kernel has to keep enough bytes in
// flight and waste none.
//
// Design: a persistent grid of a few blocks per SM (the occupancy rule,
// arsvt_fused_adamw_blocks_per_sm times the SMs, sized by the host). The
// host (ops/fused_adamw.py::plan_chunks) cuts every leaf into chunks of
// about a 32nd of a block's share of the elements, a whole number of the
// block's unrolled rounds (8 K on ViT-B's leaves), and keeps one row per
// chunk on the card: its leaf, first element, length, scalar head and
// flags (whether the four operands share their 16-byte phase, whether
// weight decay applies). That table depends on the leaves' sizes and
// alignment alone and is uploaded once; a call
// sends only the leaves' (g, m, v, p) pointers, 32 bytes a leaf (the
// gradients are new tensors every step). The blocks walk the rows with
// the grid's stride, each loading its next row while it works on the
// current one: no block searches for its leaf, a 768-element LayerNorm
// scale is one short row, not a block padded to a fixed size, the blocks
// at work stream through one window of the leaves, and the last round of
// chunks, when fewer blocks are left to keep bytes in flight, is a 32nd
// of the work. Within a chunk the interior moves as float4: each thread
// loads four float4 of each of g, m, v and p (sixteen 16-byte loads in
// flight) before any arithmetic, with streaming hints (ld.global.cs,
// st.global.cs), since every byte is touched once. A chunk whose pointers
// are only 4-byte aligned takes a scalar head up to the first 16-byte
// boundary (the host puts the boundary of every later chunk of the leaf
// on one), and the last elements past the float4s a scalar tail; a leaf
// whose four operands lie at different 16-byte phases runs scalar
// throughout. The TPU kernel's size and lane rule for picking leaves
// (fused_adamw.py:113-118) only routed launches there and changes no
// number, so it is dropped.
//
// C interface: arsvt_fused_adamw launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take); arsvt_fused_adamw_blocks_per_sm gives the
// occupancy the host sizes the grid by, arsvt_fused_adamw_chunk_quantum
// the elements of one round its chunks are whole numbers of;
// arsvt_fused_adamw_version names this interface (2: a chunk table and
// the leaves' pointers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4 of each operand in flight a thread

// One row of the chunk table, as the wrapper packs it: three int64 words.
struct Chunk {
  int64_t start;  // the chunk's first element in its leaf
  int32_t leaf;
  int32_t n;      // elements
  int32_t head;   // scalar elements before the float4 interior
  int32_t flags;  // kVec | kDecayed
};
static_assert(sizeof(Chunk) == 24, "table rows are three int64 words");
constexpr int32_t kVec = 1;      // the interior moves as float4
constexpr int32_t kDecayed = 2;  // weight decay applies

// A leaf's operands, as a call sends them: four int64 words.
struct Leaf {
  int64_t g, m, v, p;  // device pointers
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

struct Scalars {
  float gscale, bc1, bc2, step;
};

// One element, in the TPU kernel's order, each operation rounded once.
__device__ __forceinline__ void update(float g, float& m, float& v, float& p,
                                       const Scalars& s, const Hyper& h,
                                       bool decayed) {
  const float gi = __fmul_rn(g, s.gscale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, gi));
  v = __fadd_rn(__fmul_rn(h.b2, v),
                __fmul_rn(h.one_minus_b2, __fmul_rn(gi, gi)));
  float upd = __fdiv_rn(__fdiv_rn(m, s.bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps));
  if (decayed) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.step, upd));
}

__device__ __forceinline__ void update4(const float4& g, float4& m, float4& v,
                                        float4& p, const Scalars& s,
                                        const Hyper& h, bool decayed) {
  update(g.x, m.x, v.x, p.x, s, h, decayed);
  update(g.y, m.y, v.y, p.y, s, h, decayed);
  update(g.z, m.z, v.z, p.z, s, h, decayed);
  update(g.w, m.w, v.w, p.w, s, h, decayed);
}

// Elements [lo, hi) of a chunk, one a thread at a time.
__device__ __forceinline__ void scalar_run(const float* __restrict__ g,
                                           float* __restrict__ m,
                                           float* __restrict__ v,
                                           float* __restrict__ p, int lo,
                                           int hi, const Scalars& s,
                                           const Hyper& h, bool decayed) {
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    float mi = __ldcs(m + i), vi = __ldcs(v + i), pi = __ldcs(p + i);
    update(__ldcs(g + i), mi, vi, pi, s, h, decayed);
    __stcs(m + i, mi);
    __stcs(v + i, vi);
    __stcs(p + i, pi);
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_adamw_kernel(const Chunk* __restrict__ chunks, int n_chunks,
                       const Leaf* __restrict__ leaves,
                       const float* __restrict__ scalars, Hyper h) {
  const Scalars s{scalars[0], scalars[1], scalars[2], scalars[3]};
  Chunk next = chunks[blockIdx.x];
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = next;
    if (c + gridDim.x < n_chunks) next = chunks[c + gridDim.x];
    const Leaf lf = leaves[ch.leaf];
    const float* __restrict__ g = reinterpret_cast<const float*>(lf.g) +
                                  ch.start;
    float* __restrict__ m = reinterpret_cast<float*>(lf.m) + ch.start;
    float* __restrict__ v = reinterpret_cast<float*>(lf.v) + ch.start;
    float* __restrict__ p = reinterpret_cast<float*>(lf.p) + ch.start;
    const bool decayed = ch.flags & kDecayed;
    if (!(ch.flags & kVec)) {
      scalar_run(g, m, v, p, 0, ch.n, s, h, decayed);
      continue;
    }
    scalar_run(g, m, v, p, 0, ch.head, s, h, decayed);
    const int n4 = (ch.n - ch.head) / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g + ch.head);
    float4* m4 = reinterpret_cast<float4*>(m + ch.head);
    float4* v4 = reinterpret_cast<float4*>(v + ch.head);
    float4* p4 = reinterpret_cast<float4*>(p + ch.head);
    int i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < n4; i += kUnroll * kThreads) {
      float4 gr[kUnroll], mr[kUnroll], vr[kUnroll], pr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + u * kThreads;
        gr[u] = __ldcs(g4 + j);
        mr[u] = __ldcs(m4 + j);
        vr[u] = __ldcs(v4 + j);
        pr[u] = __ldcs(p4 + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + u * kThreads;
        update4(gr[u], mr[u], vr[u], pr[u], s, h, decayed);
        __stcs(m4 + j, mr[u]);
        __stcs(v4 + j, vr[u]);
        __stcs(p4 + j, pr[u]);
      }
    }
    for (; i < n4; i += kThreads) {
      float4 mr = __ldcs(m4 + i), vr = __ldcs(v4 + i), pr = __ldcs(p4 + i);
      update4(__ldcs(g4 + i), mr, vr, pr, s, h, decayed);
      __stcs(m4 + i, mr);
      __stcs(v4 + i, vr);
      __stcs(p4 + i, pr);
    }
    scalar_run(g, m, v, p, ch.head + 4 * n4, ch.n, s, h, decayed);
  }
}

}  // namespace

// chunks: device pointer to n_chunks rows of three int64 words (see
// Chunk); leaves: device pointer to one Leaf per leaf the rows name; grid:
// blocks to launch (the host's occupancy rule, at most n_chunks).
// scalars: device fp32[4] = [gscale, bc1, bc2, step].
extern "C" int arsvt_fused_adamw(const void* chunks, int n_chunks,
                                 const void* leaves, int grid,
                                 const void* scalars, float b1, float b2,
                                 float eps, float wd, float one_minus_b1,
                                 float one_minus_b2, void* stream) {
  if (n_chunks < 1 || grid < 1 || grid > n_chunks)
    return (int)cudaErrorInvalidValue;
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  fused_adamw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Chunk*>(chunks), n_chunks,
      static_cast<const Leaf*>(leaves), static_cast<const float*>(scalars),
      h);
  return (int)cudaGetLastError();
}

// Blocks of the kernel one SM holds at once (cudaOccupancy...), or -1 on
// an error.
extern "C" int arsvt_fused_adamw_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_adamw_kernel, kThreads, 0);
  return err == cudaSuccess ? blocks : -1;
}

// Elements a block's threads move in one unrolled round (a multiple of 4):
// the host makes a chunk a whole number of them, so that no chunk ends in
// rounds of one float4 a thread.
extern "C" int arsvt_fused_adamw_chunk_quantum() {
  return 4 * kThreads * kUnroll;
}

extern "C" int arsvt_fused_adamw_version() { return 2; }
