// The fused MLP's bf16 kernels (fused_mlp_fwd.cu, fused_mlp_bwd.cu): one
// warp-specialised GEMM body on Hopper's wgmma, fed by TMA, with one
// epilogue per use. fp32 stays on mlp_tile.cuh's row-tile kernel.
//
// Each output tile is 128 x 128, C = A B over the full depth K in steps of
// 64. A persistent block of 384 threads per SM walks the tiles b, b + G,
// b + 2G, ... (G blocks), handing them in turn to its two consumer
// warpgroups ("ping-pong"):
//   - warpgroup 2 is the producer: it gives up registers (setmaxnreg.dec
//     to 40); lane 0 of its warp c issues the TMA loads of consumer c's
//     tiles, each step's A (128 x 64) and B (64 x 128) into consumer c's
//     ring of kStages slots (32 KB each), a slot guarded by a "full"
//     mbarrier (TMA bytes landed) and an "empty" one (the consumer's four
//     warps are done with it);
//   - warpgroups 0 and 1 are the consumers: they take registers
//     (setmaxnreg.inc) and each computes its own tiles, per step eight
//     wgmma m64n128k16 (two 64-row halves times four 16-deep steps),
//     keeping one step's MMAs in flight while it waits for the next slot;
//     the 128 x 128 fp32 accumulator is 128 registers a thread. An order
//     barrier makes the two take turns at the tensor cores: a consumer's
//     MMAs run while the other runs its epilogue, so the epilogue's GELU,
//     loads and stores hide behind tensor work, and the producer fills the
//     ring for the next tile meanwhile. The epilogue works on the
//     accumulator in wgmma's register layout, a 64 x 64 block at a time:
//     each bf16 output of the block goes into a staging box (the TMA box
//     layout), which one thread stores with TMA, full 128-byte lines
//     instead of 4-byte pieces. The tile's bias is loaded into one
//     register a thread before the MMAs and shared through shared memory
//     (a load per element in the epilogue cost a quarter of its time).
// ptxas gives the whole kernel one register count, the launch bound's 168
// (65,536 / 384); a block of a full producer warpgroup and one consumer
// would need 216 and leave one consumer a SM, and a lone producer warp
// cannot give its registers up (setmaxnreg acts on whole warpgroups).
// Ragged edges: TMA fills the parts of a box past the tensor with zeros,
// which add nothing to the sums, and a TMA store writes only inside the
// output.
// The ragged route (kRagged: D or M not a multiple of 8, or a pointer not
// 16-byte aligned, where TMA's 16-byte row strides do not hold): the
// producer warpgroup loads the boxes itself, two warps a consumer (one
// for A's boxes, one for B's), each lane 2 chunks' loads before it stores
// them: 4-byte loads where a row allows and bounds-checked 2-byte loads
// elsewhere, assembled into 16-byte chunks, into the same 128-byte
// swizzled layout that TMA fills, zeros past the edges. Each lane makes
// its stores visible to the async proxy (wgmma reads shared memory
// through it) and arrives on the slot's full barrier, whose count is 64
// there. The consumers and their wgmma descriptors are the same. The
// epilogues stage each 64 x 64 box as before and store it with all 128
// threads, inside the output, by 4-byte or 2-byte stores; the fp32 weight
// gradients and the saved u go element by element. That route does not
// use setmaxnreg: the whole kernel is compiled at the launch bound's 168
// registers, so the consumers gain nothing from it, and the producer's
// loads keep what registers they need.
// No operand is transposed in memory: each is read as it lies,
// K-major or MN-major, and the descriptor tells wgmma which (hopper.cuh).
// What bounds it: the products are bound by operations (bf16 peak), but a
// 128 x 128 tile reads 64 FLOP a byte from L2, so the long-K launches (out,
// the weight gradients) run near what L2 delivers (PERF.md §6).
//
// Uses ("A K" = A read K-major, etc.; maps index Params::map):
//   forward launch 1 (kFwdU), n x M, K = D: A = x (K), B = w1 (MN);
//     u = C + b1 stored in bf16, h = gelu(u) from the fp32 u, in bf16;
//   forward launch 2 (kFwdOut), n x D, K = M: A = h (K), B = w2 (MN);
//     out = C + b2 in bf16;
//   backward launch 1 (kBwdDu), n x M, K = D: A = dO (K), B = w2^T (K,
//     from w2 (M, D)); du = C * gelu'(u) from the saved bf16 u (its tile
//     prefetched into L2 as the tile starts), rounded to bf16, and h =
//     gelu(u) in bf16, both stored;
//   backward launch 2 (kBwdGrads), one set of tiles over three products:
//     dw1 = x^T du (D x M, K = n; A = x (MN), B = du (MN)), the tiles of
//     its first row also summing db1 = sum over rows of du from the staged
//     du tiles; dw2 = h^T dO (M x D, K = n; A = h (MN), B = dO (MN)); dx =
//     du w1^T (n x D, K = M; A = du (K), B = w1^T (K, from w1 (D, M))); dw1
//     and dw2 tiles first (longest first), all in fp32.
// Every output element has one owner that sums over K in a fixed order:
// no atomics, the result is deterministic.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"
#include "mlp_tile.cuh"

namespace mlpg {

using namespace hopper;
using wtile::store2;

constexpr int kTile = 128;    // rows and columns of an output tile
constexpr int kDepth = 64;    // K per step (one box)
constexpr int kStages = 3;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStageBytes = 2 * kTileBytes;  // A and B
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kOutBytes = 2 * kBoxBytes;  // two 64 x 64 bf16 output boxes
// per consumer: a ring, a staging buffer, the tile's bias, full and empty
// barriers and an order barrier; and slack to align the rings to the
// 1,024 bytes of a swizzle atom (231,536 of the 232,448 bytes a block
// can have)
constexpr int kSmemBytes =
    kConsumers * (kRingBytes + kOutBytes + kTile * 4 + 2 * kStages * 8 + 8) +
    1024;
constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;

enum Launch { kFwdU, kFwdOut, kBwdDu, kBwdGrads };
enum Job { kU, kOut, kDu, kDx, kDw1, kDw2 };

// A tensor as it lies in device memory: (outer, inner), inner contiguous.
struct Operand {
  const void* ptr;
  int outer, inner;
};

struct Params {
  // Operands, then bf16 outputs (stored by TMA): kFwdU: x, w1, u, h;
  // kFwdOut: h, w2, out; kBwdDu: dO, w2, du, h; kBwdGrads: du, w1, x, h,
  // dO, dx. Each map is of the tensor as it lies (outer, inner); ops holds
  // the same tensors for the ragged route, which has no maps.
  CUtensorMap map[6];
  Operand ops[6];
  const float* b1;
  const float* b2;
  const __nv_bfloat16* u_in;  // kBwdDu: the saved u
  float* dw1;
  float* db1;
  float* dw2;
  int n, D, M;
};

struct Tile {
  int job, row0, col0, steps;
};

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ Tile grid_tile(int job, int b, int cols,
                                          int depth) {
  const int per_row = cdiv(cols, kTile);
  return Tile{job, b / per_row * kTile, b % per_row * kTile,
              cdiv(depth, kDepth)};
}

// Tile b of a launch; consecutive tiles walk one row of output tiles, so
// the tiles in flight share their A rows.
template <int kLaunch>
__device__ __forceinline__ Tile plan(const Params& p, int b) {
  if (kLaunch == kFwdU) return grid_tile(kU, b, p.M, p.D);
  if (kLaunch == kFwdOut) return grid_tile(kOut, b, p.D, p.M);
  if (kLaunch == kBwdDu) return grid_tile(kDu, b, p.M, p.D);
  const int dw = cdiv(p.D, kTile) * cdiv(p.M, kTile);
  if (b < dw) return grid_tile(kDw1, b, p.M, p.n);
  if (b < 2 * dw) return grid_tile(kDw2, b - dw, p.D, p.n);
  return grid_tile(kDx, b - 2 * dw, p.D, p.M);
}

// Whether launch kLaunch has tiles of `job`: a constant, which keeps the
// other jobs' code (and registers) out of each kernel.
template <int kLaunch>
__host__ __device__ constexpr bool runs(int job) {
  return kLaunch == kFwdU     ? job == kU
         : kLaunch == kFwdOut ? job == kOut
         : kLaunch == kBwdDu  ? job == kDu
                              : job == kDx || job == kDw1 || job == kDw2;
}

// Tiles of a launch (as plan reads them).
__host__ __device__ inline int tiles(int launch, int n, int D, int M) {
  switch (launch) {
    case kFwdU:
    case kBwdDu:
      return cdiv(n, kTile) * cdiv(M, kTile);
    case kFwdOut:
      return cdiv(n, kTile) * cdiv(D, kTile);
    default:
      return 2 * cdiv(D, kTile) * cdiv(M, kTile) +
             cdiv(n, kTile) * cdiv(D, kTile);
  }
}

// ------------------------------------------------------- shared memory

// Shared-window addresses of consumer c's pieces, from the block's
// 1,024-byte aligned base: the two rings, the two staging buffers, the
// two bias rows, then the barriers.
struct Smem {
  uint32_t base;
  __device__ uint32_t ring(int c) const { return base + c * kRingBytes; }
  __device__ uint32_t stage(int c) const {
    return base + kConsumers * kRingBytes + c * kOutBytes;
  }
  __device__ uint32_t bias(int c) const {
    return base + kConsumers * (kRingBytes + kOutBytes) + c * kTile * 4;
  }
  __device__ uint32_t bars() const {
    return base + kConsumers * (kRingBytes + kOutBytes + kTile * 4);
  }
  // consumer c's full and empty barriers of slot 0 (slot s at + 8s), and
  // its order barrier
  __device__ uint32_t full(int c) const { return bars() + c * kStages * 8; }
  __device__ uint32_t empty(int c) const {
    return bars() + (kConsumers + c) * kStages * 8;
  }
  __device__ uint32_t order(int c) const {
    return bars() + 2 * kConsumers * kStages * 8 + c * 8;
  }
};

// --------------------------------------------------------------- producer

// Box h (0, 1) of an operand tile at mn0 and depth k0: an MN-major tile
// is two 64-wide MN boxes, a K-major one two 64-row boxes.
template <bool kMn>
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int mn0, int k0,
                                         int h) {
  if (kMn)
    tma_load(dst + h * kBoxBytes, map, bar, mn0 + h * kBox, k0);
  else
    tma_load(dst + h * kBoxBytes, map, bar, k0, mn0 + h * kBox);
}

// The ragged route's load_box: the box of `op` at (inner c0, outer c1),
// as TMA would lay it out, by one warp. Lane l fills the 16-byte chunks l,
// l + 32, ... of the box (line q / 8, chunk q % 8), kBatch chunks' loads
// at a time before it stores them (a shared store would otherwise wait
// for each chunk's loads; more than 2 chunks made ptxas spill in the
// weight-gradient launch, whose consumers hold 168 registers): four
// 4-byte loads a chunk where it lies whole inside a 4-byte aligned row,
// else eight bounds-checked 2-byte loads; zeros past the tensor's edges.
__device__ __forceinline__ void load_box_ragged(uint32_t dst,
                                                const Operand& op, int c0,
                                                int c1) {
  constexpr int kBatch = 2;
  const uint16_t* src = static_cast<const uint16_t*>(op.ptr);
  const int lane = threadIdx.x & 31;
  for (int q0 = lane; q0 < kBox * 8; q0 += 32 * kBatch) {
    uint32_t w[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + 32 * u, line = q >> 3;
      const int row = c1 + line, col = c0 + 8 * (q & 7);
      const uint16_t* at = src + (int64_t)row * op.inner + col;
      const bool in_row = row < op.outer;
      if (in_row && col + 8 <= op.inner &&
          (reinterpret_cast<uintptr_t>(at) & 3) == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[u][e] = __ldg(reinterpret_cast<const uint32_t*>(at) + e);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo =
              in_row && col + 2 * e < op.inner ? __ldg(at + 2 * e) : 0u;
          const uint32_t hi = in_row && col + 2 * e + 1 < op.inner
                                  ? __ldg(at + 2 * e + 1)
                                  : 0u;
          w[u][e] = lo | hi << 16;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + 32 * u, line = q >> 3;
      st_shared_v4(dst + line * 128 + (((q & 7) ^ (line & 7)) << 4), w[u]);
    }
  }
}

// The loads of tile t's steps into a ring (full and empty: slot 0's
// barriers), from operands ia (A) and ib (B); `it` counts the steps of
// this ring so far. TMA: issued by one thread, the full barrier expecting
// the bytes. Ragged: a warp loads A's two boxes (part 0) or B's (part 1),
// then each of its lanes arrives.
template <bool kAMn, bool kBMn, bool kRagged>
__device__ __forceinline__ void produce(const Params& p, int ia, int ib,
                                        const Tile& t, uint32_t ring,
                                        uint32_t full, uint32_t empty,
                                        int& it, int part) {
  for (int s = 0; s < t.steps; ++s, ++it) {
    const int slot = it % kStages;
    mbar_wait_or_trap(empty + 8 * slot, ((it / kStages) & 1) ^ 1);
    const uint32_t bar = full + 8 * slot;
    const uint32_t a = ring + slot * kStageBytes, b = a + kTileBytes;
    if constexpr (kRagged) {
      const int k0 = s * kDepth;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the coordinates load_box gives TMA
        if (part == 0) {
          const int mn = t.row0 + h * kBox;
          load_box_ragged(a + h * kBoxBytes, p.ops[ia], kAMn ? mn : k0,
                          kAMn ? k0 : mn);
        } else {
          const int mn = t.col0 + h * kBox;
          load_box_ragged(b + h * kBoxBytes, p.ops[ib], kBMn ? mn : k0,
                          kBMn ? k0 : mn);
        }
      }
      fence_proxy_async();
      mbar_arrive(bar);
    } else {
      mbar_expect_tx(bar, kStageBytes);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        load_box<kAMn>(a, &p.map[ia], bar, t.row0, s * kDepth, h);
        load_box<kBMn>(b, &p.map[ib], bar, t.col0, s * kDepth, h);
      }
    }
  }
}

template <int kLaunch, bool kRagged>
__device__ __forceinline__ void produce_tile(const Params& p, const Tile& t,
                                             uint32_t ring, uint32_t full,
                                             uint32_t empty, int& it,
                                             int part) {
  if ((runs<kLaunch>(kU) || runs<kLaunch>(kOut)))
    produce<false, true, kRagged>(p, 0, 1, t, ring, full, empty, it, part);
  else if (runs<kLaunch>(kDu) || (runs<kLaunch>(kDx) && t.job == kDx))
    produce<false, false, kRagged>(p, 0, 1, t, ring, full, empty, it, part);
  else if (t.job == kDw1)
    produce<true, true, kRagged>(p, 2, 0, t, ring, full, empty, it, part);
  else  // kDw2
    produce<true, true, kRagged>(p, 3, 4, t, ring, full, empty, it, part);
}

// --------------------------------------------------------------- consumer

// acc[h] (rows 64h .. 64h + 63 of the tile) = A B over tile t's steps;
// `it` counts the steps of this ring so far. With sum_b, thread i also
// sums column i of every staged B tile (an MN-major tile, k-line by
// k-line, in order) into *bsum.
template <bool kAMn, bool kBMn>
__device__ __forceinline__ void consume(float (&acc)[2][64], const Tile& t,
                                        uint32_t ring, uint32_t full,
                                        uint32_t empty, int& it, bool sum_b,
                                        float* bsum) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  const bool arrives = (threadIdx.x & 31) == 0;
  for (int s = 0; s < t.steps; ++s, ++it) {
    const int slot = it % kStages;
    mbar_wait(full + 8 * slot, (it / kStages) & 1);
    const uint32_t a = ring + slot * kStageBytes, b = a + kTileBytes;
    if (sum_b) {  // column i: box i / 64, 16-byte chunk permuted by line
      const int i = threadIdx.x & 127, col = i & 63;
      const uint32_t box = b + (i >> 6) * kBoxBytes + (col & 7) * 2;
      float sum = *bsum;
#pragma unroll 8
      for (int r = 0; r < kDepth; ++r)
        sum += ld_shared_bf16(box + r * 128 + (((col >> 3) ^ (r & 7)) << 4));
      *bsum = sum;
    }
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    wgmma_fence();
    const uint64_t da = kAMn ? desc_mn(a) : desc_k(a);
    const uint64_t db = kBMn ? desc_mn(b) : desc_k(b);
    constexpr uint32_t kStepA = kAMn ? kStepMn : kStepK;
    constexpr uint32_t kStepB = kBMn ? kStepMn : kStepK;
#pragma unroll
    for (int k = 0; k < kDepth / 16; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_m64n128k16<kAMn, kBMn>(
            acc[h], desc_add(da, h * kBoxBytes + k * kStepA),
            desc_add(db, k * kStepB));
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's MMAs are done: free its slot
    if (s > 0 && arrives) mbar_arrive(empty + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  if (arrives) mbar_arrive(empty + 8 * ((it - 1) % kStages));
}

// --------------------------------------------------------------- epilogue

// The consumer warpgroup's own barrier (id 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync(int c) {
  named_barrier(1 + c, 128);
}

// This thread's place in the accumulator: rows 16w + g (r = 0) and 16w +
// g + 8 (r = 1) of each 64-row half, columns 8j + 2q and 8j + 2q + 1.
struct Frag {
  int w, g, q;
  __device__ Frag()
      : w((threadIdx.x >> 5) & 3),
        g((threadIdx.x >> 2) & 7),
        q(threadIdx.x & 3) {}
  __device__ int row(const Tile& t, int h, int r) const {
    return t.row0 + 64 * h + 16 * w + g + 8 * r;
  }
  __device__ int col(const Tile& t, int j) const {
    return t.col0 + 8 * j + 2 * q;
  }
};

// The ragged route's TMA store: the staged box at src to `op` at (inner
// c0, outer c1), by the consumer warpgroup's 128 threads, 16-byte chunk
// by chunk: four 4-byte stores where the chunk lies whole inside a 4-byte
// aligned row, else element by element inside the tensor.
__device__ __forceinline__ void store_box_ragged(const Operand& op,
                                                 uint32_t src, int c0,
                                                 int c1) {
  uint16_t* dst = static_cast<uint16_t*>(const_cast<void*>(op.ptr));
  for (int q = threadIdx.x & 127; q < kBox * 8; q += 128) {
    const int line = q >> 3, chunk = q & 7;
    const int row = c1 + line, col = c0 + 8 * chunk;
    if (row >= op.outer || col >= op.inner) continue;
    uint32_t w[4];
    ld_shared_v4(src + line * 128 + ((chunk ^ (line & 7)) << 4), w);
    uint16_t* at = dst + (int64_t)row * op.inner + col;
    if (col + 8 <= op.inner && (reinterpret_cast<uintptr_t>(at) & 3) == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) reinterpret_cast<uint32_t*>(at)[e] = w[e];
      continue;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < op.inner) at[e] = (uint16_t)(w[e >> 1] >> (16 * (e & 1)));
  }
}

// Block (h, b) of the tile, rows 64h .. 64h + 63 and columns 64b ..
// 64b + 63, of kOuts bf16 outputs at once: value(v0, v1, r, j, o) gives
// the outputs' values o[k] for the pair of columns (Frag::col(j)) of row
// Frag::row(h, r) that the accumulator a = acc[h] holds there; output k
// is written into the staging buffer as TMA box k and stored through map
// (or, ragged, operand) outs[k]. The buffer is reused once the previous
// stores have read it. The accumulator's registers of the block die here,
// so a block at a time keeps the epilogue within the kernel's registers.
template <bool kRagged, int kOuts, typename Value>
__device__ __forceinline__ void store_block(
    const Params& p, int c, const int (&outs)[kOuts], uint32_t stage,
    const Tile& t, int h, int b, const float (&a)[64], Value value) {
  const Frag f;
  const bool leader = (threadIdx.x & 127) == 0;
  if (!kRagged && leader) bulk_wait_read();
  consumer_sync(c);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = 8 * b + jj, row = 16 * f.w + f.g + 8 * r;  // row % 8 == g
      __nv_bfloat162 o[kOuts];
      value(a[4 * j + 2 * r], a[4 * j + 2 * r + 1], r, j, o);
#pragma unroll
      for (int k = 0; k < kOuts; ++k)
        st_shared(stage + k * kBoxBytes + row * 128 + ((jj ^ f.g) << 4) +
                      4 * f.q,
                  *reinterpret_cast<const uint32_t*>(&o[k]));
    }
  if constexpr (kRagged) {
    consumer_sync(c);
#pragma unroll
    for (int k = 0; k < kOuts; ++k)
      store_box_ragged(p.ops[outs[k]], stage + k * kBoxBytes,
                       t.col0 + kBox * b, t.row0 + 64 * h);
    return;
  }
  fence_proxy_async();
  consumer_sync(c);
  if (leader) {
#pragma unroll
    for (int k = 0; k < kOuts; ++k)
      tma_store(&p.map[outs[k]], stage + k * kBoxBytes, t.col0 + kBox * b,
                t.row0 + 64 * h);
    bulk_commit();
  }
}

// The fp32 weight gradients: pairs of columns straight from the
// accumulator (8 rows x 32 bytes a warp store, whole sectors); ragged,
// element by element.
template <bool kRagged>
__device__ __forceinline__ void store_dw(const Params& p, const Tile& t,
                                        float (&acc)[2][64]) {
  const Frag f;
  float* dst = t.job == kDw1 ? p.dw1 : p.dw2;
  const int rows = t.job == kDw1 ? p.D : p.M, cols = t.job == kDw1 ? p.M : p.D;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = f.row(t, h, r);
      if (row >= rows) continue;
      float* line = dst + (int64_t)row * cols;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = f.col(t, j);  // even
        if (col >= cols) continue;
        if (!kRagged) {  // cols % 8 == 0
          store2(line + col, acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
        } else {
          line[col] = acc[h][4 * j + 2 * r];
          if (col + 1 < cols) line[col + 1] = acc[h][4 * j + 2 * r + 1];
        }
      }
    }
}

// The tile's epilogue; `bias` is this thread's column's bias (kU, kOut),
// shared through the bias row at bias_s.
template <int kLaunch, bool kRagged>
__device__ __forceinline__ void epilogue(const Params& p, const Tile& t,
                                         int c, float (&acc)[2][64],
                                         uint32_t stage, uint32_t bias_s,
                                         float bias) {
  if (runs<kLaunch>(kDw1) && t.job != kDx) {
    store_dw<kRagged>(p, t, acc);
    return;
  }
  // read behind store_block's first barrier
  st_shared(bias_s + 4 * (threadIdx.x & 127), bias);
  const Frag f;
  const int first[1] = {t.job == kDx ? 5 : 2};
  const int both[2] = {2, 3};
  // the bias of column pair j, from shared memory
  const auto bias2 = [&](int j) {
    const uint32_t at = bias_s + 4 * (8 * j + 2 * f.q);
    return make_float2(ld_shared_f32(at), ld_shared_f32(at + 4));
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // kDu: the saved u of rows (h, 0) and (h, 1), zeros past the edges
    const int row0 = f.row(t, h, 0);
    const __nv_bfloat16* u_row =
        p.u_in + (int64_t)row0 * p.M + f.col(t, 0);
    const auto saved_u = [&](int r, int j) {
      if (row0 + 8 * r >= p.n || f.col(t, j) >= p.M)
        return make_float2(0.f, 0.f);
      const __nv_bfloat16* at = u_row + 8 * r * p.M + 8 * j;
      if (!kRagged)
        return __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(at));
      return make_float2(
          __bfloat162float(at[0]),
          f.col(t, j) + 1 < p.M ? __bfloat162float(at[1]) : 0.f);
    };
#pragma unroll
    for (int b = 0; b < 2; ++b) switch (kLaunch) {
        case kFwdU:  // u = C + b1 and h = gelu(u) from the fp32 u
          store_block<kRagged>(p, c, both, stage, t, h, b, acc[h],
                      [&](float v0, float v1, int, int j, __nv_bfloat162* o) {
                        const float2 bj = bias2(j);
                        const float u0 = v0 + bj.x, u1 = v1 + bj.y;
                        o[0] = __floats2bfloat162_rn(u0, u1);
                        o[1] = __floats2bfloat162_rn(mlp::gelu(u0),
                                                     mlp::gelu(u1));
                      });
          break;
        case kFwdOut:
          store_block<kRagged>(p, c, first, stage, t, h, b, acc[h],
                      [&](float v0, float v1, int, int j, __nv_bfloat162* o) {
                        const float2 bj = bias2(j);
                        o[0] = __floats2bfloat162_rn(v0 + bj.x, v1 + bj.y);
                      });
          break;
        case kBwdDu:  // du = dh * gelu'(u) and h = gelu(u), one tanh for both
          store_block<kRagged>(p, c, both, stage, t, h, b, acc[h],
                      [&](float v0, float v1, int r, int j,
                          __nv_bfloat162* o) {
                        const float2 u = saved_u(r, j);
                        float g0, g1;
                        const float d0 = mlp::gelu_and_grad(u.x, &g0);
                        const float d1 = mlp::gelu_and_grad(u.y, &g1);
                        o[0] = __floats2bfloat162_rn(v0 * d0, v1 * d1);
                        o[1] = __floats2bfloat162_rn(g0, g1);
                      });
          break;
        default:  // kBwdGrads: dx
          store_block<kRagged>(p, c, first, stage, t, h, b, acc[h],
                      [](float v0, float v1, int, int, __nv_bfloat162* o) {
                        o[0] = __floats2bfloat162_rn(v0, v1);
                      });
      }
  }
}

// Brings the saved u of tile t into L2 ahead of the epilogue that reads
// it: thread i asks for the two 128-byte lines of the tile's row i.
__device__ __forceinline__ void prefetch_u(const Params& p, const Tile& t) {
  const int i = threadIdx.x & 127, row = t.row0 + i;
  if (row >= p.n) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = t.col0 + 64 * half;
    if (col < p.M)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          p.u_in + (int64_t)row * p.M + col));
  }
}

// ----------------------------------------------------------------- kernel

template <int kLaunch, bool kRagged>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  const Smem sm{(smem_u32(gemm_smem) + kAtomBytes - 1) & ~(kAtomBytes - 1)};
  const int total = tiles(kLaunch, p.n, p.D, p.M);
  if (threadIdx.x == 0) {
    for (int c = 0; c < kConsumers; ++c) {
      for (int s = 0; s < kStages; ++s) {
        // the producer's expect_tx, or (ragged) the 64 arrivals of its
        // two warps
        mbar_init(sm.full(c) + 8 * s, kRagged ? 64 : 1);
        mbar_init(sm.empty(c) + 8 * s, 4);  // one arrival per consumer warp
      }
      mbar_init(sm.order(c), 1);
    }
    fence_barrier_init();
    mbar_arrive(sm.order(0));  // consumer 0 takes the first turn
  }
  __syncthreads();

  // consumer c's tiles: the block's tiles c, c + 2, ...
  const int wg = threadIdx.x >> 7;
  const int c = wg < kConsumers ? wg : (threadIdx.x >> 5) & 3;
  const int first = blockIdx.x + c * gridDim.x;
  const int stride = kConsumers * gridDim.x;
  int it = 0;  // steps through this consumer's ring
  if (wg == kConsumers) {  // the producer warpgroup
    if (kRagged) {  // warps 0 and 1 load consumer 0's and 1's A, 2 and 3 B
      const int cc = c & 1;
      for (int b = blockIdx.x + cc * gridDim.x; b < total; b += stride)
        produce_tile<kLaunch, true>(p, plan<kLaunch>(p, b), sm.ring(cc),
                                    sm.full(cc), sm.empty(cc), it, c >> 1);
    } else {
      setmaxnreg_dec<kProducerRegs>();
      if (c < kConsumers && (threadIdx.x & 31) == 0)
        for (int b = first; b < total; b += stride)
          produce_tile<kLaunch, false>(p, plan<kLaunch>(p, b), sm.ring(c),
                                       sm.full(c), sm.empty(c), it, 0);
    }
  } else {  // consumer c
    if (!kRagged) setmaxnreg_inc<kConsumerRegs>();
    int turn = 0;
    for (int b = first; b < total; b += stride, ++turn) {
      const Tile t = plan<kLaunch>(p, b);
      if (kLaunch == kBwdDu) prefetch_u(p, t);
      // this thread's column of the tile's bias, loaded before the MMAs
      const int col = t.col0 + (threadIdx.x & 127);
      float bias = 0.f;
      if (kLaunch == kFwdU && col < p.M) bias = __ldg(p.b1 + col);
      if (kLaunch == kFwdOut && col < p.D) bias = __ldg(p.b2 + col);
      float acc[2][64];
      float db1 = 0.f;
      const bool sum_b = runs<kLaunch>(kDw1) && t.job == kDw1 && t.row0 == 0;
      mbar_wait(sm.order(c), turn & 1);  // this consumer's turn at the MMAs
      if (runs<kLaunch>(kU) || runs<kLaunch>(kOut))
        consume<false, true>(acc, t, sm.ring(c), sm.full(c), sm.empty(c), it,
                             false, nullptr);
      else if (runs<kLaunch>(kDu) || t.job == kDx)
        consume<false, false>(acc, t, sm.ring(c), sm.full(c), sm.empty(c),
                              it, false, nullptr);
      else  // kDw1, kDw2
        consume<true, true>(acc, t, sm.ring(c), sm.full(c), sm.empty(c), it,
                            sum_b, &db1);
      if ((threadIdx.x & 127) == 0) mbar_arrive(sm.order(c ^ 1));
      epilogue<kLaunch, kRagged>(p, t, c, acc, sm.stage(c), sm.bias(c),
                                 bias);
      if (sum_b && col < p.M) p.db1[col] = db1;
    }
    if (!kRagged && (threadIdx.x & 127) == 0) bulk_wait();  // the last TMA
                                                             // stores
  }
}

// ------------------------------------------------------------------- host

constexpr int kMaxDevices = 64;

// A kernel's set-up on one device: its SM count, and whether its shared
// memory was allowed there.
struct DeviceSetup {
  int sms;
  bool ready;
};

// The current device's set-up of gemm_bf16_kernel<kLaunch, kRagged>, made
// at its first launch on that device: the SM count, a check that the
// kernel was built with the registers that setmaxnreg hands out
// (otherwise the consumers' increase could never be granted and the block
// would hang; the ragged route does not use setmaxnreg), and its dynamic
// shared memory allowed. Both are properties of a device, so they are
// kept a device, never once a process.
template <int kLaunch, bool kRagged>
cudaError_t device_setup(int* sms) {
  static DeviceSetup setup[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceSetup& s = setup[device];
  if (!s.ready) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, gemm_bf16_kernel<kLaunch, kRagged>);
    if (err != cudaSuccess) return err;
    if (!kRagged && attr.numRegs * kThreads <
                        (int)(128 * (kConsumers * kConsumerRegs +
                                     kProducerRegs)))
      return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(gemm_bf16_kernel<kLaunch, kRagged>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    s.sms = count;
    s.ready = true;
  }
  *sms = s.sms;
  return cudaSuccess;
}

// Launches kLaunch on the current device: one block per SM, or one per
// tile where there are fewer.
template <int kLaunch, bool kRagged>
cudaError_t launch_kernel(const Params& p, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = device_setup<kLaunch, kRagged>(&sms);
  if (err != cudaSuccess) return err;
  const int total = tiles(kLaunch, p.n, p.D, p.M);
  gemm_bf16_kernel<kLaunch, kRagged>
      <<<total < sms ? total : sms, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int kLaunch>
cudaError_t launch(const Params& p, bool ragged, cudaStream_t stream) {
  return ragged ? launch_kernel<kLaunch, true>(p, stream)
                : launch_kernel<kLaunch, false>(p, stream);
}

// The operands of a launch, in Params::map's order; the maps are made
// where the launch takes the TMA route.
inline cudaError_t set_maps(Params* p, std::initializer_list<Operand> ops,
                            bool ragged) {
  int i = 0;
  for (const Operand& op : ops) {
    p->ops[i] = op;
    if (!ragged) {
      const cudaError_t err = make_map(&p->map[i], op.ptr, op.outer,
                                       op.inner);
      if (err != cudaSuccess) return err;
    }
    ++i;
  }
  return cudaSuccess;
}

}  // namespace mlpg
