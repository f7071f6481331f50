// The detector's matcher on the device (objectives/matcher.py): one kernel
// with two entries that share one Jonker-Volgenant solver.
//
// arsvt_match_layers, the main path's entry (matcher.py::assign_layers, one
// launch a `match_layers` call: a train step's microbatch or an eval
// forward), builds every decoder layer's (Q, M) cost of every image into
// shared memory and solves it there, then writes each query's target slot
// and whether that slot holds a real target. JAX's `match`
// (arsvt_tpu/objectives/matcher.py:173-234) runs inside the jitted step,
// where XLA fuses the cost build; the port built it eagerly, ~55 launches a
// layer, then stacked the layers and solved them in a second kernel that
// read its cost rows from global memory on the solver's chain.
//
// arsvt_lap_rect, the solve-only entry (matcher.py::lap_rect, lap_single,
// lap_batch): costs (n, q, m) in, col_for_row (n, q) out. It stages each
// problem's costs into shared memory with one coalesced read, then runs the
// same solver.
//
// Neither replaces a Pallas kernel: JAX's lap_rect
// (arsvt_tpu/objectives/matcher.py:41-125) is plain JAX, a Jonker-Volgenant
// shortest augmenting path written with lax.scan over the rows and
// lax.while_loop growing the alternating tree.
//
// The build (match_kernel) repeats build_cost_matrix's eager arithmetic op
// by op, each op rounded as its own PyTorch kernel rounds it: the softmax
// over C+1 in the order of PyTorch's warp softmax (PersistentSoftmax.cuh:
// element k summed by lane k % W of a W-lane group, W the next power of two
// of C+1 capped at 32, the lanes' sums then met in a butterfly; expf, an
// IEEE division), -p[label], the L1 of cxcywh against the targets converted
// by xyxy_to_cxcywh (summed as PyTorch's reduction over the last 4 sums),
// -pairwise_giou with its clamps at 0 and 1e-9 and its IEEE divisions,
// w_c·cc + w_b·cb + w_g·cg summed left to right, and _PAD_COST (1e4) where
// the target slot is a pad. nvcc contracts a*b + c into an FMA, which the
// eager ops round twice, so every product and sum is a _rn intrinsic.
// Maximum, minimum and the clamps pass NaN through as PyTorch's do. A label
// outside [0, C] is clamped (JAX's gather clamps; the eager gather raises).
//
// The solver (solve) is JAX's lap_rect with its arithmetic in its order:
// cost[i] - u[i] - v, u + delta on the tree's rows, v - delta on the used
// columns, minv - delta on the others, the first index of the minimum of
// where(used, 1e30, minv) (jnp.argmin's order: NaN first, then the smaller
// value, ties to the smaller index). Subtractions and compares only, so
// integer-valued costs give JAX's assignment bit for bit, ties included.
// One warp a problem. Its time is a chain of passes, each waiting on the
// last, so the design cuts the latency of a pass: lane l owns columns j =
// l + 32k and rows r = l + 32k, k < K (K = 1, 2, 4 or 8, the smallest
// with 32K >= m, a template argument), and keeps their v, minv, used, u and
// tree in registers. A pass reads p[j1] from shared memory, takes delta and
// u[row] from their owners' registers by one shuffle each, reads the cost
// row from the shared-memory tile, and meets in two warp reductions
// (__reduce_min_sync, one instruction each on sm_80 and later) over an
// unsigned key that orders the floats as jnp.argmin does, the second over
// the columns that hold the least key. Only p (the row of each column, read
// in every pass) and way (written by a column's owner, walked by lane 0 in
// the augmenting step) stay in shared memory. Nothing on the chain reads
// global memory.
//
// Q > M (vit_base_detector: 100 queries, 25 slots): the build writes the
// transpose (slots as rows), the solver gives each slot its query (the
// padded square's optimum, JAX's route at matcher.py:216-223), and the
// kernel inverts it: a query no slot took gets M.
//
// Layout of match_kernel: one block an image and group of up to 8 layers,
// one warp a layer, so the image's target terms (xyxy, cxcywh, area, label,
// mask) are computed once into the block's shared memory and read by all
// its layers. At the detector step's (6, 32, 5, 25) that is 32 blocks of
// six warps. Each warp first stages its layer's logits and boxes into
// shared memory in one coalesced pass, issued before the targets' loads, so
// the kernel waits on global memory about once; the softmax, the box terms,
// the tile and the solver then read shared memory alone. solve_kernel is
// one warp a block: one problem a warp, and the problems spread over every
// SM (the step's 192 at most two an SM).
//
// Bound on an H100 SXM: bytes, and far below the launch's own latency. The
// fused entry reads the logits and boxes once (L·B·Q·(C+1+4)·4 bytes) and
// the targets once (B·M·21) and writes L·B·Q·9 bytes: 0.068 MB at
// (6, 32, 5, 25), 0.02 us at 3.35 TB/s. Its work is a chain: the build is a
// few hundred instructions a lane, then O(q^2) passes in the worst case, q
// = min(Q, M) <= 100 at the port's presets.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLayers = 32;        // decoder layers a fused call, at most
constexpr int kMaxWarps = 8;          // layers a fused block, at most
constexpr int kMaxClasses = 1024;     // C + 1 of PyTorch's warp softmax
constexpr int kMaxCols = 256;         // columns of a problem (32 lanes x 8)
constexpr int kMaxDevices = 64;
constexpr float kUsed = 1e30f;        // JAX's _INF: used columns in the argmin
constexpr float kPadCost = 1e4f;      // objectives/matcher.py::_PAD_COST
constexpr uint32_t kNoKey = 0xffffffffu;  // above every key of order_key
constexpr unsigned kAll = 0xffffffffu;
constexpr int kImageTerms = 11;       // a target's words in shared memory
constexpr int kQueryTerms = 11;       // a query's words in shared memory

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// One warp's solver state in shared memory: p and way, m words each.
__host__ __device__ constexpr int state_bytes(int m) {
  return round16(8 * m);
}

// jnp.argmin's order as an unsigned key: NaN first, then by value, -0 as +0
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return 0u;
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The first column of the least key over the warp; each lane passes the
// least key of its columns and the first column that holds it. With one
// column a lane (K = 1) that column is the lane, so the first lane that
// holds the least key names it.
template <int K>
__device__ __forceinline__ int warp_argmin(uint32_t key, int col) {
  const uint32_t least = __reduce_min_sync(kAll, key);
  if (K == 1) return __ffs(__ballot_sync(kAll, key == least)) - 1;
  return (int)__reduce_min_sync(kAll, key == least ? (uint32_t)col : kNoKey);
}

// Element `idx` of a register array spread over the warp (lane idx % 32,
// slot idx / 32); idx is the same on every lane.
template <int K>
__device__ __forceinline__ float owned(const float (&a)[K], int idx) {
  float x = a[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (k == idx >> 5) x = a[k];
  return __shfl_sync(kAll, x, idx & 31);
}

// JAX's lap_rect on the (q, m) costs c in shared memory, q <= m <= 32 K:
// leaves in p (shared, m words) the row of each column (-1 where free);
// way (shared, m words) is scratch. Its first __syncwarp publishes c.
template <int K>
__device__ void solve(const float* __restrict__ c, int q, int m, int* p,
                      int* way, int lane) {
  float v[K], minv[K], u[K];  // column lane + 32k's v and minv, row's u
  uint32_t used = 0, tree = 0;  // bit k: column / row lane + 32k
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.0f;
    minv[k] = 0.0f;
    u[k] = 0.0f;
  }
  for (int j = lane; j < m; j += 32) p[j] = -1;
  __syncwarp();

  for (int i = 0; i < q; ++i) {
    // the tree rooted at row i
    const float ui = owned(u, i);
    const float* ci = c + i * m;
    uint32_t best = kNoKey;
    int best_j = 0x7fffffff;
    used = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      if (j < m) {
        minv[k] = ci[j] - ui - v[k];
        way[j] = -1;
        const uint32_t key = order_key(minv[k]);
        if (key < best) {
          best = key;
          best_j = j;
        }
      }
    }
    tree = (i & 31) == lane ? 1u << (i >> 5) : 0u;
    int j1 = warp_argmin<K>(best, best_j);
    int row = p[j1];

    // grow the tree until it reaches a free column; each pass uses one
    // more column, so m passes bound it even on NaN costs
    for (int pass = 0; pass < m && row != -1; ++pass) {
      const float delta = owned(minv, j1);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        u[k] = u[k] + ((tree >> k) & 1u ? delta : 0.0f);
        const bool in = (used >> k) & 1u;
        v[k] = v[k] - (in ? delta : 0.0f);
        if (!in) minv[k] = minv[k] - delta;
      }
      if ((row & 31) == lane) tree |= 1u << (row >> 5);
      if ((j1 & 31) == lane) used |= 1u << (j1 >> 5);
      const float ur = owned(u, row);
      const float* cr = c + row * m;
      best = kNoKey;
      best_j = 0x7fffffff;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        if (j < m) {
          const bool in = (used >> k) & 1u;
          if (!in) {
            const float cur = cr[j] - ur - v[k];
            if (cur < minv[k]) {
              minv[k] = cur;
              way[j] = j1;
            }
          }
          const uint32_t key = order_key(in ? kUsed : minv[k]);
          if (key < best) {
            best = key;
            best_j = j;
          }
        }
      }
      j1 = warp_argmin<K>(best, best_j);
      row = p[j1];
    }

    // final dual update so the new matched edge becomes tight
    const float delta = owned(minv, j1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u[k] = u[k] + ((tree >> k) & 1u ? delta : 0.0f);
      v[k] = v[k] - ((used >> k) & 1u ? delta : 0.0f);
    }
    __syncwarp();  // every owner's way is written
    // augment: walk predecessors from the free column, shifting rows
    if (lane == 0) {
      int j = j1;
      for (int step = 0; step < m && way[j] != -1; ++step) {
        const int prev = way[j];
        p[j] = p[prev];
        j = prev;
      }
      p[j] = i;
    }
    __syncwarp();  // p is final for the next row
  }
}

template <int K>
__global__ void __launch_bounds__(32)
    solve_kernel(const float* __restrict__ cost, int64_t* __restrict__ out,
                 int q, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int64_t problem = blockIdx.x;
  const int n = q * m;
  float* c = reinterpret_cast<float*>(smem);
  int* p = reinterpret_cast<int*>(smem + round16(4 * n));
  const float* g = cost + problem * n;
#pragma unroll 4
  for (int k = lane; k < n; k += 32) c[k] = g[k];
  solve<K>(c, q, m, p, p + m, lane);
  int64_t* o = out + problem * q;
  for (int j = lane; j < m; j += 32) {
    if (p[j] >= 0) o[p[j]] = j;
  }
}

// torch.maximum, torch.minimum and clamp(min=) on the card: NaN passes
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// x / 2 on the card: the eager division by a host scalar multiplies by its
// reciprocal, exact for 2
__device__ __forceinline__ float halve(float x) { return __fmul_rn(x, 0.5f); }

// PyTorch's sum over the last dim of 4 (Reduce.cuh: one element a lane of a
// 4-lane group, met by shfl_down at offsets 2, then 1)
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return __fadd_rn(__fadd_rn(a, c), __fadd_rn(b, d));
}

struct Layers {
  const float* logits[kMaxLayers];  // (B, Q, C + 1) each
  const float* boxes[kMaxLayers];   // (B, Q, 4) cxcywh each
};

struct Match {
  int layers, q, m, classes;
  int labels_int64;
  float w_class, w_bbox, w_giou;
  int warps;        // layers a block
  int image_bytes;  // the block's target terms
  int tile_bytes, query_bytes, logit_bytes, box_bytes, warp_bytes;
};

// Targets, a word each in the image's terms: x1, y1, x2, y2, cx, cy, w, h,
// area, then the label and the mask as ints.
enum { kTX1, kTY1, kTX2, kTY2, kTCX, kTCY, kTW, kTH, kTArea, kTLabel, kTReal };
// Queries: cx, cy, w, h, x1, y1, x2, y2, area, the softmax's max and sum.
enum { kQCX, kQCY, kQW, kQH, kQX1, kQY1, kQX2, kQY2, kQArea, kQMax, kQSum };

template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
    match_kernel(Layers in, const void* __restrict__ labels,
                 const float* __restrict__ tboxes,
                 const unsigned char* __restrict__ tmask,
                 int64_t* __restrict__ target_for_query,
                 unsigned char* __restrict__ query_matched,
                 float* __restrict__ costs, Match a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x, Q = a.q, M = a.m, C = a.classes;
  const int64_t image = (int64_t)b * M;

  // this warp's layer: its logits and boxes staged into shared memory, one
  // coalesced pass each, while the block's threads load the targets
  const int l = blockIdx.y * a.warps + warp;
  unsigned char* base = smem + a.image_bytes + warp * a.warp_bytes;
  float* tile = reinterpret_cast<float*>(base);
  float* qt = reinterpret_cast<float*>(base + a.tile_bytes);
  float* logits = reinterpret_cast<float*>(base + a.tile_bytes +
                                           a.query_bytes);
  float* boxes = reinterpret_cast<float*>(base + a.tile_bytes +
                                          a.query_bytes + a.logit_bytes);
  int* p = reinterpret_cast<int*>(base + a.tile_bytes + a.query_bytes +
                                  a.logit_bytes + a.box_bytes);
  if (l < a.layers) {
    const float* gl = in.logits[l] + (int64_t)b * Q * C;
    const float* gb = in.boxes[l] + (int64_t)b * Q * 4;
#pragma unroll 4
    for (int k = lane; k < Q * C; k += 32) logits[k] = gl[k];
#pragma unroll 4
    for (int k = lane; k < Q * 4; k += 32) boxes[k] = gb[k];
  }
  // the image's target terms, once for all of the block's layers
  float* tt = reinterpret_cast<float*>(smem);
  int* ti = reinterpret_cast<int*>(smem);
  for (int s = threadIdx.x; s < M; s += blockDim.x) {
    const float* bx = tboxes + (image + s) * 4;
    const float x1 = bx[0], y1 = bx[1], x2 = bx[2], y2 = bx[3];
    tt[kTX1 * M + s] = x1;
    tt[kTY1 * M + s] = y1;
    tt[kTX2 * M + s] = x2;
    tt[kTY2 * M + s] = y2;
    tt[kTCX * M + s] = halve(__fadd_rn(x1, x2));
    tt[kTCY * M + s] = halve(__fadd_rn(y1, y2));
    tt[kTW * M + s] = __fsub_rn(x2, x1);
    tt[kTH * M + s] = __fsub_rn(y2, y1);
    tt[kTArea * M + s] = __fmul_rn(clamp_min(__fsub_rn(x2, x1), 0.0f),
                                   clamp_min(__fsub_rn(y2, y1), 0.0f));
    const int64_t label =
        a.labels_int64 ? static_cast<const int64_t*>(labels)[image + s]
                       : (int64_t) static_cast<const int*>(labels)[image + s];
    ti[kTLabel * M + s] = (int)(label < 0 ? 0 : label >= C ? C - 1 : label);
    ti[kTReal * M + s] = tmask[image + s] != 0;
  }
  __syncthreads();
  if (l >= a.layers) return;  // no block barrier follows

  const bool transposed = Q > M;
  const int rows = transposed ? M : Q, cols = transposed ? Q : M;

  // the softmax's max and sum of each query in PyTorch's warp-softmax order:
  // a group of `width` lanes a query, 32 / width queries at a time
  int width = 1;
  while (width < C && width < 32) width <<= 1;
  const int group = lane / width, k = lane % width;
  for (int q0 = 0; q0 < Q; q0 += 32 / width) {
    const int qi = q0 + group;
    const float* row = logits + (qi < Q ? qi : 0) * C;
    float mx = -INFINITY;
    for (int e = k; e < C; e += width) mx = nan_max(mx, row[e]);
    for (int off = width / 2; off > 0; off >>= 1)
      mx = nan_max(mx, __shfl_xor_sync(kAll, mx, off));
    float sum = 0.0f;
    for (int e = k; e < C; e += width)
      sum = __fadd_rn(sum, expf(__fsub_rn(row[e], mx)));
    for (int off = width / 2; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(kAll, sum, off));
    if (k == 0 && qi < Q) {
      qt[kQMax * Q + qi] = mx;
      qt[kQSum * Q + qi] = sum;
    }
  }
  // each query's box: cxcywh_to_xyxy and box_area
  for (int qi = lane; qi < Q; qi += 32) {
    const float cx = boxes[qi * 4], cy = boxes[qi * 4 + 1];
    const float w = boxes[qi * 4 + 2], h = boxes[qi * 4 + 3];
    const float x1 = __fsub_rn(cx, halve(w)), y1 = __fsub_rn(cy, halve(h));
    const float x2 = __fadd_rn(cx, halve(w)), y2 = __fadd_rn(cy, halve(h));
    qt[kQCX * Q + qi] = cx;
    qt[kQCY * Q + qi] = cy;
    qt[kQW * Q + qi] = w;
    qt[kQH * Q + qi] = h;
    qt[kQX1 * Q + qi] = x1;
    qt[kQY1 * Q + qi] = y1;
    qt[kQX2 * Q + qi] = x2;
    qt[kQY2 * Q + qi] = y2;
    qt[kQArea * Q + qi] = __fmul_rn(clamp_min(__fsub_rn(x2, x1), 0.0f),
                                    clamp_min(__fsub_rn(y2, y1), 0.0f));
  }
  __syncwarp();

  // the (rows, cols) tile: the costs, or their transpose where Q > M. A
  // pad slot's costs are _PAD_COST; the arithmetic runs over the (query,
  // real slot) pairs alone, the image's real slots listed in order (by
  // ballot) in `way`, which the solver overwrites only after its first
  // __syncwarp.
  int* real_slots = p + cols;
  int n_real = 0;
  for (int s0 = 0; s0 < M; s0 += 32) {
    const bool real = s0 + lane < M && ti[kTReal * M + s0 + lane];
    const unsigned bits = __ballot_sync(kAll, real);
    if (real) real_slots[n_real + __popc(bits & ((1u << lane) - 1u))] =
        s0 + lane;
    n_real += __popc(bits);
  }
  for (int e = lane; e < rows * cols; e += 32) {
    const int r = e / cols;
    if (!ti[kTReal * M + (transposed ? r : e - r * cols)]) tile[e] = kPadCost;
  }
  __syncwarp();  // the list is written
  for (int e = lane; e < Q * n_real; e += 32) {
    const int qi = e / n_real, s = real_slots[e - qi * n_real];
    {
      const float prob = __fdiv_rn(
          expf(__fsub_rn(logits[qi * C + ti[kTLabel * M + s]],
                         qt[kQMax * Q + qi])),
          qt[kQSum * Q + qi]);
      const float cb = sum4(
          fabsf(__fsub_rn(qt[kQCX * Q + qi], tt[kTCX * M + s])),
          fabsf(__fsub_rn(qt[kQCY * Q + qi], tt[kTCY * M + s])),
          fabsf(__fsub_rn(qt[kQW * Q + qi], tt[kTW * M + s])),
          fabsf(__fsub_rn(qt[kQH * Q + qi], tt[kTH * M + s])));
      const float px1 = qt[kQX1 * Q + qi], py1 = qt[kQY1 * Q + qi];
      const float px2 = qt[kQX2 * Q + qi], py2 = qt[kQY2 * Q + qi];
      const float tx1 = tt[kTX1 * M + s], ty1 = tt[kTY1 * M + s];
      const float tx2 = tt[kTX2 * M + s], ty2 = tt[kTY2 * M + s];
      const float inter = __fmul_rn(
          clamp_min(__fsub_rn(nan_min(px2, tx2), nan_max(px1, tx1)), 0.0f),
          clamp_min(__fsub_rn(nan_min(py2, ty2), nan_max(py1, ty1)), 0.0f));
      const float uni = __fsub_rn(
          __fadd_rn(qt[kQArea * Q + qi], tt[kTArea * M + s]), inter);
      const float iou = __fdiv_rn(inter, clamp_min(uni, 1e-9f));
      const float enclose = clamp_min(
          __fmul_rn(clamp_min(__fsub_rn(nan_max(px2, tx2),
                                        nan_min(px1, tx1)), 0.0f),
                    clamp_min(__fsub_rn(nan_max(py2, ty2),
                                        nan_min(py1, ty1)), 0.0f)),
          1e-9f);
      const float giou =
          __fsub_rn(iou, __fdiv_rn(__fsub_rn(enclose, uni), enclose));
      tile[transposed ? s * Q + qi : qi * M + s] =
          __fadd_rn(__fadd_rn(__fmul_rn(a.w_class, -prob),
                              __fmul_rn(a.w_bbox, cb)),
                    __fmul_rn(a.w_giou, -giou));
    }
  }

  solve<K>(tile, rows, cols, p, p + cols, lane);

  const int64_t problem = (int64_t)l * gridDim.x + b;  // (l, b) of (L, B)
  int64_t* out = target_for_query + problem * Q;
  unsigned char* matched = query_matched + problem * Q;
  if (!transposed) {  // every query holds a slot
    for (int j = lane; j < M; j += 32) {
      const int qi = p[j];
      if (qi >= 0) {
        out[qi] = j;
        matched[qi] = (unsigned char)ti[kTReal * M + j];
      }
    }
  } else {  // column j is query j; a query no slot took gets M
    for (int j = lane; j < Q; j += 32) {
      const int s = p[j];
      out[j] = s >= 0 ? s : M;
      matched[j] = s >= 0 && ti[kTReal * M + s];
    }
  }
  if (costs != nullptr) {
    float* co = costs + problem * Q * M;
    for (int e = lane; e < Q * M; e += 32) {
      const int qi = e / M, s = e - qi * M;
      co[e] = tile[transposed ? s * Q + qi : e];
    }
  }
}

// fn(std::integral_constant<int, K>) for the K of m columns: the smallest
// power of two with 32 K >= m, m <= kMaxCols.
template <class Fn>
cudaError_t by_cols(int m, Fn&& fn) {
  if (m <= 32) return fn(std::integral_constant<int, 1>());
  if (m <= 64) return fn(std::integral_constant<int, 2>());
  if (m <= 128) return fn(std::integral_constant<int, 4>());
  if (m <= kMaxCols) return fn(std::integral_constant<int, 8>());
  return cudaErrorInvalidValue;
}

// The current device's opt-in shared memory a block, with every kernel
// allowed it: set once a device.
cudaError_t allow_smem(int* limit) {
  static int optin[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (optin[dev] == 0) {
    int bytes = 0;
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int m = 32; err == cudaSuccess && m <= kMaxCols; m <<= 1)
      err = by_cols(m, [&](auto k) {
        cudaError_t e = cudaFuncSetAttribute(
            solve_kernel<decltype(k)::value>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(
              match_kernel<decltype(k)::value>,
              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        return e;
      });
    if (err != cudaSuccess) return err;
    optin[dev] = bytes;
  }
  *limit = optin[dev];
  return cudaSuccess;
}

}  // namespace

// cost: contiguous (n, q, m) fp32 on the device, 1 <= q <= m <= 256; out:
// (n, q) int64, the column of each row. smem_limit: the shared memory the
// caller allows a block (one problem's costs, p and way must fit in it; the
// device's opt-in maximum caps it as well).
extern "C" int arsvt_lap_rect(const void* cost, void* out, int n, int q,
                              int m, int smem_limit, void* stream) {
  if (cost == nullptr || out == nullptr || n < 1 || q < 1 || m < q ||
      m > kMaxCols)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  const cudaError_t err = allow_smem(&limit);
  if (err != cudaSuccess) return (int)err;
  const int bytes = round16(4 * q * m) + state_bytes(m);
  if (bytes > limit || bytes > smem_limit) return (int)cudaErrorInvalidValue;
  return (int)by_cols(m, [&](auto k) {
    solve_kernel<decltype(k)::value>
        <<<n, 32, (size_t)bytes, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(cost), static_cast<int64_t*>(out), q,
            m);
    return cudaGetLastError();
  });
}

// The device route of matcher.py::match_layers for `layers` decoder layers
// of `batch` images: logits[l] (batch, q, classes) and boxes[l] (batch, q,
// 4) cxcywh, contiguous fp32 on the device; labels (batch, m) int32, or
// int64 where labels_int64; tgt_boxes (batch, m, 4) xyxy fp32; tgt_mask
// (batch, m) bool. Writes target_for_query (layers, batch, q) int64,
// query_matched (layers, batch, q) bool and, where `costs` is not null, the
// costs (layers, batch, q, m) fp32. q, m <= 256. smem_limit: as
// arsvt_lap_rect's, for the image's target terms and one layer's tile,
// query terms, staged logits and boxes, p and way.
extern "C" int arsvt_match_layers(
    const void* const* logits, const void* const* boxes, int layers,
    const void* labels, int labels_int64, const void* tgt_boxes,
    const void* tgt_mask, int batch, int q, int m, int classes,
    float w_class, float w_bbox, float w_giou, void* target_for_query,
    void* query_matched, void* costs, int smem_limit, void* stream) {
  if (logits == nullptr || boxes == nullptr || labels == nullptr ||
      tgt_boxes == nullptr || tgt_mask == nullptr ||
      target_for_query == nullptr || query_matched == nullptr ||
      layers < 1 || layers > kMaxLayers || batch < 1 || q < 1 || m < 1 ||
      q > kMaxCols || m > kMaxCols || classes < 1 || classes > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  Layers in{};
  for (int l = 0; l < layers; ++l) {
    if (logits[l] == nullptr || boxes[l] == nullptr)
      return (int)cudaErrorInvalidValue;
    in.logits[l] = static_cast<const float*>(logits[l]);
    in.boxes[l] = static_cast<const float*>(boxes[l]);
  }
  int limit = 0;
  const cudaError_t err = allow_smem(&limit);
  if (err != cudaSuccess) return (int)err;
  limit = smem_limit < limit ? smem_limit : limit;
  Match a{};
  a.layers = layers;
  a.q = q;
  a.m = m;
  a.classes = classes;
  a.labels_int64 = labels_int64 != 0;
  a.w_class = w_class;
  a.w_bbox = w_bbox;
  a.w_giou = w_giou;
  a.image_bytes = round16(4 * kImageTerms * m);
  a.tile_bytes = round16(4 * q * m);
  a.query_bytes = round16(4 * kQueryTerms * q);
  a.logit_bytes = round16(4 * q * classes);
  a.box_bytes = round16(16 * q);
  const int cols = q > m ? q : m;
  a.warp_bytes = a.tile_bytes + a.query_bytes + a.logit_bytes + a.box_bytes +
                 state_bytes(cols);
  if (a.image_bytes + a.warp_bytes > limit) return (int)cudaErrorInvalidValue;
  const int fit = (limit - a.image_bytes) / a.warp_bytes;
  a.warps = layers < fit ? layers : fit;
  a.warps = a.warps < kMaxWarps ? a.warps : kMaxWarps;
  const dim3 grid(batch, (layers + a.warps - 1) / a.warps);
  const size_t smem = (size_t)a.image_bytes + (size_t)a.warps * a.warp_bytes;
  return (int)by_cols(cols, [&](auto k) {
    match_kernel<decltype(k)::value>
        <<<grid, a.warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
            in, labels, static_cast<const float*>(tgt_boxes),
            static_cast<const unsigned char*>(tgt_mask),
            static_cast<int64_t*>(target_for_query),
            static_cast<unsigned char*>(query_matched),
            static_cast<float*>(costs), a);
    return cudaGetLastError();
  });
}
