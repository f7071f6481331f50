// The exact rectangular linear assignment of the detector's matcher
// (objectives/matcher.py::lap_rect). It replaces no Pallas kernel: JAX's
// lap_rect (arsvt_tpu/objectives/matcher.py:41-125) is plain JAX, a
// Jonker-Volgenant shortest augmenting path written with lax.scan over the
// rows and lax.while_loop growing the alternating tree, which XLA compiles
// into the train step. This kernel runs the same algorithm with the same
// arithmetic in the same order: cost[i] - u[i] - v, u + delta on the tree's
// rows, v - delta on the used columns, minv - delta on the others, the
// first index of the minimum of where(used, 1e30, minv). Subtractions and
// compares only, so integer-valued costs give JAX's assignment bit for bit,
// ties included (no --use_fast_math; nothing to contract into an FMA).
//
// Layout: one warp a problem, every problem of a call in one launch, four
// warps a block. Lane l owns columns j = l + 32k and rows r = l + 32k of its
// problem; u (q), v, minv, p, way and used (m) and tree (q) live in the
// warp's slice of dynamic shared memory, and the cost rows are read from
// global memory (coalesced: the lanes read consecutive columns). A column's
// v, minv, way and used are written only by its owner, so the warp meets
// (__syncwarp) only where every lane reads one element: minv[j1] (delta),
// u[row] after the dual update, and p after the augmenting walk, which lane
// 0 makes alone. The argmin is a butterfly of __shfl_xor_sync over (value,
// index) with jnp.argmin's order: NaN first, then the smaller value, ties to
// the smaller index, so every lane ends with the same column.
//
// Bound: it reads each cost once in the best case (L*B*q*m*4 bytes) and
// writes q int64 indices a problem; at the detector's (6, 32, 5, 25) that is
// 0.10 MB, microseconds below the launch's own latency, so the launch sets
// its time. The tree grows at most q columns a row, so a problem costs
// O(q^2 m) steps: one warp is enough for the port's q <= 100.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps (problems) a block, at most
constexpr float kUsed = 1e30f;     // JAX's _INF: used columns in the argmin

// a precedes b in jnp.argmin's order
__device__ __forceinline__ bool precedes(float a, int ia, float b, int ib) {
  const bool a_nan = a != a, b_nan = b != b;
  if (a_nan || b_nan) return a_nan && (!b_nan || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ int warp_argmin(float val, int idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o_val = __shfl_xor_sync(0xffffffffu, val, off);
    const int o_idx = __shfl_xor_sync(0xffffffffu, idx, off);
    if (precedes(o_val, o_idx, val, idx)) {
      val = o_val;
      idx = o_idx;
    }
  }
  return idx;
}

__global__ void __launch_bounds__(kWarps * 32)
    lap_kernel(const float* __restrict__ cost, int64_t* __restrict__ out,
               int n, int q, int m, int warps, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t problem = (int64_t)blockIdx.x * warps + warp;
  if (warp >= warps || problem >= n) return;  // whole warps leave together
  unsigned char* base = smem + (size_t)warp * warp_bytes;
  float* v = reinterpret_cast<float*>(base);
  float* minv = v + m;
  int* p = reinterpret_cast<int*>(minv + m);  // row of column j, -1 if free
  int* way = p + m;                           // predecessor column, -1: root
  float* u = reinterpret_cast<float*>(way + m);
  unsigned char* used = reinterpret_cast<unsigned char*>(u + q);
  unsigned char* tree = used + m;
  const float* c = cost + problem * q * m;

  for (int j = lane; j < m; j += 32) {
    v[j] = 0.0f;
    p[j] = -1;
  }
  for (int r = lane; r < q; r += 32) u[r] = 0.0f;
  __syncwarp();

  for (int i = 0; i < q; ++i) {
    // the tree rooted at row i
    const float ui = u[i];
    const float* ci = c + (size_t)i * m;
    float best = INFINITY;
    int best_j = 0x7fffffff;
    for (int j = lane; j < m; j += 32) {
      const float mv = ci[j] - ui - v[j];
      minv[j] = mv;
      way[j] = -1;
      used[j] = 0;
      if (precedes(mv, j, best, best_j)) {
        best = mv;
        best_j = j;
      }
    }
    for (int r = lane; r < q; r += 32) tree[r] = r == i;
    int j1 = warp_argmin(best, best_j);
    __syncwarp();

    // grow the tree until it reaches a free column; each pass uses one
    // more column, so m passes bound it even on NaN costs
    for (int pass = 0; pass < m && p[j1] != -1; ++pass) {
      const float delta = minv[j1];
      const int row = p[j1];
      __syncwarp();  // every lane has read minv[j1] before its owner moves it
      for (int r = lane; r < q; r += 32) {
        u[r] = u[r] + (tree[r] ? delta : 0.0f);
        if (r == row) tree[r] = 1;
      }
      for (int j = lane; j < m; j += 32) {
        v[j] = v[j] - (used[j] ? delta : 0.0f);
        if (!used[j]) minv[j] = minv[j] - delta;
        if (j == j1) used[j] = 1;
      }
      __syncwarp();  // u[row] is final
      const float ur = u[row];
      const float* cr = c + (size_t)row * m;
      best = INFINITY;
      best_j = 0x7fffffff;
      for (int j = lane; j < m; j += 32) {
        if (!used[j]) {
          const float cur = cr[j] - ur - v[j];
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j1;
          }
        }
        const float cand = used[j] ? kUsed : minv[j];
        if (precedes(cand, j, best, best_j)) {
          best = cand;
          best_j = j;
        }
      }
      j1 = warp_argmin(best, best_j);
      __syncwarp();  // minv[j1] is final for the next pass's delta
    }

    // final dual update so the new matched edge becomes tight
    const float delta = minv[j1];
    for (int r = lane; r < q; r += 32) u[r] = u[r] + (tree[r] ? delta : 0.0f);
    for (int j = lane; j < m; j += 32) v[j] = v[j] - (used[j] ? delta : 0.0f);
    __syncwarp();
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
    __syncwarp();
  }

  // invert p (column -> row) into col_for_row; free columns are dropped
  int64_t* o = out + problem * q;
  for (int j = lane; j < m; j += 32) {
    if (p[j] >= 0) o[p[j]] = j;
  }
}

int warp_bytes(int q, int m) {
  return (4 * (4 * m + q) + m + q + 15) / 16 * 16;
}

}  // namespace

// cost: contiguous (n, q, m) fp32 on the device, 1 <= q <= m; out: (n, q)
// int64, the column of each row. smem_limit: the shared memory the caller
// allows a block (one warp's problem must fit in it; the device's opt-in
// maximum caps it as well).
extern "C" int arsvt_lap_rect(const void* cost, void* out, int n, int q,
                              int m, int smem_limit, void* stream) {
  if (n < 1 || q < 1 || m < q) return (int)cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int limit = smem_limit < optin ? smem_limit : optin;
  const int bytes = warp_bytes(q, m);
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  const int warps = limit / bytes < kWarps ? limit / bytes : kWarps;
  const size_t smem = (size_t)warps * bytes;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lap_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)((n + warps - 1) / warps);
  lap_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<int64_t*>(out), n, q, m,
      warps, bytes);
  return (int)cudaGetLastError();
}
