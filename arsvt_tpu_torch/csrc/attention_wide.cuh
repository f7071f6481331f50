// The head-major attention kernels (#3, flash_attention_fwd.cu; #4,
// flash_attention_bwd.cu) past a head dim of 128, on warp_tile.cuh's
// tensor-core tiles: the same arithmetic and rounding points as
// attention_fwd.cuh's and attention_bwd.cuh's bodies (see there), which
// hold a warp's rows over the whole padded head dim in registers and so
// stop at 128 (a 16 x 256 fp32 accumulator alone is 128 registers a
// thread).
//
// Design: the head dim d is cut into slices of kSlice = 64 columns, and
// each block owns one slice of the output columns beside its 64 rows: the
// grid's x axis runs over (row tile, output slice) pairs, ceil(d / 64)
// blocks per row tile. Every block recomputes the scores (and, in the
// backward, dP) over all of d, a 64-deep slice at a time: each slice of
// the block's rows and of the chunk's rows is staged as a 64 x 64 tile
// through the ring of two slots (16-byte cp.async where every row is
// 16-byte aligned, else element by element, attention_fwd.cuh's rule) and
// multiplied into the fp32 accumulator, which stays in registers across
// the slices. Only then is the chunk's block of the second operand staged
// for the block's own output columns. So a block keeps a 16 x 64 score
// tile and a 16 x 64 output accumulator a warp, as the d <= 64 kernels do,
// and shared memory does not grow with d. The blocks of one row tile draw
// the same dropout mask (enc::keeps of (seed, b*H + h, row, col)) and
// compute the same m, l (forward) and delta (backward) bit for bit; the
// block of slice 0 writes lse (forward) or delta (the dq kernel, for the
// dk/dv kernel that follows on the stream).
//   Forward, per key chunk: pass 1 stages (Q, K) slices and takes the row
//     max; pass 2 stages them again, forms p (with the dropout replay) and
//     then stages V's 64 columns of the block's slice for O += p.to(T) V.
//   dq kernel: first the (O, dO) slices of its rows for delta; per key
//     chunk, the (Q, K) slices give S, the (dO, V) slices dP, and the
//     chunk's K columns of the block's slice take dq += dS.to(T) K.
//   dk/dv kernel: per query chunk, (K, Q) slices give S^T, (V, dO) slices
//     dP^T, then the chunk's q and dO columns of the block's slice take dk
//     += dS^T q and dv += P_v^T dO; lse and delta of the chunk's queries
//     are read from device memory (L1-resident, 64 floats a chunk).
// Each item of the walk (a pair of 64 x 64 tiles) is one commit group, the
// next one in flight while the current one is computed. The work grows as
// d^2 / 64 in the score products (every slice block redoes them), the
// price of staying inside the registers at any d.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd.cuh"  // attn:: args, mma_tile, store_acc, run

namespace attn {

constexpr int kSlice = 64;  // head-dim columns of a staged tile and of a
                            // block's output slice

template <typename T>
struct WideLayout {
  using A = Layout<T, kSlice>;
  static constexpr bool kF32 = A::kF32;
  static constexpr int kLd = A::kLd;         // staged row stride
  static constexpr int kTile = kKeys * kLd;  // 64 staged rows
  static constexpr int kSlot = 2 * kTile;    // one item: two tiles
  // the ring; fp32 adds each warp's rows of a product operand (P, dS)
  static constexpr size_t kBytes =
      sizeof(T) * kStages * kSlot +
      (kF32 ? sizeof(float) * kRows * A::kPLd : 0);
};

// Slices of d (and output slices of a row tile).
__host__ __device__ __forceinline__ int slices(int d) {
  return (d + kSlice - 1) / kSlice;
}

// 64 rows of a 64-column slice at src (row stride ld) into a staged tile;
// rows >= rvalid and columns >= cvalid are zeros. The element-wise copy
// keeps 4 loads in flight a thread, not 16: the walk holds its score and
// output accumulators across the copy.
template <typename T>
__device__ __forceinline__ void stage_slice(bool vec, T* dst, const T* src,
                                            int64_t ld, int rvalid,
                                            int cvalid) {
  constexpr int kLd = WideLayout<T>::kLd;
  if (vec)
    copy_tile_async<kThreads>(dst, kLd, src, ld, kKeys, kSlice, rvalid,
                              cvalid);
  else
    copy_tile_elems<kThreads, T, 4>(dst, kLd, src, ld, kKeys, kSlice, rvalid,
                                    cvalid);
}

// s += A B^T over one 64-deep slice, for one warp's 16 rows of A (at Aw,
// [m][k]) and the `live` 16-row groups of the tile at Bc ([n][k]): bf16 on
// the tensor cores, fp32 on the CUDA cores (every group; the dead ones
// are staged zeros).
template <typename T>
__device__ __forceinline__ void add_scores(float (&s)[1][kKeys / 8][4],
                                           const T* Aw, const T* Bc,
                                           int live) {
  using L = WideLayout<T>;
  constexpr int kN = kKeys / 8, kLd = L::kLd;
  if constexpr (L::kF32) {
    warp_mma<1, kN, kSlice, false, false>(s, Aw, kLd, Bc, kLd);
  } else {
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16) {
      uint32_t a[4];
      load_a_frag<false>(a, Aw, kLd, kk);
#pragma unroll
      for (int jp = 0; jp < kN / 2; ++jp) {  // rows 16 jp .. 16 jp + 15
        if (jp >= live) break;
        uint32_t b[2][2];
        load_b_frags<2, false>(b, Bc + 16 * jp * kLd, kLd, kk);
        mma_bf16(s[0][2 * jp], a, b[0]);
        mma_bf16(s[0][2 * jp + 1], a, b[1]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[1][kKeys / 8][4]) {
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[0][j][e] = 0.f;
}

// The walk's ring: item `it` staged by stage_item(it, slot) into its slot,
// one commit group per item, empty past `total`.
template <typename T, class Stage>
struct Ring {
  T* base;
  int total;
  Stage stage_item;
  __device__ __forceinline__ void enqueue(int it) {
    if (it < total)
      stage_item(it, base + (it % kStages) * WideLayout<T>::kSlot);
    cp_async_commit();
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int it = 0; it < kStages - 1; ++it) enqueue(it);
  }
  // Wait for item `it`, queue the item kStages - 1 ahead; the slot of `it`.
  __device__ __forceinline__ const T* next(int it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item `it` has landed; every warp is done with the
                      // slot the enqueue refills
    enqueue(it + kStages - 1);
    return base + (it % kStages) * WideLayout<T>::kSlot;
  }
};

template <typename T, class Stage>
__device__ __forceinline__ Ring<T, Stage> make_ring(T* base, int total,
                                                    Stage stage) {
  return Ring<T, Stage>{base, total, stage};
}

// ---------------------------------------------------------------- forward

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_wide_kernel(const FwdArgs<T> a) {
  using L = WideLayout<T>;
  constexpr int kLd = L::kLd, kN = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring_base = reinterpret_cast<T*>(smem_raw);
  float* Ps = reinterpret_cast<float*>(ring_base + kStages * L::kSlot);

  const int ns = slices(a.d);
  const int row0 = blockIdx.x / ns * kRows, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * a.heads + h);
  const enc::Dropout drop = a.drop;
  const uint32_t mbh = drop.bh(b, h);  // the mask's global index
  const int warp = threadIdx.x >> 5;
  const int wrow0 = row0 + 16 * warp;  // this warp's first query row
  const bool active = wrow0 < a.sq;    // warp-uniform
  const int nk = (a.sk + kKeys - 1) / kKeys;

  // pass 1, per key chunk: ns (Q, K) slices; pass 2: the same, then V's
  // columns of this block's slice (its offsets are recomputed here from
  // the block index and the arguments, which keeps them out of the
  // registers the walk holds)
  auto ring = make_ring(ring_base, nk * (2 * ns + 1), [&](int it, T* dst) {
    const int n_s = slices(a.d), first2 = nk * n_s;
    const int r0 = blockIdx.x / n_s * kRows;
    const bool p1 = it < first2;
    const int j = p1 ? it : it - first2, per = p1 ? n_s : n_s + 1;
    const int k0 = j / per * kKeys, s = j % per;
    if (s < n_s) {
      stage_slice(a.vec, dst, a.q.at(b, h) + r0 * a.q.ld + s * kSlice,
                  a.q.ld, a.sq - r0, a.d - s * kSlice);
      stage_slice(a.vec, dst + L::kTile,
                  a.k.at(b, h) + k0 * a.k.ld + s * kSlice, a.k.ld,
                  a.sk - k0, a.d - s * kSlice);
    } else {
      const int c0 = blockIdx.x % n_s * kSlice;
      stage_slice(a.vec, dst, a.v.at(b, h) + k0 * a.v.ld + c0, a.v.ld,
                  a.sk - k0, a.d - c0);
    }
  });
  ring.start();

  float* Pw = Ps + 16 * warp * L::A::kPLd;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[1][kSlice / 8][4];
#pragma unroll
  for (int j = 0; j < kSlice / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][j][e] = 0.f;
  auto live_groups = [&](int k0) { return (min(kKeys, a.sk - k0) + 15) / 16; };

  int it = 0;
  // pass 1: the row max over the Sk keys, masked ones at MASK_VALUE
  for (int k0 = 0; k0 < a.sk; k0 += kKeys) {
    const int live = live_groups(k0);
    float s[1][kN][4];
    zero(s);
    for (int sl = 0; sl < ns; ++sl) {
      const T* slot = ring.next(it++);
      if (active) add_scores<T>(s, slot + 16 * warp * kLd, slot + L::kTile,
                                live);
    }
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j >= 2 * live) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + frag_col(e);
        const float x = col < a.kv_len ? s[0][j][e] * a.scale : kMaskValue;
        m[e >> 1] = fmaxf(m[e >> 1], col < a.sk ? x : -INFINITY);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // each row's max over its quad
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }

  // pass 2: p = exp(s - m), l = rowsum(p), O += p.to(T) V[:, c0 .. c0 + 63]
  for (int k0 = 0; k0 < a.sk; k0 += kKeys) {
    const int live = live_groups(k0);
    float s[1][kN][4];
    zero(s);
    for (int sl = 0; sl < ns; ++sl) {
      const T* slot = ring.next(it++);
      if (active) add_scores<T>(s, slot + 16 * warp * kLd, slot + L::kTile,
                                live);
    }
    const T* Vc = ring.next(it++);
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j >= 2 * live) {  // a skipped group: keys past Sk, p = 0
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][j][e] = 0.f;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a column past Sk in a live group
        // scores 0 (its K rows are zeros), so its exp is finite or +inf,
        // and is replaced by 0
        const int col = k0 + 8 * j + frag_col(e), i = e >> 1;
        const float x = col < a.kv_len ? s[0][j][e] * a.scale : kMaskValue;
        float p = expf(x - m[i]);
        p = col < a.sk ? p : 0.f;
        l[i] += p;
        if constexpr (kDrop)
          p = enc::keeps(drop, mbh, wrow0 + frag_row(e), col)
                  ? p * drop.inv_keep
                  : 0.f;
        s[0][j][e] = p;
      }
    }
    if constexpr (L::kF32) {  // P through this warp's rows of Ps
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          store2(Pw + frag_row(2 * i) * L::A::kPLd + 8 * j + frag_col(0),
                 s[0][j][2 * i], s[0][j][2 * i + 1]);
      __syncwarp();
      warp_mma<1, kSlice / 8, kKeys, false, true>(o, Pw, L::A::kPLd, Vc,
                                                  kLd);
      __syncwarp();  // read before the next chunk's P is written
    } else {  // P stays in registers, rounded to bf16
      uint32_t pf[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        pack_a_frag(pf[kk], s[0][2 * kk], s[0][2 * kk + 1]);
      warp_mma_afrag<kSlice / 8, kKeys, true>(o[0], pf, Vc, kLd, live);
    }
  }
  cp_async_wait<0>();  // the groups still open are empty
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* out = a.out.at(b, h);
  const int c0 = blockIdx.x % ns * kSlice;  // this block's output columns
  const int cols = a.d - c0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow0 + frag_row(2 * i);
    if (row >= a.sq) continue;
    T* out_row = out + row * a.out.ld + c0;
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
      const int c = 8 * j + frag_col(0);
      const float v0 = o[0][j][2 * i] / l[i], v1 = o[0][j][2 * i + 1] / l[i];
      if (a.pair_store && c + 1 < cols) {
        store2(out_row + c, v0, v1);
      } else {
        if (c < cols) out_row[c] = from_float<T>(v0);
        if (c + 1 < cols) out_row[c + 1] = from_float<T>(v1);
      }
    }
    if (c0 == 0 && (threadIdx.x & 3) == 0)
      a.lse[(int64_t)bh * a.sq + row] = m[i] + logf(l[i]);
  }
}

// ----------------------------------------------------------- backward, dq

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_wide_kernel(const BwdArgs<T> a) {
  using L = WideLayout<T>;
  constexpr int kLd = L::kLd, kN = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring_base = reinterpret_cast<T*>(smem_raw);
  float* Fs = reinterpret_cast<float*>(ring_base + kStages * L::kSlot);

  const int ns = slices(a.d);
  const int c0 = blockIdx.x % ns * kSlice;  // this block's dq columns
  const int row0 = blockIdx.x / ns * kRows, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * a.heads + h);
  const enc::Dropout drop = a.drop;
  const uint32_t mbh = drop.bh(b, h);  // the mask's global index
  const T* q = a.q.at(b, h);
  const T* k = a.k.at(b, h);
  const T* v = a.v.at(b, h);
  const T* o = a.o.at(b, h);
  const T* dout = a.dout.at(b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow0 = row0 + 16 * warp;  // this warp's first query row
  const bool active = wrow0 < a.sq;    // warp-uniform
  const int nk = (a.sk + kKeys - 1) / kKeys;

  // ns (O, dO) slices of the block's rows; per key chunk ns (Q, K) slices,
  // ns (dO, V) slices, then K's columns of this block's slice
  const int per = 2 * ns + 1;
  auto ring = make_ring(ring_base, ns + nk * per, [&](int it, T* dst) {
    const int rq = a.sq - row0;
    if (it < ns) {
      const int s0 = it * kSlice;
      stage_slice(a.vec, dst, o + row0 * a.o.ld + s0, a.o.ld, rq, a.d - s0);
      stage_slice(a.vec, dst + L::kTile, dout + row0 * a.dout.ld + s0,
                  a.dout.ld, rq, a.d - s0);
      return;
    }
    const int j = it - ns, k0 = j / per * kKeys, s = j % per;
    if (s < 2 * ns) {
      const int s0 = s % ns * kSlice;
      const bool second = s >= ns;  // dP's operands
      const T* x = second ? dout : q;
      const T* y = second ? v : k;
      const int64_t ldx = second ? a.dout.ld : a.q.ld;
      const int64_t ldy = second ? a.v.ld : a.k.ld;
      stage_slice(a.vec, dst, x + row0 * ldx + s0, ldx, rq, a.d - s0);
      stage_slice(a.vec, dst + L::kTile, y + k0 * ldy + s0, ldy, a.sk - k0,
                  a.d - s0);
    } else {
      stage_slice(a.vec, dst, k + k0 * a.k.ld + c0, a.k.ld, a.sk - k0,
                  a.d - c0);
    }
  });
  ring.start();

  // delta = rowsum(O * dO) in fp32 over all of d: lanes 2r and 2r + 1 sum
  // the two halves of each slice of the warp's row r
  int it = 0;
  float sum = 0.f;
  for (int sl = 0; sl < ns; ++sl) {
    const T* slot = ring.next(it++);
    const int r = lane >> 1, h0 = (lane & 1) * (kSlice / 2);
    const T* orow = slot + (16 * warp + r) * kLd + h0;
    const T* grow = slot + L::kTile + (16 * warp + r) * kLd + h0;
#pragma unroll 8
    for (int c = 0; c < kSlice / 2; ++c)
      sum = fmaf(to_float(orow[c]), to_float(grow[c]), sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  float delta[2], lse[2];
  {
    const int r = lane >> 1, g = lane >> 2;
    delta[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    delta[1] = __shfl_sync(0xffffffffu, sum, 2 * (g + 8));
    if (c0 == 0 && active && (lane & 1) == 0 && wrow0 + r < a.sq)
      a.delta[(int64_t)bh * a.sq + wrow0 + r] = sum;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow0 + frag_row(2 * i);
      lse[i] = row < a.sq ? a.lse[(int64_t)bh * a.sq + row] : 0.f;
    }
  }

  float* Fw = Fs + 16 * warp * L::A::kPLd;
  float acc[1][kSlice / 8][4];
#pragma unroll
  for (int j = 0; j < kSlice / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;

  for (int k0 = 0; k0 < a.sk; k0 += kKeys) {
    const int live = (min(kKeys, a.sk - k0) + 15) / 16;
    float s[1][kN][4], dp[1][kN][4];
    zero(s);
    zero(dp);
    for (int sl = 0; sl < ns; ++sl) {
      const T* slot = ring.next(it++);
      if (active) add_scores<T>(s, slot + 16 * warp * kLd, slot + L::kTile,
                                live);
    }
    for (int sl = 0; sl < ns; ++sl) {
      const T* slot = ring.next(it++);
      if (active) add_scores<T>(dp, slot + 16 * warp * kLd, slot + L::kTile,
                                live);
    }
    const T* Kc = ring.next(it++);
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j >= 2 * live) {  // a skipped group: keys past Sk, dS = 0
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][j][e] = 0.f;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // selects, no branch per element
        const int col = k0 + 8 * j + frag_col(e), i = e >> 1;
        const float x = col < a.kv_len ? s[0][j][e] * a.scale : kMaskValue;
        float p = expf(x - lse[i]);
        p = col < a.sk ? p : 0.f;
        float g = dp[0][j][e];
        if constexpr (kDrop)
          g = enc::keeps(drop, mbh, wrow0 + frag_row(e), col)
                  ? g * drop.inv_keep
                  : 0.f;
        s[0][j][e] = p * (g - delta[i]);
      }
    }
    mma_tile<T, kSlice>(acc, s[0], Kc, Fw, live);
  }
  cp_async_wait<0>();  // the groups still open are empty
  if (!active) return;
  store_acc<T, kSlice>(a.dq.at(b, h) + wrow0 * a.dq.ld + c0, a.dq.ld,
                       a.sq - wrow0, acc, a.scale, a.d - c0, a.pair_store);
}

// -------------------------------------------------------- backward, dk/dv

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_wide_kernel(const BwdArgs<T> a) {
  using L = WideLayout<T>;
  constexpr int kLd = L::kLd, kN = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring_base = reinterpret_cast<T*>(smem_raw);
  float* Fs = reinterpret_cast<float*>(ring_base + kStages * L::kSlot);

  const int ns = slices(a.d);
  const int c0 = blockIdx.x % ns * kSlice;  // this block's dk, dv columns
  const int key0 = blockIdx.x / ns * kRows, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * a.heads + h);
  const enc::Dropout drop = a.drop;
  const uint32_t mbh = drop.bh(b, h);  // the mask's global index
  const T* q = a.q.at(b, h);
  const T* k = a.k.at(b, h);
  const T* v = a.v.at(b, h);
  const T* dout = a.dout.at(b, h);
  const float* lse = a.lse + (int64_t)bh * a.sq;
  const float* delta = a.delta + (int64_t)bh * a.sq;
  const int warp = threadIdx.x >> 5;
  const int wkey0 = key0 + 16 * warp;  // this warp's first key
  const bool active = wkey0 < a.sk;    // warp-uniform

  // per query chunk: ns (K, q) slices, ns (V, dO) slices, then q's and
  // dO's columns of this block's slice
  const int per = 2 * ns + 1;
  const int nq = (a.sq + kKeys - 1) / kKeys;
  auto ring = make_ring(ring_base, nq * per, [&](int it, T* dst) {
    const int q0 = it / per * kKeys, s = it % per, rq = a.sq - q0;
    if (s < 2 * ns) {
      const int s0 = s % ns * kSlice;
      const bool second = s >= ns;  // dP^T's operands
      const T* x = second ? v : k;
      const T* y = second ? dout : q;
      const int64_t ldx = second ? a.v.ld : a.k.ld;
      const int64_t ldy = second ? a.dout.ld : a.q.ld;
      stage_slice(a.vec, dst, x + key0 * ldx + s0, ldx, a.sk - key0,
                  a.d - s0);
      stage_slice(a.vec, dst + L::kTile, y + q0 * ldy + s0, ldy, rq,
                  a.d - s0);
    } else {
      stage_slice(a.vec, dst, q + q0 * a.q.ld + c0, a.q.ld, rq, a.d - c0);
      stage_slice(a.vec, dst + L::kTile, dout + q0 * a.dout.ld + c0,
                  a.dout.ld, rq, a.d - c0);
    }
  });
  ring.start();

  float* Fw = Fs + 16 * warp * L::A::kPLd;
  float dk[1][kSlice / 8][4], dv[1][kSlice / 8][4];
#pragma unroll
  for (int j = 0; j < kSlice / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[0][j][e] = dv[0][j][e] = 0.f;

  int it = 0;
  for (int q0 = 0; q0 < a.sq; q0 += kKeys) {
    const int live = (min(kKeys, a.sq - q0) + 15) / 16;
    // S^T and dP^T: this warp's keys by the chunk's queries
    float s[1][kN][4], dp[1][kN][4];
    zero(s);
    zero(dp);
    for (int sl = 0; sl < ns; ++sl) {
      const T* slot = ring.next(it++);
      if (active) add_scores<T>(s, slot + 16 * warp * kLd, slot + L::kTile,
                                live);
    }
    for (int sl = 0; sl < ns; ++sl) {
      const T* slot = ring.next(it++);
      if (active) add_scores<T>(dp, slot + 16 * warp * kLd, slot + L::kTile,
                                live);
    }
    const T* Qc = ring.next(it++);
    const T* dOc = Qc + L::kTile;
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j >= 2 * live) {  // a skipped group: queries past Sq
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][j][e] = dp[0][j][e] = 0.f;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // S^T and dP^T at (query, key) become
        // dS^T and P_v^T; a query past Sq gets p = 0 by a select
        const int qi = q0 + 8 * j + frag_col(e), key = wkey0 + frag_row(e);
        const bool in = qi < a.sq;
        const int qr = in ? qi : a.sq - 1;
        const float x = key < a.kv_len ? s[0][j][e] * a.scale : kMaskValue;
        float p = expf(x - lse[qr]);
        p = in ? p : 0.f;
        float g = dp[0][j][e], pv = p;
        if constexpr (kDrop) {
          const bool keep = enc::keeps(drop, mbh, qi, key);
          g = keep ? g * drop.inv_keep : 0.f;
          pv = keep ? p * drop.inv_keep : 0.f;
        }
        dp[0][j][e] = p * (g - delta[qr]);  // dS^T
        s[0][j][e] = pv;                    // P_v^T
      }
    }
    mma_tile<T, kSlice>(dk, dp[0], Qc, Fw, live);
    mma_tile<T, kSlice>(dv, s[0], dOc, Fw, live);
  }
  cp_async_wait<0>();
  if (!active) return;
  store_acc<T, kSlice>(a.dk.at(b, h) + wkey0 * a.dk.ld + c0, a.dk.ld,
                       a.sk - wkey0, dk, a.scale, a.d - c0, a.pair_store);
  store_acc<T, kSlice>(a.dv.at(b, h) + wkey0 * a.dv.ld + c0, a.dv.ld,
                       a.sk - wkey0, dv, 1.f, a.d - c0, a.pair_store);
}

// ------------------------------------------------------------------ host

template <typename T, bool kDrop>
cudaError_t launch_fwd_wide_kernel(const FwdArgs<T>& a, int batch,
                                   cudaStream_t stream) {
  constexpr size_t kBytes = WideLayout<T>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_wide_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kRows - 1) / kRows * slices(a.d), a.heads, batch);
  attention_fwd_wide_kernel<T, kDrop><<<grid, kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

// The forward past d = 128 on `stream`: grid (ceil(Sq / 64) * ceil(d /
// 64), heads, batch); dropout 0 or 1 picks the instantiation.
template <typename T>
cudaError_t launch_fwd_wide(FwdArgs<T> a, int batch, int dropout,
                            cudaStream_t stream) {
  a.vec = rows_aligned(a.q, a.d) && rows_aligned(a.k, a.d) &&
          rows_aligned(a.v, a.d);
  a.pair_store =
      reinterpret_cast<uintptr_t>(a.out.base) % (2 * sizeof(T)) == 0 &&
      a.out.sb % 2 == 0 && a.out.sh % 2 == 0 && a.out.ld % 2 == 0 &&
      a.d % 2 == 0;
  return enc::with_dropout(dropout, [&](auto flag) {
    return launch_fwd_wide_kernel<T, decltype(flag)::value>(a, batch,
                                                           stream);
  });
}

template <typename T, bool kDrop>
cudaError_t launch_bwd_wide_kernels(const BwdArgs<T>& a, int batch,
                                    cudaStream_t stream) {
  constexpr size_t kBytes = WideLayout<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_wide_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_wide_kernel<T, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kBytes);
  if (err != cudaSuccess) return err;
  const int ns = slices(a.d);
  const dim3 grid_q((a.sq + kRows - 1) / kRows * ns, a.heads, batch);
  attention_bwd_dq_wide_kernel<T, kDrop>
      <<<grid_q, kThreads, kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.sk + kRows - 1) / kRows * ns, a.heads, batch);
  attention_bwd_dkdv_wide_kernel<T, kDrop>
      <<<grid_k, kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

// The backward past d = 128 on `stream`: the dq kernel, then the dk/dv
// kernel, grids (ceil(Sq / 64) * ceil(d / 64), heads, batch) and
// (ceil(Sk / 64) * ceil(d / 64), heads, batch).
template <typename T>
cudaError_t launch_bwd_wide(BwdArgs<T> a, int batch, int dropout,
                            cudaStream_t stream) {
  a.vec = rows_aligned(a.q, a.d) && rows_aligned(a.k, a.d) &&
          rows_aligned(a.v, a.d) && rows_aligned(a.o, a.d) &&
          rows_aligned(a.dout, a.d);
  a.pair_store = pairs_aligned(a.dq) && pairs_aligned(a.dk) &&
                 pairs_aligned(a.dv) && a.d % 2 == 0;
  return enc::with_dropout(dropout, [&](auto flag) {
    return launch_bwd_wide_kernels<T, decltype(flag)::value>(a, batch,
                                                            stream);
  });
}

}  // namespace attn
