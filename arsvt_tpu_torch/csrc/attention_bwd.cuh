// The attention backward shared by the direct-layout encoder kernel (#2,
// encoder_attention_bwd.cu) and the head-major kernel (#4,
// flash_attention_bwd.cu), on warp_tile.cuh's tensor-core tiles, and the
// product and store helpers it shares with the save-probs backward (#6,
// encoder_attention_savep_bwd.cu).
//
// For batch item b and head h it computes, with the TPU kernels' rounding
// points (flash_attention.py::_bwd_kernel, ::_bwd_kernel_direct):
//   s = q k^T * scale (fp32); s[:, c] = MASK_VALUE for kv_len <= c < Sk,
//   p = exp(s - lse), delta = rowsum(O * dO) (fp32), dP = dO v^T (fp32),
//   with dropout dP = keep ? dP / keep_prob : 0 and p_v = keep ? p /
//   keep_prob : 0 (else p_v = p), dS = p (dP - delta),
//   dq = (dS.to(T) k) * scale, dk = (dS.to(T)^T q) * scale,
//   dv = p_v.to(T)^T dO,
// every product summed in fp32 and cast to T at the end. The mask is
// enc::keeps, the one the forwards draw.
//
// Design. Operands are addressed as attention_fwd.cuh's are (base + b * sb
// + h * sh + row * ld), so one body reads the packed (B, S, 3D) qkv's head
// columns and (B, S, D) O and dO (#2) or contiguous (B, H, S, d) slabs
// (#4), and writes dq, dk and dv the same way. The head dim is padded in
// shared memory to kDp (16, 32, 64, 96 or 128); padded columns are zeros.
// Rows are staged in T by 16-byte cp.async when every row is 16-byte
// aligned, else element by element (attention_fwd.cuh's rule), and chunks
// of 64 rows come through a ring of two slots, the next in flight while
// the current one is computed. bf16 runs mma.sync m16n8k16 with fp32
// accumulation; fp32 runs the same tiles on the CUDA cores (warp_mma's
// fp32 body), with each warp's dS or P_v rows staged in shared memory for
// the second product. The sums over keys (dq) and over queries (dk, dv)
// stay deterministic with no atomics: two kernels on one stream.
//   1. attention_bwd_dq_kernel, one block of four warps per (64 query
//      rows, head, batch item), 16 rows a warp. It stages Q and dO of its
//      rows, and O into the ring's second slot, which the walk has not
//      reached yet; delta = rowsum(O * dO) comes from the staged tiles and
//      is written to the (B, H, Sq) scratch. The walk over the keys (K and
//      V through the ring): S = Q K^T and dP = dO V^T, p = exp(s - lse),
//      the replay, dS = p (dP - delta) rounded to T as it is packed into A
//      fragments (dS never leaves registers), dq += dS K with K through
//      ldmatrix.trans.
//   2. attention_bwd_dkdv_kernel, one block of four warps per (64 keys,
//      head, batch item), 16 keys a warp. The walk over the queries (q and
//      dO through the ring, lse and delta beside them by 4-byte cp.async):
//      S^T = K Q^T and dP^T = V dO^T, p from lse[query], the replay drawn
//      at (query, key), dS^T and P_v^T each rounded to T as it is packed,
//      dk += dS^T q and dv += P_v^T dO, q and dO through ldmatrix.trans.
// Each kernel draws each mask element once. The A fragments of the
// block's own rows (Q and dO, or K and V) stay in registers for kDp <= 64
// (in the dk/dv kernel only without dropout, whose draw takes their
// room); otherwise they are read from shared memory by ldmatrix at each
// chunk, a 16-deep step at a time; past 64 columns the dk/dv kernel also
// walks each chunk one 16-query group at a time (S^T and dP^T of 16 x 16,
// their products straight into dk and dv), so that the kDp registers of
// its accumulators fit beside them without a spill. s is computed in both
// kernels with the roles of A and B exchanged, so p may differ by an ulp
// between dq and dk/dv. Keys >= Sk (tile padding) get p = 0 by a select in
// the dq kernel, queries >= Sq get p = 0 by a select in the dk/dv kernel
// (their staged rows are zeros and lse 0, so p would be exp(0)); rows past
// Sq or Sk are not stored. Shared memory does not grow with S: in bf16
// 54 KiB (dq) and 55 KiB (dk/dv) at kDp = 64, 102 and 103 KiB at 128; in
// fp32 at 128, 215 and 216 KiB of the 227 KiB a block may take.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_fwd.cuh"  // attn:: staging and score tiles; enc::keeps

namespace attn {

// ------------------------------------------- helpers shared with #6

// P for one warp's 16 rows (m) and a chunk's `live` 16-column groups (n),
// in the accumulator's layout: p[j][e] = P(m = frag_row(e), n = 8 j +
// frag_col(e)), from the bf16 tile at Pw, stored [m][n] or, kTrans, [n][m]
// (row stride ld). Groups past `live` read as zeros.
template <bool kTrans>
__device__ __forceinline__ void load_p(float (&p)[kKeys / 8][4],
                                       const __nv_bfloat16* Pw, int ld,
                                       int live) {
#pragma unroll
  for (int q = 0; q < kKeys / 16; ++q) {
    uint32_t f[4] = {0u, 0u, 0u, 0u};
    if (q < live) load_a_frag<kTrans>(f, Pw, ld, 16 * q);
    // the A fragment's registers 0-1 are columns 16q..16q+7, rows g and
    // g + 8; registers 2-3 the next 8 columns: accumulators 2q and 2q + 1
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* dst = p[2 * q + (r >> 1)] + 2 * (r & 1);
      dst[0] = __uint_as_float(f[r] << 16);
      dst[1] = __uint_as_float(f[r] & 0xffff0000u);
    }
  }
}

// acc[0] += A B with A the 16 x 64 tile `x` (accumulator layout, rounded to
// T as it is packed: A fragments in bf16, this warp's fp32 rows Fw in fp32)
// and B the staged chunk Bc as [k][n] (kDp columns), over its `live`
// 16-deep steps. Past 64 columns B's fragments are loaded two 8-column
// tiles at a time, not a whole 16-deep step's at once, which would take
// 2 * kDp / 8 registers beside the accumulators.
template <typename T, int kDp>
__device__ __forceinline__ void mma_tile(float (&acc)[1][kDp / 8][4],
                                         const float (&x)[kKeys / 8][4],
                                         const T* Bc, float* Fw, int live) {
  using L = Layout<T, kDp>;
  if constexpr (L::kF32) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store2(Fw + frag_row(2 * i) * L::kPLd + 8 * j + frag_col(0),
               x[j][2 * i], x[j][2 * i + 1]);
    __syncwarp();
    warp_mma<1, kDp / 8, kKeys, false, true>(acc, Fw, L::kPLd, Bc, L::kLd);
    __syncwarp();  // read before the next tile is written
  } else {
    uint32_t f[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      pack_a_frag(f[kk], x[2 * kk], x[2 * kk + 1]);
    if constexpr (kDp <= 64) {
      warp_mma_afrag<kDp / 8, kKeys, true>(acc[0], f, Bc, L::kLd, live);
    } else {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        if (kk >= live) break;
#pragma unroll
        for (int j = 0; j < kDp / 8; j += 2) {
          uint32_t b[2][2];
          load_b_frags<2, true>(b, Bc + 8 * j, L::kLd, 16 * kk);
          mma_bf16(acc[0][j], f[kk], b[0]);
          mma_bf16(acc[0][j + 1], f[kk], b[1]);
        }
      }
    }
  }
}

// 16 rows of a warp's fp32 accumulator (times `scale`), cast to T, into
// dst + r * ld for the rows r < rows and the columns c < cols: two
// neighbouring columns at a time where `pair` (the rows 4-byte aligned).
template <typename T, int kDp>
__device__ __forceinline__ void store_acc(T* dst, int64_t ld, int rows,
                                          const float (&acc)[1][kDp / 8][4],
                                          float scale, int cols = kDp,
                                          bool pair = true) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = frag_row(2 * i);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kDp / 8; ++j) {
      const int c = 8 * j + frag_col(0);
      const float v0 = acc[0][j][2 * i] * scale;
      const float v1 = acc[0][j][2 * i + 1] * scale;
      if (pair && c + 1 < cols) {
        store2(dst + r * ld + c, v0, v1);
      } else {
        if (c < cols) dst[r * ld + c] = from_float<T>(v0);
        if (c + 1 < cols) dst[r * ld + c + 1] = from_float<T>(v1);
      }
    }
  }
}

// A chunk with `rows_left` rows to go: a full one (every 16-row group
// live) as an instantiation with no per-group branch, the partial last one
// as another.
template <class Body>
__device__ __forceinline__ void run(int rows_left, Body&& body) {
  const int live = (min(kKeys, rows_left) + 15) / 16;
  if (live == kKeys / 16)
    body(std::true_type{}, live);
  else
    body(std::false_type{}, live);
}

// ------------------------------------------------------- the backward

template <typename T>
struct BwdArgs {
  Operand<const T> q, k, v, o, dout;
  Operand<T> dq, dk, dv;
  const float* lse;  // (B, H, Sq) fp32
  float* delta;      // (B, H, Sq) fp32: the dq kernel writes, dk/dv reads
  int heads, sq, sk, kv_len, d;
  float scale;
  enc::Dropout drop;
  bool vec;         // every q, k, v, O, dO row 16-byte aligned: cp.async
  bool pair_store;  // dq, dk, dv stored two neighbouring columns at a time
};

template <typename T, int kDp>
struct BwdLayout {
  using A = Layout<T, kDp>;
  static_assert(kRows == kKeys, "a block's rows and a chunk are one tile");
  static constexpr bool kF32 = A::kF32;
  static constexpr int kLd = A::kLd;
  static constexpr int kTile = kKeys * kLd;  // 64 staged rows
  // the block's two own tiles, then per slot two tiles; fp32 adds each
  // warp's rows of a product operand
  static constexpr size_t kDqBytes =
      sizeof(T) * (2 + 2 * kStages) * kTile +
      (kF32 ? sizeof(float) * kRows * A::kPLd : 0);
  // and lse and delta beside each slot of the dk/dv ring
  static constexpr size_t kDkvBytes =
      kDqBytes + sizeof(float) * kStages * 2 * kKeys;
  // bf16: the block's own A fragments held in registers for the whole
  // walk, where they fit beside the accumulators and the dropout draw
  static constexpr bool kHoldDq = !kF32 && kDp <= 64;
  template <bool kDrop>
  static constexpr bool kHoldDkv = !kF32 && kDp <= 64 && !kDrop;
  // bf16 dk/dv past 64 columns: S^T and dP^T one 16-query group at a time,
  // whose products go straight into dk and dv, so that two 16 x 64 fp32
  // tiles are not live beside the kDp registers of the accumulators
  static constexpr bool kGroupWalk = !kF32 && kDp > 64;
};

// s = A B^T for one warp's 16 rows (A) and the `live` 16-row groups of the
// chunk at Bc: A's fragments `held` (bf16, kHold), or loaded from its
// staged rows Aw one 16-deep step at a time (bf16), or Aw on the CUDA
// cores (fp32).
template <typename T, int kDp, bool kHold>
__device__ __forceinline__ void scores(float (&s)[1][kKeys / 8][4],
                                       const uint32_t (&held)[kDp / 16][4],
                                       const T* Aw, const T* Bc, int live) {
  using L = BwdLayout<T, kDp>;
  constexpr int kN = kKeys / 8, kLd = L::kLd;
  if constexpr (kHold || L::kF32) {
    chunk_scores<T, kDp>(s, held, Aw, Bc, live);
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDp; kk += 16) {
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

template <typename T, int kDp>
__device__ __forceinline__ void stage_rows(const BwdArgs<T>& a, T* dst,
                                           const T* src, int64_t ld,
                                           int rvalid) {
  constexpr int kLd = BwdLayout<T, kDp>::kLd;
  if (a.vec)
    copy_tile_async<kThreads>(dst, kLd, src, ld, kKeys, kDp, rvalid, a.d);
  else
    copy_tile_elems<kThreads>(dst, kLd, src, ld, kKeys, kDp, rvalid, a.d);
}

template <typename T, int kDp, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const BwdArgs<T> a) {
  using L = BwdLayout<T, kDp>;
  constexpr int kLd = L::kLd, kN = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // kRows x kLd
  T* dOs = Qs + L::kTile;                  // kRows x kLd
  T* ring = dOs + L::kTile;                // kStages x (K, V)
  float* Fs = reinterpret_cast<float*>(ring + kStages * 2 * L::kTile);

  const int row0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * a.heads + h);
  const enc::Dropout drop = a.drop;
  const uint32_t mbh = drop.bh(b, h);  // the mask's global index
  const T* k = a.k.at(b, h);
  const T* v = a.v.at(b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow0 = row0 + 16 * warp;  // this warp's first query row
  const bool active = wrow0 < a.sq;    // warp-uniform
  const int nk = (a.sk + kKeys - 1) / kKeys;

  // Chunk `it` of K and V into its ring slot; one commit group per chunk,
  // empty past the end (the element-wise copy is done when it returns).
  auto enqueue = [&](int it) {
    if (it < nk) {
      const int k0 = it * kKeys;
      T* dst = ring + (it % kStages) * 2 * L::kTile;
      stage_rows<T, kDp>(a, dst, k + k0 * a.k.ld, a.k.ld, a.sk - k0);
      stage_rows<T, kDp>(a, dst + L::kTile, v + k0 * a.v.ld, a.v.ld,
                         a.sk - k0);
    }
    cp_async_commit();
  };
  // Wait for chunk `it`, queue the next; the slot of `it`.
  auto next = [&](int it) -> const T* {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk `it` has landed; every warp is done with the
                      // slot the enqueue refills
    enqueue(it + kStages - 1);
    return ring + (it % kStages) * 2 * L::kTile;
  };

  // Q, dO and O (in slot 1, free until chunk 1 is queued) in one group,
  // then chunk 0
  T* Os = ring + 2 * L::kTile;
  stage_rows<T, kDp>(a, Qs, a.q.at(b, h) + row0 * a.q.ld, a.q.ld,
                     a.sq - row0);
  stage_rows<T, kDp>(a, dOs, a.dout.at(b, h) + row0 * a.dout.ld, a.dout.ld,
                     a.sq - row0);
  stage_rows<T, kDp>(a, Os, a.o.at(b, h) + row0 * a.o.ld, a.o.ld,
                     a.sq - row0);
  cp_async_commit();
  enqueue(0);
  cp_async_wait<1>();
  __syncthreads();  // Q, dO and O have landed

  // delta = rowsum(O * dO) in fp32: lanes 2r and 2r + 1 sum the two halves
  // of the warp's row r; each lane then takes its rows g and g + 8
  const T* Qw = Qs + 16 * warp * kLd;
  const T* dOw = dOs + 16 * warp * kLd;
  float delta[2], lse[2];
  {
    const int r = lane >> 1, c0 = (lane & 1) * (kDp / 2);
    const T* orow = Os + (16 * warp + r) * kLd + c0;
    const T* grow = dOw + r * kLd + c0;
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < kDp / 2; ++c)
      sum = fmaf(to_float(orow[c]), to_float(grow[c]), sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const int g = lane >> 2;
    delta[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    delta[1] = __shfl_sync(0xffffffffu, sum, 2 * (g + 8));
    if (active && (lane & 1) == 0 && wrow0 + r < a.sq)
      a.delta[(int64_t)bh * a.sq + wrow0 + r] = sum;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow0 + frag_row(2 * i);
      lse[i] = row < a.sq ? a.lse[(int64_t)bh * a.sq + row] : 0.f;
    }
  }

  constexpr bool kHold = L::kHoldDq;
  uint32_t qf[kDp / 16][4], df[kDp / 16][4];  // kHold: A fragments
  if constexpr (kHold)
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk) {
      load_a_frag<false>(qf[kk], Qw, kLd, kk * 16);
      load_a_frag<false>(df[kk], dOw, kLd, kk * 16);
    }
  float* Fw = Fs + 16 * warp * L::A::kPLd;
  float acc[1][kDp / 8][4];
#pragma unroll
  for (int j = 0; j < kDp / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const T* Kc = next(it);
    if (!active) continue;
    const T* Vc = Kc + L::kTile;
    const int k0 = it * kKeys;
    run(a.sk - k0, [&](auto full, int live_) {
      const int live = decltype(full)::value ? kKeys / 16 : live_;
      float s[1][kN][4], dp[1][kN][4];
      scores<T, kDp, kHold>(s, qf, Qw, Kc, live);
      scores<T, kDp, kHold>(dp, df, dOw, Vc, live);
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
      mma_tile<T, kDp>(acc, s[0], Kc, Fw, live);
    });
  }
  cp_async_wait<0>();  // the groups still open are empty
  if (!active) return;
  store_acc<T, kDp>(a.dq.at(b, h) + wrow0 * a.dq.ld, a.dq.ld, a.sq - wrow0,
                    acc, a.scale, a.d, a.pair_store);
}

template <typename T, int kDp, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const BwdArgs<T> a) {
  using L = BwdLayout<T, kDp>;
  constexpr int kLd = L::kLd, kN = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // kRows x kLd
  T* Vs = Ks + L::kTile;                   // kRows x kLd
  T* ring = Vs + L::kTile;                 // kStages x (q, dO)
  float* Fs = reinterpret_cast<float*>(ring + kStages * 2 * L::kTile);
  // per slot: lse, then delta, of the chunk's queries
  float* LDring = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem_raw) + L::kDqBytes);

  const int key0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * a.heads + h);
  const enc::Dropout drop = a.drop;
  const uint32_t mbh = drop.bh(b, h);  // the mask's global index
  const T* q = a.q.at(b, h);
  const T* dout = a.dout.at(b, h);
  const float* lse = a.lse + (int64_t)bh * a.sq;
  const float* delta = a.delta + (int64_t)bh * a.sq;
  const int warp = threadIdx.x >> 5;
  const int wkey0 = key0 + 16 * warp;  // this warp's first key
  const bool active = wkey0 < a.sk;    // warp-uniform
  const int nq = (a.sq + kKeys - 1) / kKeys;

  auto enqueue = [&](int it) {
    if (it < nq) {
      const int q0 = it * kKeys, slot = it % kStages;
      T* dst = ring + slot * 2 * L::kTile;
      stage_rows<T, kDp>(a, dst, q + q0 * a.q.ld, a.q.ld, a.sq - q0);
      stage_rows<T, kDp>(a, dst + L::kTile, dout + q0 * a.dout.ld,
                         a.dout.ld, a.sq - q0);
      static_assert(kThreads == 2 * kKeys, "a thread per lse or delta");
      const int t = threadIdx.x & (kKeys - 1);
      const bool ok = q0 + t < a.sq;
      const float* src = threadIdx.x < kKeys ? lse : delta;
      cp_async4(LDring + slot * 2 * kKeys + threadIdx.x,
                ok ? src + q0 + t : src, ok);
    }
    cp_async_commit();
  };
  auto next = [&](int it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    enqueue(it + kStages - 1);
    return it % kStages;
  };

  stage_rows<T, kDp>(a, Ks, a.k.at(b, h) + key0 * a.k.ld, a.k.ld,
                     a.sk - key0);  // in group 0
  stage_rows<T, kDp>(a, Vs, a.v.at(b, h) + key0 * a.v.ld, a.v.ld,
                     a.sk - key0);
  enqueue(0);

  const T* Kw = Ks + 16 * warp * kLd;
  const T* Vw = Vs + 16 * warp * kLd;
  float* Fw = Fs + 16 * warp * L::A::kPLd;
  constexpr bool kHold = L::template kHoldDkv<kDrop>;
  uint32_t kf[kDp / 16][4], vf[kDp / 16][4];  // kHold: A fragments
  float dk[1][kDp / 8][4], dv[1][kDp / 8][4];
#pragma unroll
  for (int j = 0; j < kDp / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[0][j][e] = dv[0][j][e] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int slot = next(it);
    if (!active) continue;
    if constexpr (kHold)
      if (it == 0)
#pragma unroll
        for (int kk = 0; kk < kDp / 16; ++kk) {
          load_a_frag<false>(kf[kk], Kw, kLd, kk * 16);
          load_a_frag<false>(vf[kk], Vw, kLd, kk * 16);
        }
    const int q0 = it * kKeys;
    const T* Qc = ring + slot * 2 * L::kTile;
    const T* dOc = Qc + L::kTile;
    const float* Lc = LDring + slot * 2 * kKeys;
    const float* Dc = Lc + kKeys;
    // S^T and dP^T at (query q0 + c, key) become dS^T and P_v^T in place
    auto grads = [&](float& sv, float& gv, int c, int key) {
      const float x = key < a.kv_len ? sv * a.scale : kMaskValue;
      float p = expf(x - Lc[c]);
      p = q0 + c < a.sq ? p : 0.f;  // a select, no branch per element
      float g = gv, pv = p;
      if constexpr (kDrop) {
        const bool keep = enc::keeps(drop, mbh, q0 + c, key);
        g = keep ? g * drop.inv_keep : 0.f;
        pv = keep ? p * drop.inv_keep : 0.f;
      }
      gv = p * (g - Dc[c]);  // dS^T
      sv = pv;               // P_v^T
    };
    if constexpr (L::kGroupWalk) {  // one 16-query group at a time
#pragma unroll
      for (int g = 0; g < kKeys / 16; ++g) {
        if (16 * g >= a.sq - q0) break;
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kDp; kk += 16) {
          uint32_t f[4], b[2][2];
          load_a_frag<false>(f, Kw, kLd, kk);
          load_b_frags<2, false>(b, Qc + 16 * g * kLd, kLd, kk);
          mma_bf16(s[0], f, b[0]);
          mma_bf16(s[1], f, b[1]);
          load_a_frag<false>(f, Vw, kLd, kk);
          load_b_frags<2, false>(b, dOc + 16 * g * kLd, kLd, kk);
          mma_bf16(dp[0], f, b[0]);
          mma_bf16(dp[1], f, b[1]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            grads(s[j][e], dp[j][e], 16 * g + 8 * j + frag_col(e),
                  wkey0 + frag_row(e));
        uint32_t fs[4], fp[4];
        pack_a_frag(fs, dp[0], dp[1]);
        pack_a_frag(fp, s[0], s[1]);
#pragma unroll
        for (int j = 0; j < kDp / 8; j += 2) {
          uint32_t b[2][2];
          load_b_frags<2, true>(b, Qc + 8 * j, kLd, 16 * g);
          mma_bf16(dk[0][j], fs, b[0]);
          mma_bf16(dk[0][j + 1], fs, b[1]);
          load_b_frags<2, true>(b, dOc + 8 * j, kLd, 16 * g);
          mma_bf16(dv[0][j], fp, b[0]);
          mma_bf16(dv[0][j + 1], fp, b[1]);
        }
      }
      continue;
    }
    run(a.sq - q0, [&](auto full, int live_) {
      const int live = decltype(full)::value ? kKeys / 16 : live_;
      // S^T and dP^T: this warp's keys by the chunk's queries
      float s[1][kN][4], dp[1][kN][4];
      scores<T, kDp, kHold>(s, kf, Kw, Qc, live);
      scores<T, kDp, kHold>(dp, vf, Vw, dOc, live);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        if (j >= 2 * live) {  // a skipped group: queries past Sq
#pragma unroll
          for (int e = 0; e < 4; ++e) s[0][j][e] = dp[0][j][e] = 0.f;
          continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          grads(s[0][j][e], dp[0][j][e], 8 * j + frag_col(e),
                wkey0 + frag_row(e));
      }
      mma_tile<T, kDp>(dk, dp[0], Qc, Fw, live);
      mma_tile<T, kDp>(dv, s[0], dOc, Fw, live);
    });
  }
  cp_async_wait<0>();
  if (!active) return;
  store_acc<T, kDp>(a.dk.at(b, h) + wkey0 * a.dk.ld, a.dk.ld, a.sk - wkey0,
                    dk, a.scale, a.d, a.pair_store);
  store_acc<T, kDp>(a.dv.at(b, h) + wkey0 * a.dv.ld, a.dv.ld, a.sk - wkey0,
                    dv, 1.f, a.d, a.pair_store);
}

template <typename T, int kDp, bool kDrop>
cudaError_t launch_bwd_kernels(const BwdArgs<T>& a, int batch,
                               cudaStream_t stream) {
  using L = BwdLayout<T, kDp>;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<T, kDp, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kDqBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, kDp, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kDkvBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.sq + kRows - 1) / kRows, a.heads, batch);
  attention_bwd_dq_kernel<T, kDp, kDrop>
      <<<grid_q, kThreads, L::kDqBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.sk + kRows - 1) / kRows, a.heads, batch);
  attention_bwd_dkdv_kernel<T, kDp, kDrop>
      <<<grid_k, kThreads, L::kDkvBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
bool pairs_aligned(const Operand<T>& x) {
  return reinterpret_cast<uintptr_t>(x.base) % (2 * sizeof(T)) == 0 &&
         x.sb % 2 == 0 && x.sh % 2 == 0 && x.ld % 2 == 0;
}

// Launch the dq kernel, then the dk/dv kernel, on `stream` with the head
// dim padded to kDp (d <= kDp): grids (ceil(Sq / 64), heads, batch) and
// (ceil(Sk / 64), heads, batch); dropout 0 or 1 picks the instantiation.
template <typename T, int kDp>
cudaError_t launch_bwd(BwdArgs<T> a, int batch, int dropout,
                       cudaStream_t stream) {
  a.vec = rows_aligned(a.q, a.d) && rows_aligned(a.k, a.d) &&
          rows_aligned(a.v, a.d) && rows_aligned(a.o, a.d) &&
          rows_aligned(a.dout, a.d);
  a.pair_store = pairs_aligned(a.dq) && pairs_aligned(a.dk) &&
                 pairs_aligned(a.dv) && a.d % 2 == 0;
  return enc::with_dropout(dropout, [&](auto flag) {
    return launch_bwd_kernels<T, kDp, decltype(flag)::value>(a, batch,
                                                            stream);
  });
}

}  // namespace attn
