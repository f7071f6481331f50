// The attention forward shared by the direct-layout encoder kernel (#1,
// encoder_attention_fwd.cu), the head-major kernel (#3,
// flash_attention_fwd.cu) and the save-probs kernel (#5,
// encoder_attention_savep_fwd.cu), on warp_tile.cuh's tensor-core tiles.
//
// For batch item b and head h it computes, in the TPU kernels' arithmetic
// order (flash_attention.py::_fwd_kernel_direct, ::_fwd_kernel):
//   s = q k^T * scale (fp32); s[:, c] = MASK_VALUE for kv_len <= c < Sk;
//   m = rowmax(s) over the Sk keys, p = exp(s - m), l = rowsum(p),
//   O = (p.to(T) v) / l accumulated in fp32, lse = m + log(l).
// The unnormalised p is rounded to the input type T before the product and
// the division by l comes after it. With dropout, p is zeroed where
// enc::keeps drops it and scaled by 1/keep where it keeps, before the
// rounding and the product; l and lse are the sums before dropout.
//
// Design. One block of 4 warps per (64 query rows, head, batch item); each
// warp owns 16 rows. Operands are addressed as base + b * sb + h * sh +
// row * ld, so one body reads the packed (B, S, 3D) projection's head
// columns (#1) and contiguous (B, H, S, d) slabs (#3). The head dim d is
// padded to kDp, a multiple of 16, in shared memory; the padded columns
// of q and k are zeros, so they add nothing to the scores. q's tile and
// chunks of 64 keys of K (and V) are staged in T, not converted, with
// 16-byte cp.async when every row is 16-byte aligned (else element by
// element), into a ring of two slots: the next chunk is in flight while
// the current one is computed. Row strides are 16 bytes past the padded
// width, so ldmatrix reads are conflict-free. Key rows past Sk are staged
// as zeros (an Inf or NaN pattern left in shared memory times p = 0 would
// poison O).
//   Pass 1 walks K: S = Q K^T (16 x 64 per warp) with mma.sync m16n8k16,
//     Q's fragments kept in registers for the whole call; the row max is
//     taken over the keys < Sk and reduced over the quad of lanes that
//     shares a row.
//   Pass 2 walks K and V: S again, p = exp(s - m), l summed in fp32 before
//     dropout; p is rounded to T as it is packed into the A fragments of
//     P V (two neighbouring 16 x 8 accumulators are one 16 x 16 A
//     fragment, so P never leaves registers), and V's fragments come
//     through ldmatrix.trans.
// Two passes keep the TPU kernel's order exactly for any Sk: the global
// row max before the exponential (no online rescale). The mask draw uses
// the absolute (row, col) of each accumulator element, so the mask is the
// one ops/dropout.py::keep_mask and the backward kernels draw. fp32 runs
// the same tiles through warp_mma's fp32 body (sequential FMAs in depth
// order), with each warp's P staged in shared memory for the product.
// Warps whose 16 rows lie past Sq stage but compute nothing; 16-key groups
// wholly past Sk are skipped. Each pass body has two instantiations, one
// for a full chunk with no per-group branch (ldmatrix loads then run ahead
// of the products that read them) and one for the partial last chunk; the
// per-element masks are selects, not branches, so the exponentials of a
// lane overlap.
//
// Save-probs (kSaveP, #5: flash_attention.py::_fwd_kernel_direct_savep)
// normalises before the product: P = p / l is written as bf16 (B, H, Sq,
// Sk) before dropout, and O = P_use.to(T) v with no division after it, no
// lse. Pass 1 therefore gives l as well as m: each lane keeps a running
// max and a sum rescaled when the max grows over its own keys, and the
// quad combines them at the end. That costs one exponential a score in
// pass 1, where a third walk over the keys would restage K and recompute
// S as well. Pass 2 forms P = exp(s - m) / l (div_rn: the IEEE quotient,
// from 1 / l taken once a row), stages each warp's 16 x 64 bf16 tile in
// shared memory, and writes whole rows from there with neighbouring
// lanes on neighbouring keys: a row of Sk bf16 starts 2 bytes past a
// 4-byte boundary on every other row when Sk is odd, so a pair is one
// 4-byte store on an aligned row and two 2-byte stores on the others. Keys
// >= Sk and rows >= Sq are not stored. The kSaveP = false instantiations
// (#1, #3) compile none of this.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "encoder_tile.cuh"  // enc::Dropout, enc::keeps, enc::with_dropout
#include "warp_tile.cuh"

namespace attn {

using namespace wtile;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;           // keys per staged chunk
constexpr int kStages = 2;          // chunks in the ring
constexpr int kEncoderHeadDim = 64;  // the direct layout's (#1, #2, #5, #6)
// -0.7 * float32 max, rounded once to fp32 as JAX rounds its MASK_VALUE
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

// Row `row` of (batch item b, head h) starts at base + b * sb + h * sh +
// row * ld; its d elements are contiguous.
template <typename T>
struct Operand {
  T* base;
  int64_t sb, sh, ld;
  __device__ __forceinline__ T* at(int b, int h) const {
    return base + b * sb + h * sh;
  }
};

template <typename T>
struct FwdArgs {
  Operand<const T> q, k, v;
  Operand<T> out;
  float* lse;             // (B, H, 1, Sq); unused by kSaveP
  __nv_bfloat16* probs;   // (B, H, Sq, Sk) bf16, kSaveP only
  int heads, sq, sk, kv_len, d;
  float scale;
  enc::Dropout drop;
  bool vec;         // every q, k, v row 16-byte aligned: cp.async staging
  bool pair_store;  // O stored two neighbouring columns at a time
};

template <typename T, int kDp>
struct Layout {
  static_assert(kDp % 16 == 0 && kDp <= 128, "padded head dim");
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kLd = kDp + 16 / sizeof(T);  // staged row stride
  static constexpr int kPLd = kKeys + 4;             // fp32 P rows
  static constexpr int kSlot = 2 * kKeys * kLd;      // K and V of a chunk
  static constexpr size_t kBytes =
      sizeof(T) * (kRows * kLd + kStages * kSlot) +
      (kF32 ? sizeof(float) * kRows * kPLd : 0);
  // kSaveP: each warp's bf16 P tile on its way to device memory
  static constexpr int kPbLd = kKeys + 8;
  static constexpr size_t kSavePBytes =
      sizeof(__nv_bfloat16) * kRows * kPbLd;
};

// s = Q K^T for one warp's 16 query rows and the `live` 16-key groups of
// the chunk at Kc: bf16 from Q's A fragments qf on the tensor cores, fp32
// from Q's staged rows Qw on the CUDA cores.
template <typename T, int kDp>
__device__ __forceinline__ void chunk_scores(
    float (&s)[1][kKeys / 8][4], const uint32_t (&qf)[kDp / 16][4],
    const T* Qw, const T* Kc, int live) {
  constexpr int kN = kKeys / 8, kLd = Layout<T, kDp>::kLd;
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][j][e] = 0.f;
  if constexpr (Layout<T, kDp>::kF32) {
    warp_mma<1, kN, kDp, false, false>(s, Qw, kLd, Kc, kLd);
  } else {
#pragma unroll
    for (int kk = 0; kk < kDp; kk += 16)
#pragma unroll
      for (int jp = 0; jp < kN / 2; ++jp) {  // keys 16 jp .. 16 jp + 15
        if (jp >= live) break;
        uint32_t kf[2][2];
        load_b_frags<2, false>(kf, Kc + 16 * jp * kLd, kLd, kk);
        mma_bf16(s[0][2 * jp], qf[kk / 16], kf[0]);
        mma_bf16(s[0][2 * jp + 1], qf[kk / 16], kf[1]);
      }
  }
}

// `rows` rows of a warp's bf16 tile Pw (row stride ld_s) to device memory,
// row r at dst + r * ld, its first `cols` keys: lane l writes keys 2l and
// 2l + 1, so a row is one coalesced run; one 4-byte store where the row is
// 4-byte aligned, two 2-byte stores where it is not.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int64_t ld,
                                           int rows, int cols,
                                           const __nv_bfloat16* Pw,
                                           int ld_s) {
  const int c = 2 * (threadIdx.x & 31);
  for (int r = 0; r < rows; ++r) {
    __nv_bfloat16* row = dst + r * ld;
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(Pw + r * ld_s + c);
    if (c + 1 < cols && reinterpret_cast<uintptr_t>(row) % 4 == 0) {
      *reinterpret_cast<__nv_bfloat162*>(row + c) = v;
    } else {
      if (c < cols) row[c] = v.x;
      if (c + 1 < cols) row[c + 1] = v.y;
    }
  }
}

// p / l as IEEE fp32 division rounds it, from rl = 1 / l rounded in fp64:
// the fp64 product is within 2^-52 of p / l (relative), and a quotient of
// two 24-bit numbers lies at least 2^-49 from every rounding boundary of
// the normal fp32 range, so rounding the product to fp32 gives the
// correctly rounded quotient wherever it is a normal number (p <= 1 and
// l >= 1 here, so nothing overflows). `p / l` itself compiles to a
// slow-path call, around which ptxas spilled in pass 2 (40 bytes at 168
// registers in bf16); this keeps 168 with no spill. An fp32 quotient
// corrected from 1 / l (Markstein) is not exact where the remainder
// underflows (p below about 2^-100).
__device__ __forceinline__ float div_rn(float p, double rl) {
  return static_cast<float>(static_cast<double>(p) * rl);
}

template <typename T, int kDp, bool kDrop, bool kSaveP>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const FwdArgs<T> a) {
  using L = Layout<T, kDp>;
  constexpr int kLd = L::kLd, kN = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // kRows x kLd
  T* ring = Qs + kRows * kLd;              // kStages x (K, V)
  float* Ps = reinterpret_cast<float*>(ring + kStages * L::kSlot);  // fp32
  // kSaveP: bf16 P tiles, after the fp32 ones
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<unsigned char*>(smem_raw) + L::kBytes);

  const int row0 = blockIdx.x * kRows;
  // the mask's global key word: with dropout the one index that stays live
  // through the key walk (the stores recover the launch's b and h from it,
  // so the offsets of a parallel rank cost no register in the loop);
  // without, the stores read blockIdx again
  const enc::Dropout drop = a.drop;
  const uint32_t mbh = drop.bh(blockIdx.z, blockIdx.y);
  auto local_b = [&] {
    return kDrop ? drop.batch_of(mbh) : (int)blockIdx.z;
  };
  auto local_h = [&] {
    return kDrop ? drop.head_of(mbh) : (int)blockIdx.y;
  };
  const T* q = a.q.at(blockIdx.z, blockIdx.y);
  const T* k = a.k.at(blockIdx.z, blockIdx.y);
  const T* v = a.v.at(blockIdx.z, blockIdx.y);
  const int warp = threadIdx.x >> 5;
  const int wrow0 = row0 + 16 * warp;  // this warp's first query row
  const bool active = wrow0 < a.sq;    // warp-uniform
  const int nk = (a.sk + kKeys - 1) / kKeys;
  const int total = 2 * nk;  // pass 1: K chunks; pass 2: K and V chunks

  auto stage = [&](T* dst, const T* src, int64_t ld, int rows, int rvalid) {
    if (a.vec)
      copy_tile_async<kThreads>(dst, kLd, src, ld, rows, kDp, rvalid, a.d);
    else
      copy_tile_elems<kThreads>(dst, kLd, src, ld, rows, kDp, rvalid, a.d);
  };
  // Item `it` into its ring slot; one commit group per item, empty past the
  // end (the element-wise copy is done when it returns).
  auto enqueue = [&](int it) {
    if (it < total) {
      const int k0 = (it < nk ? it : it - nk) * kKeys;
      T* dst = ring + (it % kStages) * L::kSlot;
      stage(dst, k + k0 * a.k.ld, a.k.ld, kKeys, a.sk - k0);
      if (it >= nk)
        stage(dst + kKeys * kLd, v + k0 * a.v.ld, a.v.ld, kKeys, a.sk - k0);
    }
    cp_async_commit();
  };

  stage(Qs, q + row0 * a.q.ld, a.q.ld, kRows, a.sq - row0);  // in group 0
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) enqueue(it);

  const T* Qw = Qs + 16 * warp * kLd;
  float* Pw = Ps + 16 * warp * L::kPLd;
  __nv_bfloat16* Pbw = Pb + 16 * warp * L::kPbLd;
  uint32_t qf[kDp / 16][4];  // bf16: Q's A fragments
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  double rl[2] = {0.0, 0.0};  // kSaveP: 1 / l
  float o[1][kDp / 8][4];
#pragma unroll
  for (int j = 0; j < kDp / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][j][e] = 0.f;

  // Wait for item `it`, queue the item kStages - 1 ahead; the slot of `it`.
  auto next = [&](int it) -> const T* {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item `it` has landed; every warp is done with the
                      // slot the enqueue refills
    enqueue(it + kStages - 1);
    return ring + (it % kStages) * L::kSlot;
  };
  // 16-key groups of the chunk at key k0 that hold a key below Sk; the rest
  // (S = 197 leaves 5 keys in its last chunk) are skipped, warp-uniformly.
  auto live_groups = [&](int k0) { return (min(kKeys, a.sk - k0) + 15) / 16; };

  // Each pass runs a chunk through `body(full, live)`: a full chunk (every
  // 16-key group live) as an instantiation with no per-group branch, so
  // loads and products schedule freely; a partial one (the last) as another.
  auto run = [&](int k0, auto&& body) {
    const int live = live_groups(k0);
    if (live == kKeys / 16)
      body(std::true_type{}, live);
    else
      body(std::false_type{}, live);
  };

  // pass 1: the row max over the Sk keys, masked ones at MASK_VALUE (and,
  // kSaveP, this lane's sum of exp(s - m), rescaled as its max grows)
  for (int it = 0; it < nk; ++it) {
    const T* Kc = next(it);
    if (!active) continue;
    if constexpr (!L::kF32)
      if (it == 0)
#pragma unroll
        for (int kk = 0; kk < kDp / 16; ++kk)
          load_a_frag<false>(qf[kk], Qw, kLd, kk * 16);
    const int k0 = it * kKeys;
    run(k0, [&](auto full, int live_) {
      const int live = decltype(full)::value ? kKeys / 16 : live_;
      float s[1][kN][4];
      chunk_scores<T, kDp>(s, qf, Qw, Kc, live);
      if constexpr (kSaveP) {
        float cm[2] = {-INFINITY, -INFINITY};  // this chunk's max
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          if (j >= 2 * live) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + frag_col(e);
            const float x =
                col < a.kv_len ? s[0][j][e] * a.scale : kMaskValue;
            s[0][j][e] = col < a.sk ? x : -INFINITY;
            cm[e >> 1] = fmaxf(cm[e >> 1], s[0][j][e]);
          }
        }
        float add[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) cm[i] = fmaxf(m[i], cm[i]);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          if (j >= 2 * live) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // a key past Sk holds -inf: 0
            const float p = expf(s[0][j][e] - cm[e >> 1]);
            add[e >> 1] += s[0][j][e] == -INFINITY ? 0.f : p;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // no key of this lane yet: l = 0
          l[i] = cm[i] == -INFINITY ? 0.f
                                    : l[i] * expf(m[i] - cm[i]) + add[i];
          m[i] = cm[i];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          if (j >= 2 * live) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // selects, no branch per element
            const int col = k0 + 8 * j + frag_col(e);
            const float x =
                col < a.kv_len ? s[0][j][e] * a.scale : kMaskValue;
            m[e >> 1] = fmaxf(m[e >> 1], col < a.sk ? x : -INFINITY);
          }
        }
      }
    });
  }
  if constexpr (kSaveP) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // each row's max and sum over its quad,
      // each lane's sum rescaled to the row's max
      float mr = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
      l[i] = m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mr);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      m[i] = mr;
      rl[i] = 1.0 / static_cast<double>(l[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // each row's max over its quad
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
  }

  // pass 2: p = exp(s - m), l = rowsum(p), O += p.to(T) V (kSaveP: P =
  // exp(s - m) / l stored as bf16, O += P_use.to(T) V)
  for (int it = nk; it < total; ++it) {
    const T* Kc = next(it);
    if (!active) continue;
    const T* Vc = Kc + kKeys * kLd;
    const int k0 = (it - nk) * kKeys;
    run(k0, [&](auto full, int live_) {
      const int live = decltype(full)::value ? kKeys / 16 : live_;
      float s[1][kN][4];
      chunk_scores<T, kDp>(s, qf, Qw, Kc, live);
      if constexpr (kSaveP) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          if (j >= 2 * live) {  // a skipped group: keys past Sk, P = 0
#pragma unroll
            for (int e = 0; e < 4; ++e) s[0][j][e] = 0.f;
            continue;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + frag_col(e), i = e >> 1;
            const float x =
                col < a.kv_len ? s[0][j][e] * a.scale : kMaskValue;
            const float p = div_rn(expf(x - m[i]), rl[i]);
            s[0][j][e] = col < a.sk ? p : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)  // P before dropout, as bf16
            store2(Pbw + frag_row(2 * i) * L::kPbLd + 8 * j + frag_col(0),
                   s[0][j][2 * i], s[0][j][2 * i + 1]);
          if constexpr (kDrop)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[0][j][e] = enc::keeps(drop, mbh, wrow0 + frag_row(e),
                                      k0 + 8 * j + frag_col(e))
                               ? s[0][j][e] * drop.inv_keep
                               : 0.f;
        }
        __syncwarp();  // the tile is staged; the next chunk's writes come
                       // after next()'s barrier
        store_rows(a.probs + ((int64_t)(local_b() * a.heads + local_h()) *
                                  a.sq + wrow0) * a.sk + k0,
                   a.sk, min(16, a.sq - wrow0), min(kKeys, a.sk - k0), Pbw,
                   L::kPbLd);
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          if (j >= 2 * live) {  // a skipped group: keys past Sk, p = 0
#pragma unroll
            for (int e = 0; e < 4; ++e) s[0][j][e] = 0.f;
            continue;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // selects, no branch per element: a
            // column past Sk in a live group scores 0 (its K row is zeros),
            // so its exp is finite or +inf, and is replaced by 0
            const int col = k0 + 8 * j + frag_col(e), i = e >> 1;
            const float x =
                col < a.kv_len ? s[0][j][e] * a.scale : kMaskValue;
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
      }

      if constexpr (L::kF32) {  // P through this warp's rows of Ps
#pragma unroll
        for (int j = 0; j < kN; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            store2(Pw + frag_row(2 * i) * L::kPLd + 8 * j + frag_col(0),
                   s[0][j][2 * i], s[0][j][2 * i + 1]);
        __syncwarp();
        warp_mma<1, kDp / 8, kKeys, false, true>(o, Pw, L::kPLd, Vc, kLd);
        __syncwarp();  // read before the next chunk's P is written
      } else {  // P stays in registers, rounded to bf16
        uint32_t pf[kKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          pack_a_frag(pf[kk], s[0][2 * kk], s[0][2 * kk + 1]);
        warp_mma_afrag<kDp / 8, kKeys, true>(o[0], pf, Vc, kLd, live);
      }
    });
  }
  cp_async_wait<0>();  // the groups still open are empty
  if (!active) return;

  if constexpr (!kSaveP)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  const int b = local_b(), h = local_h();
  T* out = a.out.at(b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow0 + frag_row(2 * i);
    if (row >= a.sq) continue;
    T* out_row = out + row * a.out.ld;
#pragma unroll
    for (int j = 0; j < kDp / 8; ++j) {
      const int c = 8 * j + frag_col(0);
      float v0 = o[0][j][2 * i], v1 = o[0][j][2 * i + 1];
      if constexpr (!kSaveP) {  // kSaveP: P was normalised before P V
        v0 /= l[i];
        v1 /= l[i];
      }
      if (a.pair_store && c + 1 < a.d) {
        store2(out_row + c, v0, v1);
      } else {
        if (c < a.d) out_row[c] = from_float<T>(v0);
        if (c + 1 < a.d) out_row[c + 1] = from_float<T>(v1);
      }
    }
    if constexpr (!kSaveP)
      if ((threadIdx.x & 3) == 0)
        a.lse[(int64_t)(b * a.heads + h) * a.sq + row] = m[i] + logf(l[i]);
  }
}

template <typename T>
bool rows_aligned(const Operand<const T>& x, int d) {
  constexpr int kVec = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(x.base) % 16 == 0 && x.sb % kVec == 0 &&
         x.sh % kVec == 0 && x.ld % kVec == 0 && d % kVec == 0;
}

template <typename T, int kDp, bool kDrop, bool kSaveP>
cudaError_t launch_kernel(const FwdArgs<T>& a, int batch,
                          cudaStream_t stream) {
  using L = Layout<T, kDp>;
  constexpr size_t kBytes = L::kBytes + (kSaveP ? L::kSavePBytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T, kDp, kDrop, kSaveP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kRows - 1) / kRows, a.heads, batch);
  attention_fwd_kernel<T, kDp, kDrop, kSaveP>
      <<<grid, kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

// Launch on `stream` with the head dim padded to kDp (d <= kDp): grid
// (ceil(Sq / 64), heads, batch); dropout 0 or 1 picks the instantiation;
// kSaveP also writes P (a.probs) and no lse.
template <typename T, int kDp, bool kSaveP = false>
cudaError_t launch_fwd(FwdArgs<T> a, int batch, int dropout,
                       cudaStream_t stream) {
  a.vec = rows_aligned(a.q, a.d) && rows_aligned(a.k, a.d) &&
          rows_aligned(a.v, a.d);
  a.pair_store =
      reinterpret_cast<uintptr_t>(a.out.base) % (2 * sizeof(T)) == 0 &&
      a.out.sb % 2 == 0 && a.out.sh % 2 == 0 && a.out.ld % 2 == 0 &&
      a.d % 2 == 0;
  return enc::with_dropout(dropout, [&](auto flag) {
    return launch_kernel<T, kDp, decltype(flag)::value, kSaveP>(a, batch,
                                                                stream);
  });
}

}  // namespace attn
