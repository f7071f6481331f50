// Direct-layout encoder attention backward from the saved probabilities,
// for Hopper (sm_90a).
//
// Replaces arsvt_tpu/ops/pallas/flash_attention.py::_bwd_kernel_direct_savep
// (called through _bwd_direct_savep), with its dropout branch. For each
// batch item b and head h it reads the (S, 64) column blocks of q, k and v out of the
// packed (B, S, 3D) projection output, of dO out of (B, S, D), and the
// forward's normalised probabilities P (B, H, S, S) bf16, and computes with
// the TPU kernel's rounding points:
//   p = P (bf16 -> fp32), dP = dO v^T (fp32), delta = rowsum(dP * p),
//   dS = p * (dP - delta),
//   dq = (dS.to(T) k) * scale, dk = (dS.to(T)^T q) * scale, dv = p.to(T)^T dO,
// every product summed in fp32 and cast to T at the end. There is no q k^T,
// no exp, no lse and no O: delta = rowsum(dP * P) equals rowsum(dO * O).
// With dropout (flash_attention.py:836-846) the forward's mask
// (encoder_tile.cuh::keeps) is replayed on dP, dP = keep ? dP/keep_prob : 0,
// before delta = rowsum(dP * P) and dS = P (dP - delta), both with the saved
// P before dropout; dv = p_v.to(T)^T dO with p_v = keep ? P/keep_prob : 0.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the call reads qkv,
// P and dO and writes dq, dk and dv: at ViT-B (S=197, D=768, H=12) and B=32
// that is 29.0 + 29.8 + 9.7 + 29.0 MB, 29.1 us, against 8*B*H*S^2*d =
// 7.6 GFLOP (dP, dq, dk, dv), 7.7 us: memory-bound.
//
// Design (attention_fwd.cuh's tiles and staging on warp_tile.cuh: mma.sync
// m16n8k16 with fp32 accumulation in bf16, the same tiles on the CUDA cores
// in fp32). The sums over query rows (dk, dv) and over keys (dq) stay
// deterministic with no atomics: two kernels on one stream, the second
// reading the delta the first wrote to a (B, H, S) fp32 scratch.
//   1. savep_bwd_dq_kernel, one block of four warps per (64 query rows,
//      head, batch item), 16 rows a warp with dO's A fragments in
//      registers (as the forward holds Q's). Chunks of 64 keys come
//      through a two-slot ring: V (and, in walk 2, K) by 16-byte cp.async,
//      and the chunk's 64 x 64 tile of P element by element (a row of 197
//      bf16 is not 4-byte aligned on every row), consecutive threads on
//      consecutive keys, into 16-byte aligned rows that ldmatrix reads in
//      the accumulator's layout. Walk 1: dP = dO V^T, the dropout replay,
//      delta += dP * P per lane, reduced over the quad and written out;
//      each lane keeps the 32 keep bits it drew for a chunk as one word in
//      shared memory (512 bytes a chunk for the block). Walk 2: dP again,
//      masked by those bits (the mask is drawn once, not twice), dS = P
//      (dP - delta) rounded to T as it is packed into A fragments, dq +=
//      dS K with K through ldmatrix.trans.
//   2. savep_bwd_dkdv_kernel, one block of four warps per (64 keys, head,
//      batch item), 16 keys a warp with V's A fragments in registers (K is
//      not needed: there is no q k^T). Chunks of 64 queries come through
//      the ring: q and dO by cp.async, the (queries x keys) tile of P
//      element by element as [query][key], and delta. dP^T = V dO^T with
//      the replay; P^T in the accumulator's layout from ldmatrix.trans of
//      the tile; dS^T = P^T (dP^T - delta[query]) and P_v^T, each rounded
//      to T as it is packed into A fragments; dk += dS^T q and dv += P_v^T
//      dO, with q and dO through ldmatrix.trans.
// 16-key (16-query) groups wholly past S are skipped, and each walk body
// has a full-chunk and a partial-chunk instantiation, as in the forward.
// Rows past S are staged as zeros (P included), so they give dS = 0 and
// P_v = 0, and are not stored. The dq kernel's shared memory grows by 512
// bytes a chunk of 64 keys with dropout: 64.5 KB + 0.5 KB per chunk in
// bf16 (122.9 KB + 0.5 KB in fp32) against the 227 KB a block may take,
// so S up to about 20,000 (13,000 in fp32); past that the launch fails and
// the wrapper raises.
//
// C interface: arsvt_encoder_attention_savep_bwd launches both kernels on
// the given stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_bwd.cuh"  // attn::load_p, mma_tile, store_acc, run
#include "attention_fwd.cuh"  // attn:: staging and score tiles; enc::keeps

namespace {

using namespace wtile;
using attn::kKeys;    // rows of the other side per staged chunk: 64
using attn::load_p;
using attn::mma_tile;
using attn::run;
using attn::store_acc;
using attn::kRows;    // rows a block owns: 64 queries (dq) or keys (dk/dv)
using attn::kStages;  // chunks in the ring: 2
using attn::kThreads;
constexpr int kHeadDim = attn::kEncoderHeadDim;  // 64

template <typename T>
struct Layout {
  using A = attn::Layout<T, kHeadDim>;
  static constexpr bool kF32 = A::kF32;
  static constexpr int kLd = A::kLd;        // staged rows of q, k, v, dO
  static constexpr int kFLd = A::kPLd;      // fp32 rows of dS, P_v (fp32)
  static constexpr int kPLd = kKeys + 8;    // staged bf16 rows of P
  static constexpr int kTile = kKeys * kLd;  // 64 staged rows
  static constexpr int kPTile = kRows * kPLd;
  // the block's own rows, then per slot two tiles and a tile of P (and,
  // dk/dv, delta); fp32 adds each warp's rows of the product operands
  static constexpr size_t kBase =
      sizeof(T) * (kRows * kLd + kStages * 2 * kTile) +
      sizeof(__nv_bfloat16) * kStages * kPTile;
  static constexpr size_t kDqBytes =
      kBase + (kF32 ? sizeof(float) * kRows * kFLd : 0);
  static constexpr size_t kDkvBytes = kBase + sizeof(float) * kStages * kKeys +
                                      (kF32 ? 2 * sizeof(float) * kRows * kFLd
                                            : 0);
};

template <typename T>
struct BwdArgs {
  const T* qkv;
  const __nv_bfloat16* probs;
  const T* dout;
  float* delta;
  T *dq, *dk, *dv;
  int seq, heads;
  float scale;
  enc::Dropout drop;
};

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    savep_bwd_dq_kernel(const BwdArgs<T> a) {
  using L = Layout<T>;
  constexpr int kLd = L::kLd, kN = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dOs = reinterpret_cast<T*>(smem_raw);  // kRows x kLd
  T* ring = dOs + kRows * kLd;              // kStages x (V, K)
  __nv_bfloat16* Pring =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * 2 * L::kTile);
  float* Fs = reinterpret_cast<float*>(Pring + kStages * L::kPTile);  // fp32
  // kDrop: walk 1's keep bits, one word a lane and chunk, for walk 2
  uint32_t* Ms = reinterpret_cast<uint32_t*>(
      reinterpret_cast<unsigned char*>(smem_raw) + L::kDqBytes);

  const int row0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int seq = a.seq;
  const uint32_t bh = (uint32_t)(b * a.heads + h);
  const enc::Dropout drop = a.drop;
  const uint32_t mbh = drop.bh(b, h);  // the mask's global index
  const int64_t d_model = (int64_t)a.heads * kHeadDim, ld = 3 * d_model;
  const T* k = a.qkv + b * seq * ld + d_model + h * kHeadDim;
  const T* v = k + d_model;
  const T* dout = a.dout + b * seq * d_model + h * kHeadDim;
  const __nv_bfloat16* probs = a.probs + (int64_t)bh * seq * seq;
  const int warp = threadIdx.x >> 5;
  const int wrow0 = row0 + 16 * warp;  // this warp's first query row
  const bool active = wrow0 < seq;     // warp-uniform
  const int nk = (seq + kKeys - 1) / kKeys;
  const int total = 2 * nk;  // walk 1: V and P; walk 2: V, K and P

  // Item `it` into its ring slot: one commit group for the cp.async tiles,
  // empty past the end; P's loads are done when it returns.
  auto enqueue = [&](int it) {
    if (it < total) {
      const int k0 = (it < nk ? it : it - nk) * kKeys;
      T* dst = ring + (it % kStages) * 2 * L::kTile;
      copy_tile_async<kThreads>(dst, kLd, v + k0 * ld, ld, kKeys, kHeadDim,
                                seq - k0, kHeadDim);
      if (it >= nk)
        copy_tile_async<kThreads>(dst + L::kTile, kLd, k + k0 * ld, ld, kKeys,
                                  kHeadDim, seq - k0, kHeadDim);
      cp_async_commit();
      attn::copy_tile_elems<kThreads>(Pring + (it % kStages) * L::kPTile,
                                      L::kPLd, probs + (int64_t)row0 * seq + k0,
                                      seq, kRows, kKeys, seq - row0, seq - k0);
    } else {
      cp_async_commit();
    }
  };
  // Wait for item `it`, queue the next; the slot index of `it`.
  auto next = [&](int it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item `it` has landed; every warp is done with the
                      // slot the enqueue refills
    enqueue(it + kStages - 1);
    return it % kStages;
  };

  copy_tile_async<kThreads>(dOs, kLd, dout + row0 * d_model, d_model, kRows,
                            kHeadDim, seq - row0, kHeadDim);  // in group 0
  enqueue(0);

  const T* dOw = dOs + 16 * warp * kLd;
  float* Fw = Fs + 16 * warp * L::kFLd;
  uint32_t df[kHeadDim / 16][4];  // bf16: dO's A fragments
  float delta[2] = {0.f, 0.f};
  float acc[1][kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;

  // dP for this warp's rows and the chunk's keys (masked by the replay:
  // walk 1 draws the mask and keeps its bits, walk 2 reads them), and P at
  // the same positions
  uint32_t* Mw = Ms + (warp * nk) * 32 + (threadIdx.x & 31);
  auto dp_and_p = [&](float (&dp)[1][kN][4], float (&p)[kN][4], int slot,
                      int c, bool draw, int live) {
    const T* Vc = ring + slot * 2 * L::kTile;
    attn::chunk_scores<T, kHeadDim>(dp, df, dOw, Vc, live);
    load_p<false>(p, Pring + slot * L::kPTile + 16 * warp * L::kPLd, L::kPLd,
                  live);
    if constexpr (kDrop) {
      uint32_t bits = draw ? 0u : Mw[32 * c];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (draw)
            bits |= (uint32_t)enc::keeps(drop, mbh, wrow0 + frag_row(e),
                                         c * kKeys + 8 * j + frag_col(e))
                    << (4 * j + e);
          dp[0][j][e] =
              (bits >> (4 * j + e)) & 1u ? dp[0][j][e] * drop.inv_keep : 0.f;
        }
      if (draw) Mw[32 * c] = bits;
    }
  };

  // walk 1: delta = rowsum(dP * P) in fp32
  for (int it = 0; it < nk; ++it) {
    const int slot = next(it);
    if (!active) continue;
    if constexpr (!L::kF32)
      if (it == 0)
#pragma unroll
        for (int kk = 0; kk < kHeadDim / 16; ++kk)
          load_a_frag<false>(df[kk], dOw, kLd, kk * 16);
    const int k0 = it * kKeys;
    run(seq - k0, [&](auto full, int live_) {
      const int live = decltype(full)::value ? kKeys / 16 : live_;
      float dp[1][kN][4], p[kN][4];
      dp_and_p(dp, p, slot, it, true, live);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        if (j >= 2 * live) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)  // keys past S hold P = 0
          delta[e >> 1] = fmaf(dp[0][j][e], p[j][e], delta[e >> 1]);
      }
    });
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // each row's delta over its quad
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    const int row = wrow0 + frag_row(2 * i);
    if (active && (threadIdx.x & 3) == 0 && row < seq)
      a.delta[(int64_t)bh * seq + row] = delta[i];
  }

  // walk 2: dS = P (dP - delta), dq += dS.to(T) K
  for (int it = nk; it < total; ++it) {
    const int slot = next(it);
    if (!active) continue;
    const int k0 = (it - nk) * kKeys;
    run(seq - k0, [&](auto full, int live_) {
      const int live = decltype(full)::value ? kKeys / 16 : live_;
      float dp[1][kN][4], p[kN][4];
      dp_and_p(dp, p, slot, it - nk, false, live);
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // zeros past the live groups
          p[j][e] = j < 2 * live ? p[j][e] * (dp[0][j][e] - delta[e >> 1])
                                 : 0.f;
      mma_tile<T, kHeadDim>(acc, p, ring + slot * 2 * L::kTile + L::kTile,
                            Fw, live);
    });
  }
  cp_async_wait<0>();  // the groups still open are empty
  if (!active) return;
  store_acc<T, kHeadDim>(a.dq + (b * seq + wrow0) * d_model + h * kHeadDim,
                         d_model, seq - wrow0, acc, a.scale);
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    savep_bwd_dkdv_kernel(const BwdArgs<T> a) {
  using L = Layout<T>;
  constexpr int kLd = L::kLd, kN = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Vs = reinterpret_cast<T*>(smem_raw);  // kRows x kLd
  T* ring = Vs + kRows * kLd;              // kStages x (q, dO)
  __nv_bfloat16* Pring =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * 2 * L::kTile);
  float* Dring = reinterpret_cast<float*>(Pring + kStages * L::kPTile);
  float* Fs = Dring + kStages * kKeys;  // fp32: dS^T, then P_v^T rows

  const int key0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int seq = a.seq;
  const uint32_t bh = (uint32_t)(b * a.heads + h);
  const enc::Dropout drop = a.drop;
  const uint32_t mbh = drop.bh(b, h);  // the mask's global index
  const int64_t d_model = (int64_t)a.heads * kHeadDim, ld = 3 * d_model;
  const T* q = a.qkv + b * seq * ld + h * kHeadDim;
  const T* v = q + 2 * d_model;
  const T* dout = a.dout + b * seq * d_model + h * kHeadDim;
  const __nv_bfloat16* probs = a.probs + (int64_t)bh * seq * seq;
  const float* delta = a.delta + (int64_t)bh * seq;
  const int warp = threadIdx.x >> 5;
  const int wkey0 = key0 + 16 * warp;  // this warp's first key
  const bool active = wkey0 < seq;     // warp-uniform
  const int nq = (seq + kKeys - 1) / kKeys;

  auto enqueue = [&](int it) {
    if (it < nq) {
      const int q0 = it * kKeys, slot = it % kStages;
      T* dst = ring + slot * 2 * L::kTile;
      copy_tile_async<kThreads>(dst, kLd, q + q0 * ld, ld, kKeys, kHeadDim,
                                seq - q0, kHeadDim);
      copy_tile_async<kThreads>(dst + L::kTile, kLd, dout + q0 * d_model,
                                d_model, kKeys, kHeadDim, seq - q0, kHeadDim);
      cp_async_commit();
      attn::copy_tile_elems<kThreads>(
          Pring + slot * L::kPTile, L::kPLd, probs + (int64_t)q0 * seq + key0,
          seq, kKeys, kRows, seq - q0, seq - key0);
      for (int t = threadIdx.x; t < kKeys; t += kThreads)
        Dring[slot * kKeys + t] = q0 + t < seq ? delta[q0 + t] : 0.f;
    } else {
      cp_async_commit();
    }
  };
  auto next = [&](int it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    enqueue(it + kStages - 1);
    return it % kStages;
  };

  copy_tile_async<kThreads>(Vs, kLd, v + key0 * ld, ld, kRows, kHeadDim,
                            seq - key0, kHeadDim);  // in group 0
  enqueue(0);

  const T* Vw = Vs + 16 * warp * kLd;
  float* Fw = Fs + 16 * warp * L::kFLd;
  float* Gw = Fs + (kRows + 16 * warp) * L::kFLd;
  uint32_t vf[kHeadDim / 16][4];  // bf16: V's A fragments
  float dk[1][kHeadDim / 8][4], dv[1][kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[0][j][e] = dv[0][j][e] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int slot = next(it);
    if (!active) continue;
    if constexpr (!L::kF32)
      if (it == 0)
#pragma unroll
        for (int kk = 0; kk < kHeadDim / 16; ++kk)
          load_a_frag<false>(vf[kk], Vw, kLd, kk * 16);
    const int q0 = it * kKeys;
    const T* Qc = ring + slot * 2 * L::kTile;
    const T* dOc = Qc + L::kTile;
    const float* Dc = Dring + slot * kKeys;
    run(seq - q0, [&](auto full, int live_) {
      const int live = decltype(full)::value ? kKeys / 16 : live_;
      float dp[1][kN][4], p[kN][4];
      // dP^T = V dO^T: this warp's keys by the chunk's queries
      attn::chunk_scores<T, kHeadDim>(dp, vf, Vw, dOc, live);
      load_p<true>(p, Pring + slot * L::kPTile + 16 * warp, L::kPLd, live);
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + frag_col(e);  // query q0 + c
          float g = dp[0][j][e], pv = p[j][e];
          if constexpr (kDrop) {
            const bool keep =
                enc::keeps(drop, mbh, q0 + c, wkey0 + frag_row(e));
            g = keep ? g * drop.inv_keep : 0.f;
            pv = keep ? pv * drop.inv_keep : 0.f;
          }
          // a query past S: P was staged as 0 (or read as 0 past the live
          // groups), so dS^T = P_v^T = 0
          dp[0][j][e] = p[j][e] * (g - Dc[c]);
          p[j][e] = pv;
        }
      mma_tile<T, kHeadDim>(dk, dp[0], Qc, Fw, live);
      mma_tile<T, kHeadDim>(dv, p, dOc, Gw, live);
    });
  }
  cp_async_wait<0>();
  if (!active) return;
  const int64_t at = (b * seq + wkey0) * d_model + h * kHeadDim;
  store_acc<T, kHeadDim>(a.dk + at, d_model, seq - wkey0, dk, a.scale);
  store_acc<T, kHeadDim>(a.dv + at, d_model, seq - wkey0, dv, 1.f);
}

template <typename T, bool kDrop>
cudaError_t launch(const BwdArgs<T>& a, int batch, cudaStream_t stream) {
  using L = Layout<T>;
  const int nk = (a.seq + kKeys - 1) / kKeys;
  const size_t dq_bytes =
      L::kDqBytes + (kDrop ? sizeof(uint32_t) * kRows / 16 * 32 * nk : 0);
  cudaError_t err = cudaFuncSetAttribute(
      savep_bwd_dq_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(savep_bwd_dkdv_kernel<T, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kDkvBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, batch);
  savep_bwd_dq_kernel<T, kDrop><<<grid, kThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  savep_bwd_dkdv_kernel<T, kDrop><<<grid, kThreads, L::kDkvBytes, stream>>>(
      a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* qkv, const void* probs,
                         const void* dout, void* delta, void* dq, void* dk,
                         void* dv, int batch, int seq, int heads,
                         enc::Dropout drop, int dropout,
                         cudaStream_t stream) {
  BwdArgs<T> a{};
  a.qkv = static_cast<const T*>(qkv);
  a.probs = static_cast<const __nv_bfloat16*>(probs);
  a.dout = static_cast<const T*>(dout);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.seq = seq;
  a.heads = heads;
  a.scale = 1.0f / sqrtf((float)kHeadDim);
  a.drop = drop;
  return enc::with_dropout(dropout, [&](auto flag) {
    return launch<T, decltype(flag)::value>(a, batch, stream);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers, 16-byte
// aligned; qkv is a contiguous (batch, seq, 3 * heads * 64) tensor, probs a
// contiguous (batch, heads, seq, seq) bfloat16 tensor, dout, dq, dk and dv
// contiguous (batch, seq, heads * 64) tensors of qkv's type, delta a
// contiguous (batch, heads, seq) fp32 scratch written by the first kernel
// and read by the second. dropout, seed, threshold and inv_keep as the
// forward's.
extern "C" int arsvt_encoder_attention_savep_bwd(
    const void* qkv, const void* probs, const void* dout, void* delta,
    void* dq, void* dk, void* dv, int batch, int seq, int heads,
    int head_dim, uint32_t seed, uint32_t threshold, float inv_keep,
    int dropout, int b0, int mask_heads, int h0, int dtype, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || seq < 1 ||
      heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b0 < 0 || mask_heads < heads || h0 < 0 || h0 + heads > mask_heads)
    return (int)cudaErrorInvalidValue;
  const enc::Dropout drop{seed, threshold, inv_keep, b0, mask_heads, h0};
  switch (dtype) {
    case 0:
      return (int)launch_typed<float>(qkv, probs, dout, delta, dq, dk, dv,
                                      batch, seq, heads, drop, dropout, st);
    case 1:
      return (int)launch_typed<__nv_bfloat16>(qkv, probs, dout, delta, dq,
                                              dk, dv, batch, seq, heads, drop,
                                              dropout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Interface 2 takes the mask's global offsets (b0, mask_heads, h0) after
// the dropout flag; interface 1 had none.
extern "C" int arsvt_attention_version() { return 2; }
