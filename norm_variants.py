#!/usr/bin/env python3
"""Time the designs weighed for the port's LayerNorm and GELU kernels
against the shipped kernels, in one process on one card.

    python3 norm_variants.py [--parent DIR]

Each variant is this checkout's ``csrc/layernorm.cu`` or
``csrc/gelu_tanh.cu`` with the edits of `VARIANTS`, built with this
checkout's nvcc flags into ``build/norm_variants/`` (one nvcc each, all
started together) and bound by ctypes through the C interface of the
shipped library. The LayerNorm forward's:

- ``ln_fwd_no_prefetch``: a warp asks for its next row after it has
  written the current one, not before it reduces it (a row's registers
  fewer a thread);
- ``ln_fwd_row_a_warp``: a warp a row, as many blocks as the rows need
  (the grid not capped at what the card holds at once);
- ``ln_fwd_six_blocks``, ``ln_fwd_blocks_by_width``: the row kernel's
  launch bound asking for 6 blocks an SM at every width, or at up to 3
  vectors a lane (4 past it);

the GELU backward's:

- ``gelu_bwd_capped``: the parent's launch, a grid-stride loop on twice
  the blocks the card holds at once (as the forward launches);
- ``gelu_bwd_two_a_thread``: half the blocks, two vectors a thread;
- ``gelu_bwd_table_ring``: the table route weighed in place of the
  arithmetic (`_TABLE`): gelu'(u) in fp32 over the bf16 inputs with 2^-23
  <= |u| < 2^9 (32 KB) in shared memory, gelu_grad beyond; u and g
  streamed through a cp.async ring of four slots a thread, one block of
  1,024 threads an SM;
- ``gelu_bwd_table_ring_stream_only``: that ring storing u xor g, no
  lookup (a time only: its streaming alone);

and, from the previous redesign, the LayerNorm backward's and the GELU
forward's:

- ``ln_two_launches_serial``: the column sums launched after the row
  kernel, not as its programmatic dependent;
- ``ln_row_kernel_alone``: the row kernel without the column sums (dscale
  and dbias not written: a time only);
- ``ln_one_launch_tickets``: one launch: the last block of each group of
  about sqrt(blocks) blocks to finish, found by an integer ticket, sums
  its group's partials in block order, and the last group's the groups'
  into dscale and dbias (its tickets and pointers in device globals of
  its own);
- ``gelu_without_table_copy``: the forward's lookup kernel without the
  table's copy into shared memory (a time only);
- ``gelu_copy_without_lookup``: the forward's lookup kernel storing each
  vector of u as it arrived (the table copied, not read: a time only).

The variants that compute the function are held against the shipped
kernel to the bit (`SAME_BITS`: the LayerNorm forward's and the GELU
backward's) or
against the plain version at ``chip_smoke.py`` phase 3(c)'s limits (the
LayerNorm backward's; the ticketed one also to its own bits on a second
run). Then at ViT-B's, the detector's and ViT-L's bf16 training shapes
and B = 1 serving's (`chip_smoke.NORM_TIMED`) the shipped kernel (through
its wrapper), each variant, the GELU's arithmetic routes and the library
call (F.layer_norm and its autograd backward, F.gelu(approximate="tanh")
and its autograd backward) are timed held on the device
(`chip_smoke.device_ms`), in turns (in order, then reversed). Prints the
card's name and power limit, each variant's registers, and one JSON line
per kernel and shape with each mean and the byte bound.

With ``--parent DIR`` (the root of a checkout of the parent commit, read
and never written) the parent's ``layernorm.cu`` and ``gelu_tanh.cu`` are
built beside the variants: the LayerNorm forward is held to the parent's
bits (y, mean and rstd, 0 differing elements) at `chip_smoke`'s widths in
both dtypes, the GELU backward likewise at the timed shapes, and both
parent kernels are timed in the same turns.

Run from the root of a checkout on a machine with the card and the CUDA
toolkit; it imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops import layernorm as ln_ops
from arsvt_tpu_torch.ops import mlp as mlp_ops
from chip_smoke import (
    NORM_DTYPES,
    NORM_EPS,
    NORM_TIMED,
    NORM_WIDTHS,
    check,
    device_ms,
    differing,
    held,
    ln_inputs,
    norm_bound,
    ptxas_report,
)

OUT_DIR = build.BUILD_DIR.parent / "norm_variants"

# The column sums as a plain launch after the row kernel.
_PDL_LAUNCH = '''  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cdiv(a.d, 32));
  cfg.blockDim = dim3(1024);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ln_bwd_cols,
                           static_cast<const float*>(a.part_gx),
                           static_cast<const float*>(a.part_g), dscale, dbias,
                           scale_bf16, blocks, a.d);'''
_SERIAL_LAUNCH = '''  ln_bwd_cols<<<(unsigned)cdiv(a.d, 32), 1024, 0, st>>>(
      a.part_gx, a.part_g, dscale, dbias, scale_bf16, blocks, a.d);
  err = cudaGetLastError();'''
_ROW_KERNEL_ONLY = ('''  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};''', '''  return err;
  cudaLaunchConfig_t cfg = {};''')

# The one-launch design: group partials after the block partials (2 (blocks
# + groups) d floats of scratch), tickets and output pointers in globals
# the launcher sets on the stream before the launch.
_TICKETS = r'''
constexpr int kMaxGroups = 64;
__device__ int g_tickets[1 + kMaxGroups];  // [0] the groups', [1 + k] group k's
struct Finish {
  void* dscale;
  void* dbias;
  int out_bf16;
  int group;  // blocks a group
};
__device__ Finish g_finish;

// dst[c] = sum over r < count of src[r * d + c], in r order, both arrays
__device__ void sum_rows(const float* src_gx, const float* src_g, int count,
                         int d, float* dst_gx, float* dst_g, int out_bf16) {
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < count; ++r) {
      sa = __fadd_rn(sa, __ldcg(src_gx + (int64_t)r * d + c));
      sb = __fadd_rn(sb, __ldcg(src_g + (int64_t)r * d + c));
    }
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(dst_gx)[c] = __float2bfloat16_rn(sa);
      reinterpret_cast<__nv_bfloat16*>(dst_g)[c] = __float2bfloat16_rn(sb);
    } else {
      dst_gx[c] = sa;
      dst_g[c] = sb;
    }
  }
}

// true in every thread of the block that takes the last of `count`
// tickets, which it sets back to 0
__device__ bool last_to_arrive(int* ticket, int count) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ticket, 1) == count - 1;
    if (s_last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

__device__ void finish(const BwdArgs& a) {
  const Finish f = g_finish;
  const int nb = gridDim.x, k = blockIdx.x / f.group, d = a.d;
  const int first = k * f.group;
  const int count = nb - first < f.group ? nb - first : f.group;
  const int groups = (nb + f.group - 1) / f.group;
  float* grp_gx = a.part_g + (int64_t)nb * d;
  float* grp_g = grp_gx + (int64_t)groups * d;
  if (!last_to_arrive(g_tickets + 1 + k, count)) return;
  sum_rows(a.part_gx + (int64_t)first * d, a.part_g + (int64_t)first * d,
           count, d, grp_gx + (int64_t)k * d, grp_g + (int64_t)k * d, 0);
  if (!last_to_arrive(g_tickets, groups)) return;
  sum_rows(grp_gx, grp_g, groups, d, static_cast<float*>(f.dscale),
           static_cast<float*>(f.dbias), f.out_bf16);
}

// The vector route, D <= 1,024 a multiple of kVec'''
_VEC_END = '''  block_partials<kVec, kLoads>(acc_g, red,
                               a.part_g + (int64_t)blockIdx.x * a.d, a.d);
}'''
_ROW_LAUNCH = '''  void* args[] = {const_cast<BwdArgs*>(&a)};'''
_ROW_LAUNCH_TICKETS = '''  int group = 1;
  while (group * group < blocks) ++group;
  const Finish f{dscale, dbias, scale_bf16, group};
  cudaError_t set =
      cudaMemcpyToSymbolAsync(g_finish, &f, sizeof(f), 0,
                              cudaMemcpyHostToDevice, st);
  if (set != cudaSuccess) return set;
  void* args[] = {const_cast<BwdArgs*>(&a)};'''

_TABLE_COPY = '''      hopper::mbar_expect_tx(table_bar, kTableBytes);
#pragma unroll
      for (int c = 0; c < kTableChunks; ++c)
        bulk_load(hopper::smem_u32(smem) + c * kChunk,
                  table + c * (kChunk / 2), kChunk, table_bar);'''

# The LayerNorm forward's edits.
_FWD_NO_PREFETCH = [
    ("    load_row<T, kVec, kLoads>(nx, a, row + step, lane);\n"
     "    float s = 0.f;", "    float s = 0.f;"),
    ("    if (lane == 0) {\n      a.mean[row] = mean;\n"
     "      a.rstd[row] = rstd;\n    }\n  }\n}",
     "    if (lane == 0) {\n      a.mean[row] = mean;\n"
     "      a.rstd[row] = rstd;\n    }\n"
     "    load_row<T, kVec, kLoads>(nx, a, row + step, lane);\n  }\n}")]
_FWD_CAP = ("<<<(unsigned)(want < fit ? want : fit), kThreads, 0, st>>>",
            "<<<(unsigned)want, kThreads, 0, st>>>")
_FWD_SIX = ("__launch_bounds__(kThreads) ln_fwd_rows",
            "__launch_bounds__(kThreads, 6) ln_fwd_rows")
_FWD_BY_WIDTH = ("__launch_bounds__(kThreads) ln_fwd_rows",
                 "__launch_bounds__(kThreads, kLoads <= 3 ? 6 : 4) "
                 "ln_fwd_rows")
# The GELU backward's edits: the forward's capped grid; two vectors a
# thread; the table route weighed in place of the arithmetic (`_TABLE`,
# `_TABLE_ENTRIES`: a table of gelu'(u) over the bf16 inputs with 2^-23 <=
# |u| < 2^9 in shared memory, u and g streamed through a cp.async ring of
# four slots a thread, one block of 1,024 threads an SM).
_BWD_CAPPED = ("  if constexpr (!kBwd) {  // resident at 8 blocks an SM,",
               "  if constexpr (true) {  // resident at 8 blocks an SM,")
_BWD_TWO = ("  int64_t blocks = (work + kThreads - 1) / kThreads;",
            "  int64_t blocks = (work + (kBwd ? 2 : 1) * kThreads - 1) /"
            " ((kBwd ? 2 : 1) * kThreads);")
_TABLE = r'''
// ------------------------------------------- the bf16 backward's table

// The band of u whose fp32 derivative the table holds: every bf16 of
// biased exponent kGradExpLo ... kGradExpLo + kGradExps - 1, that is 2^-23
// <= |u| < 2^9, 128 mantissas an exponent, the positive half first. The
// rest (zeros, subnormals, |u| < 2^-23, |u| >= 512, ±Inf, NaN) takes
// gelu_grad.
constexpr uint32_t kGradExpLo = 104;
constexpr int kGradExps = 32;
constexpr int kGradHalfLog2 = 12;
constexpr int kGradHalf = 1 << kGradHalfLog2;   // 4,096 entries a sign
static_assert(kGradHalf == kGradExps * 128, "a half is the band's exponents");
constexpr int kGradEntries = 2 * kGradHalf;
constexpr int kGradBytes = kGradEntries * 4;    // 32 KB
constexpr int kGradThreads = 1024;              // one block an SM
// 16-byte vectors of u and of g a thread keeps in flight, in a ring of its
// own slots in shared memory
constexpr int kGradStages = 4;
constexpr int kGradRingBytes = kGradStages * 2 * kGradThreads * 16;
constexpr int kGradSmem = kGradBytes + kGradRingBytes;  // 160 KB

// entry i = gelu_grad of the bf16 whose bits the band's i-th place names
__global__ void __launch_bounds__(kThreads) grad_table_kernel(float* table) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t bits = ((i >> kGradHalfLog2) << 15) |
                        ((i & (kGradHalf - 1)) + (kGradExpLo << 7));
  table[i] = gelu_grad(__uint_as_float(bits << 16));
}

// gelu'(u) for bf16 bits b: the table's entry where u is in the band
__device__ __forceinline__ bool grad_in_band(uint32_t b, uint32_t* entry) {
  const uint32_t off = (b & 0x7fffu) - (kGradExpLo << 7);  // wraps below
  *entry = off + ((b >> 15) << kGradHalfLog2);
  return off < (uint32_t)kGradHalf;
}

__device__ __forceinline__ float grad_of(const float* t, uint32_t b) {
  uint32_t entry;
  return grad_in_band(b, &entry) ? t[entry]
                                 : gelu_grad(__uint_as_float(b << 16));
}

// du for the 8 bf16 of u and g in two 16-byte vectors: each lane's
// lookups first, then, where one of its 8 is outside the band (rare for a
// GELU's inputs), gelu_grad for those; g * gelu'(u) rounded once.
__device__ __forceinline__ uint4 grad8(const float* t, uint4 uv, uint4 gv) {
  const uint32_t uw[4] = {uv.x, uv.y, uv.z, uv.w};
  const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
  float d[8];
  bool outside = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t b = k & 1 ? uw[k / 2] >> 16 : uw[k / 2] & 0xffffu;
    uint32_t entry;
    const bool in = grad_in_band(b, &entry);
    d[k] = t[in ? entry : 0];
    outside |= !in;
  }
  if (outside) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t b = k & 1 ? uw[k / 2] >> 16 : uw[k / 2] & 0xffffu;
      uint32_t entry;
      if (!grad_in_band(b, &entry))
        d[k] = gelu_grad(__uint_as_float(b << 16));
    }
  }
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 two = __floats2bfloat162_rn(
        __fmul_rn(__uint_as_float(gw[k] << 16), d[2 * k]),
        __fmul_rn(__uint_as_float(gw[k] & 0xffff0000u), d[2 * k + 1]));
    o[k] = *reinterpret_cast<const uint32_t*>(&two);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 16 bytes from global src to shared dst by cp.async, zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// du = g * gelu'(u) over n bf16 elements by the table: one block of 1,024
// threads an SM, each thread taking the 16-byte vectors i, i + stride, ...
// of u and g. The block's first cp.async group copies the 32 KB table into
// shared memory; then each thread keeps kGradStages of its vectors of u
// and of g in flight by cp.async into a ring of its own slots, one group a
// vector, and refills a slot as soon as it has used it. No register holds
// a byte in flight, so an SM has 128 KB of loads outstanding. The tail past
// the whole vectors, or every element of an unaligned tensor, one a thread.
__global__ void __launch_bounds__(kGradThreads, 1)
    grad_table_bwd_kernel(uint16_t* __restrict__ du,
                          const uint16_t* __restrict__ u,
                          const uint16_t* __restrict__ g,
                          const float* __restrict__ table, int64_t n,
                          int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const float* s_grad = reinterpret_cast<const float*>(smem);
  uint4* ring = reinterpret_cast<uint4*>(smem + kGradBytes);  // [stage][2][t]
  const int64_t nv = vec ? n / 8 : 0;
  const int64_t first = (int64_t)blockIdx.x * kGradThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kGradThreads;
  const uint4* uv = reinterpret_cast<const uint4*>(u);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* dv = reinterpret_cast<uint4*>(du);
  auto slot = [&](int s, int which) {
    return ring + (s * 2 + which) * kGradThreads + threadIdx.x;
  };
  // vector i of u and g into slot s; past the end, zeros (from the table's
  // 16-byte aligned address: u itself may be unaligned)
  auto ask = [&](int64_t i, int s) {
    const bool ok = i < nv;
    const void* none = table;
    cp_async16(slot(s, 0), ok ? (const void*)(uv + i) : none, ok);
    cp_async16(slot(s, 1), ok ? (const void*)(gv + i) : none, ok);
    cp_async_commit();
  };
  for (int i = threadIdx.x; i < kGradBytes / 16; i += kGradThreads)
    cp_async16(smem + i * 16, reinterpret_cast<const uint4*>(table) + i,
               true);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kGradStages; ++s) ask(first + s * stride, s);
  cp_async_wait<kGradStages>();  // this thread's part of the table
  __syncthreads();               // and every other thread's
  int s = 0;
  for (int64_t i = first; i < nv; i += stride) {
    cp_async_wait<kGradStages - 1>();  // vector i landed in slot s
    dv[i] = grad8(s_grad, *slot(s, 0), *slot(s, 1));
    ask(i + kGradStages * stride, s);
    s = s + 1 == kGradStages ? 0 : s + 1;
  }
  cp_async_wait<0>();
  for (int64_t i = nv * 8 + first; i < n; i += stride) {
    const float d = grad_of(s_grad, u[i]);
    const float gf = __uint_as_float((uint32_t)g[i] << 16);
    du[i] = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(gf, d)));
  }
}

// the backward table route's 160 KB of dynamic shared memory, allowed once
// a device
cudaError_t allow_grad_smem() {
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || allowed[dev]) return err;
  err = cudaFuncSetAttribute((const void*)grad_table_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGradSmem);
  allowed[dev] = err == cudaSuccess;
  return err;
}

'''
_TABLE_ENTRIES = r'''
// The backward's table (arsvt_gelu_tanh_grad_table_entries() fp32, 16-byte
// aligned): gelu_grad, the derivative of arsvt_gelu_tanh_bwd, at each bf16
// of the band, in the band's order.
extern "C" int arsvt_gelu_tanh_grad_table(void* table, void* stream) {
  if (table == nullptr || (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  grad_table_kernel<<<kGradEntries / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table));
  return (int)cudaGetLastError();
}

extern "C" int arsvt_gelu_tanh_grad_table_entries() { return kGradEntries; }

// du = g * gelu'(u) in bf16, gelu'(u) from the table where u is in its
// band: the bits of arsvt_gelu_tanh_bwd. All three contiguous with n
// elements, du overlapping neither input; table as
// arsvt_gelu_tanh_grad_table left it.
extern "C" int arsvt_gelu_tanh_bwd_table(void* du, const void* u,
                                         const void* g, const void* table,
                                         int64_t n, void* stream) {
  if (du == nullptr || u == nullptr || g == nullptr || table == nullptr ||
      n < 1 || (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) err = allow_grad_smem();
  if (err != cudaSuccess) return (int)err;
  const bool vec = (uintptr_t)du % 16 == 0 && (uintptr_t)u % 16 == 0 &&
                   (uintptr_t)g % 16 == 0;
  const int64_t work = vec ? n / 8 : n;
  const int64_t want = (work + kGradThreads - 1) / kGradThreads;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : want < sms ? want : sms);
  grad_table_bwd_kernel<<<blocks, kGradThreads, kGradSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(du), static_cast<const uint16_t*>(u),
      static_cast<const uint16_t*>(g), static_cast<const float*>(table), n,
      vec ? 1 : 0);
  return (int)cudaGetLastError();
}
'''
_TABLE_AT = "}  // namespace\n\n// h = gelu(u), both contiguous"
_ENTRIES_AT = ("      static_cast<const uint16_t*>(table), n, vec ? 1 : 0);\n"
               "  return (int)cudaGetLastError();\n}")
_TABLE_IN = [(_TABLE_AT, _TABLE + _TABLE_AT),
             (_ENTRIES_AT, _ENTRIES_AT + "\n\n" + _TABLE_ENTRIES)]
_XOR8 = ("// 16 bytes from global src to shared dst by cp.async",
         """__device__ __forceinline__ uint4 xor8(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// 16 bytes from global src to shared dst by cp.async""")
_TABLE_LOOKUP = ("dv[i] = grad8(s_grad, *slot(s, 0), *slot(s, 1));",
                 "dv[i] = xor8(*slot(s, 0), *slot(s, 1));")

VARIANTS = {
    "ln_fwd_no_prefetch": ("layernorm", _FWD_NO_PREFETCH),
    "ln_fwd_row_a_warp": ("layernorm", [_FWD_CAP]),
    "ln_fwd_six_blocks": ("layernorm", [_FWD_SIX]),
    "ln_fwd_blocks_by_width": ("layernorm", [_FWD_BY_WIDTH]),
    "gelu_bwd_capped": ("gelu_tanh", [_BWD_CAPPED]),
    "gelu_bwd_two_a_thread": ("gelu_tanh", [_BWD_TWO]),
    "gelu_bwd_table_ring": ("gelu_tanh", _TABLE_IN),
    "gelu_bwd_table_ring_stream_only": ("gelu_tanh", _TABLE_IN + [
        _XOR8, _TABLE_LOOKUP]),
    "ln_two_launches_serial": ("layernorm", [(_PDL_LAUNCH, _SERIAL_LAUNCH)]),
    "ln_row_kernel_alone": ("layernorm", [_ROW_KERNEL_ONLY]),
    "ln_one_launch_tickets": ("layernorm", [
        ("\n// The vector route, D <= 1,024 a multiple of kVec",
         _TICKETS),
        (_VEC_END, _VEC_END[:-1] + "  finish(a);\n}"),
        (_ROW_LAUNCH, _ROW_LAUNCH_TICKETS), _ROW_KERNEL_ONLY]),
    "gelu_without_table_copy": ("gelu_tanh", [
        (_TABLE_COPY, "      hopper::mbar_arrive(table_bar);")]),
    "gelu_copy_without_lookup": ("gelu_tanh", [
        ("hv[e0 / 8 + t] = look8(s_table, tile[t]);",
         "hv[e0 / 8 + t] = tile[t];")]),
}
# variants whose outputs are held to the shipped kernel's bits, and those
# held against the plain version
SAME_BITS = ("ln_fwd_no_prefetch", "ln_fwd_row_a_warp", "ln_fwd_six_blocks",
             "ln_fwd_blocks_by_width", "gelu_bwd_capped",
             "gelu_bwd_two_a_thread", "gelu_bwd_table_ring",
             "parent_gelu_tanh")
COMPUTES = ("ln_two_launches_serial", "ln_one_launch_tickets")
# the GELU backward variants reached through the table route's entry
TABLE_ROUTE = ("gelu_bwd_table_ring", "gelu_bwd_table_ring_stream_only")


def build_variants(parent: Path | None = None) -> dict:
    """{variant: its library}, all compiled at once; with `parent` (the root
    of the parent commit's checkout) also its ``layernorm.cu`` and
    ``gelu_tanh.cu`` as they are, "parent_layernorm" and
    "parent_gelu_tanh"."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    jobs = [(name, build.source_path(source), edits, build.CSRC_DIR)
            for name, (source, edits) in VARIANTS.items()]
    if parent is not None:
        csrc = parent / "arsvt_tpu_torch" / "csrc"
        jobs += [(f"parent_{source}", csrc / f"{source}.cu", [], csrc)
                 for source in ("layernorm", "gelu_tanh")]
    for name, path, edits, include in jobs:
        text = path.read_text()
        for old, new in edits:
            check(old in text, f"{name}: the edit's anchor is not in "
                  f"{path.name}: {old[:60]!r}")
            text = text.replace(old, new)
        src = OUT_DIR / f"{name}.cu"
        src.write_text(text)
        cmd = build.nvcc_command(src, OUT_DIR / f"lib{name}.so", nvcc)
        procs[name] = subprocess.Popen(
            [*cmd, "-I", str(include), "-Xcompiler=-fno-gnu-unique"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on {name}:\n{log}")
        for row in ptxas_report({name: {"log": log}}):
            print(json.dumps({"variant": name, "ptxas": row}), flush=True)
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ln_variant(lib: ctypes.CDLL, tickets: bool):
    """A call of `lib`'s backward on (x, g, scale, mean, rstd), returning
    (dx, dscale, dbias); the scratch sized for the variant."""
    blocks_fn = lib.arsvt_layer_norm_bwd_blocks
    blocks_fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    fn = lib.arsvt_layer_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]

    def call(x, g, scale, mean, rstd):
        rows, d = x.shape
        blocks = blocks_fn(rows, d, 1)
        group = math.isqrt(blocks - 1) + 1
        groups = -(-blocks // group) if tickets else 0
        check(groups <= 64, f"{groups} groups: past the variant's tickets")
        scratch = torch.empty(2 * (blocks + groups) * d, device="cuda")
        dx = torch.empty_like(x)
        dscale = torch.empty(d, dtype=scale.dtype, device="cuda")
        dbias = torch.empty_like(dscale)
        err = fn(dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                 scratch.data_ptr(), blocks, x.data_ptr(), g.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), rows, d,
                 1, 1, stream())
        check(err == 0, f"LayerNorm variant launch: CUDA error {err}")
        return dx, dscale, dbias
    return call


def gelu_variant(lib: ctypes.CDLL):
    fn = lib.arsvt_gelu_tanh_fwd_table
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]

    def call(u):
        h = torch.empty_like(u)
        err = fn(h.data_ptr(), u.data_ptr(), mlp_ops._table(u).data_ptr(),
                 u.numel(), stream())
        check(err == 0, f"GELU variant launch: CUDA error {err}")
        return h
    return call


def ln_fwd_variant(lib: ctypes.CDLL):
    """A call of `lib`'s LayerNorm forward on (x, scale, bias), x (rows, d),
    each in fp32 or bf16, returning (y, mean, rstd)."""
    fn = lib.arsvt_layer_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    code = {torch.float32: 0, torch.bfloat16: 1}

    def call(x, scale, bias):
        rows, d = x.shape
        y = torch.empty_like(x)
        mean = torch.empty(rows, device="cuda")
        rstd = torch.empty_like(mean)
        err = fn(y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), x.data_ptr(),
                 scale.data_ptr(), bias.data_ptr(), rows, d, code[x.dtype],
                 code[scale.dtype], code[bias.dtype], NORM_EPS, stream())
        check(err == 0, f"LayerNorm forward variant launch: CUDA error {err}")
        return y, mean, rstd
    return call


def gelu_bwd_variant(lib: ctypes.CDLL, table_route: bool):
    """A call of `lib`'s bf16 GELU backward on (u, g): its arithmetic entry,
    or the table route's with a table the library filled on the card."""
    if not table_route:
        fn = lib.arsvt_gelu_tanh_bwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_void_p]
        extra = (1,)  # bf16
    else:
        fill = lib.arsvt_gelu_tanh_grad_table
        fill.argtypes = [ctypes.c_void_p] * 2
        table = torch.empty(lib.arsvt_gelu_tanh_grad_table_entries(),
                            device="cuda")
        check(fill(table.data_ptr(), stream()) == 0, "the table's fill")
        fn = lib.arsvt_gelu_tanh_bwd_table
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]

    def call(u, g):
        du = torch.empty_like(u)
        if table_route:
            err = fn(du.data_ptr(), u.data_ptr(), g.data_ptr(),
                     table.data_ptr(), u.numel(), stream())
        else:
            err = fn(du.data_ptr(), u.data_ptr(), g.data_ptr(), u.numel(),
                     *extra, stream())
        check(err == 0, f"GELU backward variant launch: CUDA error {err}")
        return du
    return call


def parent_bits(lib: ctypes.CDLL, gen) -> dict:
    """Elements of y, mean and rstd whose bits differ between the parent's
    LayerNorm forward and the shipped one, over `chip_smoke`'s widths, 197
    and 6,304 rows, x and the parameters in bf16 and fp32, and a row
    pointer off 16 bytes."""
    parent = ln_fwd_variant(lib)
    cases = [(r, d, xdt, sdt, 0) for d in NORM_WIDTHS for r in (197, 6304)
             for xdt in NORM_DTYPES for sdt in NORM_DTYPES]
    cases += [(197, 768, xdt, xdt, 1) for xdt in NORM_DTYPES]
    out = {"cases": len(cases), "y": 0, "mean": 0, "rstd": 0}
    for rows, d, xdt, sdt, offset in cases:
        x, scale, bias, _ = ln_inputs(rows, d, xdt, sdt, gen, offset)
        got = ln_ops.layer_norm_fwd(x, scale, bias, NORM_EPS)
        ref = parent(x.contiguous(), scale, bias)
        for k, a, b in zip(("y", "mean", "rstd"), got, ref):
            out[k] += differing(a, b)
    return out


def timed(kernel: str, cell: str, shape, calls: dict, nbytes: int,
          smi: str) -> None:
    """Held device ms of each call in turns, beside the byte bound."""
    print(json.dumps({"kernel": kernel, "cell": cell, "shape": list(shape),
                      "device_ms": in_turns(calls),
                      **norm_bound(nbytes, 0), "card": smi}), flush=True)


def same_bits(name: str, cell: str, got, ref) -> None:
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    check(all(differing(a, b) == 0 for a, b in zip(got, ref)),
          f"{name} at {cell}: the shipped kernel's bits differ")


def in_turns(fns: dict) -> dict:
    """{name: mean held device ms} over two turns, in order then reversed,
    each call held behind 2 ms of spin."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(reversed(fns))):
        for k in order:
            try:
                times[k].append(device_ms(fns[k], iters=50,
                                          hold_cycles=4_000_000))
            except RuntimeError as err:
                raise RuntimeError(f"timing {k}: {err}") from err
    return {k: sum(v) / len(v) for k, v in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("norm_variants: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve() \
        if "--parent" in sys.argv[1:] else None
    libs = build_variants(parent)
    gen = torch.Generator(device="cuda").manual_seed(36)
    dt = torch.bfloat16
    if parent is not None:
        rec = parent_bits(libs["parent_layernorm"], gen)
        print(json.dumps({"check": "LayerNorm forward against the parent's "
                          "kernel, differing elements", "parent": str(parent),
                          **rec, "card": smi}), flush=True)
        check(rec["y"] == rec["mean"] == rec["rstd"] == 0,
              f"the LayerNorm forward's bits moved from the parent's: {rec}")
        VARIANTS["parent_layernorm"] = ("layernorm", [])
        VARIANTS["parent_gelu_tanh"] = ("gelu_tanh", [])
    for cell, (rows, d, m) in NORM_TIMED.items():
        x, scale, bias, g = ln_inputs(rows, d, dt, dt, gen)
        n, e = rows * d, x.element_size()
        ref = ln_ops.layer_norm_fwd(x, scale, bias, NORM_EPS)
        calls = {"shipped": lambda: ln_ops.layer_norm_fwd(x, scale, bias,
                                                          NORM_EPS)}
        for name in VARIANTS:
            if name.startswith("ln_fwd_") or name == "parent_layernorm":
                fn = ln_fwd_variant(libs[name])
                calls[name] = (lambda fn=fn: fn(x, scale, bias))
                same_bits(name, cell, calls[name](), ref)
        calls["library"] = lambda: F.layer_norm(x, (d,), scale, bias,
                                                NORM_EPS)
        timed("layer_norm forward", cell, (rows, d), calls,
              2 * n * e + 2 * d * e + 8 * rows, smi)
        mean, rstd = ref[1], ref[2]

        if cell != "serve_b1":
            ref = ln_ops.layer_norm_bwd_plain(x, g, scale, mean, rstd)
            calls = {"shipped": lambda: ln_ops.layer_norm_bwd(
                x, g, scale, mean, rstd)}
            for name in VARIANTS:
                if name.startswith("ln_") and not name.startswith("ln_fwd"):
                    fn = ln_variant(libs[name],
                                    name == "ln_one_launch_tickets")
                    calls[name] = (lambda fn=fn: fn(x, g, scale, mean, rstd))
                    if name in COMPUTES:
                        got, again = calls[name](), calls[name]()
                        rec = [held(a, b) for a, b in zip(got, ref)]
                        check(all(r["ok"] for r in rec) and all(
                            torch.equal(a, b) for a, b in zip(got, again)),
                            f"{name} at {cell}: {rec}")
            xr, sr, br = (t.clone().requires_grad_(True)
                          for t in (x, scale, bias))
            y = F.layer_norm(xr, (d,), sr, br, NORM_EPS)
            calls["library"] = lambda: torch.autograd.grad(
                y, (xr, sr, br), g, retain_graph=True)
            timed("layer_norm backward", cell, (rows, d), calls,
                  3 * n * e + 3 * d * e + 8 * rows, smi)
            del xr, y
        del x, g, calls, ref

        u = torch.randn(rows, m, generator=gen, device="cuda").mul(4).to(dt)
        gu = torch.randn(rows, m, generator=gen, device="cuda").to(dt)
        n = rows * m
        if cell != "serve_b1":
            ref = mlp_ops.gelu_tanh_fwd(u, route="arithmetic")
            calls = {"shipped": lambda: mlp_ops.gelu_tanh_fwd(u,
                                                              route="table"),
                     "arithmetic": lambda: mlp_ops.gelu_tanh_fwd(
                         u, route="arithmetic"),
                     "library": lambda: F.gelu(u, approximate="tanh")}
            same_bits("the table route", cell, calls["shipped"](), ref)
            for name in VARIANTS:
                if name.startswith("gelu_") and not name.startswith(
                        "gelu_bwd"):
                    fn = gelu_variant(libs[name])
                    calls[name] = (lambda fn=fn: fn(u))
            timed("gelu_tanh forward", cell, (rows, m), calls, 4 * n, smi)

        ref = mlp_ops.gelu_tanh_bwd(u, gu)
        calls = {"shipped": lambda: mlp_ops.gelu_tanh_bwd(u, gu)}
        for name in VARIANTS:
            if name.startswith("gelu_bwd_") or name == "parent_gelu_tanh":
                fn = gelu_bwd_variant(libs[name], name in TABLE_ROUTE)
                calls[name] = (lambda fn=fn: fn(u, gu))
                if name in SAME_BITS:
                    same_bits(name, cell, calls[name](), ref)
        ur = u.clone().requires_grad_(True)
        h = F.gelu(ur, approximate="tanh")
        calls["library"] = lambda: torch.autograd.grad(h, ur, gu,
                                                       retain_graph=True)
        timed("gelu_tanh backward", cell, (rows, m), calls, 6 * n, smi)
        del u, gu, ur, h, ref, calls
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
