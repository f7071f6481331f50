#!/usr/bin/env python3
"""Time the designs weighed for the bf16 GELU forward's table route and
the LayerNorm backward against the shipped kernels, in one process on one
card.

    python3 norm_variants.py

Each variant is this checkout's ``csrc/layernorm.cu`` or
``csrc/gelu_tanh.cu`` with the edits of `VARIANTS`, built with this
checkout's nvcc flags into ``build/norm_variants/`` (one nvcc each, all
started together) and bound by ctypes through the C interface of the
shipped library:

- ``ln_two_launches_serial``: the column sums launched after the row
  kernel, not as its programmatic dependent;
- ``ln_row_kernel_alone``: the row kernel without the column sums (dscale
  and dbias not written: a time only);
- ``ln_one_launch_tickets``: one launch: the last block of each group of
  about sqrt(blocks) blocks to finish, found by an integer ticket, sums
  its group's partials in block order, and the last group's the groups'
  into dscale and dbias (its tickets and pointers in device globals of
  its own);
- ``gelu_without_table_copy``: the lookup kernel without the table's copy
  into shared memory (it looks up whatever that memory holds: a time
  only);
- ``gelu_copy_without_lookup``: the lookup kernel storing each vector of
  u as it arrived (the table copied, not read: a time only).

The variants that compute the function are held against the plain
version at ``chip_smoke.py`` phase 3(c)'s limits (the ticketed one also
to its own bits on a second run). Then at ViT-B's, the detector's and
ViT-L's bf16 training shapes (`chip_smoke.NORM_TIMED`) the shipped
kernel (through its wrapper), each variant, the GELU's arithmetic route
and the library call (F.layer_norm's autograd backward,
F.gelu(approximate="tanh")) are timed held on the device
(`chip_smoke.device_ms`), in turns (in order, then reversed). Prints the
card's name and power limit, each variant's registers, and one JSON line
per kernel and shape with each mean and the byte bound.

Run from the root of a checkout on a machine with the card and the CUDA
toolkit; it imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops import layernorm as ln_ops
from arsvt_tpu_torch.ops import mlp as mlp_ops
from chip_smoke import (
    NORM_EPS,
    NORM_TIMED,
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

// kVec values of one 16-byte vector'''
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

VARIANTS = {
    "ln_two_launches_serial": ("layernorm", [(_PDL_LAUNCH, _SERIAL_LAUNCH)]),
    "ln_row_kernel_alone": ("layernorm", [_ROW_KERNEL_ONLY]),
    "ln_one_launch_tickets": ("layernorm", [
        ("\n// kVec values of one 16-byte vector", _TICKETS),
        (_VEC_END, _VEC_END[:-1] + "  finish(a);\n}"),
        (_ROW_LAUNCH, _ROW_LAUNCH_TICKETS), _ROW_KERNEL_ONLY]),
    "gelu_without_table_copy": ("gelu_tanh", [
        (_TABLE_COPY, "      hopper::mbar_arrive(table_bar);")]),
    "gelu_copy_without_lookup": ("gelu_tanh", [
        ("hv[e0 / 8 + t] = look8(s_table, tile[t]);",
         "hv[e0 / 8 + t] = tile[t];")]),
}
# variants whose outputs are held against the plain version
COMPUTES = ("ln_two_launches_serial", "ln_one_launch_tickets")


def build_variants() -> dict:
    """{variant: its library}, all compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name, (source, edits) in VARIANTS.items():
        text = build.source_path(source).read_text()
        for old, new in edits:
            check(old in text, f"{name}: the edit's anchor is not in "
                  f"{source}.cu: {old[:60]!r}")
            text = text.replace(old, new)
        src = OUT_DIR / f"{name}.cu"
        src.write_text(text)
        cmd = build.nvcc_command(src, OUT_DIR / f"lib{name}.so", nvcc)
        procs[name] = subprocess.Popen(
            [*cmd, "-I", str(build.CSRC_DIR), "-Xcompiler=-fno-gnu-unique"],
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


def in_turns(fns: dict) -> dict:
    """{name: mean held device ms} over two turns, in order then reversed."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(reversed(fns))):
        for k in order:
            times[k].append(device_ms(fns[k], iters=50,
                                      hold_cycles=2_000_000))
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
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(36)
    dt = torch.bfloat16
    for cell, (rows, d, m) in NORM_TIMED.items():
        if cell not in ("vit_b", "detector", "vit_l"):
            continue
        x, scale, bias, g = ln_inputs(rows, d, dt, dt, gen)
        _, mean, rstd = ln_ops.layer_norm_fwd(x, scale, bias, NORM_EPS)
        ref = ln_ops.layer_norm_bwd_plain(x, g, scale, mean, rstd)
        calls = {"shipped": lambda: ln_ops.layer_norm_bwd(x, g, scale, mean,
                                                          rstd)}
        for name in VARIANTS:
            if name.startswith("ln_"):
                fn = ln_variant(libs[name], name == "ln_one_launch_tickets")
                calls[name] = (lambda fn=fn: fn(x, g, scale, mean, rstd))
                if name in COMPUTES:
                    got, again = calls[name](), calls[name]()
                    rec = [held(a, b) for a, b in zip(got, ref)]
                    check(all(r["ok"] for r in rec) and all(
                        torch.equal(a, b) for a, b in zip(got, again)),
                        f"{name} at {cell}: {rec}")
        xr, sr, br = (t.clone().requires_grad_(True) for t in (x, scale,
                                                              bias))
        y = F.layer_norm(xr, (d,), sr, br, NORM_EPS)
        calls["library"] = lambda: torch.autograd.grad(
            y, (xr, sr, br), g, retain_graph=True)
        n, e = rows * d, x.element_size()
        print(json.dumps({"kernel": "layer_norm backward", "cell": cell,
                          "shape": [rows, d], "device_ms": in_turns(calls),
                          **norm_bound(3 * n * e + 3 * d * e + 8 * rows, 0),
                          "card": smi}), flush=True)
        del x, g, xr, y, calls

        u = torch.randn(rows, m, generator=gen, device="cuda").mul(4).to(dt)
        ref = mlp_ops.gelu_tanh_fwd(u, route="arithmetic")
        calls = {"shipped": lambda: mlp_ops.gelu_tanh_fwd(u, route="table"),
                 "arithmetic": lambda: mlp_ops.gelu_tanh_fwd(
                     u, route="arithmetic"),
                 "library": lambda: F.gelu(u, approximate="tanh")}
        check(differing(calls["shipped"](), ref) == 0,
              f"the table route differs from the arithmetic at {cell}")
        for name in VARIANTS:
            if name.startswith("gelu_"):
                fn = gelu_variant(libs[name])
                calls[name] = (lambda fn=fn: fn(u))
        print(json.dumps({"kernel": "gelu_tanh forward", "cell": cell,
                          "shape": [rows, m], "device_ms": in_turns(calls),
                          **norm_bound(2 * rows * m * u.element_size(), 0),
                          "card": smi}), flush=True)
        del u, ref, calls
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
