#!/usr/bin/env python3
"""Time the attention, fused-MLP and AdamW kernels of several kernel source
trees in one process on one card, in turns, at the main paths' shapes.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is a ``csrc`` directory: this checkout's is
``arsvt_tpu_torch/csrc``; another commit's comes from ``git archive <rev>
arsvt_tpu_torch/csrc`` unpacked under a git-ignored directory (``build/``).
From each tree, kernel #1 (``encoder_attention_fwd.cu``), #2
(``encoder_attention_bwd.cu``), #3 (``flash_attention_fwd.cu``), #4
(``flash_attention_bwd.cu``), #5 (``encoder_attention_savep_fwd.cu``), #6
(``encoder_attention_savep_bwd.cu``), #7 (``fused_adamw.cu``), #8
(``fused_mlp_fwd.cu``) and #9 (``fused_mlp_bwd.cu``) are built with this
checkout's nvcc flags into ``build/kernel_ab/<n>/`` (one nvcc each, all
started together, without GNU-unique symbols: see ``AB_FLAGS``) and bound
in turn to this checkout's wrappers, each tree through the C interface it
exports (#8's forward takes an h scratch since interface 2, which
``arsvt_fused_mlp_version`` names; a tree without that symbol is called
without it; #7 takes a chunk table and the leaves' pointers since its
interface 2, ``arsvt_fused_adamw_version``, and a tree without it gets the
table of one row per leaf that its own wrapper built, see
`legacy_adamw`). Each tree's outputs are held once against the plain
version, at the limits of ``chip_smoke.py`` phase 3 (#1/#3: O and lse;
#2/#4/#6: dq, dk and dv; #5: O and P; #7: p, m and v on every leaf; #8:
out and u; #9: dx, dw1, db1 and dw2). Then, per shape, the trees are timed
in turns (1..n, then n..1), each turn giving ``ms`` over launches issued
back to back (at B=1 the host's pace), ``device_ms`` over launches queued
behind a spin kernel (the card's own time) and ``host_us``, the host's
time a call on an idle card (`chip_smoke.host_us`). Shapes: #1 at
ViT-B/16's B = 1, 8 and 32 (and dropout 0.1 at B = 32); #2 at the same and
at ViT-L/16@384's S = 577 (B = 2, D = 1,024, H = 16); #3 at the detector
paths' shapes; #4 at the DeiT-400 encoder's training shape (B = 32) with
dropout 0 and 0.1, the DETR cross-attention's and d = 96; #5 and #6 at B =
8 and 32 with dropout 0 and 0.1, and #5 at ViT-L's S = 577 (B = 2, D =
1,024, H = 16); #8 and #9 in bf16 at ViT-B's bench_train microbatch (n =
6,304, D = 768, M = 3,072), ViT-L's (9,232, 1,024, 4,096), DeiT-400's
three images (594, 400, 1,600) and one ViT-B image (197, 768, 3,072: the
host's cost a call, from ``ms`` against ``device_ms``); #7 over ViT-B/16's
leaf set (85.8 M fp32 parameters), held 4 ms a call. Prints the card's
name and power limit, each tree's ``-Xptxas=-v`` rows, one JSON line per
tree, shape and turn, and one summary line per shape: each tree's mean
over its turns and the library's time on the same inputs (SDPA; for #2,
#4 and #6, SDPA's forward and backward less its forward; for #8 the
cuBLAS MLP, for #9 its backward, i.e. forward and backward less forward;
for #7 ``torch.optim.AdamW(fused=True).step`` on the same leaves).

Run from the root of a checkout on a machine with the card and the CUDA
toolkit; it imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from arsvt_tpu_torch.core.dtypes import tree_leaves
from arsvt_tpu_torch.models.classifier import init_image_classifier
from arsvt_tpu_torch.models.registry import PRESETS
from arsvt_tpu_torch.ops import (
    build,
    encoder_attention,
    flash_attention,
    fused_adamw,
    fused_mlp,
)
from arsvt_tpu_torch.train.optim import _wd_mask
from chip_smoke import (
    ADAMW_HOLD_CYCLES,
    DROPOUT_RATE,
    DROPOUT_SEED,
    FLASH_PATH_SHAPES,
    FLASH_TRAIN_SHAPES,
    HBM_BYTES_PER_S,
    HOLD_CYCLES_PER_CALL,
    TOL_ADAMW,
    TOL_BF16,
    TOL_BF16_ULP,
    TOL_BWD_BF16,
    TOL_LSE,
    TOL_U_ABS,
    adamw_leaves,
    attention_bound,
    bwd_bound,
    check,
    cuda_ms,
    device_ms,
    flash_bound,
    flash_bwd_bound,
    flash_limit,
    host_us,
    library_attention,
    library_mlp,
    max_err,
    mlp_bound,
    mlp_limit,
    ptxas_report,
    savep_bound,
    seeded_heads,
    seeded_mlp,
    seeded_qkv,
)

# source name: (wrapper module, its cached C function, the loader that
# sets the C function's signature)
KERNELS = {
    "encoder_attention_fwd": (encoder_attention, "_fn", "_kernel"),
    "encoder_attention_bwd": (encoder_attention, "_bwd_fn", "_bwd_kernel"),
    "flash_attention_fwd": (flash_attention, "_fn", "_kernel"),
    "flash_attention_bwd": (flash_attention, "_bwd_fn", "_bwd_kernel"),
    "encoder_attention_savep_fwd": (encoder_attention, "_savep_fn",
                                    "_savep_kernel"),
    "encoder_attention_savep_bwd": (encoder_attention, "_savep_bwd_fn",
                                    "_savep_bwd_kernel"),
    "fused_mlp_fwd": (fused_mlp, "_fwd_fn", "_fwd_kernel"),
    "fused_mlp_bwd": (fused_mlp, "_bwd_fn", "_bwd_kernel"),
    "fused_adamw": (fused_adamw, "_fn", "_kernel"),
}
# (atol, rtol) per output, |kernel - plain| <= atol + rtol * |plain|
LIMITS = {"encoder_attention_fwd": ((TOL_BF16, TOL_BF16), (TOL_LSE, 0.0)),
          "flash_attention_fwd": ((TOL_BF16, TOL_BF16), (TOL_LSE, 0.0)),
          "encoder_attention_savep_fwd": ((TOL_BF16, TOL_BF16),
                                          (1e-6, TOL_BF16_ULP)),
          "encoder_attention_bwd": ((TOL_BWD_BF16, TOL_BWD_BF16),) * 3,
          "encoder_attention_savep_bwd": ((TOL_BWD_BF16, TOL_BWD_BF16),) * 3}
AB_DIR = build.BUILD_DIR.parent / "kernel_ab"


# Each tree's libraries are loaded into one process beside the others'.
# GCC gives a function-local static of an inline or template function
# (the fused MLP's launcher keeps whether it set its kernel's shared
# memory in one) a GNU-unique symbol, which the dynamic loader binds to
# the first library that defines it, whatever the load mode: a second
# tree's launcher would then skip its own set-up. The A/B builds make
# them ordinary local copies.
AB_FLAGS = ("-Xcompiler=-fno-gnu-unique",)


def build_trees(trees: list[Path]) -> list[dict]:
    """{kernel name: library path} per tree, all compiled at once."""
    nvcc = build.find_nvcc()
    libs, procs = [], []
    for i, tree in enumerate(trees):
        out_dir = AB_DIR / str(i)
        out_dir.mkdir(parents=True, exist_ok=True)
        libs.append({})
        for name in KERNELS:
            out = out_dir / f"lib{name}.so"
            libs[-1][name] = out
            cmd = build.nvcc_command(tree / f"{name}.cu", out, nvcc)
            procs.append((tree / f"{name}.cu", subprocess.Popen(
                [cmd[0], *AB_FLAGS, *cmd[1:]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for i, (src, proc) in enumerate(procs):
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on {src}:\n{log}")
        for row in ptxas_report({src.stem: {"log": log}}):
            print(json.dumps({"tree": i // len(KERNELS), "ptxas": row}),
                  flush=True)
    return libs


def fwd_without_scratch(lib: ctypes.CDLL):
    """#8's C entry of a tree from before interface 2 (no h scratch),
    behind the wrapper's current argument list."""
    fn = lib.arsvt_fused_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, w1, b1, w2, b2, out, u, h, *rest):
        return fn(x, w1, b1, w2, b2, out, u, *rest)

    return call


def legacy_adamw(lib: ctypes.CDLL):
    """#7 of a tree from before interface 2 (no chunk table), called as its
    own wrapper called it, checks included (so that ``host_us`` compares
    wrappers): a table of one 64-byte row per leaf (g, m, v, p, numel,
    first block, decayed, 0), built from a Python list and copied through a
    fresh pinned tensor every call, and one block per
    ``arsvt_fused_adamw_elems_per_block`` elements of every leaf."""
    fn = lib.arsvt_fused_adamw
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p] + [ctypes.c_float] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.arsvt_fused_adamw_elems_per_block.restype = ctypes.c_int
    per_block = lib.arsvt_fused_adamw_elems_per_block()

    def call(scalars, grads, ms, vs, ps, decayed, *, b1, b2, eps, wd):
        leaves = list(zip(grads, ms, vs, ps))
        device = ps[0].device
        for leaf in leaves:
            shape = leaf[3].shape
            for t in leaf:
                check(t.dtype == torch.float32 and t.shape == shape
                      and t.device == device, "fused_adamw leaf")
        check(scalars.shape == (4,) and scalars.dtype == torch.float32
              and scalars.device == device, "fused_adamw scalars")
        for leaf in leaves:
            for t in leaf:
                check(t.is_contiguous(), "fused_adamw contiguity")
        rows, first = [], 0
        for g, m, v, p, d in zip(grads, ms, vs, ps, decayed):
            rows.append([g.data_ptr(), m.data_ptr(), v.data_ptr(),
                         p.data_ptr(), p.numel(), first, int(d), 0])
            first += -(-p.numel() // per_block)
        table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
            ps[0].device, non_blocking=True)
        err = fn(table.data_ptr(), len(rows), first, scalars.data_ptr(), b1,
                 b2, eps, wd, 1.0 - b1, 1.0 - b2,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"fused_adamw launch failed: CUDA error {err}")

    return call


# The #7 entry of the bound tree: the wrapper, or `legacy_adamw`'s caller.
ADAMW = {"call": fused_adamw.fused_adamw}


def without_offsets(lib: ctypes.CDLL, name: str, new):
    """Attention entry `name` of a tree before interface 2
    (``arsvt_attention_version``), called with interface 2's arguments:
    the three mask offsets that come before the dtype and the stream are
    dropped. Such a tree draws the one-process mask, which is what the
    offsets (0, heads, 0) of these calls ask for."""
    fn = getattr(lib, f"arsvt_{name}")
    fn.argtypes = new.argtypes[:-5] + new.argtypes[-2:]
    fn.restype = ctypes.c_int

    def call(*args):
        return fn(*args[:-5], *args[-2:])

    return call


ATTENTION = ("encoder_attention_fwd", "encoder_attention_bwd",
             "flash_attention_fwd", "flash_attention_bwd",
             "encoder_attention_savep_fwd", "encoder_attention_savep_bwd")


def bind(lib_paths: dict) -> None:
    """Point each wrapper at this tree's library: the wrapper's own loader
    sets the C signature, or, for #8 and #7 of a tree that predates their
    interface 2 and the attention kernels of one before theirs, the
    adapters above."""
    real = build.load
    build.load = lambda name: ctypes.CDLL(str(lib_paths[name]))
    try:
        for name, (module, fn, loader) in KERNELS.items():
            setattr(module, fn, None)
            lib = build.load(name)
            if name == "fused_adamw" and not hasattr(
                    lib, "arsvt_fused_adamw_version"):
                ADAMW["call"] = legacy_adamw(lib)
                continue
            if name == "fused_adamw":
                ADAMW["call"] = fused_adamw.fused_adamw
            getattr(module, loader)()
            if name == "fused_mlp_fwd" and not hasattr(
                    lib, "arsvt_fused_mlp_version"):
                fused_mlp._fwd_fn = fwd_without_scratch(lib)
            if name in ATTENTION and not hasattr(
                    lib, "arsvt_attention_version"):
                setattr(module, fn, without_offsets(
                    lib, name, getattr(module, fn)))
    finally:
        build.load = real


def library_dropout(qkv, rate: float):
    """SDPA on #1's packed input, with dropout where rate > 0."""
    if rate == 0.0:
        return library_attention(qkv, 12)
    b, s, _ = qkv.shape
    q, k, v = qkv.view(b, s, 3, 12, 64).permute(2, 0, 3, 1, 4).unbind(0)
    return F.scaled_dot_product_attention(q, k, v, dropout_p=rate)


def library_packed_bwd(qkv, dout, rate: float, num_heads: int = 12):
    """SDPA's forward and backward on #2's or #6's inputs, and its forward
    alone: the backward's yardstick is their difference."""
    b, s, three_d = qkv.shape
    q, k, v = (t.contiguous().requires_grad_(True) for t in qkv.view(
        b, s, 3, num_heads, 64).permute(2, 0, 3, 1, 4).unbind(0))
    g = dout.view(b, s, num_heads, 64).transpose(1, 2)
    return library_heads_bwd(q, k, v, g, rate)


def library_heads_bwd(q, k, v, g, rate: float):
    """SDPA's forward and backward on head-major (B, H, S, d) operands, and
    its forward alone."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, dropout_p=rate)

    return (lambda: torch.autograd.grad(fwd(), (q, k, v), g)), fwd


def savep_shapes() -> list[dict]:
    """#5 and #6 at the opt-in route's microbatches (B = 8 and 32 of
    ViT-B/16) with dropout 0 and 0.1, and #5 at ViT-L/16@384's S = 577."""
    ea, out = encoder_attention, []
    for b in (8, 32):
        qkv = seeded_qkv(b, 197, 768, torch.bfloat16, seed=14)
        gen = torch.Generator().manual_seed(15)
        dout = torch.randn(b, 197, 768, generator=gen).to(
            torch.bfloat16).cuda()
        for rate in (0.0, DROPOUT_RATE):
            kw = dict(dropout_rate=rate, seed=DROPOUT_SEED)
            _, probs = ea.encoder_attention_fwd_savep_plain(
                qkv, 12, rate, DROPOUT_SEED)
            shape = {"B": b, "S": 197, "D": 768, "H": 12,
                     "dropout_rate": rate}
            out.append({
                "kernel": "encoder_attention_savep_fwd", "shape": shape,
                "call": lambda qkv=qkv, kw=kw:
                    ea.encoder_attention_fwd_savep(qkv, 12, **kw),
                "plain": lambda qkv=qkv, rate=rate:
                    ea.encoder_attention_fwd_savep_plain(
                        qkv, 12, rate, DROPOUT_SEED),
                "library": lambda qkv=qkv, rate=rate:
                    library_dropout(qkv, rate),
                "bound": savep_bound(b, 197, 768, 12, False)})
            lib, lib_fwd = library_packed_bwd(qkv, dout, rate)
            out.append({
                "kernel": "encoder_attention_savep_bwd", "shape": shape,
                "call": lambda qkv=qkv, p=probs, do=dout, kw=kw:
                    ea.encoder_attention_bwd_savep(qkv, p, do, 12, **kw),
                "plain": lambda qkv=qkv, p=probs, do=dout, rate=rate:
                    ea.encoder_attention_bwd_savep_plain(
                        qkv, p, do, 12, rate, DROPOUT_SEED),
                "library": lib, "library_fwd": lib_fwd,
                "bound": savep_bound(b, 197, 768, 12, True)})
    qkv = seeded_qkv(2, 577, 1024, torch.bfloat16, seed=16)
    out.append({
        "kernel": "encoder_attention_savep_fwd",
        "shape": {"B": 2, "S": 577, "D": 1024, "H": 16, "dropout_rate": 0.0},
        "call": lambda: ea.encoder_attention_fwd_savep(qkv, 16),
        "plain": lambda: ea.encoder_attention_fwd_savep_plain(qkv, 16),
        "library": lambda: library_attention(qkv, 16),
        "bound": savep_bound(2, 577, 1024, 16, False)})
    return out


def bwd_shapes() -> list[dict]:
    """#2 at the ViT-B/16 microbatch shapes (dropout 0.1 as well at B =
    32) and at ViT-L/16@384's S = 577; #4 at the DeiT-400 encoder's
    training shape with dropout 0 and 0.1, the DETR cross-attention's and
    d = 96. O and lse come from the plain forwards."""
    ea, fa, out = encoder_attention, flash_attention, []
    for b, s, d, h, rate in ((1, 197, 768, 12, 0.0), (8, 197, 768, 12, 0.0),
                             (32, 197, 768, 12, 0.0),
                             (32, 197, 768, 12, DROPOUT_RATE),
                             (2, 577, 1024, 16, 0.0)):
        qkv = seeded_qkv(b, s, d, torch.bfloat16, seed=18)
        gen = torch.Generator().manual_seed(19)
        dout = torch.randn(b, s, d, generator=gen).to(torch.bfloat16).cuda()
        o, lse = ea.encoder_attention_fwd_plain(qkv, h, rate, DROPOUT_SEED)
        kw = dict(dropout_rate=rate, seed=DROPOUT_SEED)
        lib, lib_fwd = library_packed_bwd(qkv, dout, rate, h)
        out.append({
            "kernel": "encoder_attention_bwd",
            "shape": {"B": b, "S": s, "D": d, "H": h, "dropout_rate": rate},
            "call": lambda qkv=qkv, o=o, do=dout, lse=lse, h=h, kw=kw:
                ea.encoder_attention_bwd(qkv, o, do, lse, h, **kw),
            "plain": lambda qkv=qkv, o=o, do=dout, lse=lse, h=h, rate=rate:
                ea.encoder_attention_bwd_plain(qkv, o, do, lse, h, rate,
                                               DROPOUT_SEED),
            "library": lib, "library_fwd": lib_fwd,
            "bound": bwd_bound(b, s, d, h)})
    enc, cross = FLASH_TRAIN_SHAPES["deit_encoder_B32"], \
        FLASH_TRAIN_SHAPES["deit_cross_B32"]
    for name, (b, h, sq, sk, d), rate in (
            ("deit_encoder_B32", enc, 0.0),
            ("deit_encoder_B32", enc, DROPOUT_RATE),
            ("deit_cross_B32", cross, 0.0),
            ("d96_B8", (8, 8, 198, 198, 96), 0.0)):
        q, k, v = seeded_heads(b, h, sq, sk, d, torch.bfloat16, seed=20)
        gen = torch.Generator().manual_seed(21)
        do = torch.randn(b, h, sq, d, generator=gen).to(torch.bfloat16).cuda()
        o, lse = fa.flash_attention_fwd_plain(q, k, v, sk, rate, DROPOUT_SEED)
        kw = dict(dropout_rate=rate, seed=DROPOUT_SEED)
        lib, lib_fwd = library_heads_bwd(q, k, v, do, rate)
        out.append({
            "kernel": "flash_attention_bwd",
            "shape": {"of": name, "B": b, "H": h, "Sq": sq, "Sk": sk, "d": d,
                      "dropout_rate": rate},
            "call": lambda q=q, k=k, v=v, o=o, do=do, lse=lse, kw=kw:
                fa.flash_attention_bwd(q, k, v, o, do, lse, **kw),
            "plain": lambda q=q, k=k, v=v, o=o, do=do, lse=lse, sk=sk,
                rate=rate: fa.flash_attention_bwd_plain(
                    q, k, v, o, do, lse, sk, rate, DROPOUT_SEED),
            "library": lib, "library_fwd": lib_fwd,
            "bound": flash_bwd_bound(b, h, sq, sk, d)})
    return out


def fwd_shapes() -> list[dict]:
    """#1 at the ViT-B/16 microbatch shapes (and with dropout at B=32), #3
    at the detector paths' shapes."""
    out = []
    for b in (1, 8, 32):
        for rate in ((0.0, DROPOUT_RATE) if b == 32 else (0.0,)):
            qkv = seeded_qkv(b, 197, 768, torch.bfloat16, seed=7)
            kw = dict(dropout_rate=rate, seed=DROPOUT_SEED)
            out.append({
                "kernel": "encoder_attention_fwd",
                "shape": {"B": b, "S": 197, "D": 768, "H": 12,
                          "dropout_rate": rate},
                "call": lambda qkv=qkv, kw=kw:
                    encoder_attention.encoder_attention_fwd(qkv, 12, **kw),
                "plain": lambda qkv=qkv, rate=rate:
                    encoder_attention.encoder_attention_fwd_plain(
                        qkv, 12, rate, DROPOUT_SEED),
                "library": lambda qkv=qkv, rate=rate:
                    library_dropout(qkv, rate),
                "bound": attention_bound(b, 197, 768, 12)})
    for name, (h, sq, sk, d) in FLASH_PATH_SHAPES.items():
        for b in (1, 8, 32):
            q, k, v = seeded_heads(b, h, sq, sk, d, torch.bfloat16, seed=8)
            out.append({
                "kernel": "flash_attention_fwd",
                "shape": {"of": name, "B": b, "H": h, "Sq": sq, "Sk": sk,
                          "d": d},
                "call": lambda q=q, k=k, v=v:
                    flash_attention.flash_attention_fwd(q, k, v),
                "plain": lambda q=q, k=k, v=v, sk=sk:
                    flash_attention.flash_attention_fwd_plain(q, k, v, sk),
                "library": lambda q=q, k=k, v=v:
                    F.scaled_dot_product_attention(q, k, v),
                "bound": flash_bound(b, h, sq, sk, d)})
    return out


def shapes() -> list[dict]:
    """The timed calls: #1 and #3, then #2 and #4, #5 and #6, #8 and #9,
    then #7."""
    return fwd_shapes() + bwd_shapes() + savep_shapes() + mlp_shapes() + \
        adamw_shapes()


def adamw_shapes() -> list[dict]:
    """#7 over ViT-B/16's leaf set (seeded g, m, v, p, the weight-decay
    mask of the tree), chip_smoke.py phase 3's scalars and hyperparameters;
    the library is the fused torch.optim.AdamW step on copies of the same
    leaves."""
    tree = init_image_classifier(PRESETS["vit_base_16_224"], 6, seed=0)
    leaves = adamw_leaves(tree, torch.Generator().manual_seed(11))
    decayed = tree_leaves(_wd_mask(tree))
    scalars = torch.tensor([0.5, 0.1, 0.001, 1e-3], device="cuda")
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.05)
    grads, ms, vs, ps = (list(t) for t in zip(*leaves))
    params = [p.clone().requires_grad_(True) for p in ps]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=0.05, fused=True)
    n = sum(p.numel() for p in ps)
    nbytes = 28 * n
    return [{
        "kernel": "fused_adamw",
        "shape": {"params": n, "leaves": len(ps)},
        "call": lambda: ADAMW["call"](scalars, grads, ms, vs, ps, decayed,
                                      **hyper),
        "adamw": (scalars, leaves, decayed, hyper),
        "library": opt.step, "hold_cycles": ADAMW_HOLD_CYCLES,
        "bound": (nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes, 0)}]


def hold_adamw(case: dict) -> None:
    """One call on copies of the leaves against `adamw_plain` on every
    leaf: p, m and v within TOL_ADAMW."""
    scalars, leaves, decayed, hyper = case["adamw"]
    work = [tuple(t.clone() for t in leaf) for leaf in leaves]
    ADAMW["call"](scalars, *(list(t) for t in zip(*work)), decayed, **hyper)
    torch.cuda.synchronize()
    for (g, m, v, p), (_, m2, v2, p2), d in zip(leaves, work, decayed):
        ref = fused_adamw.adamw_plain(
            scalars, g, m, v, p, **{**hyper, "wd": hyper["wd"] if d else 0.0})
        err = max(max_err(x, r) for x, r in zip((p2, m2, v2), ref))
        check(err <= TOL_ADAMW, f"fused_adamw disagrees with its plain "
                                f"version: {err}")


def library_mlp_bwd(x, w1, b1, w2, b2, dout):
    """The cuBLAS MLP's forward and backward on #9's inputs, and its
    forward alone: the backward's yardstick is their difference."""
    args = [t.detach().clone().requires_grad_(True)
            for t in (x, w1, b1, w2, b2)]

    def fwd():
        return library_mlp(*args)

    return (lambda: torch.autograd.grad(fwd(), args, dout)), fwd


def mlp_shapes() -> list[dict]:
    """#8 and #9 in bf16 at ViT-B's bench_train microbatch, ViT-L's,
    DeiT-400's three images and one ViT-B image."""
    out = []
    for n, d, m in ((6304, 768, 3072), (9232, 1024, 4096), (594, 400, 1600),
                    (197, 768, 3072)):
        x, w1, b1, w2, b2 = seeded_mlp(n, d, m, torch.bfloat16, seed=16)
        gen = torch.Generator().manual_seed(17)
        dout = torch.randn(n, d, generator=gen).to(torch.bfloat16).cuda()
        _, u = fused_mlp.fused_mlp_fwd_plain(x, w1, b1, w2, b2)
        shape = {"n": n, "D": d, "M": m, "dtype": "bfloat16"}
        out.append({
            "kernel": "fused_mlp_fwd", "shape": shape,
            "call": lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2:
                fused_mlp.fused_mlp_fwd(x, w1, b1, w2, b2),
            "plain": lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2:
                fused_mlp.fused_mlp_fwd_plain(x, w1, b1, w2, b2),
            "library": lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2:
                library_mlp(x, w1, b1, w2, b2),
            "bound": mlp_bound(n, d, m, False)})
        lib, lib_fwd = library_mlp_bwd(x, w1, b1, w2, b2, dout)
        out.append({
            "kernel": "fused_mlp_bwd", "shape": shape,
            "call": lambda x=x, u=u, w1=w1, w2=w2, do=dout:
                fused_mlp.fused_mlp_bwd(x, u, w1, w2, do),
            "plain": lambda x=x, u=u, w1=w1, w2=w2, do=dout:
                fused_mlp.fused_mlp_bwd_plain(x, u, w1, w2, do),
            "library": lib, "library_fwd": lib_fwd,
            "bound": mlp_bound(n, d, m, True)})
    return out


def hold_mlp(case: dict, got, ref) -> None:
    """#8 and #9 at phase 3's limits: each output within a share of the
    plain result's largest magnitude; u per element to one bf16 ulp plus
    TOL_U_ABS."""
    for i, (x, r) in enumerate(zip(got, ref)):
        ok = x.shape == r.shape and max_err(x, r) <= mlp_limit(
            r, torch.bfloat16)
        if case["kernel"] == "fused_mlp_fwd" and i == 1:
            ok = ok and float(((x.float() - r.float()).abs() - TOL_BF16_ULP
                               * r.float().abs()).max()) <= TOL_U_ABS
        check(ok, f"{case['kernel']} {case['shape']} output {i} disagrees "
                  f"with its plain version: {max_err(x, r)}")


def hold(case: dict) -> None:
    """The bound tree's outputs against the plain version's, each at its
    limit."""
    if case["kernel"] == "fused_adamw":
        hold_adamw(case)
        return
    got, ref = case["call"](), case["plain"]()
    torch.cuda.synchronize()
    if case["kernel"] in ("fused_mlp_fwd", "fused_mlp_bwd"):
        hold_mlp(case, got, ref)
        return
    if case["kernel"] == "flash_attention_bwd":  # phase 3's flash_limit
        for i, (x, r) in enumerate(zip(got, ref)):
            check(x.shape == r.shape and max_err(x, r) <= flash_limit(
                r, torch.bfloat16), f"{case['kernel']} {case['shape']} "
                f"output {i} disagrees with its plain version: "
                f"{max_err(x, r)}")
        return
    for i, (x, r, (atol, rtol)) in enumerate(
            zip(got, ref, LIMITS[case["kernel"]])):
        ok = x.shape == r.shape and bool(
            ((x.float() - r.float()).abs()
             <= atol + rtol * r.float().abs()).all())
        check(ok, f"{case['kernel']} {case['shape']} output {i} disagrees "
                  f"with its plain version: {max_err(x, r)}")


# SDPA's backward goes through autograd, whose host time a call exceeds
# the kernels' hold: its calls are held four times as long
LIBRARY_HOLD_CYCLES = 4 * HOLD_CYCLES_PER_CALL


def library_times(case: dict) -> dict:
    """The library's host-paced and held-device time on the case's inputs
    (less its forward's, where the case names one). The held-device time is
    None where the host cannot enqueue the library's calls within the
    hold."""
    hold = case.get("hold_cycles", LIBRARY_HOLD_CYCLES)

    def held(fn):
        try:
            return device_ms(fn, iters=100, hold_cycles=hold)
        except RuntimeError:
            return None

    ms, dev = cuda_ms(case["library"], iters=100), held(case["library"])
    if "library_fwd" in case:
        ms -= cuda_ms(case["library_fwd"], iters=100)
        fwd = held(case["library_fwd"])
        dev = None if dev is None or fwd is None else dev - fwd
    return {"library_ms": ms, "library_device_ms": dev}


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "trees": [str(t) for t in trees]}),
          flush=True)
    libs = build_trees(trees)
    cases = shapes()
    for lib in libs:
        bind(lib)
        for case in cases:
            hold(case)
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    for case in cases:
        times = {i: [] for i in range(len(trees))}
        for turn, i in enumerate(order):
            bind(libs[i])
            rec = {"ms": cuda_ms(case["call"], iters=100),
                   "device_ms": device_ms(case["call"], iters=100,
                                          hold_cycles=case.get(
                                              "hold_cycles",
                                              HOLD_CYCLES_PER_CALL)),
                   "host_us": host_us(case["call"], iters=20)}
            times[i].append(rec)
            print(json.dumps({"ab": case["kernel"], **case["shape"],
                              "tree": i, "turn": turn, **rec}), flush=True)
        bound_ms, bound_by, _, _ = case["bound"]
        summary = {"ab_summary": case["kernel"], **case["shape"],
                   **library_times(case),
                   "bound_ms": bound_ms, "bound_by": bound_by}
        for i, recs in times.items():
            for key in ("ms", "device_ms", "host_us"):
                summary[f"tree{i}_{key}"] = sum(r[key] for r in recs) / len(
                    recs)
        print(json.dumps(summary), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
