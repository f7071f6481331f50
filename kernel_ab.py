#!/usr/bin/env python3
"""Time the attention forwards of several kernel source trees in one
process on one card, in turns, at the main paths' shapes.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is a ``csrc`` directory: this checkout's is
``arsvt_tpu_torch/csrc``; another commit's comes from ``git archive <rev>
arsvt_tpu_torch/csrc`` unpacked under a git-ignored directory (``build/``).
From each tree, kernel #1 (``encoder_attention_fwd.cu``) and kernel #3
(``flash_attention_fwd.cu``) are built with this checkout's nvcc flags into
``build/kernel_ab/<n>/`` (one nvcc each, all started together) and bound in
turn to this checkout's wrappers, whose C interfaces every tree shares.
Each tree's output is held once against the plain version, at the limits of
``chip_smoke.py`` phase 3. Then, per shape, the trees are timed in turns
(1..n, then n..1), each turn giving ``ms`` over launches issued back to back
(at B=1 the host's pace) and ``device_ms`` over launches queued behind a
spin kernel (the card's own time). Prints the card's name and power limit,
one JSON line per tree, shape and turn, and one summary line per shape: each
tree's mean over its turns and SDPA's time on the same inputs.

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

from arsvt_tpu_torch.ops import build, encoder_attention, flash_attention
from chip_smoke import (
    DROPOUT_RATE,
    DROPOUT_SEED,
    FLASH_PATH_SHAPES,
    TOL_BF16,
    TOL_LSE,
    attention_bound,
    check,
    cuda_ms,
    device_ms,
    flash_bound,
    library_attention,
    max_err,
    ptxas_report,
    seeded_heads,
    seeded_qkv,
)

KERNELS = {"encoder_attention_fwd": encoder_attention,
           "flash_attention_fwd": flash_attention}
AB_DIR = build.BUILD_DIR.parent / "kernel_ab"


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
            procs.append((tree / f"{name}.cu", subprocess.Popen(
                build.nvcc_command(tree / f"{name}.cu", out, nvcc),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for i, (src, proc) in enumerate(procs):
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on {src}:\n{log}")
        for row in ptxas_report({src.stem: {"log": log}}):
            print(json.dumps({"tree": i // len(KERNELS), "ptxas": row}),
                  flush=True)
    return libs


def bind(lib_paths: dict) -> None:
    """Point each wrapper at this tree's library: the wrapper's own loader
    sets the C signature."""
    real = build.load
    build.load = lambda name: ctypes.CDLL(str(lib_paths[name]))
    try:
        for module in KERNELS.values():
            module._fn = None
            module._kernel()
    finally:
        build.load = real


def library_dropout(qkv, rate: float):
    """SDPA on #1's packed input, with dropout where rate > 0."""
    if rate == 0.0:
        return library_attention(qkv, 12)
    b, s, _ = qkv.shape
    q, k, v = qkv.view(b, s, 3, 12, 64).permute(2, 0, 3, 1, 4).unbind(0)
    return F.scaled_dot_product_attention(q, k, v, dropout_p=rate)


def shapes() -> list[dict]:
    """The timed calls: #1 at the ViT-B/16 microbatch shapes (and with
    dropout at B=32), #3 at the detector paths' shapes."""
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


def hold(case: dict) -> None:
    """The bound tree's output against the plain version."""
    (out, lse), (ref, ref_lse) = case["call"](), case["plain"]()
    torch.cuda.synchronize()
    ok = bool(((out.float() - ref.float()).abs()
               <= TOL_BF16 + TOL_BF16 * ref.float().abs()).all())
    check(ok and max_err(lse, ref_lse) <= TOL_LSE,
          f"{case['kernel']} {case['shape']} disagrees with its plain "
          f"version: {max_err(out, ref)}")


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
                   "device_ms": device_ms(case["call"], iters=100)}
            times[i].append(rec)
            print(json.dumps({"ab": case["kernel"], **case["shape"],
                              "tree": i, "turn": turn, **rec}), flush=True)
        bound_ms, bound_by, _, _ = case["bound"]
        summary = {"ab_summary": case["kernel"], **case["shape"],
                   "library_ms": cuda_ms(case["library"], iters=100),
                   "library_device_ms": device_ms(case["library"],
                                                  iters=100),
                   "bound_ms": bound_ms, "bound_by": bound_by}
        for i, recs in times.items():
            for key in ("ms", "device_ms"):
                summary[f"tree{i}_{key}"] = sum(r[key] for r in recs) / len(
                    recs)
        print(json.dumps(summary), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
