"""One-pass AdamW over every fp32 parameter leaf (counterpart of
``arsvt_tpu/ops/pallas/fused_adamw.py``: ``_adamw_leaf_pallas`` →
``_adamw_kernel``).

`fused_adamw` updates (p, m, v) in place. On CUDA tensors it launches the
hand-written kernel in ``csrc/fused_adamw.cu`` once for all leaves, with
the scalars [gscale, bc1, bc2, step] read from a device tensor; on CPU
tensors it runs `adamw_plain` per leaf. There is no fallback from one to
the other. The JAX package's size and lane rule for which leaves take its
kernel (``fused_adamw.py:113-118``) only routed launches on the TPU and
changes no number; here every leaf takes the one launch.
"""

from __future__ import annotations

import ctypes

import torch

from arsvt_tpu_torch.ops import build

# Kernel launches in this process (one per `fused_adamw` call on CUDA).
LAUNCHES = 0

_fn = None
_elems_per_block = None


def adamw_plain(scalars, g, m, v, p, *, b1: float, b2: float, eps: float,
                wd: float):
    """The kernel's math (``fused_adamw.py:101-110``) on one leaf, each
    operation rounded to fp32 in the kernel's order. Returns (p', m', v')."""
    gscale, bc1, bc2, step = (scalars[i] for i in range(4))
    g = g * gscale
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if wd:
        upd = upd + wd * p
    return p - step * upd, m, v


def adamw_plain_update(scalars, grads, ms, vs, ps, decayed, *, b1: float,
                       b2: float, eps: float, wd: float) -> None:
    """`adamw_plain` over every leaf, written back into (p, m, v) in place;
    `wd` applies to the leaves whose `decayed` flag is true."""
    with torch.no_grad():
        for g, m, v, p, d in zip(grads, ms, vs, ps, decayed):
            new = adamw_plain(scalars, g, m, v, p, b1=b1, b2=b2, eps=eps,
                              wd=wd if d else 0.0)
            for dst, src in zip((p, m, v), new):
                dst.copy_(src)


def _kernel():
    global _fn, _elems_per_block
    if _fn is None:
        lib = build.load("fused_adamw")
        fn = lib.arsvt_fused_adamw
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p] + [ctypes.c_float] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.arsvt_fused_adamw_elems_per_block.restype = ctypes.c_int
        _elems_per_block = lib.arsvt_fused_adamw_elems_per_block()
        _fn = fn
    return _fn


def _leaf_table(grads, ms, vs, ps, decayed, device):
    """Device table of one row per leaf: g, m, v, p pointers, numel, first
    block, decayed, 0 (the layout of ``csrc/fused_adamw.cu``'s Leaf).

    The copy is asynchronous on the current stream, so the step does not
    wait for the card; PyTorch's pinned-memory allocator keeps the host
    buffer until the copy has run."""
    rows, first = [], 0
    for g, m, v, p, d in zip(grads, ms, vs, ps, decayed):
        n = p.numel()
        rows.append([g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(),
                     n, first, int(d), 0])
        first += -(-n // _elems_per_block)
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True), first


def fused_adamw(scalars, grads, ms, vs, ps, decayed, *, b1: float,
                b2: float, eps: float, wd: float) -> None:
    """Update every leaf's (p, m, v) in place.

    scalars: fp32[4] = [gscale, bc1, bc2, step] on the leaves' device;
    grads, ms, vs, ps: lists of fp32 tensors, leaf by leaf of one shape
    each; decayed: per-leaf bools (weight decay `wd` applies where true).
    """
    global LAUNCHES
    leaves = list(zip(grads, ms, vs, ps))
    if not leaves or len(decayed) != len(leaves):
        raise ValueError("fused_adamw needs one decayed flag per leaf and at "
                         "least one leaf")
    device = ps[0].device
    for leaf in leaves:
        shape = leaf[3].shape
        for t in leaf:
            if t.dtype != torch.float32 or t.shape != shape:
                raise ValueError("fused_adamw takes fp32 (g, m, v, p) of one "
                                 f"shape per leaf, got {t.dtype} "
                                 f"{tuple(t.shape)} against {tuple(shape)}")
            if t.device != device:
                raise ValueError("fused_adamw needs every tensor on one "
                                 "device")
    if scalars.shape != (4,) or scalars.dtype != torch.float32 or \
            scalars.device != device:
        raise ValueError("scalars must be fp32[4] on the leaves' device")
    if device.type == "cpu":
        adamw_plain_update(scalars, grads, ms, vs, ps, decayed, b1=b1, b2=b2,
                           eps=eps, wd=wd)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adamw runs on cpu or cuda, got {device}")
    for leaf in leaves:
        for t in leaf:
            if not t.is_contiguous():
                raise ValueError("fused_adamw needs contiguous tensors")
    fn = _kernel()
    with torch.cuda.device(device):
        table, blocks = _leaf_table(grads, ms, vs, ps, decayed, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(table.data_ptr(), len(leaves), blocks, scalars.data_ptr(),
                 b1, b2, eps, wd, 1.0 - b1, 1.0 - b2, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_adamw kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
