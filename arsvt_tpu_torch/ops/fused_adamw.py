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

The kernel walks a table of chunks that `plan_chunks` lays out on the
host (pure Python, so the CPU tests hold its layout): every leaf is cut
into chunks of `chunk_size` elements or fewer, none crossing a leaf, each
chunk's float4 interior on a 16-byte boundary, and the persistent grid
(`grid_size`) walks them with its stride, so the blocks at work stream
through one window of the leaves at a time, about CHUNKS_PER_BLOCK chunks
a block, so that the launch's last round is short. The table depends on
the leaves' sizes, their pointers' 16-byte phases, their weight-decay
flags and the chunk size alone: it is packed once (`pack_rows`), uploaded
once per device and kept. A call sends only the leaves' (g, m, v, p)
pointers, 32 bytes a leaf, from pageable memory, which CUDA stages before
the copy call returns, so no pinned buffer is allocated or waited for
while the card runs behind the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from arsvt_tpu_torch.ops import build

# Kernel launches in this process (one per `fused_adamw` call on CUDA).
LAUNCHES = 0

# Elements a block takes at least: the grid is no larger than the leaves'
# elements over this, so a small tree is not spread over idle blocks.
MIN_BLOCK_ELEMS = 4096
# Chunks a block walks, about: the tail of a launch is one chunk a block.
CHUNKS_PER_BLOCK = 32
# int64 words of a table row (``csrc/fused_adamw.cu``'s Chunk): the first
# element, then (leaf, n) and (head, flags) as int32 pairs; flags 1: the
# interior moves as float4, 2: weight decay applies.
ROW_WORDS = 3

_fn = None
_blocks_per_sm = None
_quantum = None
_tables_kept: dict = {}  # chunk tables on the card, by device and layout


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


def grid_size(n_elems: int, sms: int, blocks_per_sm: int) -> int:
    """The persistent grid: as many blocks as the SMs hold at once (the
    C entry's ``arsvt_fused_adamw_blocks_per_sm`` a SM), no more than give
    each block MIN_BLOCK_ELEMS elements."""
    return max(1, min(sms * max(1, blocks_per_sm),
                      -(-n_elems // MIN_BLOCK_ELEMS)))


def chunk_size(n_elems: int, blocks: int, quantum: int) -> int:
    """Elements a chunk at most: the multiple of `quantum` (the elements a
    block's threads move in one unrolled round, a multiple of 4, the C
    entry's ``arsvt_fused_adamw_chunk_quantum``) nearest to giving each of
    `blocks` CHUNKS_PER_BLOCK chunks, at least one round. A chunk that is
    not a whole number of rounds ends in rounds of one float4 a thread,
    too few loads in flight (10,160-element chunks took 1.01 ms on ViT-B's
    leaves on an H100, 8,192-element ones 0.86)."""
    rounds = round(n_elems / (blocks * CHUNKS_PER_BLOCK * quantum))
    return max(1, rounds) * quantum


def plan_chunks(numels, addresses, chunk: int):
    """The chunk table's layout: one (leaf, start, n, head, vec) per chunk.

    numels: elements per leaf; addresses: per leaf the byte addresses of
    its g, m, v and p (4-byte aligned fp32 data). A leaf whose four
    operands share their 16-byte phase is vectorised: its first chunk
    takes `head` scalar elements up to the first 16-byte boundary, and
    every later chunk starts at head + k * chunk, on a boundary; a leaf
    with mixed phases is scalar throughout (vec 0, head 0). Chunks never
    cross a leaf and cover each element once."""
    if chunk % 4 or chunk < 4:
        raise ValueError(f"chunk must be a positive multiple of 4, got "
                         f"{chunk}")
    rows = []
    for leaf, (n, addrs) in enumerate(zip(numels, addresses)):
        phases = {a % 16 for a in addrs}
        vec = len(phases) == 1
        head = min(n, (16 - phases.pop()) % 16 // 4) if vec else 0
        start = 0
        while start < n:
            stop = min(n, (head if start == 0 else start) + chunk)
            rows.append((leaf, start, stop - start,
                         head if start == 0 else 0, int(vec)))
            start = stop
    return rows


def pack_rows(rows, decayed) -> np.ndarray:
    """The chunk table of `plan_chunks` rows as ``csrc/fused_adamw.cu``'s
    Chunk reads it: (rows, ROW_WORDS) int64, word 0 the chunk's first
    element, words 1-2 (leaf, n) and (head, flags) as int32 (little-endian;
    flags 1 for a float4 interior, 2 where weight decay applies)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1, 5)
    table = np.zeros((len(rows), ROW_WORDS), dtype=np.int64)
    table[:, 0] = rows[:, 1]
    words = table[:, 1:3].view(np.int32)
    words[:, 0], words[:, 1], words[:, 2] = rows[:, 0], rows[:, 2], rows[:, 3]
    words[:, 3] = rows[:, 4] + 2 * np.asarray(decayed, dtype=np.int64)[
        rows[:, 0]]
    return table


def _chunks_on(device, numels, addresses: np.ndarray, decayed, chunk: int):
    """The chunk table for these leaves on `device`, planned, packed and
    uploaded the first time it is asked for, then kept."""
    key = (device, numels, (addresses % 16).tobytes(), decayed, chunk)
    table = _tables_kept.get(key)
    if table is None:
        rows = plan_chunks(numels, addresses.tolist(), chunk)
        table = torch.from_numpy(pack_rows(rows, decayed)).to(device)
        _tables_kept[key] = table
    return table


def _kernel():
    global _fn, _blocks_per_sm, _quantum
    if _fn is None:
        lib = build.load("fused_adamw")
        fn = lib.arsvt_fused_adamw
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p] + [
            ctypes.c_float] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.arsvt_fused_adamw_blocks_per_sm.restype = ctypes.c_int
        lib.arsvt_fused_adamw_chunk_quantum.restype = ctypes.c_int
        _blocks_per_sm = lib.arsvt_fused_adamw_blocks_per_sm()
        if _blocks_per_sm < 1:
            raise RuntimeError("fused_adamw: the occupancy query failed")
        _quantum = lib.arsvt_fused_adamw_chunk_quantum()
        _fn = fn
    return _fn


def _addresses(leaves) -> np.ndarray:
    """(leaves, 4) int64: the data pointers of each leaf's g, m, v, p;
    raises for a tensor that is not contiguous."""
    rows = []
    for leaf in leaves:
        rows.append([t.data_ptr() for t in leaf])
        if not all(t.is_contiguous() for t in leaf):
            raise ValueError("fused_adamw needs contiguous tensors")
    return np.array(rows, dtype=np.int64)


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
    numels = []  # one pass of cheap checks: an update is element by element
    for leaf in leaves:
        n = leaf[3].numel()
        for t in leaf:
            if t.dtype is not torch.float32 or t.numel() != n:
                raise ValueError(
                    "fused_adamw takes fp32 (g, m, v, p) of one size per "
                    f"leaf, got {t.dtype} {tuple(t.shape)} against "
                    f"{tuple(leaf[3].shape)}")
            if t.device != device:
                raise ValueError("fused_adamw needs every tensor on one "
                                 "device")
        numels.append(n)
    if scalars.shape != (4,) or scalars.dtype != torch.float32 or \
            scalars.device != device:
        raise ValueError("scalars must be fp32[4] on the leaves' device")
    if device.type == "cpu":
        adamw_plain_update(scalars, grads, ms, vs, ps, decayed, b1=b1, b2=b2,
                           eps=eps, wd=wd)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adamw runs on cpu or cuda, got {device}")
    addresses = _addresses(leaves)
    fn = _kernel()
    with torch.cuda.device(device):
        n_elems = sum(numels)
        grid = grid_size(n_elems, torch.cuda.get_device_properties(
            device).multi_processor_count, _blocks_per_sm)
        chunks = _chunks_on(device, tuple(numels), addresses,
                            tuple(bool(d) for d in decayed),
                            chunk_size(n_elems, grid, _quantum))
        # 32 bytes a leaf from pageable memory: staged before the call
        # returns, so the array may go
        pointers = torch.from_numpy(addresses).to(device, non_blocking=True)
        n_chunks = len(chunks)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(chunks.data_ptr(), n_chunks, pointers.data_ptr(),
                 min(grid, n_chunks), scalars.data_ptr(), b1, b2, eps, wd,
                 1.0 - b1, 1.0 - b2, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_adamw kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
