"""The data axis inside a step: what JAX's GSPMD does for a batch sharded
over ``data`` (``arsvt_tpu/train/accum.py:11-15``,
``objectives/detection_loss.py:99, 116``), written out.

A rank holds rows [b0, b0 + m) of each global microbatch of n·m rows (n
data ranks). Its loss is the local numerator over the global denominator,
so the ranks' gradients **sum** to the one-process gradient of the global
microbatch: `sum_over` all-reduces them once a step, after accumulation.
Values that JAX reduces over the global microbatch (the detector's
normalisers, the triplet loss's batch, the metrics) come from `total` and
`gather_rows`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from arsvt_tpu_torch.parallel.tensor_parallel import all_reduce_sum

# elements of one bucket of the gradient all-reduce (64 MiB of fp32)
BUCKET = 1 << 24


def sum_over(tensors: list, group) -> list:
    """Each tensor summed over `group`, in buckets of flattened fp32
    (one all-reduce a bucket); a list like `tensors`."""
    out, bucket, size = [], [], 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            n = t.numel()
            out.append(flat[offset:offset + n].view(t.shape).to(t.dtype))
            offset += n
        bucket.clear()

    for t in tensors:
        if size + t.numel() > BUCKET:
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    flush()
    return out


def total(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group` (no gradient: denominators and metrics); x
    itself without a group."""
    return x if group is None else all_reduce_sum(x.detach(), group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank of `group` in rank order (equal counts), the
    own rows live for autograd and the others constants; x without a
    group."""
    if group is None:
        return x
    # bool as bytes and bf16 as its 16-bit words: the same bits, in types
    # every backend gathers
    as_type = {torch.bool: torch.uint8, torch.bfloat16: torch.int16}.get(
        x.dtype)
    y = x.detach().contiguous()
    y = y if as_type is None else y.view(as_type)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    if as_type is not None:
        parts = [t.view(x.dtype) for t in parts]
    parts[dist.get_rank(group)] = x
    return torch.cat(parts)


def rows_of(draws, start: int, count: int):
    """A draws dataclass (or tensor) cut to rows [start, start + count) of
    every per-image field; host scalars and None stay as they are."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws[start:start + count] if draws.dim() else draws
    if dataclasses.is_dataclass(draws):
        return dataclasses.replace(draws, **{
            f.name: rows_of(getattr(draws, f.name), start, count)
            for f in dataclasses.fields(draws)})
    return draws
