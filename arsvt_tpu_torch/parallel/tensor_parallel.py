"""Tensor parallelism inside the model code: the shard a rank holds and
Megatron's two conjugate operators over the model group.

JAX shards the blocks by `PartitionSpec`s (``arsvt_tpu/parallel/
sharding.py:24-47``) and GSPMD inserts the collectives. The port writes
them out. A block's column-sharded products (qkv, the DETR q and kv, fc1)
take their input through `enter` (identity forward, all-reduce of the
gradient backward), and its row-sharded products (proj, fc2) give their
partial sums to `leave` (all-reduce forward, identity backward): one
all-reduce a block each way. A row shard's bias is added once, after
`leave`, on every rank. Both sums run in fp32 whatever the activations'
dtype (gloo, which `chip_smoke.py` runs on CUDA tensors, has no bf16
sum), then round once to that dtype.

A rank holds whole heads, so that it runs the attention kernels on its
own: head h of H goes to rank `split_range(H, t, r)`, the counts
following ``numpy.array_split`` (25 heads on 2 ranks: 13 and 12). fc1's
hidden columns and fc2's rows split the same way.

The step functions set the rank's `ModelShard` with `model_parallel`
around the forward; the model code reads it with `active` once a forward
and hands it to each block (the blocks' replays under remat see the
shard they ran with).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


def split_sizes(n: int, parts: int) -> list[int]:
    """``numpy.array_split``'s part sizes: the first n % parts get one
    more."""
    base, extra = divmod(int(n), int(parts))
    return [base + (i < extra) for i in range(parts)]


def split_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """(start, count) of part `index` of n under `split_sizes`."""
    sizes = split_sizes(n, parts)
    return sum(sizes[:index]), sizes[index]


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the model axis: its process group, the axis
    size and its index on it."""

    group: object
    size: int
    rank: int

    def heads(self, n: int) -> tuple[int, int]:
        """(h0, count) of this rank's heads among n."""
        return split_range(n, self.size, self.rank)


_ACTIVE: ModelShard | None = None


def active() -> ModelShard | None:
    """The shard the running step set, or None (no tensor parallelism)."""
    return _ACTIVE


@contextlib.contextmanager
def model_parallel(shard: ModelShard | None):
    """Run the model code of the block under `shard` (None: as one
    rank)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, shard
    try:
        yield shard
    finally:
        _ACTIVE = prev


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, taken in fp32, in x's dtype; x is left
    as it was."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, shard: ModelShard | None) -> torch.Tensor:
    """Into a column shard: x as it is, its gradient summed over the model
    group."""
    return x if shard is None else _Enter.apply(x, shard.group)


def leave(x: torch.Tensor, shard: ModelShard | None) -> torch.Tensor:
    """Out of a row shard: the partial sums summed over the model group."""
    return x if shard is None else _Leave.apply(x, shard.group)
