"""Gradient accumulation: one optimizer step over k microbatches
(counterpart of ``arsvt_tpu/train/accum.py``).

Microbatch `a` is rows ``a::k`` of the batch (JAX reshapes (B, ...) to
(B/k, k, ...) and takes column a). The per-microbatch losses, aux values
and gradients are summed and divided by k, which equals the full-batch
mean for equal-size microbatches.

Under a data mesh the batch is the rank's contiguous slice of the global
batch, and its microbatch `a` is that slice's rows ``a::k``: JAX's layout
under a data mesh (``arsvt_tpu/train/accum.py:11-15``), where the reshape
is local to each device. Global microbatch `a` (global rows ``a::k``) is
then the ranks' microbatches `a` in rank order, rank r holding its rows
[r·m, (r+1)·m), m = B/(n·k) for n data ranks.
"""

from __future__ import annotations

import torch


def microbatch_split(batch: dict, accum: int) -> list[dict]:
    """Batch dict of (B, ...) tensors -> `accum` dicts, the a-th holding
    rows a::accum."""
    for x in batch.values():
        if x.dim() < 1 or x.shape[0] % accum:
            raise ValueError(
                f"grad_accum={accum} must divide the batch dim, "
                f"got shape {tuple(x.shape)}")
    return [{k: x[a::accum] for k, x in batch.items()}
            for a in range(accum)]


def accumulated_value_and_grad(loss_fn, params: list, batch: dict,
                               accum: int):
    """Value and gradient of `loss_fn` over `accum` microbatches.

    loss_fn(microbatch, a) -> (loss, aux dict of tensors), built on
    `params` (a list of tensors that require grad). Returns
    ((loss, aux), grads), each summed over the microbatches and divided by
    `accum` (dividing by 1 is exact); grads is a list like `params`.
    """
    total = aux_total = grads = None
    for a, mb in enumerate(microbatch_split(batch, accum)):
        loss, aux = loss_fn(mb, a)
        g = list(torch.autograd.grad(loss, params))
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        if a == 0:
            grads, total, aux_total = g, loss, aux
        else:
            grads = torch._foreach_add(grads, g)
            total = total + loss
            aux_total = {k: aux_total[k] + v for k, v in aux.items()}
    grads = torch._foreach_div(grads, float(accum))
    return (total / accum, {k: v / accum for k, v in aux_total.items()}), grads
