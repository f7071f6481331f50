"""Rematerialisation of the encoder blocks: the five policies of
``arsvt_tpu/models/vit.py:248-312`` on ``torch.utils.checkpoint``.

JAX wraps each block in ``jax.checkpoint`` with a policy; the backward
replays what the policy did not save. Here each policy is a
non-reentrant checkpoint (the dropout masks replay: every site draws from
a generator or kernel seed of its own ``Rng``, so the RNG state is not
stashed):

- ``full``: the block, nothing saved but its input;
- ``dots``: the block, saving the outputs of its un-batched products
  (``aten.mm``: qkv, proj and fc1, before their bias adds), as
  ``dots_with_no_batch_dims_saveable`` saves the dots the backward reads
  (fc2's product, tagged ``mlp_fc2``, feeds only adds); a kernel's
  products are invisible to both, so the kernels' forwards replay;
- ``names``: the block, saving the attention kernels' outputs (the custom
  ops ``arsvt::encoder_attention_fwd`` and ``arsvt::flash_attention_fwd``:
  JAX's ``flash_out`` and ``flash_lse``) and the unfused MLP's fc1 output
  (``mlp_u``, tagged by `checkpoint_name`);
- ``all_but_mlp``: only the MLP, nothing saved;
- ``mlp_tail``: only GELU → fc2, nothing saved but u.

The last two are applied in ``ops/mlp.py::gelu_mlp``'s callers. The
``mlp_u`` tag sits on fc1's product, before its bias add: the same bytes
as JAX's biased u, and the replay then runs only the add, where an eager
replay that saved the sum would run fc1's matmul again (XLA's replay
drops it as dead code).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

REMAT_POLICIES = ("full", "dots", "names", "all_but_mlp", "mlp_tail")
# the policies that checkpoint a whole block; the other two checkpoint
# parts of the MLP
BLOCK_POLICIES = ("full", "dots", "names")



class _Tags(threading.local):
    """The open `checkpoint_name` tags, innermost last, of this thread: the
    thread that runs a forward or its replay is the one whose policy reads
    them."""

    def __init__(self):
        self.stack: list[str] = []


_tags = _Tags()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the ops run inside with `name` (``jax.ad_checkpoint.
    checkpoint_name``): the ``names`` policy saves the product tagged
    ``mlp_u``, ``dots`` leaves the one tagged ``mlp_fc2``. Outside a
    checkpoint it changes nothing."""
    _tags.stack.append(name)
    try:
        yield
    finally:
        _tags.stack.pop()


def check_policy(remat: bool, policy: str) -> None:
    """JAX's check (``vit.py:289-293``): an unknown policy raises
    ValueError when remat is on."""
    if remat and policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; one of "
                         f"{REMAT_POLICIES}")


def _save(yes: bool):
    return (CheckpointPolicy.MUST_SAVE if yes
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots(ctx, op, *args, **kwargs):
    # JAX saves a dot only where the backward reads it; fc2's product
    # feeds adds alone, so XLA drops it from the residuals: so here
    return _save(op is torch.ops.aten.mm.default
                 and _tags.stack[-1:] != ["mlp_fc2"])


def _names(ctx, op, *args, **kwargs):
    if op in (torch.ops.arsvt.encoder_attention_fwd.default,
              torch.ops.arsvt.flash_attention_fwd.default):
        return _save(True)
    return _save(op is torch.ops.aten.mm.default
                 and _tags.stack[-1:] == ["mlp_u"])


_SELECTIVE = {"dots": _dots, "names": _names}


def remat_call(fn, *args, policy: str = "full"):
    """fn(*args) with its activations rematerialised under `policy`
    ("full", "dots" or "names"; "full" also for the MLP-only policies,
    which checkpoint their part whole). Without autograd it is the call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if policy in _SELECTIVE:
        # the custom ops' namespace must exist before a policy names it
        from arsvt_tpu_torch.ops import library

        library.register_all()
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _SELECTIVE[policy])
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
