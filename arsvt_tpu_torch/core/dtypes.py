"""Mixed-precision dtype policy (counterpart of ``arsvt_tpu/core/dtypes.py``).

bf16 activations with fp32 parameters; softmax, LayerNorm statistics and
logits stay fp32 ("fp32 islands"). The policy only governs tensor storage
between ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Storage dtypes for the three tensor classes in a step."""

    param_dtype: torch.dtype = torch.float32    # master weights
    compute_dtype: torch.dtype = torch.bfloat16  # activations & matmul inputs
    output_dtype: torch.dtype = torch.float32    # loss / metrics

    def cast_to_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast_floating(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return _cast_floating(tree, self.output_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map_with_path(fn, tree, prefix: str = ""):
    """Like `tree_map`, with fn(path, leaf): "/"-joined keys and list
    indices as the path."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a tree of dicts and lists, with dict keys in
    sorted order (as JAX flattens dicts), so two trees of the same
    structure give their leaves in the same order whatever order their
    dicts were built in."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def _cast_floating(tree, dtype):
    return tree_map(
        lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
        and x.is_floating_point() else x,
        tree,
    )


def to_unit_float(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Rescale uint8 images to [0,1] `dtype` on the device.

    Integer input is multiplied by the reciprocal 1/255 in `dtype`, exactly
    as the JAX function does; float input passes through with a cast.
    """
    if not images.is_floating_point():
        return images.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype,
                                               device=images.device)
    return images.to(dtype)


def check_unit_range_images(arr, context: str) -> None:
    """Reject float images outside ~[0,1] on host-side serving paths.

    The engines normalize inside their forwards; already-normalized or
    0-255 float input would silently give wrong probabilities.
    """
    a = np.asarray(arr)
    if not np.issubdtype(a.dtype, np.floating) or a.size == 0:
        return  # uint8 is always in contract; empty batches have no range
    lo, hi = a.min(), a.max()
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(
            f"{context} got non-finite pixel values — the forward would "
            "silently produce NaN probabilities"
        )
    if lo < -0.25 or hi > 1.25:
        raise ValueError(
            f"{context} expects uint8 or [0,1]-float images and "
            f"normalizes inside the forward; got float range "
            f"[{lo:.2f}, {hi:.2f}] — input looks already "
            "normalized or 0-255 scaled."
        )
