"""Sharding rules: which parameter leaves a tensor-parallel rank holds a
shard of, and which rows of a batch a data-parallel rank takes
(counterpart of ``arsvt_tpu/parallel/sharding.py``).

`_TP_RULES` are JAX's, letter for letter, matched on the port's leaf
paths ("backbone/blocks/3/attn/qkv/kernel": the port keeps one dict a
layer where JAX stacks them, and the `.*` prefixes match both). JAX cuts a
"col" leaf into contiguous blocks of its last axis and a "row" leaf into
blocks of its second-to-last, with GSPMD padding an uneven split. A port
rank runs the attention kernels on its own heads, so it needs whole
heads: the attention leaves are cut **by heads** instead, each rank
holding the columns of its heads in every packed part (the q, k and v of
``qkv``, [q|k|v] as kernel #1 reads them; the k and v of the cross
attention's ``kv``; the rows of ``proj``), and the MLP leaves into
contiguous hidden units. Counts split as ``numpy.array_split`` does
(``parallel/tensor_parallel.py``), so 25 heads on 2 ranks are 13 and 12.
`gather_params` puts the shards back into JAX's layout, which is what a
checkpoint holds at any world size.

A batch leaf's leading dim is split over the data axis into contiguous
slices, the rank taking its own (`shard_batch`); a remainder batch whose
leading dim does not divide is `Replicated` on every rank, as JAX
replicates it, and the step functions then run it whole on each rank
with no data collective.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.distributed as dist

from arsvt_tpu_torch.core.dtypes import tree_map_with_path
from arsvt_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from arsvt_tpu_torch.parallel.tensor_parallel import split_range

# path-regex -> which axis (from the right) carries the model shard
_COL = "col"  # output-feature sharded: qkv / fc1 kernels and biases
_ROW = "row"  # input-feature sharded: proj / fc2 kernels
_TP_RULES: list[tuple[str, str]] = [
    # NOTE: `.*attn/proj/kernel$` also matches cross_attn proj paths (the
    # `.*` absorbs the `cross_` prefix) — self- and cross-attention output
    # projections deliberately share the _ROW layout, ONE rule for both.
    (r".*attn/qkv/kernel$", _COL),
    (r".*attn/qkv/bias$", _COL),
    (r".*attn/proj/kernel$", _ROW),
    (r".*cross_attn/(q|kv)/kernel$", _COL),
    (r".*cross_attn/(q|kv)/bias$", _COL),
    (r".*mlp/fc1/kernel$", _COL),
    (r".*mlp/fc1/bias$", _COL),
    (r".*mlp/fc2/kernel$", _ROW),
]


def _kind(name: str, mesh: Mesh) -> str | None:
    if mesh.shape.get(MODEL_AXIS, 1) > 1:
        for pat, kind in _TP_RULES:
            if re.match(pat, name):
                return kind
    return None


def param_sharding_rules(params, mesh: Mesh):
    """A tree like `params` of "col", "row" or None (replicated). With a
    model axis of 1 every leaf is replicated, the pure-DP regime."""
    return tree_map_with_path(lambda name, leaf: _kind(name, mesh), params)


def _layout(name: str):
    """(packed parts, by heads) of a sharded leaf: qkv 3, the cross
    attention's kv 2, q and proj 1, all by heads; the MLP by units."""
    if "/mlp/" in f"/{name}":
        return 1, False
    if name.endswith(("/qkv/kernel", "/qkv/bias")):
        return 3, True
    if name.endswith(("/kv/kernel", "/kv/bias")):
        return 2, True
    return 1, True


def _heads_of(name: str, num_heads) -> int:
    """The head count of the layer a leaf belongs to: `num_heads` an int,
    or {top-level key: int} ("backbone", "detr")."""
    if isinstance(num_heads, int):
        return num_heads
    return num_heads[name.split("/", 1)[0]]


def _index(name: str, width: int, mesh: Mesh, num_heads) -> torch.Tensor:
    """The positions along a sharded axis of full `width` that this model
    rank holds."""
    parts, by_heads = _layout(name)
    block = width // parts
    if by_heads:
        heads = _heads_of(name, num_heads)
        head_dim = block // heads
        h0, hl = split_range(heads, mesh.model, mesh.model_rank)
        start, count = h0 * head_dim, hl * head_dim
    else:  # contiguous hidden units
        start, count = split_range(block, mesh.model, mesh.model_rank)
    return torch.cat([torch.arange(p * block + start, p * block + start
                                   + count) for p in range(parts)])


def _axis(kind: str) -> int:
    return -1 if kind == _COL else -2


def shard_params(params, mesh: Mesh, num_heads):
    """This rank's shards of a full (JAX-layout) tree, each a new
    contiguous tensor on `mesh.device`; replicated leaves are copied
    whole. `num_heads`: the head count, or {top-level key: count}."""
    def take(name, x):
        kind = _kind(name, mesh)
        if kind is not None:
            axis = x.dim() + _axis(kind)
            idx = _index(name, x.shape[axis], mesh, num_heads)
            x = x.index_select(axis, idx.to(x.device))
        return x.to(mesh.device).contiguous().clone()

    return tree_map_with_path(take, params)


def gather_params(local, mesh: Mesh, num_heads):
    """The full JAX-layout tree from the model ranks' shards, on every
    rank (one all-reduce of the full leaf, and one of its width, a
    sharded leaf: checkpoint time only)."""
    if mesh.model == 1:
        return local

    def put(name, x):
        kind = _kind(name, mesh)
        if kind is None:
            return x
        axis = x.dim() + _axis(kind)
        width = torch.tensor([x.shape[axis]], dtype=torch.int64,
                             device=x.device)
        dist.all_reduce(width, group=mesh.model_group)
        shape = list(x.shape)
        shape[axis] = int(width)
        out = torch.zeros(shape, dtype=torch.float32, device=x.device)
        idx = _index(name, shape[axis], mesh, num_heads).to(x.device)
        out.index_copy_(axis, idx, x.float())
        dist.all_reduce(out, group=mesh.model_group)
        return out.to(x.dtype)

    return tree_map_with_path(put, local)


def sharded_mask(params, mesh: Mesh):
    """A tree of bools like `params`: True where the leaf is a model
    shard (its squares sum over the model group in the gradient norm)."""
    return tree_map_with_path(
        lambda name, leaf: _kind(name, mesh) is not None, params)


class Replicated(dict):
    """A batch every data rank holds whole (its leading dim does not
    divide the data axis); the steps run it whole on each rank."""


def batch_sharding(mesh: Mesh, ndim: int = 4):
    """The rows a rank takes of a leading dim n, as a function n ->
    slice (all of them where n does not divide the data axis)."""
    del ndim  # every leaf shards its leading dim alone

    def rows(n: int) -> slice:
        data = mesh.shape.get(DATA_AXIS, 1)
        if n % data:
            return slice(0, n)
        per = n // data
        return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)

    return rows


def shard_batch(batch, mesh: Mesh):
    """This data rank's contiguous slice of every leaf of a batch dict
    (numpy arrays or tensors, kept as they are); a batch whose leading
    dims do not all divide the data axis comes back `Replicated`."""
    n_data = mesh.shape.get(DATA_AXIS, 1)
    dims = {k: int(np.shape(x)[0]) for k, x in batch.items()
            if np.ndim(x) >= 1}
    if n_data == 1:
        return batch
    if any(n % n_data for n in dims.values()):
        return Replicated(batch)
    rows = batch_sharding(mesh)
    return {k: x[rows(dims[k])] if k in dims else x
            for k, x in batch.items()}


def replicated(mesh: Mesh):
    """The rows a replicated leaf gives a rank: all of them."""
    del mesh
    return lambda n: slice(0, n)


def place_on_mesh(tree, mesh: Mesh):
    """Every tensor leaf on the rank's device (shards stay the shards
    they are); other leaves (the optimizer's host counters) as they are.
    A state placed so restores and runs on any mesh."""
    def place(x):
        return x.to(mesh.device) if isinstance(x, torch.Tensor) else x

    if isinstance(tree, dict):
        return {k: place_on_mesh(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_on_mesh(v, mesh) for v in tree)
    return place(tree)


class TreeLayout:
    """How a train state's trees sit on a mesh, for checkpoints: `gather`
    gives the full JAX-layout tree on every rank, `shard` this rank's part
    of a full tree, and only the first rank writes (`writes`)."""

    def __init__(self, mesh: Mesh, num_heads):
        self.mesh = mesh
        self.num_heads = num_heads

    @property
    def writes(self) -> bool:
        return self.mesh.rank == 0

    def gather(self, tree):
        return gather_params(tree, self.mesh, self.num_heads)

    def shard(self, tree):
        return shard_params(tree, self.mesh, self.num_heads)
