"""Optimizer and LR schedules with the optax chain's exact semantics
(counterpart of ``arsvt_tpu/train/optim.py``).

The JAX package chains ``clip_by_global_norm`` → ``scale_by_adam`` →
``add_decayed_weights(mask=_wd_mask)`` → ``scale_by_schedule`` →
``scale_by_learning_rate(lr_scale)``, or runs the same math in one pass
(`fused_adamw_update`). The port has the one pass only, through
``ops/fused_adamw.py``: the kernel on the card, its plain version on the
CPU, for either value of ``TrainConfig.fused_adamw``. PyTorch's own AdamW
is not used: it applies the decay before the Adam step and folds the bias
corrections otherwise.

The optimizer state is a plain dict: ``mu`` and ``nu`` are trees like the
parameters (updated in place); ``adam_count``, ``schedule_count`` and the
inject counter ``count`` are host ints and ``lr_scale`` a host float, so
a step needs no device-to-host copy. Schedules are evaluated on the host
in float32, in optax's order of operations.

Under a mesh (``parallel/``) the step functions have already summed the
gradients over the data axis; under tensor parallelism the global norm
sums the sharded leaves' squares over the model group and counts each
replicated leaf once, and #7 updates the rank's local shards in its one
launch. JAX turns its kernel off under TP (``arsvt_tpu/train/optim.py:
156-161, 189-193``) only because a ``pallas_call`` on sharded leaves
would all-gather them; the port's kernel takes each rank's shards as they
are, so it stays on: a difference by design, with the same math.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from arsvt_tpu_torch.core.dtypes import (
    tree_leaves,
    tree_map,
    tree_map_with_path,
)
from arsvt_tpu_torch.ops.fused_adamw import fused_adamw
from arsvt_tpu_torch.train.config import TrainConfig

_F32 = np.float32
_INT32_MAX = 2**31 - 1
ADAM_EPS = 1e-8


def _linear_schedule(init: float, end: float, steps: int):
    """optax.linear_schedule (polynomial, power 1, no transition_begin)."""
    if steps <= 0:
        return lambda count: _F32(init)

    def schedule(count: int):
        frac = _F32(1.0) - _F32(min(max(count, 0), steps)) / _F32(steps)
        return _F32(init - end) * frac + _F32(end)

    return schedule


def _cosine_decay(init: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule with exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count: int):
        c = min(_F32(count), _F32(decay_steps))
        cosine = _F32(0.5) * (_F32(1.0) + np.cos(
            _F32(np.pi) * c / _F32(decay_steps)))
        return _F32(init) * (_F32(1.0 - alpha) * cosine + _F32(alpha))

    return schedule


def _warmup_cosine_decay(init, peak, warmup_steps, decay_steps, end):
    """optax.warmup_cosine_decay_schedule: linear from `init` to `peak`,
    then a cosine with alpha = end / peak over decay - warmup steps."""
    alpha = 0.0 if peak == 0.0 else end / peak
    warmup = _linear_schedule(init, peak, warmup_steps)
    cosine = _cosine_decay(peak, decay_steps - warmup_steps, alpha)
    return lambda count: (warmup(count) if count < warmup_steps
                          else cosine(count - warmup_steps))


def make_schedule(cfg: TrainConfig):
    """count (int) -> learning rate (np.float32)."""
    if cfg.schedule == "cosine":
        return _warmup_cosine_decay(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(cfg.total_steps, cfg.warmup_steps + 1),
            cfg.learning_rate * cfg.min_lr_ratio)
    if cfg.schedule in ("constant", "plateau"):
        # plateau scaling is applied multiplicatively via PlateauState
        if cfg.warmup_steps > 0:
            return _linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
        return lambda count: _F32(cfg.learning_rate)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def _wd_mask(params):
    """Decay only matrices: no weight decay on biases, LN params, tokens.

    The JAX rule is ``ndim <= 1 + ("blocks" in name)`` because its blocks
    are stacked on a depth axis; the port keeps one dict per layer, so a
    bias is 1-D everywhere and the rule is ``ndim <= 1``. Returns a tree of
    bools shaped like `params`.
    """
    def leaf(name, x):
        if x.ndim <= 1:
            return False
        return not any(t in name for t in ("token", "pos_embed", "queries",
                                           "ln"))

    return tree_map_with_path(leaf, params)


def init_opt_state(params) -> dict:
    """The state ``make_optimizer(cfg).init(params)`` holds, as a dict."""
    return {
        "count": 0,            # optax.inject_hyperparams' own counter
        "lr_scale": 1.0,
        "adam_count": 0,
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "schedule_count": 0,
    }


def set_lr_scale(opt_state: dict, scale: float) -> dict:
    """A new state with the plateau multiplier set (the input is left as
    it was; ``mu`` and ``nu`` are shared, not copied)."""
    return {**opt_state, "lr_scale": float(_F32(scale))}


@dataclasses.dataclass
class PlateauState:
    """Functional ReduceLROnPlateau: torch's rel-mode threshold."""

    scale: float = 1.0
    best: float = float("inf")
    bad_epochs: int = 0

    def update(self, metric: float, cfg: TrainConfig) -> "PlateauState":
        if metric < self.best * (1.0 - cfg.plateau_threshold):
            return PlateauState(self.scale, metric, 0)
        bad = self.bad_epochs + 1
        if bad > cfg.plateau_patience:
            floor = cfg.plateau_min_lr / max(cfg.learning_rate, 1e-30)
            return PlateauState(
                max(self.scale * cfg.plateau_factor, floor), self.best, 0
            )
        return PlateauState(self.scale, self.best, bad)


def _safe_increment(count: int) -> int:
    return count + 1 if count < _INT32_MAX else _INT32_MAX


def global_norm(grads: list, sharded: list | None = None,
                model_group=None) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's squares. Under
    tensor parallelism (`sharded`, a bool a leaf, and the `model_group`)
    the shards' squares are summed over the group first."""
    squares = [g.square().sum() for g in grads]
    if sharded is None or model_group is None:
        return torch.sqrt(torch.stack(squares).sum())
    from arsvt_tpu_torch.parallel.data_parallel import total

    local = torch.stack([q for q, s in zip(squares, sharded) if s]).sum()
    rest = [q for q, s in zip(squares, sharded) if not s]
    whole = total(local, model_group)
    if rest:
        whole = whole + torch.stack(rest).sum()
    return torch.sqrt(whole)


def adamw_scalars(cfg: TrainConfig, gnorm: torch.Tensor, count_inc: int,
                  schedule_count: int, lr_scale: float) -> torch.Tensor:
    """[gscale, bc1, bc2, step] as fp32[4] on gnorm's device.

    gscale is clip_by_global_norm's select (no epsilon); the bias
    corrections use the incremented Adam count; the schedule is read at
    the count before the increment, so step 0 has the schedule's value at
    0. The host values go in by fill, with no host-to-device copy.
    """
    max_norm = cfg.grad_clip_norm
    scalars = torch.empty(4, dtype=torch.float32, device=gnorm.device)
    scalars[0] = torch.where(gnorm < max_norm, 1.0, max_norm / gnorm)
    scalars[1].fill_(float(_F32(1.0) - _F32(cfg.beta1) ** _F32(count_inc)))
    scalars[2].fill_(float(_F32(1.0) - _F32(cfg.beta2) ** _F32(count_inc)))
    scalars[3].fill_(float(make_schedule(cfg)(schedule_count)
                           * _F32(lr_scale)))
    return scalars


def fused_adamw_update(cfg: TrainConfig, grads, opt_state: dict, params,
                       mesh=None):
    """One-pass AdamW: returns (params, opt_state, grad_norm).

    `params`, ``mu`` and ``nu`` are updated in place; the returned state is
    a new dict with the counts advanced. The update is one launch of the
    kernel on CUDA tensors and its plain version on CPU tensors, whatever
    ``cfg.fused_adamw`` says (JAX's two settings are the same math). Under
    a `mesh` with a model axis the leaves are the rank's shards and the
    norm is the global one (module docstring).
    """
    g_leaves = tree_leaves(grads)
    p_leaves = tree_leaves(params)
    mu, nu = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
    decayed = tree_leaves(_wd_mask(params))
    if mesh is not None and mesh.model > 1:
        from arsvt_tpu_torch.parallel.sharding import sharded_mask

        gnorm = global_norm(g_leaves, tree_leaves(sharded_mask(params, mesh)),
                            mesh.model_group)
    else:
        gnorm = global_norm(g_leaves)
    count_inc = _safe_increment(opt_state["adam_count"])
    scalars = adamw_scalars(cfg, gnorm, count_inc,
                            opt_state["schedule_count"],
                            opt_state["lr_scale"])
    fused_adamw(scalars, g_leaves, mu, nu, p_leaves, decayed, b1=cfg.beta1,
                b2=cfg.beta2, eps=ADAM_EPS, wd=cfg.weight_decay)
    new_state = {
        **opt_state,
        "adam_count": count_inc,
        "schedule_count": _safe_increment(opt_state["schedule_count"]),
        "count": _safe_increment(opt_state["count"]),
    }
    return params, new_state, gnorm
