"""Config-bound checkpoints with resume (counterpart of
``arsvt_tpu/train/checkpoint.py``).

The JAX package writes orbax checkpoints; orbax imports JAX, so the port
has its own format: one file per step, ``step_<step:09d>.pt``, holding
``torch.save`` of {"params", "opt_state", "step", "train_config" (the
`TrainConfig` JSON), "metrics", "extra"} with every tensor on the CPU. A
save writes a temporary file in the same directory and renames it into
place, so a reader sees a whole checkpoint or none. Loads use
``weights_only=True`` (tensors, containers and numbers only) and
``mmap=True``, so reading a checkpoint's config or metrics does not read
its tensors.

As in JAX, `restore` refuses a checkpoint whose model config differs
(`_model_config_mismatches`) before it touches the state, and the manager
keeps the latest `keep` steps plus the single best one by `best_metric`
(a step saved without metrics is kept only as one of the latest). Saves
are synchronous: `wait` has nothing to wait for.

Under a mesh (a `layout`, ``parallel/sharding.py::TreeLayout``) every rank
gathers the parameters and Adam moments into the full JAX-layout tree and
the first rank alone writes it, in the same format; a restore loads the
full tree on every rank and cuts its shards from it. So a checkpoint
restores on any world size and grid, as JAX's (``parallel/sharding.py:
137-150``, ``train/checkpoint.py:129, 201``), and a resumed run on
another grid continues the same run.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

from arsvt_tpu_torch.core.dtypes import tree_map
from arsvt_tpu_torch.train.config import TrainConfig

_NAME = re.compile(r"^step_(\d{9})\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.pt")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


def _load(directory: str, step: int) -> dict:
    return torch.load(_path(directory, step), map_location="cpu", mmap=True,
                      weights_only=True)


def latest_step(directory: str) -> int | None:
    """Most recent checkpoint step in `directory` (None when empty)."""
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def _pick_step(directory: str, step: int | None) -> int:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    return step


def _host(x):
    return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x


def _onto(like, saved, path: str = ""):
    """`saved` in the structure of `like`, each tensor on like's device and
    in its dtype; shapes and structure must agree."""
    if isinstance(like, dict):
        if set(like) != set(saved):
            raise ValueError(f"checkpoint tree differs at {path or '/'}: "
                             f"{sorted(saved)} vs {sorted(like)}")
        return {k: _onto(like[k], saved[k], f"{path}/{k}") for k in like}
    if isinstance(like, (list, tuple)):
        if len(like) != len(saved):
            raise ValueError(f"checkpoint tree differs at {path}: "
                             f"{len(saved)} vs {len(like)} entries")
        return type(like)(_onto(a, b, f"{path}/{i}")
                          for i, (a, b) in enumerate(zip(like, saved)))
    if isinstance(like, torch.Tensor):
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} != "
                             f"{tuple(like.shape)} at {path}")
        # a copy: the loaded tensor maps the file, and training updates
        # its state in place
        return saved.to(device=like.device, dtype=like.dtype, copy=True)
    return saved


class CheckpointManager:
    def __init__(self, directory: str, cfg: TrainConfig, *, keep: int = 3,
                 best_metric: str | None = None, best_mode: str = "min",
                 layout=None):
        """`best_metric`: metric key (from the metrics dict passed to
        `save`) that selects the best checkpoint, which garbage collection
        keeps beside the latest `keep`. `layout`: the mesh's
        ``TreeLayout`` (module docstring), None for one process."""
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got "
                             f"{best_mode!r}")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._cfg = cfg
        self._keep = keep
        self._best_metric = best_metric
        self._best_mode = best_mode
        self._layout = layout
        self._writes = layout is None or layout.writes
        # step -> metrics of the checkpoints on disk (None: saved without)
        self._metrics = {s: _load(self._dir, s)["metrics"]
                         for s in _steps(self._dir)}
        self.last_extra: dict = {}

    def save(self, step: int, state: dict, *, metrics: dict | None = None,
             extra: dict | None = None):
        """Write `state` ({"params", "opt_state", "step"}) as checkpoint
        `step`. `extra`: small host-side state saved alongside, e.g. the
        plateau controller's counters."""
        params, opt_state = state["params"], state["opt_state"]
        if self._layout is not None:
            params = self._layout.gather(params)
            opt_state = {**opt_state,
                         "mu": self._layout.gather(opt_state["mu"]),
                         "nu": self._layout.gather(opt_state["nu"])}
        blob = {
            "params": tree_map(_host, params),
            "opt_state": tree_map(_host, opt_state),
            "step": int(state["step"]),
            "train_config": self._cfg.to_json(),
            "metrics": (None if metrics is None
                        else {k: float(v) for k, v in metrics.items()}),
            "extra": extra or {},
        }
        if self._writes:
            final = _path(self._dir, step)
            tmp = f"{final}.{os.getpid()}.tmp"
            torch.save(blob, tmp)
            os.replace(tmp, final)
        self._metrics[step] = blob["metrics"]
        self._collect()

    def _collect(self):
        """Keep the latest `keep` steps and the best one; delete the rest."""
        steps = sorted(self._metrics)
        kept = set(steps[-self._keep:]) if self._keep > 0 else set()
        best = self.best_step
        if best is not None:
            kept.add(best)
        for s in steps:
            if s not in kept:
                if self._writes:
                    os.remove(_path(self._dir, s))
                del self._metrics[s]

    def wait(self):
        """Saves are synchronous; kept for the JAX manager's interface."""

    @property
    def latest_step(self) -> int | None:
        return max(self._metrics) if self._metrics else None

    @property
    def best_step(self) -> int | None:
        if not self._best_metric:
            return None
        scored = [(m[self._best_metric], s) for s, m in self._metrics.items()
                  if m and self._best_metric in m]
        if not scored:
            return None
        pick = min if self._best_mode == "min" else max
        return pick(scored)[1]

    def restore(self, state_like: dict, *, step: int | None = None,
                strict_config: bool = True) -> tuple[dict, TrainConfig]:
        """Restore into the structure of `state_like` (devices, dtypes,
        shapes). Returns (state, the checkpoint's TrainConfig)."""
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        blob = _load(self._dir, step)
        saved_cfg = TrainConfig.from_json(blob["train_config"])
        self.last_extra = blob["extra"]
        if strict_config:
            mismatches = _model_config_mismatches(saved_cfg, self._cfg)
            if mismatches:
                raise ValueError(
                    "checkpoint was trained with a different model config "
                    f"({mismatches}); pass strict_config=False to override")
        params, opt_state = blob["params"], blob["opt_state"]
        if self._layout is not None:
            params = self._layout.shard(params)
            opt_state = {**opt_state,
                         "mu": self._layout.shard(opt_state["mu"]),
                         "nu": self._layout.shard(opt_state["nu"])}
        state = {"params": _onto(state_like["params"], params),
                 "opt_state": _onto(state_like["opt_state"], opt_state),
                 "step": blob["step"]}
        return state, saved_cfg


_MODEL_FIELDS = ("preset", "task", "num_classes", "image_size")


def _model_config_mismatches(a: TrainConfig, b: TrainConfig) -> dict[str, Any]:
    return {
        f: (getattr(a, f), getattr(b, f))
        for f in _MODEL_FIELDS
        if getattr(a, f) != getattr(b, f)
    }


def load_for_eval(directory: str, cfg: TrainConfig, state_like: dict,
                  *, step: int | None = None):
    """Eval-side loader: restore the state bound to its training config."""
    return CheckpointManager(directory, cfg).restore(state_like, step=step)


def _bound_blob(directory: str, cfg: TrainConfig, step: int | None):
    blob = _load(os.path.abspath(directory), _pick_step(directory, step))
    saved_cfg = TrainConfig.from_json(blob["train_config"])
    mismatches = _model_config_mismatches(saved_cfg, cfg)
    if mismatches:
        raise ValueError("checkpoint was trained with a different model "
                         f"config ({mismatches})")
    return blob, saved_cfg


def load_params_for_eval(directory: str, cfg: TrainConfig, params_like,
                         *, step: int | None = None):
    """Restore only the params, config-bound: the optimizer moments stay
    unread in the memory-mapped file."""
    blob, saved_cfg = _bound_blob(directory, cfg, step)
    return _onto(params_like, blob["params"]), saved_cfg


def peek_config(directory: str, *, step: int | None = None) -> TrainConfig:
    """Read only the TrainConfig stored in a checkpoint, so a consumer can
    rebuild the trained architecture before building any params."""
    blob = _load(os.path.abspath(directory), _pick_step(directory, step))
    return TrainConfig.from_json(blob["train_config"])
