"""The (data, model) grid of ranks (counterpart of
``arsvt_tpu/parallel/mesh.py``).

JAX builds a `jax.sharding.Mesh` of devices and lets XLA place the
collectives. The port runs one process a rank on ``torch.distributed``:
rank r sits at (r // model, r % model) of the grid, its data group holds
the ranks of its column (the same model index: the same shards of every
weight) and its model group the ranks of its row (the same rows of the
batch). The backend is NCCL on the card and gloo on the CPU; where the
default group was already initialised (a launcher, a test, ``chip_smoke.py``
spawning gloo ranks on one card), `make_mesh` takes it as it is.

A 1x1 mesh of a process with no group (the default) has no groups at
all: the step functions then run exactly the one-process step.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from arsvt_tpu_torch.core.devices import platform_device
from arsvt_tpu_torch.parallel.tensor_parallel import ModelShard

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices"
            )
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the grid. `data_group` / `model_group` are
    process groups, or None in a process with no default group (then the
    mesh is 1x1)."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def model_shard(self) -> ModelShard | None:
        """The tensor-parallel shard of this rank, None without TP."""
        if self.model == 1:
            return None
        return ModelShard(self.model_group, self.model, self.model_rank)


def rank_device(platform: str | None = None, rank: int = 0) -> torch.device:
    """The CPU where `platform` or ``ARSVT_PLATFORM`` says ``cpu``, else
    the card of this rank (``LOCAL_RANK`` or `rank`, modulo the cards);
    raises where there is no card."""
    if (platform or platform_device()) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass platform='cpu' (or set "
                           "ARSVT_PLATFORM=cpu) for a CPU mesh")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init_from_environment(platform: str | None) -> None:
    """A launcher's env:// rendezvous (``WORLD_SIZE`` > 1 with
    ``MASTER_ADDR``), when no group exists yet."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    rank = int(os.environ["RANK"])
    device = rank_device(platform, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(default_backend(device), init_method="env://")


def make_mesh(config: MeshConfig | None = None, *, device=None,
              platform: str | None = None) -> Mesh:
    """The (data, model) grid over the ranks of the default process group
    (initialised from a launcher's environment if there is one and none
    exists); without a group, a 1x1 mesh of this process. `device`: this
    rank's device, by default `rank_device`."""
    _init_from_environment(platform)
    config = config or MeshConfig()
    if not dist.is_initialized():
        data, model = config.resolve(1)
        return Mesh(data, model, 0, torch.device(device) if device is not None
                    else rank_device(platform))
    world, rank = dist.get_world_size(), dist.get_rank()
    data, model = config.resolve(world)
    dev = (torch.device(device) if device is not None
           else rank_device(platform, rank))
    # every rank makes every group, in the same order
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    return Mesh(data, model, rank, dev, data_groups[rank % model],
                model_groups[rank // model])


def single_device_mesh(platform: str | None = None) -> Mesh:
    """A 1x1 mesh of this process alone, on `rank_device`, with no
    groups, whatever the default group holds."""
    return Mesh(1, 1, 0, rank_device(platform))
