"""Multi-process wiring (counterpart of ``arsvt_tpu/parallel/multihost.py``).

JAX runs one process a host over all its chips; the port runs one process
a rank (one a card), all on ``torch.distributed``:

  * `initialize_multihost()` initialises the default process group from
    ``ARSVT_COORDINATOR_ADDRESS`` (host:port of rank 0),
    ``ARSVT_NUM_PROCESSES`` and ``ARSVT_PROCESS_ID``: NCCL on the card,
    gloo on the CPU (``ARSVT_PLATFORM=cpu``). A group that is already
    initialised is success; an environment without those variables is a
    single process (False).
  * `local_batch` / `global_batch_from_local`: each rank of the data axis
    feeds its own shard of the data (``data/pipeline.py``'s
    `process_index` / `process_count` take `data_shard`: ranks of one
    model group share a shard) at `global_batch // data` rows, and keeps
    its local rows as the step's input.

The train CLI turns this on under ``ARSVT_MULTIHOST=1``; every process
runs the identical command line with its own ``ARSVT_PROCESS_ID``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_INITIALIZED = False


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> bool:
    """Initialise the default process group once; returns True when it
    spans more than one process afterwards. Unset arguments come from
    ARSVT_COORDINATOR_ADDRESS / ARSVT_NUM_PROCESSES / ARSVT_PROCESS_ID."""
    global _INITIALIZED
    if coordinator_address is None:
        coordinator_address = os.environ.get("ARSVT_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("ARSVT_NUM_PROCESSES"):
        num_processes = int(os.environ["ARSVT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("ARSVT_PROCESS_ID"):
        process_id = int(os.environ["ARSVT_PROCESS_ID"])
    # a launcher (or the caller) may have initialised the group first:
    # that is success, not failure
    if dist.is_initialized():
        _INITIALIZED = True
    if not _INITIALIZED:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            return False  # a single-process environment
        from arsvt_tpu_torch.parallel.mesh import (
            default_backend,
            rank_device,
        )

        device = rank_device(None, process_id)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        dist.init_process_group(default_backend(device), init_method=init,
                                world_size=num_processes, rank=process_id)
        _INITIALIZED = True
    return dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def data_shard(mesh) -> tuple[int, int]:
    """(index, count) of the data shard this rank feeds: its data rank
    and the data axis (ranks of one model group feed the same rows)."""
    return mesh.data_rank, mesh.data


_BARRIER_GROUP = None


def host_barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Align all processes on a gloo group (not a device collective), with
    JAX's timeout; a rank that does not arrive is named in the error.
    No-op for one process. Why: the first collective of a step comes
    after unequal host work (dataset parse, checkpoint restore, the first
    kernel builds), and NCCL's own first rendezvous has a shorter
    patience than that skew."""
    global _BARRIER_GROUP
    if process_count() <= 1:
        return
    if _BARRIER_GROUP is None:
        _BARRIER_GROUP = (dist.group.WORLD
                          if dist.get_backend() == "gloo"
                          else dist.new_group(backend="gloo"))
    del name  # gloo barriers need no id; JAX's coordination service did
    dist.monitored_barrier(group=_BARRIER_GROUP,
                           timeout=datetime.timedelta(milliseconds=timeout_ms))


def local_batch(global_batch_size: int, mesh=None) -> int:
    """Rows this rank must feed per step (global batch // data ranks, or
    // processes without a mesh)."""
    n = mesh.data if mesh is not None else process_count()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} must divide over "
            f"{n} processes"
        )
    return global_batch_size // n


def global_batch_from_local(local, mesh) -> dict:
    """A rank's step input from its local batch: the local rows as they
    are when several processes feed (each already holds its slice);
    `shard_batch` in a single process, which it equals there."""
    from arsvt_tpu_torch.parallel.sharding import shard_batch

    if process_count() == 1:
        return shard_batch(local, mesh)
    return local
