"""Data- and tensor-parallel training on ``torch.distributed``
(counterpart of ``arsvt_tpu/parallel``): the (data, model) grid of ranks
(`mesh.py`), the sharding rules (`sharding.py`), the multi-process
wiring (`multihost.py`), the Megatron operators of the model code
(`tensor_parallel.py`) and `dryrun.py`'s multi-process dry run.

JAX's names are re-exported lazily, as ``serving/__init__.py`` does, so
importing the package loads no kernel.
"""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "DATA_AXIS": "mesh",
    "MODEL_AXIS": "mesh",
    "MeshConfig": "mesh",
    "make_mesh": "mesh",
    "batch_sharding": "sharding",
    "param_sharding_rules": "sharding",
    "replicated": "sharding",
    "shard_batch": "sharding",
    "shard_params": "sharding",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
