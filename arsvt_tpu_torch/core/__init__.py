"""Dtype policy, image rescaling, tree helpers and the explicit random
streams (counterpart of ``arsvt_tpu/core``)."""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "Policy": "dtypes",
    "DEFAULT_POLICY": "dtypes",
    "FP32_POLICY": "dtypes",
    "Rng": "prng",
    "generator": "prng",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
