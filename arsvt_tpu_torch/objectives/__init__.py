"""Training objectives (counterpart of ``arsvt_tpu/objectives``)."""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "softmax_cross_entropy": "classification",
    "mixup": "classification",
    "accuracy_top1": "classification",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
