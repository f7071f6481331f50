"""Evaluation and streaming inference (counterpart of
``arsvt_tpu/evaluation``)."""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "evaluate_classifier": "classify",
    "StreamingClassifier": "classify",
    "StreamingDetector": "classify",
    "evaluate_detector": "detect",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
