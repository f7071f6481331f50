"""Taxonomy, synthetic data, host decode and pipeline, augmentation
(counterpart of ``arsvt_tpu/data``)."""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "RECYCLING_CLASSES": "taxonomy",
    "NUM_CLASSES": "taxonomy",
    "class_name": "taxonomy",
    "class_index": "taxonomy",
    "synthetic_classification_batches": "synthetic",
    "make_synthetic_coco": "synthetic",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
