"""ViT/DeiT backbone, classifier and DETR heads, detector, presets and
the JAX parameter bridge (counterpart of ``arsvt_tpu/models``)."""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "BackboneConfig": "vit",
    "init_backbone": "vit",
    "apply_backbone": "vit",
    "ClassifierConfig": "heads",
    "init_classifier": "heads",
    "apply_classifier": "heads",
    "DetrHeadConfig": "heads",
    "init_detr_head": "heads",
    "apply_detr_head": "heads",
    "init_image_classifier": "classifier",
    "apply_image_classifier": "classifier",
    "DetectorConfig": "detector",
    "init_detector": "detector",
    "apply_detector": "detector",
    "PRESETS": "registry",
    "get_preset": "registry",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
