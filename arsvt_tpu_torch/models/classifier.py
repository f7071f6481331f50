"""Full image classifier = backbone + classifier head (counterpart of
``arsvt_tpu/models/classifier.py``)."""

from __future__ import annotations

import torch

from arsvt_tpu_torch.models.heads import (
    ClassifierConfig,
    apply_classifier,
    init_classifier,
)
from arsvt_tpu_torch.models.vit import (
    BackboneConfig,
    apply_backbone,
    init_backbone,
)


def init_image_classifier(backbone_cfg: BackboneConfig, num_classes: int,
                          seed: int = 0, *, device="cpu") -> dict:
    head_cfg = ClassifierConfig(num_classes=num_classes,
                                distilled=backbone_cfg.distilled)
    return {
        "backbone": init_backbone(backbone_cfg, seed, device=device),
        "classifier": init_classifier(head_cfg, backbone_cfg.embed_dim,
                                      device=device),
    }


def apply_image_classifier(params: dict, images: torch.Tensor,
                           backbone_cfg: BackboneConfig,
                           num_classes: int, *, train: bool = False,
                           rng=None, remat: bool = False,
                           remat_policy: str = "full") -> torch.Tensor:
    """images (B, H, W, C) in the compute dtype -> logits (B, C) fp32;
    `train`, `rng`, `remat` and `remat_policy` as `apply_backbone`'s."""
    tokens = apply_backbone(params["backbone"], images, backbone_cfg,
                            train=train, rng=rng, remat=remat,
                            remat_policy=remat_policy)
    head_cfg = ClassifierConfig(num_classes=num_classes,
                                distilled=backbone_cfg.distilled)
    return apply_classifier(params["classifier"], tokens, head_cfg)
