"""Full object detector = backbone + DETR head (+ triplet projection);
counterpart of ``arsvt_tpu/models/detector.py``.

Backbone tokens → strip the special tokens → DETR decoder head. With
`return_features` the CLS feature also goes through the L2-normalised
triplet projection that the metric-learning loss reads. A training
forward's `rng` splits as JAX's key: ``rng.fold_in(0)`` for the backbone,
``rng.fold_in(1)`` for the head.
"""

from __future__ import annotations

import dataclasses

import torch

from arsvt_tpu_torch.models.heads import (
    DetrHeadConfig,
    apply_detr_head,
    init_detr_head,
)
from arsvt_tpu_torch.models.vit import (
    BackboneConfig,
    _linear_init,
    apply_backbone,
    init_backbone,
)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    backbone: BackboneConfig = BackboneConfig()
    head: DetrHeadConfig = DetrHeadConfig()
    triplet_dim: int = 256


def init_detector(cfg: DetectorConfig, seed: int = 0, *,
                  device="cpu") -> dict:
    """Seeded fp32 init with the JAX tree's keys and per-layer shapes; the
    backbone, head and projection each draw from their own generator
    (seeds `seed`, `seed + 1`, `seed + 2`)."""
    d = cfg.backbone.embed_dim
    gen = torch.Generator().manual_seed(seed + 2)
    return {
        "backbone": init_backbone(cfg.backbone, seed, device=device),
        "detr": init_detr_head(cfg.head, d, seed + 1, device=device),
        "triplet_proj": {
            "kernel": _linear_init(gen, d, (d, cfg.triplet_dim)).to(device),
            "bias": torch.zeros(cfg.triplet_dim, device=device),
        },
    }


def apply_detector(params: dict, images: torch.Tensor, cfg: DetectorConfig,
                   *, train: bool = False, rng=None,
                   return_features: bool = False, return_aux: bool = False,
                   remat: bool = False, remat_policy: str = "full"):
    """images (B, H, W, C) in the compute dtype -> {'class_logits':
    (B, Q, C+1) fp32, 'boxes_cxcywh': (B, Q, 4) fp32}, plus 'aux' with
    `return_aux` (when the decoder has two layers or more); with
    `return_features`, (outputs, L2-normalised triplet features (B, T)
    fp32). `train` with an `rng` (``core/prng.py::Rng``) applies the
    configs' dropout; `remat` and `remat_policy` rematerialise the
    backbone's blocks, as `apply_backbone`'s (the DETR head is not
    rematerialised, as in JAX)."""
    tokens = apply_backbone(params["backbone"], images, cfg.backbone,
                            train=train,
                            rng=None if rng is None else rng.fold_in(0),
                            remat=remat, remat_policy=remat_policy)
    memory = tokens[:, cfg.backbone.num_special_tokens:]
    head_out = apply_detr_head(params["detr"], memory, cfg.head,
                               cfg.backbone.embed_dim, train=train,
                               rng=None if rng is None else rng.fold_in(1),
                               return_aux=return_aux)
    if return_aux:
        outputs, aux = head_out
        if aux is not None:
            outputs = dict(outputs, aux=aux)
    else:
        outputs = head_out
    if not return_features:
        return outputs
    proj = params["triplet_proj"]
    feat = torch.matmul(tokens[:, 0].float(), proj["kernel"].float()) + \
        proj["bias"].float()
    feat = feat / torch.clamp(feat.norm(dim=-1, keepdim=True), min=1e-12)
    return outputs, feat
