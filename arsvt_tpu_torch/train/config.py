"""One config for train and eval (counterpart of ``arsvt_tpu/train/config.py``).

`TrainConfig` has every field of the JAX dataclass with the same names and
defaults, so JSON written by either package reads in the other.
`resolve_backbone` and `resolve_detector` turn a config into the model's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from arsvt_tpu_torch.models.detector import DetectorConfig
from arsvt_tpu_torch.models.heads import DetrHeadConfig
from arsvt_tpu_torch.models.vit import BackboneConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model
    preset: str = "vit_tiny_16_224"          # models/registry.py key
    task: str = "classify"                   # "classify" | "detect"
    num_classes: int = 6                     # recycling taxonomy
    # data
    data_dir: str = ""                       # COCO-format root ("" = synthetic)
    batch_size: int = 512                    # global batch
    image_size: int = 0                      # 0 = preset default
    canvas: int = 256                        # host letterbox size (static shape)
    augment: str = "none"                    # "none"|"crop_flip"|"randaugment"|"detection"
    warp_variant: str = ""                   # bilinear warp strategy (RandAugment)
    # optimization
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip_norm: float = 1.0
    schedule: str = "cosine"                 # "cosine" | "constant" | "plateau"
    warmup_steps: int = 500
    total_steps: int = 10_000
    min_lr_ratio: float = 1e-3
    # plateau schedule
    plateau_factor: float = 0.7
    plateau_patience: int = 1
    plateau_min_lr: float = 1e-7
    plateau_threshold: float = 1e-3
    # regularisation
    label_smoothing: float = 0.0
    mixup_alpha: float = 0.0                 # 0 = off
    # attention-prob dropout: None = the preset's value, 0.0 = off
    attn_dropout: float | None = None
    ln_eps: float = 0.0                      # 0 = preset default
    # distillation
    distillation: str = "none"               # "none" | "hard" | "soft"
    distill_teacher: str = ""
    distill_alpha: float = 0.5
    distill_temperature: float = 3.0
    # precision / parallelism
    bf16: bool = True
    mesh_data: int = -1
    mesh_model: int = 1
    # split the global batch into k microbatches inside one step
    grad_accum: int = 1
    remat: bool = False
    remat_policy: str = "full"
    # JAX's choice of its one-pass AdamW kernel, kept so that configs read
    # in both packages; the port runs ops/fused_adamw.py for either value
    fused_adamw: bool = False
    # bookkeeping
    seed: int = 0
    log_every: int = 100
    eval_every: int = 1000
    checkpoint_every: int = 1000
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    # detection loss weights
    w_ce: float = 1.0
    w_bbox: float = 5.0
    w_giou: float = 2.0
    w_triplet: float = 0.6
    background_weight: float = 0.1
    triplet_margin: float = 0.3
    max_objects: int = 25
    aux_loss: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def with_overrides(self, **kwargs: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kwargs)


def resolve_backbone(cfg: TrainConfig) -> BackboneConfig:
    from arsvt_tpu_torch.models.registry import get_preset

    bb = get_preset(cfg.preset)
    if cfg.image_size and cfg.image_size != bb.image_size:
        bb = dataclasses.replace(bb, image_size=cfg.image_size)
    if cfg.attn_dropout is not None and cfg.attn_dropout != bb.attn_dropout:
        bb = dataclasses.replace(bb, attn_dropout=cfg.attn_dropout)
    if cfg.ln_eps and cfg.ln_eps != bb.ln_eps:
        bb = dataclasses.replace(bb, ln_eps=cfg.ln_eps)
    return bb


def resolve_detector(cfg: TrainConfig) -> DetectorConfig:
    """The detector of `cfg.preset` (a detector preset, or a backbone
    preset under the default DETR head) with the config's num_classes,
    attn_dropout and ln_eps overrides, as JAX's."""
    from arsvt_tpu_torch.models.registry import DETECTOR_PRESETS, get_preset

    if cfg.preset in DETECTOR_PRESETS:
        det = DETECTOR_PRESETS[cfg.preset]
    else:
        det = DetectorConfig(backbone=get_preset(cfg.preset),
                             head=DetrHeadConfig(num_classes=cfg.num_classes))
    if det.head.num_classes != cfg.num_classes:
        det = dataclasses.replace(det, head=dataclasses.replace(
            det.head, num_classes=cfg.num_classes))
    if cfg.attn_dropout is not None:
        det = dataclasses.replace(
            det,
            backbone=dataclasses.replace(det.backbone,
                                         attn_dropout=cfg.attn_dropout),
            head=dataclasses.replace(det.head,
                                     attn_dropout=cfg.attn_dropout))
    if cfg.ln_eps:
        det = dataclasses.replace(
            det,
            backbone=dataclasses.replace(det.backbone, ln_eps=cfg.ln_eps),
            head=dataclasses.replace(det.head, ln_eps=cfg.ln_eps))
    return det


def input_canvas(cfg: TrainConfig) -> int:
    """Host-pipeline letterbox size for this config: the augmentation
    canvas when the step augments, else the model's own size."""
    if cfg.augment != "none":
        return cfg.canvas
    if cfg.image_size:
        return cfg.image_size
    if cfg.task == "detect":
        return resolve_detector(cfg).backbone.image_size
    return resolve_backbone(cfg).image_size


# The JAX package's named train presets.
TRAIN_PRESETS: dict[str, TrainConfig] = {
    "smoke": TrainConfig(
        preset="vit_test_8_32", batch_size=16, total_steps=30,
        warmup_steps=5, log_every=10, eval_every=10**9,
        checkpoint_every=10**9, bf16=False,
    ),
    "vit_tiny_eval": TrainConfig(preset="vit_tiny_16_224", batch_size=8),
    "vit_base_finetune": TrainConfig(
        preset="vit_base_16_224", batch_size=512, learning_rate=3e-4,
        warmup_steps=500, total_steps=20_000, label_smoothing=0.1,
        augment="crop_flip",
    ),
    "vit_base_bf16_flash": TrainConfig(
        preset="vit_base_16_224", batch_size=512, bf16=True, grad_accum=16,
    ),
    "vit_large_384": TrainConfig(
        preset="vit_large_16_384", batch_size=256, mixup_alpha=0.2,
        label_smoothing=0.1, remat=True,
        augment="randaugment", canvas=416,
    ),
    # the reference's own detector training config: the detection
    # augmentation on a 224 canvas, dropout 0.1 including the attention
    # probabilities (in-kernel)
    "deit_detector_ref": TrainConfig(
        preset="deit_detector_ref", task="detect", batch_size=32,
        learning_rate=1e-4, weight_decay=1e-4, schedule="plateau",
        max_objects=25, augment="detection", canvas=224,
        attn_dropout=0.1,
    ),
}
