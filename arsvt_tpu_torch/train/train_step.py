"""Train and eval steps for the classifier (counterpart of
``arsvt_tpu/train/train_step.py::make_classifier_step_fns``).

A train step: uint8 images -> `to_unit_float` -> crop/flip + normalize
(when the config augments) -> cast of every floating parameter to the
compute dtype (its backward rounds the weight gradients to that dtype and
feeds fp32 master gradients, as JAX's cast VJP does) -> forward -> CE ->
backward, accumulated over ``grad_accum`` microbatches -> one AdamW update
-> step + 1. Metrics stay on the device.

PyTorch runs eagerly, so the step is a Python function, not a compiled
one. The state is a dict {"params", "opt_state", "step"} updated in place
(parameters and Adam moments; the returned dict is new), which keeps one
copy of the fp32 master weights and moments on the card.

Residual and positional dropout draw from ``Rng(seed, step,
microbatch)``. The JAX package's two no-remat opt-ins route the step
from the environment, as there (``ops/dispatch.py``):
``ARSVT_ATTN_SAVE_PROBS`` takes the save-probs attention kernels in the
training forward and backward, ``ARSVT_ENABLE_FUSED_MLP`` the fused-MLP
kernels in training and eval; attention dropout runs in the kernels of
either route. Not ported yet (ROADMAP Queue A): distillation, mixup,
RandAugment and remat (the ViT-L recipe).
"""

from __future__ import annotations

import numpy as np
import torch

from arsvt_tpu_torch.core.dtypes import Policy, to_unit_float, tree_leaves
from arsvt_tpu_torch.core.prng import Rng, generator
from arsvt_tpu_torch.data.augment import (
    ClassifyAugmentConfig,
    classification_train_augment,
    draw_classification_augment,
    eval_preprocess,
)
from arsvt_tpu_torch.evaluation.classify import resolve_device
from arsvt_tpu_torch.models.classifier import (
    apply_image_classifier,
    init_image_classifier,
)
from arsvt_tpu_torch.models.vit import check_train_supported
from arsvt_tpu_torch.objectives.classification import (
    accuracy_top1,
    confusion_matrix,
    softmax_cross_entropy,
)
from arsvt_tpu_torch.train.accum import accumulated_value_and_grad
from arsvt_tpu_torch.train.config import TrainConfig, resolve_backbone
from arsvt_tpu_torch.train.optim import fused_adamw_update, init_opt_state

# {"params": tree, "opt_state": dict, "step": int}
TrainState = dict


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def make_classifier_step_fns(cfg: TrainConfig, device=None):
    """Build (init_fn, train_step, eval_step) for classification.

    init_fn(seed=None) -> state, seeded from `cfg.seed` by default.
    train_step(state, batch, step_seed=None, *, draws=None) ->
        (state, {"loss", "accuracy", "grad_norm"}); the augmentation of
        microbatch a is drawn from a CPU generator seeded with (step_seed
        or cfg.seed, state["step"], a), unless `draws` gives one
        `CropFlipDraws` per microbatch; its dropout from ``Rng`` of the
        same three.
    eval_step(params, batch) -> {"loss", "correct", "count", "confusion"}.
    batch = {"image": (B, H, W, C) uint8 or float, "label": (B,) int[,
    "valid": (B,) 0/1 for eval]}, numpy arrays or tensors.

    `device` None means the card; without one that raises unless the
    caller passes device="cpu".
    """
    dev = resolve_device(device)
    if cfg.task != "classify":
        raise ValueError(f"make_classifier_step_fns needs task='classify', "
                         f"got {cfg.task!r}")
    if cfg.distillation != "none":
        raise NotImplementedError(
            "distillation is not ported yet (ROADMAP Queue A)")
    if cfg.mixup_alpha > 0.0:
        raise NotImplementedError(
            "mixup is not ported yet (ROADMAP Queue A, the ViT-L "
            "recipe)")
    backbone_cfg = resolve_backbone(cfg)
    check_train_supported(backbone_cfg, remat=cfg.remat)
    compute_dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    policy = Policy(compute_dtype=compute_dtype)
    num_classes = cfg.num_classes

    aug_cfg = None
    if cfg.augment in ("crop_flip", "randaugment"):
        aug_cfg = ClassifyAugmentConfig(
            image_size=backbone_cfg.image_size,
            rand_augment=cfg.augment == "randaugment",
            warp_variant=cfg.warp_variant,
        )
        if aug_cfg.rand_augment:
            raise NotImplementedError(
                "RandAugment is not ported yet (ROADMAP Queue A, the "
                "ViT-L recipe)")
    elif cfg.augment != "none":
        raise ValueError(f"unknown augment mode {cfg.augment!r} for classify")

    def init_fn(seed: int | None = None) -> TrainState:
        params = init_image_classifier(
            backbone_cfg, num_classes, cfg.seed if seed is None else seed,
            device=dev)
        return {"params": params, "opt_state": init_opt_state(params),
                "step": 0}

    def train_step(state: TrainState, batch, step_seed: int | None = None,
                   *, draws=None):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        seed = cfg.seed if step_seed is None else step_seed
        data = {"image": _to_device(batch["image"], dev),
                "label": _to_device(batch["label"], dev)}

        def loss_fn(mb, a):
            compute_params = policy.cast_to_compute(params)
            images = to_unit_float(mb["image"])
            if aug_cfg is not None:
                d = (draws[a] if draws is not None else
                     draw_classification_augment(
                         generator(seed, state["step"], a),
                         images.shape[0], aug_cfg))
                images = classification_train_augment(images, d.to(dev),
                                                      aug_cfg)
            logits = apply_image_classifier(
                compute_params, images.to(compute_dtype), backbone_cfg,
                num_classes, train=True, rng=Rng(seed, state["step"], a))
            labels = mb["label"]
            loss = softmax_cross_entropy(
                logits, labels, num_classes=num_classes,
                label_smoothing=cfg.label_smoothing)
            hard = labels if labels.dim() == 1 else labels.argmax(dim=-1)
            return loss, {"accuracy": accuracy_top1(logits, hard)}

        (loss, aux), grads = accumulated_value_and_grad(
            loss_fn, leaves, data, cfg.grad_accum)
        params, opt_state, grad_norm = fused_adamw_update(
            cfg, grads, state["opt_state"], params)
        new_state = {"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **aux, "grad_norm": grad_norm}

    def eval_step(params, batch) -> dict:
        with torch.inference_mode():
            compute_params = policy.cast_to_compute(params)
            images = to_unit_float(_to_device(batch["image"], dev))
            if aug_cfg is not None:
                images = eval_preprocess(images, size=backbone_cfg.image_size)
            logits = apply_image_classifier(
                compute_params, images.to(compute_dtype), backbone_cfg,
                num_classes)
            labels = _to_device(batch["label"], dev)
            preds = logits.argmax(dim=-1)
            valid = batch.get("valid")
            hit = (preds == labels).to(torch.int32)
            if valid is None:
                correct = hit.sum()
                count = torch.full((), labels.shape[0], dtype=torch.int32,
                                   device=dev)
            else:
                valid = _to_device(valid, dev)
                correct = (hit * valid.to(torch.int32)).sum()
                count = valid.to(torch.int32).sum()
            return {
                "loss": softmax_cross_entropy(
                    logits, labels, num_classes=num_classes, valid=valid),
                "correct": correct,
                "count": count,
                "confusion": confusion_matrix(preds, labels, num_classes,
                                              valid=valid),
            }

    return init_fn, train_step, eval_step
