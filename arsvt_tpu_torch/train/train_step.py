"""Train and eval steps for the classifier (counterpart of
``arsvt_tpu/train/train_step.py::make_classifier_step_fns``).

A train step: uint8 images -> `to_unit_float` -> `augment_input_cast`
(bf16 under ``ARSVT_AUGMENT_BF16``) -> crop/flip, RandAugment with
``augment="randaugment"``, normalize (when the config augments) -> the
compute dtype -> mixup (``mixup_alpha > 0``: soft labels) -> cast of every
floating parameter to the compute dtype (its backward rounds the weight
gradients to that dtype and feeds fp32 master gradients, as JAX's cast VJP
does) -> forward, its blocks rematerialised under ``remat_policy`` when
``remat`` -> CE with label smoothing -> backward, accumulated over
``grad_accum`` microbatches -> one AdamW update -> step + 1. Metrics stay
on the device; accuracy takes the argmax of mixed labels, as JAX's.

PyTorch runs eagerly, so the step is a Python function, not a compiled
one. The state is a dict {"params", "opt_state", "step"} updated in place
(parameters and Adam moments; the returned dict is new), which keeps one
copy of the fp32 master weights and moments on the card.

The augmentation and mixup of microbatch a draw from a CPU generator
seeded with (seed, step, a); residual and positional dropout from
``Rng(seed, step, a)``. The JAX package's two no-remat opt-ins route the
step from the environment, as there (``ops/dispatch.py``):
``ARSVT_ATTN_SAVE_PROBS`` takes the save-probs attention kernels in the
training forward and backward, ``ARSVT_ENABLE_FUSED_MLP`` the fused-MLP
kernels in training and eval; attention dropout runs in the kernels of
either route.

DeiT distillation (``distillation="hard"`` or ``"soft"``, a distilled
student): a frozen teacher, loaded from its own checkpoint by
`_load_teacher` and cast to the compute dtype once, sees the student's
input (after the augmentation, the cast and mixup) without dropout and
under ``torch.no_grad()``, so it saves nothing for a backward. The CLS
head takes CE with the labels, the DIST head CE against the teacher's
argmax (hard) or the temperature-scaled KL term (soft), mixed as
``(1 - alpha) * base + alpha * dloss``; accuracy is taken on the mean of
the two heads and ``loss_distill`` joins the metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from arsvt_tpu_torch.core.dtypes import Policy, to_unit_float, tree_leaves
from arsvt_tpu_torch.core.prng import Rng, generator
from arsvt_tpu_torch.data.augment import (
    ClassifyAugmentConfig,
    augment_input_cast,
    classification_train_augment,
    draw_classification_augment,
    eval_preprocess,
)
from arsvt_tpu_torch.evaluation.classify import resolve_device
from arsvt_tpu_torch.models.classifier import (
    apply_image_classifier,
    init_image_classifier,
)
from arsvt_tpu_torch.objectives.classification import (
    accuracy_top1,
    confusion_matrix,
    draw_mixup,
    mixup,
    softmax_cross_entropy,
)
from arsvt_tpu_torch.ops.remat import check_policy
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
    train_step(state, batch, step_seed=None, *, draws=None,
        mixup_draws=None) -> (state, {"loss", "accuracy", "grad_norm"}
        [+ "loss_distill" when distilling]);
        the augmentation, then the mixup, of microbatch a are drawn from a
        CPU generator seeded with (step_seed or cfg.seed, state["step"],
        a), unless `draws` gives one `CropFlipDraws` and `mixup_draws` one
        `MixupDraws` per microbatch; its dropout from ``Rng`` of the same
        three.
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
    backbone_cfg = resolve_backbone(cfg)
    check_policy(cfg.remat, cfg.remat_policy)
    compute_dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    policy = Policy(compute_dtype=compute_dtype)
    num_classes = cfg.num_classes

    # DeiT distillation: the DIST head learns from a frozen teacher, the
    # CLS head from the labels
    distilling = cfg.distillation != "none"
    teacher = teacher_bb = None
    if distilling:
        if cfg.distillation not in ("hard", "soft"):
            raise ValueError(
                f"distillation must be 'none'|'hard'|'soft', "
                f"got {cfg.distillation!r}"
            )
        if not backbone_cfg.distilled:
            raise ValueError(
                "distillation needs a distilled (DeiT) preset — the DIST "
                "token/head is the distillation surface"
            )
        if not cfg.distill_teacher:
            raise ValueError(
                "distillation='hard'|'soft' requires distill_teacher "
                "(checkpoint dir of a trained classifier)"
            )
        teacher, teacher_bb = _load_teacher(cfg, backbone_cfg, dev)
        # cast once here, where JAX casts every microbatch: the weights
        # never change, so each cast gives the same bits
        teacher = policy.cast_to_compute(teacher)

    aug_cfg = None
    if cfg.augment in ("crop_flip", "randaugment"):
        aug_cfg = ClassifyAugmentConfig(
            image_size=backbone_cfg.image_size,
            rand_augment=cfg.augment == "randaugment",
            warp_variant=cfg.warp_variant,
        )
    elif cfg.augment != "none":
        raise ValueError(f"unknown augment mode {cfg.augment!r} for classify")

    def init_fn(seed: int | None = None) -> TrainState:
        params = init_image_classifier(
            backbone_cfg, num_classes, cfg.seed if seed is None else seed,
            device=dev)
        return {"params": params, "opt_state": init_opt_state(params),
                "step": 0}

    def train_step(state: TrainState, batch, step_seed: int | None = None,
                   *, draws=None, mixup_draws=None):
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
            n = images.shape[0]
            gen = generator(seed, state["step"], a)
            if aug_cfg is not None:
                d = (draws[a] if draws is not None else
                     draw_classification_augment(gen, n, aug_cfg))
                images = classification_train_augment(
                    augment_input_cast(images), d.to(dev), aug_cfg)
            images = images.to(compute_dtype)
            labels = mb["label"]
            if cfg.mixup_alpha > 0.0:
                m = (mixup_draws[a] if mixup_draws is not None else
                     draw_mixup(gen, n, cfg.mixup_alpha))
                images, labels = mixup(images, labels, m,
                                       num_classes=num_classes)
            hard = labels if labels.dim() == 1 else labels.argmax(dim=-1)
            logits = apply_image_classifier(
                compute_params, images, backbone_cfg, num_classes,
                train=True, rng=Rng(seed, state["step"], a),
                remat=cfg.remat, remat_policy=cfg.remat_policy,
                return_heads=distilling)
            if not distilling:
                loss = softmax_cross_entropy(
                    logits, labels, num_classes=num_classes,
                    label_smoothing=cfg.label_smoothing)
                return loss, {"accuracy": accuracy_top1(logits, hard)}
            logits_cls, logits_dist = logits
            base = softmax_cross_entropy(
                logits_cls, labels, num_classes=num_classes,
                label_smoothing=cfg.label_smoothing)
            with torch.no_grad():
                t_logits = apply_image_classifier(
                    teacher, images, teacher_bb, num_classes)
            dloss = distill_loss(logits_dist, t_logits, cfg.distillation,
                                 cfg.distill_temperature, num_classes)
            alpha = cfg.distill_alpha
            loss = (1.0 - alpha) * base + alpha * dloss
            return loss, {
                "accuracy": accuracy_top1((logits_cls + logits_dist) / 2.0,
                                          hard),
                "loss_distill": dloss,
            }

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


def distill_loss(logits_dist, t_logits, mode: str, temperature: float,
                 num_classes: int) -> torch.Tensor:
    """The DIST head's loss against the teacher's fp32 logits: CE against
    their argmax, unsmoothed ("hard"), or -(t^2) mean(sum(p_t log
    softmax(logits_dist / t))) with p_t = softmax(t_logits / t) ("soft":
    KL(p_t || p_s) up to p_t's constant entropy; t^2 keeps the gradient's
    scale independent of t)."""
    if mode == "hard":
        return softmax_cross_entropy(logits_dist, t_logits.argmax(dim=-1),
                                     num_classes=num_classes)
    t = temperature
    logp = torch.log_softmax(logits_dist / t, dim=-1)
    p_t = torch.softmax(t_logits / t, dim=-1)
    return -(t * t) * (p_t * logp).sum(dim=-1).mean()


def _load_teacher(cfg: TrainConfig, student_bb, device):
    """The frozen distillation teacher from its own checkpoint, on
    `device`: its architecture from the config stored there (an imported
    teacher keeps its ln_eps), its params only (its Adam moments are never
    read). Returns (params, backbone_cfg)."""
    from arsvt_tpu_torch.train.checkpoint import (
        load_params_for_eval,
        peek_config,
    )

    tcfg = peek_config(cfg.distill_teacher)
    teacher_bb = resolve_backbone(tcfg)
    if tcfg.num_classes != cfg.num_classes:
        raise ValueError(
            f"teacher has {tcfg.num_classes} classes, student expects "
            f"{cfg.num_classes}"
        )
    if teacher_bb.image_size != student_bb.image_size:
        raise ValueError(
            f"teacher image_size {teacher_bb.image_size} != student "
            f"{student_bb.image_size}"
        )
    params_like = init_image_classifier(teacher_bb, tcfg.num_classes,
                                        device=device)
    params, _ = load_params_for_eval(cfg.distill_teacher, tcfg, params_like)
    return params, teacher_bb
