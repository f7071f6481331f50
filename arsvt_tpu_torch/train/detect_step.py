"""Train and eval steps for the DETR detector (counterpart of
``arsvt_tpu/train/detect_step.py::make_detector_step_fns``).

A train step: images -> `to_unit_float` -> `augment_input_cast` and the
detection augmentation (when the config augments; boxes and their
validity move with the images; the config's warp and interpolation) ->
cast of the parameters to the compute dtype -> forward (backbone + DETR
decoder with aux outputs + triplet features, dropout drawn from
``Rng(seed, step, microbatch)``, the backbone's blocks rematerialised
under ``remat_policy`` when ``remat``) -> Hungarian matching of the
final and every aux layer in one solve (``loss_cfg.matcher.backend``: on
the default ``"device"`` route one launch of ``csrc/lap.cu`` on the card,
no copy to the host; on ``"scipy"`` one copy of the stacked costs to the
host and one of the indices back) -> `detection_loss` plus the summed
aux-layer losses -> backward, accumulated over ``grad_accum``
microbatches -> one AdamW update -> step + 1. Metrics stay on the
device.

The state is a dict {"params", "opt_state", "step"} updated in place, as
the classifier step's.

Under a `mesh` a rank runs its part of the global step as the classifier
step's rank does (``train/train_step.py``): its slice's microbatches, the
global microbatch's augmentation draws cut to its rows, its dropout
masks at its global rows and heads, its parameter shards; the losses
take their normalisers and the triplet batch over the data axis
(``objectives/detection_loss.py``), so the ranks' gradients and metrics
sum to the one-process step's.
"""

from __future__ import annotations

import torch

from arsvt_tpu_torch.core.dtypes import Policy, to_unit_float, tree_leaves
from arsvt_tpu_torch.core.prng import Rng, generator
from arsvt_tpu_torch.data.augment import (
    DetectionAugmentConfig,
    augment_input_cast,
    check_detection_supported,
    detection_train_augment,
    draw_detection_augment,
    eval_preprocess,
)
from arsvt_tpu_torch.models.detector import apply_detector, init_detector
from arsvt_tpu_torch.objectives.detection_loss import (
    DetectionLossConfig,
    detection_loss,
)
from arsvt_tpu_torch.objectives.matcher import match_layers
from arsvt_tpu_torch.ops.remat import check_policy
from arsvt_tpu_torch.parallel.sharding import shard_params
from arsvt_tpu_torch.parallel.tensor_parallel import model_parallel
from arsvt_tpu_torch.train.accum import accumulated_value_and_grad
from arsvt_tpu_torch.train.config import TrainConfig, resolve_detector
from arsvt_tpu_torch.train.optim import fused_adamw_update, init_opt_state
from arsvt_tpu_torch.train.train_step import (
    DataPlace,
    _to_device,
    mesh_device,
    num_heads_for,
)


def make_detector_step_fns(cfg: TrainConfig, device=None, *, mesh=None):
    """Build (init_fn, train_step, eval_step) for the detection task.

    init_fn(seed=None) -> state, seeded from `cfg.seed` by default.
    train_step(state, batch, step_seed=None, *, draws=None) -> (state,
        {"loss", "loss_ce", "loss_bbox", "loss_giou", "cardinality_error",
        "loss_triplet", "grad_norm"}); microbatch a draws its augmentation
        from a CPU generator seeded with (step_seed or cfg.seed,
        state["step"], a), unless `draws` gives one `DetectionDraws` per
        microbatch, and its dropout from ``Rng`` of the same three.
    eval_step(params, batch) -> {"loss", "loss_ce", "loss_bbox",
        "loss_giou", "cardinality_error", "total", "count", "outputs"},
        pad rows (batch "valid" 0) weighted out.
    batch = {"image": (B, H, W, C) uint8 or [0, 1] float, "boxes": (B, M,
    4) normalised xyxy, "labels": (B, M) int, "mask": (B, M) bool[,
    "valid": (B,) 0/1]}, numpy arrays or tensors.

    `device` None means the card; without one that raises unless the
    caller passes device="cpu". `mesh`: the rank's part of the step, as
    `make_classifier_step_fns`'s (`draws` are the global microbatches').
    """
    dev = mesh_device(mesh, device)
    tp = None if mesh is None else mesh.model_shard()
    if cfg.task != "detect":
        raise ValueError(f"make_detector_step_fns needs task='detect', got "
                         f"{cfg.task!r}")
    det_cfg = resolve_detector(cfg)
    check_policy(cfg.remat, cfg.remat_policy)
    compute_dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    policy = Policy(compute_dtype=compute_dtype)
    loss_cfg = DetectionLossConfig(
        num_classes=det_cfg.head.num_classes,
        background_weight=cfg.background_weight, w_ce=cfg.w_ce,
        w_bbox=cfg.w_bbox, w_giou=cfg.w_giou, w_triplet=cfg.w_triplet,
        triplet_margin=cfg.triplet_margin)
    if cfg.augment not in ("detection", "none"):
        raise ValueError(f"unknown augment mode {cfg.augment!r} for detect "
                         "(expected 'detection' or 'none')")
    aug_cfg = None
    if cfg.augment == "detection":
        aug_cfg = DetectionAugmentConfig(
            image_size=det_cfg.backbone.image_size,
            warp_variant=cfg.warp_variant)
        check_detection_supported(aug_cfg)

    def init_fn(seed: int | None = None) -> dict:
        params = init_detector(det_cfg, cfg.seed if seed is None else seed,
                               device=dev)
        if mesh is not None:
            params = shard_params(params, mesh, num_heads_for(cfg))
        return {"params": params, "opt_state": init_opt_state(params),
                "step": 0}

    def layer_losses(outputs, feats, targets, group=None):
        """Final-layer loss and parts plus the aux layers' totals, every
        layer matched in one `match_layers` call; the parts' "total" is
        the rank's share of the summed loss (`detection_loss`)."""
        aux = outputs.pop("aux", None)
        layers = [(outputs["class_logits"], outputs["boxes_cxcywh"])]
        if aux is not None:
            layers += list(zip(aux["class_logits"].unbind(0),
                               aux["boxes_cxcywh"].unbind(0)))
        assignments = match_layers(layers, targets["labels"],
                                   targets["boxes"], targets["mask"],
                                   loss_cfg.matcher)
        total, parts = detection_loss(outputs, targets, loss_cfg, feats,
                                      assignment=assignments[0], group=group)
        share = parts["total"]
        for (cl, bx), asg in zip(layers[1:], assignments[1:]):
            aux_total = detection_loss(
                {"class_logits": cl, "boxes_cxcywh": bx}, targets, loss_cfg,
                assignment=asg, group=group)[0]
            total, share = total + aux_total, share + aux_total
        return total, {**parts, "total": share}

    def train_step(state: dict, batch, step_seed: int | None = None, *,
                   draws=None):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        seed = cfg.seed if step_seed is None else step_seed
        step = state["step"]
        data = {k: _to_device(batch[k], dev)
                for k in ("image", "boxes", "labels", "mask")}
        place = DataPlace(mesh, batch, data["image"].shape[0],
                          cfg.grad_accum)

        def loss_fn(mb, a):
            compute_params = policy.cast_to_compute(params)
            images = to_unit_float(mb["image"])
            boxes, mask = mb["boxes"].float(), mb["mask"].bool()
            if aug_cfg is not None:
                d = (draws[a] if draws is not None else
                     draw_detection_augment(generator(seed, step, a),
                                            place.rows, aug_cfg))
                images, boxes, mask = detection_train_augment(
                    augment_input_cast(images), boxes, mask,
                    place.draws(d).to(dev), aug_cfg)
            outputs, feats = apply_detector(
                compute_params, images.to(compute_dtype), det_cfg,
                train=True, rng=Rng(seed, step, a, row0=place.row0),
                return_features=True, return_aux=cfg.aux_loss,
                remat=cfg.remat, remat_policy=cfg.remat_policy)
            targets = {"boxes": boxes, "labels": mb["labels"], "mask": mask}
            return layer_losses(outputs, feats, targets, place.group)

        with model_parallel(tp):
            (_, parts), grads = accumulated_value_and_grad(
                loss_fn, leaves, data, cfg.grad_accum)
        grads = place.sum(grads)
        parts = dict(zip(parts, place.sum(list(parts.values()))))
        loss = parts.pop("total")
        params, opt_state, grad_norm = fused_adamw_update(
            cfg, grads, state["opt_state"], params, mesh)
        new_state = {"params": params, "opt_state": opt_state,
                     "step": step + 1}
        return new_state, {"loss": loss, **parts, "grad_norm": grad_norm}

    def eval_step(params, batch) -> dict:
        place = DataPlace(mesh, batch, 1, 1)
        with model_parallel(tp):
            metrics = _eval(params, batch, place.group)
        if place.group is None:
            return metrics
        keys = [k for k in metrics if k != "outputs"]
        summed = place.sum([metrics[k] for k in keys])
        return {**dict(zip(keys, summed)), "outputs": metrics["outputs"]}

    def _eval(params, batch, group) -> dict:
        with torch.inference_mode():
            compute_params = policy.cast_to_compute(params)
            images = to_unit_float(_to_device(batch["image"], dev))
            if aug_cfg is not None:
                images = eval_preprocess(images,
                                         size=det_cfg.backbone.image_size)
            outputs = apply_detector(compute_params,
                                     images.to(compute_dtype), det_cfg)
            targets = {"boxes": _to_device(batch["boxes"], dev).float(),
                       "labels": _to_device(batch["labels"], dev),
                       "mask": _to_device(batch["mask"], dev).bool()}
            valid = batch.get("valid")
            if valid is not None:
                valid = _to_device(valid, dev)
            total, parts = detection_loss(outputs, targets, loss_cfg, None,
                                          image_weight=valid, group=group)
            count = (torch.full((), images.shape[0], dtype=torch.int32,
                                device=dev) if valid is None
                     else valid.to(torch.int32).sum())
            return {"loss": total, **parts, "count": count,
                    "outputs": outputs}

    return init_fn, train_step, eval_step
