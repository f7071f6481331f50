"""DETR losses: weighted CE + L1 + GIoU + cardinality (+ triplet)
(counterpart of ``arsvt_tpu/objectives/detection_loss.py``).

- labels: CE over C+1 classes, background weight 0.1; unmatched queries
  learn background;
- boxes: L1 on cxcywh + GIoU on xyxy between matched pairs, normalised by
  the (clamped) number of matched boxes;
- cardinality: L1 between the count of non-background predictions and of
  targets, a metric with no gradient;
- triplet: batch-hard margin triplet on image-level features with
  dominant-class labels.

The assignment comes from ``objectives/matcher.py`` on the route of
``cfg.matcher.backend`` (by default JAX's Jonker-Volgenant on the
tensors' device, ``csrc/lap.cu`` on the card); a caller that matched
several decoder layers at once passes each layer's `assignment` in.

Under a data mesh (`group`, the data axis's process group) the batch is a
rank's rows of the global microbatch, and every value JAX reduces over
the global microbatch is reduced over the group: the CE weight sum and
the matched-box count (JAX ``detection_loss.py:99, 116``), the
cardinality's image count, and the triplet loss's batch (the features,
labels and validity are gathered, the rank's own rows live). Each term is
then the rank's numerator over the global denominator, so the terms
summed over the ranks are the one-process values, and so are their
gradients.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed

from arsvt_tpu_torch.objectives.boxes import (
    cxcywh_to_xyxy,
    elementwise_giou,
    xyxy_to_cxcywh,
)
from arsvt_tpu_torch.objectives.matcher import MatcherConfig, match
from arsvt_tpu_torch.objectives.triplet import batch_hard_triplet_loss
from arsvt_tpu_torch.parallel.data_parallel import gather_rows, total


@dataclasses.dataclass(frozen=True)
class DetectionLossConfig:
    num_classes: int = 6
    background_weight: float = 0.1
    w_ce: float = 1.0
    w_bbox: float = 5.0
    w_giou: float = 2.0
    w_triplet: float = 0.6
    triplet_margin: float = 0.3
    matcher: MatcherConfig = MatcherConfig()


def detection_loss(outputs, targets, cfg: DetectionLossConfig,
                   triplet_features=None, image_weight=None, *,
                   assignment=None, group=None):
    """outputs: {'class_logits': (B, Q, C+1), 'boxes_cxcywh': (B, Q, 4)};
    targets: {'boxes': (B, M, 4) xyxy normalised, 'labels': (B, M) int,
    'mask': (B, M) bool}. Returns (total, dict of unweighted parts, with
    'total').

    `image_weight` (B,) 0/1: rows with weight 0 drop out of every term.
    `assignment` (target_for_query, query_matched) from
    `objectives.matcher.match_layers`; None matches here. `group`: the
    data axis (module docstring). There the parts are the rank's shares,
    which sum over the ranks to the global values; the triplet term of the
    returned total is the whole global loss on every rank (its gradient
    reaches the rank's own features alone), and the parts carry its share.
    """
    iw = None if image_weight is None else image_weight.float()
    logits = outputs["class_logits"].float()
    pred_boxes = outputs["boxes_cxcywh"].float()
    c = cfg.num_classes
    if logits.shape[-1] != c + 1:
        raise ValueError(
            f"class_logits last dim is {logits.shape[-1]}, expected "
            f"num_classes+1 = {c + 1} — head and loss config disagree")
    tgt_boxes = targets["boxes"].float()
    tgt_labels = targets["labels"].long()
    tgt_mask = targets["mask"].bool()

    if assignment is None:
        assignment = match(logits, pred_boxes, tgt_labels, tgt_boxes,
                           tgt_mask, cfg.matcher)
    tgt_idx, matched = assignment

    safe_idx = tgt_idx.clamp(0, tgt_labels.shape[1] - 1)
    gather_labels = torch.gather(tgt_labels, 1, safe_idx)
    class_target = torch.where(matched, gather_labels,
                               torch.full_like(gather_labels, c))

    # labels: weighted CE over queries
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, class_target[..., None])[..., 0]
    weights = torch.where(matched, 1.0, cfg.background_weight)
    if iw is not None:
        weights = weights * iw[:, None]
    loss_ce = (ce * weights).sum() / torch.clamp(total(weights.sum(), group),
                                                 min=1e-9)

    # boxes: L1 (cxcywh) + GIoU (xyxy)
    gather_boxes = torch.gather(
        tgt_boxes, 1, safe_idx[..., None].expand(*safe_idx.shape, 4))
    pred_xyxy = cxcywh_to_xyxy(pred_boxes)
    matchedf = matched.float()
    if iw is not None:
        matchedf = matchedf * iw[:, None]
    num_boxes = torch.clamp(total(matchedf.sum(), group), min=1.0)
    l1 = (pred_boxes - xyxy_to_cxcywh(gather_boxes)).abs().sum(dim=-1)
    loss_bbox = (l1 * matchedf).sum() / num_boxes
    giou = elementwise_giou(pred_xyxy, gather_boxes)
    loss_giou = ((1.0 - giou) * matchedf).sum() / num_boxes

    # cardinality (metric only)
    with torch.no_grad():
        pred_fg = (logits.argmax(dim=-1) != c).float().sum(dim=1)
        n_tgt = tgt_mask.float().sum(dim=1)
        card_err = (pred_fg - n_tgt).abs()
        if iw is None and group is None:
            cardinality = card_err.mean()
        elif iw is None:
            images = torch.full((), card_err.shape[0], dtype=card_err.dtype,
                                device=card_err.device)
            cardinality = card_err.sum() / total(images, group)
        else:
            cardinality = (card_err * iw).sum() / torch.clamp(
                total(iw.sum(), group), min=1.0)

    parts = {"loss_ce": loss_ce, "loss_bbox": loss_bbox,
             "loss_giou": loss_giou, "cardinality_error": cardinality}
    loss = cfg.w_ce * loss_ce + cfg.w_bbox * loss_bbox + \
        cfg.w_giou * loss_giou
    parts["total"] = loss

    # triplet on image-level features, mined over the global microbatch
    if triplet_features is not None:
        image_labels, image_valid = dominant_labels(tgt_labels, tgt_mask, c)
        if iw is not None:
            image_valid = image_valid & (iw > 0)
        loss_triplet = batch_hard_triplet_loss(
            gather_rows(triplet_features, group),
            gather_rows(image_labels, group),
            gather_rows(image_valid, group), margin=cfg.triplet_margin)
        ranks = 1 if group is None else torch.distributed.get_world_size(
            group)
        parts["loss_triplet"] = loss_triplet / ranks
        parts["total"] = loss + cfg.w_triplet * parts["loss_triplet"]
        loss = loss + cfg.w_triplet * loss_triplet
    return loss, parts


def dominant_labels(tgt_labels, tgt_mask, num_classes: int):
    """Most frequent class per image; ties resolve to the lowest label id
    (the reference's ``np.unique`` + argmax rule). Returns (labels (B,)
    int64, valid (B,) bool), invalid where an image has no real box."""
    onehot = torch.nn.functional.one_hot(
        tgt_labels.long().clamp(0, num_classes - 1), num_classes).float()
    counts = (onehot * tgt_mask[..., None].float()).sum(dim=1)  # (B, C)
    # argmax returns the first maximum: the lowest label id on ties
    return counts.argmax(dim=-1), tgt_mask.any(dim=1)
