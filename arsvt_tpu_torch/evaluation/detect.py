"""Detection post-processing (counterpart of the first part of
``arsvt_tpu/evaluation/detect.py``): softmax → best foreground class →
confidence threshold → class-aware greedy NMS → sort by score, on fixed
(B, Q) shapes with a validity mask. The COCO-protocol AP and
`evaluate_detector` come with the detector-training slice.
"""

from __future__ import annotations

import torch

from arsvt_tpu_torch.objectives.boxes import cxcywh_to_xyxy


def post_process(class_logits: torch.Tensor, boxes_cxcywh: torch.Tensor, *,
                 conf_threshold: float = 0.5, nms_threshold: float = 0.5,
                 class_aware: bool = True) -> dict:
    """(B, Q, C+1) logits + (B, Q, 4) cxcywh -> masked detections.

    Returns {"boxes": (B, Q, 4) xyxy, "labels": (B, Q) int32, "scores":
    (B, Q), "valid": (B, Q) bool}, sorted by score within each image
    (kept rows first, ties and the rest in query order: the sort is
    stable, as ``jnp.argsort``). Runs on the device of its inputs; the
    streaming detector copies the raw outputs to the host once and calls
    it there.
    """
    probs = torch.softmax(class_logits.float(), dim=-1)
    fg = probs[..., :-1]  # exclude background (last index)
    scores = fg.amax(dim=-1)
    labels = fg.argmax(dim=-1).to(torch.int32)  # first maximum, as JAX
    boxes = cxcywh_to_xyxy(boxes_cxcywh.float())
    valid = scores >= conf_threshold
    keep = _nms_mask(boxes, scores, labels, valid, nms_threshold,
                     class_aware)
    order = torch.argsort(-torch.where(keep, scores, -1.0), dim=-1,
                          stable=True)
    return {
        "boxes": torch.gather(boxes, 1, order[..., None].expand_as(boxes)),
        "labels": torch.gather(labels, 1, order),
        "scores": torch.gather(scores, 1, order),
        "valid": torch.gather(keep, 1, order),
    }


def _nms_mask(boxes, scores, labels, valid, iou_thr: float,
              class_aware: bool) -> torch.Tensor:
    """Greedy NMS over each image's Q boxes as an O(Q²) masked fixed
    point: a box is kept if valid and no kept, higher-scoring (ties by
    index), same-class box overlaps it by more than `iou_thr`.

    JAX iterates Q times; the suppression order is acyclic, so the
    iteration reaches its fixed point within Q steps and stays there. This
    loop stops as soon as `keep` repeats, which gives the same mask.
    """
    q = boxes.shape[-2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    lt_x = torch.maximum(x1[..., :, None], x1[..., None, :])
    lt_y = torch.maximum(y1[..., :, None], y1[..., None, :])
    rb_x = torch.minimum(x2[..., :, None], x2[..., None, :])
    rb_y = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(rb_x - lt_x, min=0) * torch.clamp(rb_y - lt_y, min=0)
    iou = inter / torch.clamp(area[..., :, None] + area[..., None, :] - inter,
                              min=1e-9)
    idx = torch.arange(q, device=boxes.device)
    # suppressed by j: j scores higher, or equal with a lower index
    higher = (scores[..., None, :] > scores[..., :, None]) | (
        (scores[..., None, :] == scores[..., :, None])
        & (idx[None, :] < idx[:, None]))
    suppressor = (iou > iou_thr) & higher & valid[..., None, :]
    if class_aware:
        suppressor &= labels[..., :, None] == labels[..., None, :]
    keep = valid
    for _ in range(q):
        new = valid & ~(suppressor & keep[..., None, :]).any(dim=-1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep
