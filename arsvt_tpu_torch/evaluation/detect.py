"""Detection evaluation (counterpart of ``arsvt_tpu/evaluation/detect.py``).

`post_process`: softmax → best foreground class → confidence threshold →
class-aware greedy NMS → sort by score, on fixed (B, Q) shapes with a
validity mask. `average_precision`, `collect_batch_detections` and
`evaluate_detector`: the COCO-protocol AP sweep, numpy host code copied
from the JAX package; the raw outputs of a batch cross to the host once
and are post-processed there.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import compiler

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
    loop stops as soon as `keep` repeats, which gives the same mask; while
    ``torch.export`` traces it (``serving/export.py``), where a stop that
    depends on the data cannot be traced, it runs JAX's Q iterations.
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
    exporting = compiler.is_exporting()
    keep = valid
    for _ in range(q):
        new = valid & ~(suppressor & keep[..., None, :]).any(dim=-1)
        if not exporting and torch.equal(new, keep):
            break
        keep = new
    return keep


def average_precision(predictions, ground_truths, *, num_classes: int,
                      iou_thresholds=None):
    """COCO-protocol AP. predictions: list per image of dicts with numpy
    'boxes' (N, 4) xyxy, 'scores' (N,), 'labels' (N,); ground_truths: list
    per image of 'boxes' (M, 4), 'labels' (M,) and optionally 'iscrowd'
    (M,): crowd ground truths are ignore regions (no recall; detections
    inside them are neither TP nor FP).

    Returns {"mAP", "AP50", "AP75", "per_class": {cls: AP}}.
    """
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    ap_table = np.full((len(iou_thresholds), num_classes), np.nan)

    for ci in range(num_classes):
        dets = []  # (img_idx, score, box)
        n_gt = 0
        gts_per_img = []
        crowds_per_img = []
        for i, (pred, gt) in enumerate(zip(predictions, ground_truths)):
            sel = pred["labels"] == ci
            for s, b in zip(pred["scores"][sel], pred["boxes"][sel]):
                dets.append((i, float(s), b))
            cls_sel = gt["labels"] == ci
            crowd = np.asarray(
                gt.get("iscrowd", np.zeros(len(gt["labels"]))), bool)
            g = gt["boxes"][cls_sel & ~crowd]
            gts_per_img.append(g)
            crowds_per_img.append(gt["boxes"][cls_sel & crowd])
            n_gt += len(g)
        if n_gt == 0:
            continue
        dets.sort(key=lambda t: -t[1])
        # IoUs do not depend on the threshold: once per detection
        det_ious = [
            _iou_one_to_many(box, gts_per_img[img])
            if len(gts_per_img[img]) else None
            for (img, _, box) in dets
        ]
        det_crowd_iod = [
            float(_intersection_over_det(box, crowds_per_img[img]).max())
            if len(crowds_per_img[img]) else 0.0
            for (img, _, box) in dets
        ]

        for ti, thr in enumerate(iou_thresholds):
            matched = [np.zeros(len(g), bool) for g in gts_per_img]
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for di, (img, _, box) in enumerate(dets):
                if det_ious[di] is not None:
                    # best-IoU unmatched ground truth
                    ious = np.where(matched[img], -1.0, det_ious[di])
                    best = int(np.argmax(ious))
                    if ious[best] >= thr:
                        matched[img][best] = True
                        tp[di] = 1
                        continue
                if det_crowd_iod[di] >= thr:
                    continue  # inside a crowd region: ignored
                fp[di] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / n_gt
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            # 101-point interpolation (COCO)
            prec_interp = np.zeros(101)
            for ri, r in enumerate(np.linspace(0, 1, 101)):
                mask = recall >= r
                prec_interp[ri] = precision[mask].max() if mask.any() else 0.0
            ap_table[ti, ci] = prec_interp.mean()

    def _thr_index(value):
        hits = np.where(np.isclose(np.asarray(iou_thresholds), value))[0]
        return int(hits[0]) if len(hits) else None

    i50, i75 = _thr_index(0.5), _thr_index(0.75)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        # all-NaN rows (classes absent from the split) are expected
        warnings.simplefilter("ignore", category=RuntimeWarning)
        per_class = np.nanmean(ap_table, axis=0)
        ap50 = np.nanmean(ap_table[i50]) if i50 is not None else np.nan
        ap75 = np.nanmean(ap_table[i75]) if i75 is not None else np.nan
        mean_ap = np.nanmean(ap_table)
    return {
        "mAP": float(mean_ap) if np.isfinite(mean_ap) else 0.0,
        "AP50": float(ap50) if np.isfinite(ap50) else 0.0,
        "AP75": float(ap75) if np.isfinite(ap75) else 0.0,
        "per_class": {
            int(c): (float(per_class[c]) if np.isfinite(per_class[c])
                     else None)
            for c in range(num_classes)
        },
    }


def _intersection_over_det(box, boxes):
    """Intersection area / detection area against each box."""
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = max((box[2] - box[0]) * (box[3] - box[1]), 1e-9)
    return inter / area


def _iou_one_to_many(box, boxes):
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_a = max((box[2] - box[0]) * (box[3] - box[1]), 0)
    area_b = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(
        boxes[:, 3] - boxes[:, 1], 0, None)
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def collect_batch_detections(outputs, batch, *, conf_threshold: float,
                             nms_threshold: float,
                             ap_conf_threshold: float = 0.05):
    """Post-process one batch once at the AP floor and split the survivors
    into (user-threshold predictions, AP-floor predictions, ground
    truths). Rows whose batch "valid" is 0 (padding) are skipped."""
    predictions, ap_predictions, ground_truths = [], [], []
    ap_post = post_process(
        torch.from_numpy(_host(outputs["class_logits"])),
        torch.from_numpy(_host(outputs["boxes_cxcywh"])),
        conf_threshold=ap_conf_threshold, nms_threshold=nms_threshold)
    ap_post = {k: v.numpy() for k, v in ap_post.items()}
    row_valid = _host(batch["valid"]) if "valid" in batch else None
    boxes, labels, gmasks = (_host(batch[k]) for k in
                             ("boxes", "labels", "mask"))
    for i in range(ap_post["boxes"].shape[0]):
        if row_valid is not None and not row_valid[i]:
            continue
        ap_sel = ap_post["valid"][i]
        sel = ap_sel & (ap_post["scores"][i] >= conf_threshold)
        predictions.append({k: ap_post[k][i][sel]
                            for k in ("boxes", "scores", "labels")})
        ap_predictions.append({k: ap_post[k][i][ap_sel]
                               for k in ("boxes", "scores", "labels")})
        gmask = gmasks[i].astype(bool)
        g = {"boxes": boxes[i][gmask], "labels": labels[i][gmask]}
        if "iscrowd" in batch:
            g["iscrowd"] = _host(batch["iscrowd"])[i][gmask]
        ground_truths.append(g)
    return predictions, ap_predictions, ground_truths


def evaluate_detector(eval_step, params, batches, *, num_classes: int,
                      conf_threshold: float = 0.5,
                      nms_threshold: float = 0.5,
                      ap_conf_threshold: float = 0.05):
    """Sweep: per-batch forward + post-process, host-side AP at the
    `ap_conf_threshold` floor (COCO AP needs the whole ranked curve); the
    count statistics re-filter those survivors at `conf_threshold`.
    Losses are weighted by each batch's valid row count."""
    predictions, ap_predictions, ground_truths = [], [], []
    total_loss, weight_total = 0.0, 0.0
    parts_sum: dict = {}
    for batch in batches:
        m = eval_step(params, batch)
        weight = (float(m["count"]) if "count" in m
                  else float(np.shape(batch["image"])[0]))
        weight_total += weight
        total_loss += float(m["loss"]) * weight
        for k, v in m.items():
            if k in ("outputs", "loss", "count"):
                continue
            parts_sum[k] = parts_sum.get(k, 0.0) + float(v) * weight
        p, ap_p, g = collect_batch_detections(
            m["outputs"], batch, conf_threshold=conf_threshold,
            nms_threshold=nms_threshold,
            ap_conf_threshold=ap_conf_threshold)
        predictions.extend(p)
        ap_predictions.extend(ap_p)
        ground_truths.extend(g)
    ap = average_precision(ap_predictions, ground_truths,
                           num_classes=num_classes)
    result = {"loss": total_loss / max(weight_total, 1.0), **ap}
    for k, v in parts_sum.items():
        result[k] = v / max(weight_total, 1.0)
    n_images = len(predictions)
    counts = np.zeros(num_classes, np.int64)
    for pred in predictions:
        for lab in pred["labels"]:
            counts[int(lab)] += 1
    result["total_predictions"] = int(counts.sum())
    result["predictions_per_image"] = (
        float(counts.sum() / n_images) if n_images else 0.0)
    result["class_prediction_counts"] = counts.tolist()
    return result
