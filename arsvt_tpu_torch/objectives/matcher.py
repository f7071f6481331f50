"""Hungarian (bipartite) matching (counterpart of
``arsvt_tpu/objectives/matcher.py``).

The cost matrices are built on the device, as JAX's `build_cost_matrix`:
class + L1 (cxcywh) + GIoU terms, target slots that hold no real box at
`_PAD_COST`. The assignment is solved on the host with scipy's
``linear_sum_assignment``, the solver JAX keeps as its ``backend="scipy"``
oracle; it finds the same optimum as JAX's on-device Jonker-Volgenant
(`lap_rect`). `match_layers` stacks the costs of every decoder layer it
is given, copies them to the host once, and copies the indices back
once: the only device-to-host round trip of a detector train step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from arsvt_tpu_torch.objectives.boxes import (
    cxcywh_to_xyxy,
    pairwise_giou,
    xyxy_to_cxcywh,
)

# Pad cost: dominates any real cost while fp32 addition keeps the real
# costs' differences (JAX's value).
_PAD_COST = 1e4


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 1.0
    cost_bbox: float = 1.0
    cost_giou: float = 1.0


def build_cost_matrix(class_logits, boxes_cxcywh, tgt_labels, tgt_boxes_xyxy,
                      tgt_mask, cfg: MatcherConfig = MatcherConfig()):
    """Costs (..., Q, M): class_logits (..., Q, C+1), boxes_cxcywh (..., Q,
    4), tgt_labels (..., M) int, tgt_boxes_xyxy (..., M, 4), tgt_mask
    (..., M) bool; leading dims are shared (the batch)."""
    probs = torch.softmax(class_logits.float(), dim=-1)
    idx = tgt_labels.long()[..., None, :].expand(*probs.shape[:-1],
                                                  tgt_labels.shape[-1])
    cost_class = -torch.gather(probs, -1, idx)  # (..., Q, M)
    pred_xyxy = cxcywh_to_xyxy(boxes_cxcywh)
    tgt_cxcywh = xyxy_to_cxcywh(tgt_boxes_xyxy)
    cost_bbox = (boxes_cxcywh[..., :, None, :]
                 - tgt_cxcywh[..., None, :, :]).abs().sum(dim=-1)
    cost_giou = -pairwise_giou(pred_xyxy, tgt_boxes_xyxy)
    cost = (cfg.cost_class * cost_class + cfg.cost_bbox * cost_bbox
            + cfg.cost_giou * cost_giou)
    return torch.where(tgt_mask[..., None, :], cost,
                       torch.full_like(cost, _PAD_COST))


def solve(cost: np.ndarray) -> np.ndarray:
    """One (Q, M) cost -> target slot per query (Q,) int64; with Q > M the
    queries left without a slot get M (JAX's out-of-range index)."""
    q, m = cost.shape
    rows, cols = linear_sum_assignment(cost)
    out = np.full(q, m, np.int64)
    out[rows] = cols
    return out


def match_layers(layers, tgt_labels, tgt_boxes_xyxy, tgt_mask,
                 cfg: MatcherConfig = MatcherConfig()):
    """Matching of several decoder layers' outputs against one set of
    targets: `layers` is a list of (class_logits (B, Q, C+1), boxes (B, Q,
    4)). Returns a list of (target_for_query (B, Q) int64,
    query_matched (B, Q) bool), one per layer, on the targets' device:
    `target_for_query[b, q]` is the slot assigned to query q, and
    `query_matched` is True only where that slot holds a real target. The
    costs are computed without a graph (the assignment is discrete)."""
    with torch.no_grad():
        costs = torch.stack([
            build_cost_matrix(cl, bx, tgt_labels, tgt_boxes_xyxy.float(),
                              tgt_mask, cfg) for cl, bx in layers])
        host = costs.cpu().numpy()  # (L, B, Q, M): the one copy to the host
        idx = np.stack([[solve(c) for c in layer] for layer in host])
        idx = torch.from_numpy(idx).to(tgt_labels.device)
        m = tgt_labels.shape[1]
        in_range = idx < m
        real = torch.gather(
            tgt_mask[None].expand(len(layers), -1, -1), 2,
            idx.clamp(max=m - 1))
        return [(i, r) for i, r in zip(idx, in_range & real)]


def match(class_logits, boxes_cxcywh, tgt_labels, tgt_boxes_xyxy, tgt_mask,
          cfg: MatcherConfig = MatcherConfig()):
    """Batched matching of one layer, JAX's `match` contract: returns
    (target_for_query (B, Q), query_matched (B, Q) bool)."""
    return match_layers([(class_logits, boxes_cxcywh)], tgt_labels,
                        tgt_boxes_xyxy, tgt_mask, cfg)[0]
