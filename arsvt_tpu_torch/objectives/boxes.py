"""Box utilities: format conversion, IoU, GIoU, vectorized (copy of
``arsvt_tpu/objectives/boxes.py``).

Boxes are cxcywh from a sigmoid head (degeneracy-free by construction) or
x1y1x2y2; the functions have no data-dependent branches, fp32 math.
"""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.chunk(4, dim=-1)
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.chunk(4, dim=-1)
    return torch.cat([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                     dim=-1)


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    wh = torch.clamp(boxes_xyxy[..., 2:] - boxes_xyxy[..., :2], min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a_xyxy, b_xyxy):
    """a: (..., N, 4), b: (..., M, 4) -> iou (..., N, M), union (..., N, M)."""
    area_a = box_area(a_xyxy)[..., :, None]
    area_b = box_area(b_xyxy)[..., None, :]
    lt = torch.maximum(a_xyxy[..., :, None, :2], b_xyxy[..., None, :, :2])
    rb = torch.minimum(a_xyxy[..., :, None, 2:], b_xyxy[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter / torch.clamp(union, min=1e-9), union


def pairwise_giou(a_xyxy, b_xyxy):
    """GIoU = IoU - (enclosing - union) / enclosing, in [-1, 1]."""
    iou, union = pairwise_iou(a_xyxy, b_xyxy)
    lt = torch.minimum(a_xyxy[..., :, None, :2], b_xyxy[..., None, :, :2])
    rb = torch.maximum(a_xyxy[..., :, None, 2:], b_xyxy[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    enclose = torch.clamp(wh[..., 0] * wh[..., 1], min=1e-9)
    return iou - (enclose - union) / enclose


def elementwise_giou(a_xyxy, b_xyxy):
    """GIoU between aligned boxes: (..., 4), (..., 4) -> (...)."""
    area_a = box_area(a_xyxy)
    area_b = box_area(b_xyxy)
    lt = torch.maximum(a_xyxy[..., :2], b_xyxy[..., :2])
    rb = torch.minimum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    iou = inter / torch.clamp(union, min=1e-9)
    lt_e = torch.minimum(a_xyxy[..., :2], b_xyxy[..., :2])
    rb_e = torch.maximum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    wh_e = torch.clamp(rb_e - lt_e, min=0.0)
    enclose = torch.clamp(wh_e[..., 0] * wh_e[..., 1], min=1e-9)
    return iou - (enclose - union) / enclose
