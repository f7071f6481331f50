"""Classification objectives: CE with label smoothing, top-1, confusion
matrix (counterpart of ``arsvt_tpu/objectives/classification.py``; mixup
belongs to the ViT-L recipe and is not ported yet). All reductions in fp32.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels, *, num_classes: int,
                          label_smoothing: float = 0.0, valid=None):
    """logits (B, C); labels int (B,) or soft (B, C). Mean CE in fp32.

    `valid` (B,) 0/1 weights drop padded rows out of the mean; an all-pad
    batch returns 0."""
    logits = logits.float()
    if labels.dim() == logits.dim() - 1:
        onehot = torch.nn.functional.one_hot(
            labels.long(), num_classes).float()
    else:
        onehot = labels.float()
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    logp = torch.log_softmax(logits, dim=-1)
    ce = -(onehot * logp).sum(dim=-1)
    if valid is None:
        return ce.mean()
    w = valid.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def accuracy_top1(logits, labels):
    """Share of rows whose first maximal logit is the label (fp32)."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def confusion_matrix(preds, labels, num_classes: int, valid=None):
    """(C, C) int32 counts, rows = truth, columns = prediction; `valid`
    (B,) 0/1 rows contribute nothing when 0."""
    idx = (labels.long() * num_classes + preds.long())
    inc = (torch.ones_like(idx, dtype=torch.int32) if valid is None
           else valid.to(torch.int32))
    counts = torch.zeros(num_classes * num_classes, dtype=torch.int32,
                         device=idx.device)
    counts.index_add_(0, idx, inc)
    return counts.reshape(num_classes, num_classes)
