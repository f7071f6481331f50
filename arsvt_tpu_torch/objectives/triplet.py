"""Batch-hard triplet loss (copy of ``arsvt_tpu/objectives/triplet.py``).

For each valid anchor: hardest positive = largest same-label distance,
hardest negative = smallest different-label distance, hinge at `margin`
on the squared L2 distance of L2-normalised features; the masked mean
over anchors that have at least one positive and one negative.
"""

from __future__ import annotations

import torch


def batch_hard_triplet_loss(features, labels, valid, *, margin: float = 0.3):
    """features (B, D) L2-normalised fp32; labels (B,) int; valid (B,)
    bool. Returns a scalar fp32 tensor."""
    f = features.float()
    gram = f @ f.T
    sq = (f * f).sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)

    both = valid[:, None] & valid[None, :]
    same = (labels[:, None] == labels[None, :]) & both
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=f.device)
    pos_mask = same & ~eye
    neg_mask = ~same & both

    big = 1e9
    hardest_pos = torch.where(pos_mask, d2, -big).amax(dim=1)
    hardest_neg = torch.where(neg_mask, d2, big).amin(dim=1)

    anchor_ok = valid & pos_mask.any(dim=1) & neg_mask.any(dim=1)
    losses = torch.clamp(hardest_pos - hardest_neg + margin, min=0.0)
    denom = torch.clamp(anchor_ok.float().sum(), min=1.0)
    return torch.where(anchor_ok, losses, torch.zeros_like(losses)).sum() \
        / denom
