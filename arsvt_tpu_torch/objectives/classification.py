"""Classification objectives: CE with label smoothing, mixup, top-1,
confusion matrix (counterpart of ``arsvt_tpu/objectives/classification.py``).
All reductions in fp32. Mixup is split as the augmentation is: `draw_mixup`
takes the microbatch's generator, `mixup` takes the draws (so a test can
feed it ``jax.random``'s λ and permutation).
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class MixupDraws:
    """One microbatch's mixup: lam, λ ~ Beta(α, α) as a Python float
    (rounded to fp32 where it is used), and perm (B,) int64, the partner of
    each row."""

    lam: float
    perm: torch.Tensor


def draw_mixup(gen: torch.Generator, n: int, alpha: float) -> MixupDraws:
    """λ ~ Beta(alpha, alpha) and a permutation of n rows, from the
    microbatch's CPU generator: ``torch.distributions.Beta`` takes no
    generator, so λ comes from a numpy Generator seeded by a draw of
    `gen`, then the permutation from ``torch.randperm(generator=gen)``."""
    seed = int(torch.randint(0, 2**62, (), generator=gen))
    lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    return MixupDraws(lam, torch.randperm(n, generator=gen))


def mixup(images, labels, draws: MixupDraws, *, num_classes: int):
    """JAX's ``mixup`` with explicit draws: images (B, H, W, C), integer
    labels (B,) -> (λ x + (1 - λ) x[perm] in x's dtype, soft labels (B, C)
    fp32). The mix is computed in fp32 and rounded once, as JAX's fp32 λ
    promotes bf16 images before its cast back."""
    dev = images.device
    lam = torch.tensor(draws.lam, dtype=torch.float32, device=dev)
    perm = draws.perm.to(dev)
    x = images.float()
    mixed = lam * x + (1.0 - lam) * x[perm]
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    soft = lam * onehot + (1.0 - lam) * onehot[perm]
    return mixed.to(images.dtype), soft


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
