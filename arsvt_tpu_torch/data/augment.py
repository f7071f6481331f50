"""ImageNet normalization (the part of ``arsvt_tpu/data/augment.py`` that
the serving path runs)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(image: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """(image - mean) / std over the trailing channel axis, in the image's
    own dtype (the JAX function casts mean and std to it first)."""
    mean = torch.tensor(mean, dtype=image.dtype, device=image.device)
    std = torch.tensor(std, dtype=image.dtype, device=image.device)
    return (image - mean) / std
