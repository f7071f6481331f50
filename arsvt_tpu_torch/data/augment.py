"""On-device image augmentation for classification (the crop/flip and
eval parts of ``arsvt_tpu/data/augment.py``) and ImageNet normalization.

Images are batched NHWC fp32 in [0, 1]. Each random op is split in two: a
draw function that takes a `torch.Generator` and returns the per-image
values, and an apply function that takes those values explicitly (so a
test can feed it ``jax.random``'s own draws). The resample is JAX's
``jax.image.scale_and_translate`` with the linear (triangle) kernel and
antialiasing: a separable (in, out) weight matrix per axis, the kernel
widened by 1/scale when downscaling, normalized per output, zero where
the sample falls outside [-0.5, n - 0.5]; applied with two batched
products. ``F.interpolate(antialias=True)`` is a different filter.

Not ported yet: RandAugment, color jitter and the bf16 augmentation
opt-in (``ARSVT_AUGMENT_BF16``) — the ViT-L recipe (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_EPS32 = float(np.finfo(np.float32).eps)


def normalize(image: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """(image - mean) / std over the trailing channel axis, in the image's
    own dtype (the JAX function casts mean and std to it first)."""
    mean = torch.tensor(mean, dtype=image.dtype, device=image.device)
    std = torch.tensor(std, dtype=image.dtype, device=image.device)
    return (image - mean) / std


def _weight_mat(in_size: int, out_size: int, inv_scale: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """JAX's ``compute_weight_mat`` for the triangle kernel, antialiased,
    one matrix per image: inv_scale and shift (= translation * inv_scale)
    are (B,) fp32; returns (B, in_size, out_size) fp32."""
    dev = inv_scale.device
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_idx + 0.5)[None, :] * inv_scale[:, None]
                - shift[:, None] - 0.5)
    in_idx = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_idx[None, :, None]).abs() \
        / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def _resample(images: torch.Tensor, size: int, inv_scale, shift):
    """Scale-and-translate (B, H, W, C) to (B, size, size, C); inv_scale and
    shift are (rows, columns) pairs of (B,) tensors, or None to keep an
    axis as it is."""
    out = images
    if inv_scale[0] is not None:
        wh = _weight_mat(images.shape[1], size, inv_scale[0], shift[0])
        out = torch.einsum("bhwc,bho->bowc", out, wh.to(out.dtype))
    if inv_scale[1] is not None:
        ww = _weight_mat(images.shape[2], size, inv_scale[1], shift[1])
        out = torch.einsum("bowc,bwp->bopc", out, ww.to(out.dtype))
    return out


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(..., method="linear")`` of each (H, W, C) image
    to (size, size, C); an axis already of that size is left alone."""
    b = images.shape[0]
    inv, shift = [], []
    for n in images.shape[1:3]:
        if n == size:
            inv.append(None)
            shift.append(None)
            continue
        # JAX divides 1 by the Python scale in double and rounds to fp32
        inv.append(torch.full((b,), 1.0 / (size / n), dtype=torch.float32,
                              device=images.device))
        shift.append(torch.zeros(b, dtype=torch.float32,
                                 device=images.device))
    return _resample(images, size, inv, shift)


def draw_random_resized_crop(gen: torch.Generator, n: int, *,
                             scale=(0.65, 1.0), ratio=(3 / 4, 4 / 3)):
    """Per-image (area, log_ratio, y_frac, x_frac), each (n,) fp32 on the
    CPU, from the distributions of ``augment.py:658-669``."""
    def uniform(lo, hi):
        return torch.rand(n, generator=gen) * (hi - lo) + lo

    area = uniform(scale[0], scale[1])
    log_ratio = uniform(math.log(ratio[0]), math.log(ratio[1]))
    y_frac = uniform(0.0, 1.0)
    x_frac = uniform(0.0, 1.0)
    return area, log_ratio, y_frac, x_frac


def random_resized_crop(images: torch.Tensor, size: int, area, log_ratio,
                        y_frac, x_frac) -> torch.Tensor:
    """RandomResizedCrop of each image with explicit draws ((B,) fp32 on
    the images' device), as one scale-and-translate: the crop has area
    `area` of the image and aspect exp(log_ratio), placed at fractions
    (y_frac, x_frac) of the free room."""
    h, w = images.shape[1:3]
    aspect = torch.exp(log_ratio)
    ch = torch.clamp(torch.sqrt(area / aspect) * h, max=float(h))
    cw = torch.clamp(torch.sqrt(area * aspect) * w, max=float(w))
    y0 = y_frac * (h - ch)
    x0 = x_frac * (w - cw)
    sc = (size / ch, size / cw)
    tr = (-y0 * size / ch, -x0 * size / cw)
    inv = tuple(1.0 / s for s in sc)
    shift = tuple(t * i for t, i in zip(tr, inv))
    return _resample(images, size, inv, shift)


def draw_horizontal_flip(gen: torch.Generator, n: int, *, p: float = 0.5):
    """(n,) bool on the CPU: True where the image is flipped."""
    return torch.rand(n, generator=gen) < p


def horizontal_flip(images: torch.Tensor, flip: torch.Tensor):
    """Mirror the W axis of the images where `flip` (B,) is true."""
    return torch.where(flip[:, None, None, None], images.flip(2), images)


@dataclasses.dataclass(frozen=True)
class ClassifyAugmentConfig:
    image_size: int = 224
    flip_p: float = 0.5
    crop_scale: tuple = (0.65, 1.0)
    jitter_p: float = 0.0
    rand_augment: bool = False
    rand_augment_magnitude: float = 0.5
    warp_variant: str = ""


@dataclasses.dataclass(frozen=True)
class CropFlipDraws:
    """The per-image values of one crop/flip augmentation, (B,) each."""

    area: torch.Tensor
    log_ratio: torch.Tensor
    y_frac: torch.Tensor
    x_frac: torch.Tensor
    flip: torch.Tensor

    def to(self, device) -> "CropFlipDraws":
        return CropFlipDraws(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))


def _check_supported(cfg: ClassifyAugmentConfig) -> None:
    if cfg.rand_augment or cfg.jitter_p > 0:
        raise NotImplementedError(
            "RandAugment and color jitter are not ported yet (ROADMAP Queue "
            "A, the ViT-L recipe)")


def draw_classification_augment(gen: torch.Generator, n: int,
                                cfg: ClassifyAugmentConfig) -> CropFlipDraws:
    """The host draws for `classification_train_augment` on n images."""
    _check_supported(cfg)
    crop = draw_random_resized_crop(gen, n, scale=cfg.crop_scale)
    return CropFlipDraws(*crop, draw_horizontal_flip(gen, n, p=cfg.flip_p))


def classification_train_augment(images: torch.Tensor, draws: CropFlipDraws,
                                 cfg: ClassifyAugmentConfig) -> torch.Tensor:
    """Crop/flip fine-tune augmentation, then normalize: (B, H, W, C) ->
    (B, size, size, C), with `draws` on the images' device."""
    _check_supported(cfg)
    images = random_resized_crop(images, cfg.image_size, draws.area,
                                 draws.log_ratio, draws.y_frac, draws.x_frac)
    return normalize(horizontal_flip(images, draws.flip))


def eval_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Resize(size) -> Normalize, per image of the batch."""
    if images.shape[1] != size or images.shape[2] != size:
        images = resize(images, size)
    return normalize(images)
