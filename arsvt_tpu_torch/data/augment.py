"""On-device image augmentation (``arsvt_tpu/data/augment.py``): the
classification crop/flip, color jitter and RandAugment, the detection
pipeline (shadow → flip with boxes → affine with boxes → color jitter →
coarse dropout → resize → normalize), eval preprocessing and ImageNet
normalization.

Images are batched NHWC fp32 in [0, 1]. Each random op is split in two: a
draw function that takes a `torch.Generator` and returns the per-image
values, and an apply function that takes those values explicitly (so a
test can feed it ``jax.random``'s own draws). The resample is JAX's
``jax.image.scale_and_translate`` with the linear (triangle) kernel and
antialiasing: a separable (in, out) weight matrix per axis, the kernel
widened by 1/scale when downscaling, normalized per output, zero where
the sample falls outside [-0.5, n - 0.5]; applied with two batched
products. ``F.interpolate(antialias=True)`` is a different filter.

The affine and RandAugment's rotate resample through JAX's warps, chosen
by name: ``shear_matmul`` (the default: three 1-D linear passes, each a
product with a band matrix of two-tap weights, chunked over images,
columns and rows), the bilinear gathers ``taps``, ``flat`` and ``patch``
(tap for tap the same result in JAX, so one body here) and, behind
``interpolation="lanczos4"``, the 8 x 8-tap Lanczos-4 resample. Boxes
move through the affine matrix itself (the ellipse or corner rule) and
lose validity as JAX's. RandAugment is JAX's fused two-round form
``P2 ∘ W(θ1 + θ2) ∘ P1``: the pointwise op of each round, one warp at the
summed angle between them.

JAX's switches are read from the environment at each call:
``ARSVT_SHEAR_MAXSKEW`` sizes the shear warp's pad (JAX reads it once, at
import), ``ARSVT_WARP_VARIANT`` names the bilinear warp where the config
leaves ``warp_variant`` empty, and ``ARSVT_AUGMENT_BF16`` runs the
augmentation in bf16 from the steps' input cast and the bilinear warp on
(`augment_input_cast`). Under it JAX's RandAugment fails to trace (its
posterize returns fp32 where the other branches keep bf16), and the port
raises there too.
"""

from __future__ import annotations

import dataclasses
import math
import os

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


def denormalize(image: torch.Tensor, mean=IMAGENET_MEAN,
                std=IMAGENET_STD) -> torch.Tensor:
    """The inverse of `normalize`: image * std + mean."""
    mean = torch.tensor(mean, dtype=image.dtype, device=image.device)
    std = torch.tensor(std, dtype=image.dtype, device=image.device)
    return image * std + mean


def augment_input_cast(images: torch.Tensor) -> torch.Tensor:
    """JAX's ``augment_input_cast``: the images in bf16 when
    ``ARSVT_AUGMENT_BF16`` is set (read at each call), else unchanged."""
    if os.environ.get("ARSVT_AUGMENT_BF16"):
        return images.to(torch.bfloat16)
    return images


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
class JitterDraws:
    """The per-image values of one color jitter: apply (B,) bool; the
    brightness, contrast and saturation factors and the hue angle in
    radians (B,); order (B, 4), the permutation of the four adjustments."""

    apply: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    order: torch.Tensor

    def to(self, device) -> "JitterDraws":
        return JitterDraws(*(getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)))


def draw_color_jitter(gen: torch.Generator, n: int, *, p: float,
                      brightness: float, contrast: float, saturation: float,
                      hue: float) -> JitterDraws:
    """The draws of JAX's ``color_jitter`` (``augment.py:98-130``) for n
    images: the factors uniform in 1 ± their range, the hue shift uniform
    in ± `hue` turns, a random order, applied with probability p."""
    def uniform(lo, hi):
        return torch.rand(n, generator=gen) * (hi - lo) + lo

    return JitterDraws(
        apply=torch.rand(n, generator=gen) < p,
        brightness=uniform(1 - brightness, 1 + brightness),
        contrast=uniform(1 - contrast, 1 + contrast),
        saturation=uniform(1 - saturation, 1 + saturation),
        hue=uniform(-hue, hue) * 2.0 * math.pi,
        order=torch.argsort(torch.rand((n, 4), generator=gen), dim=1))


@dataclasses.dataclass(frozen=True)
class CropFlipDraws:
    """The per-image values of one classification augmentation, (B,) each:
    the crop and the flip, and, where the config asks for them, the color
    jitter's and RandAugment's draws."""

    area: torch.Tensor
    log_ratio: torch.Tensor
    y_frac: torch.Tensor
    x_frac: torch.Tensor
    flip: torch.Tensor
    jitter: JitterDraws | None = None
    rand_augment: "RandAugmentDraws | None" = None

    def to(self, device) -> "CropFlipDraws":
        return CropFlipDraws(*(
            None if t is None else t.to(device)
            for t in (getattr(self, f.name)
                      for f in dataclasses.fields(self))))


# JAX's ``color_jitter`` defaults, which the classification pipeline keeps
_CLASSIFY_JITTER = dict(brightness=0.2, contrast=0.2, saturation=0.2,
                        hue=0.2)


def draw_classification_augment(gen: torch.Generator, n: int,
                                cfg: ClassifyAugmentConfig) -> CropFlipDraws:
    """The host draws for `classification_train_augment` on n images:
    crop, flip, then the jitter (``jitter_p > 0``) and RandAugment
    (``rand_augment``) draws."""
    crop = draw_random_resized_crop(gen, n, scale=cfg.crop_scale)
    flip = draw_horizontal_flip(gen, n, p=cfg.flip_p)
    jitter = (draw_color_jitter(gen, n, p=cfg.jitter_p, **_CLASSIFY_JITTER)
              if cfg.jitter_p > 0 else None)
    ra = draw_rand_augment(gen, n) if cfg.rand_augment else None
    return CropFlipDraws(*crop, flip, jitter, ra)


def classification_train_augment(images: torch.Tensor, draws: CropFlipDraws,
                                 cfg: ClassifyAugmentConfig) -> torch.Tensor:
    """JAX's ``classification_train_augment``: crop → flip → color jitter
    (``jitter_p > 0``) → RandAugment (``rand_augment``) → normalize,
    (B, H, W, C) -> (B, size, size, C), with `draws` on the images'
    device (RandAugment's op indices stay on the host)."""
    images = random_resized_crop(images, cfg.image_size, draws.area,
                                 draws.log_ratio, draws.y_frac, draws.x_frac)
    images = horizontal_flip(images, draws.flip)
    if cfg.jitter_p > 0:
        j = draws.jitter
        images = color_jitter(images, j.apply, j.brightness, j.contrast,
                              j.saturation, j.hue, j.order)
    if cfg.rand_augment:
        images = rand_augment(images, draws.rand_augment,
                              magnitude=cfg.rand_augment_magnitude,
                              warp_variant=cfg.warp_variant or None)
    return normalize(images)


def eval_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Resize(size) -> Normalize, per image of the batch."""
    if images.shape[1] != size or images.shape[2] != size:
        images = resize(images, size)
    return normalize(images)


# ------------------------------------------------------------- detection


def random_shadow(images, apply, n, angle, ox, oy, intensity, *,
                  roi=(0.0, 0.7, 1.0, 1.0)):
    """Darken up to K half-plane regions inside `roi` (fractions of the
    image), JAX's ``random_shadow`` with explicit draws: apply (B,) bool,
    n (B,) int (shadows in use), angle, ox, oy, intensity (B, K) fp32."""
    b, h, w, _ = images.shape
    dev = images.device
    yy = (torch.arange(h, dtype=torch.float32, device=dev) / h)[:, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev) / w)[None, :]
    rx1, ry1, rx2, ry2 = roi
    roi_mask = (xx >= rx1) & (xx < rx2) & (yy >= ry1) & (yy < ry2)
    factor = torch.ones((b, h, w), dtype=torch.float32, device=dev)
    for i in range(angle.shape[1]):
        def per(t):
            return t[:, i, None, None]
        side = ((xx - per(ox)) * torch.cos(per(angle))
                + (yy - per(oy)) * torch.sin(per(angle))) > 0.0
        on = side & roi_mask & (i < n)[:, None, None]
        factor = factor * torch.where(on, 1.0 - per(intensity), 1.0)
    shade = images * factor[..., None]
    return torch.where(apply[:, None, None, None], shade, images)


def coarse_dropout(images, apply, n, hole_h, hole_w, hole_y, hole_x, *,
                   fill: float = 1.0):
    """Fill up to K rectangles with `fill`, JAX's ``coarse_dropout`` with
    explicit draws: apply (B,) bool, n (B,) int, hole_h and hole_w (B, K)
    fractions of the sides, hole_y and hole_x (B, K) in [0, 1) placing each
    hole in the free room."""
    b, h, w, _ = images.shape
    dev = images.device
    hh = hole_h * h
    ww = hole_w * w
    ys = hole_y * (h - hh)
    xs = hole_x * (w - ww)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    drop = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    for i in range(hole_h.shape[1]):
        def per(t):
            return t[:, i, None, None]
        drop |= ((yy >= per(ys)) & (yy < per(ys) + per(hh))
                 & (xx >= per(xs)) & (xx < per(xs) + per(ww))
                 & (i < n)[:, None, None])
    out = torch.where(drop[..., None],
                      torch.tensor(fill, dtype=images.dtype, device=dev),
                      images)
    return torch.where(apply[:, None, None, None], out, images)


def flip_boxes(boxes, flip):
    """Mirror normalised xyxy boxes (B, M, 4) where `flip` (B,) is true."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    flipped = torch.stack([1.0 - x2, y1, 1.0 - x1, y2], dim=-1)
    return torch.where(flip[:, None, None], flipped, boxes)


def adjust_brightness(images, factor):
    return images * factor.to(images.dtype)[:, None, None, None]


def adjust_contrast(images, factor):
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return (images - mean) * factor.to(images.dtype)[:, None, None, None] \
        + mean


def adjust_saturation(images, factor):
    gray = images.mean(dim=-1, keepdim=True)
    return gray + (images - gray) * factor.to(images.dtype)[:, None, None,
                                                            None]


def adjust_hue(images, radians):
    """Hue rotation by the RGB rotation matrix about the gray axis, one
    angle (B,) per image."""
    c, s = torch.cos(radians), torch.sin(radians)
    m = torch.stack([
        torch.stack([0.299 + 0.701 * c + 0.168 * s,
                     0.587 - 0.587 * c + 0.330 * s,
                     0.114 - 0.114 * c - 0.497 * s], dim=-1),
        torch.stack([0.299 - 0.299 * c - 0.328 * s,
                     0.587 + 0.413 * c + 0.035 * s,
                     0.114 - 0.114 * c + 0.292 * s], dim=-1),
        torch.stack([0.299 - 0.300 * c + 1.250 * s,
                     0.587 - 0.588 * c - 1.050 * s,
                     0.114 + 0.886 * c - 0.203 * s], dim=-1),
    ], dim=-2).to(images.dtype)  # (B, 3, 3)
    return torch.einsum("bhwc,bkc->bhwk", images, m)


def color_jitter(images, apply, brightness, contrast, saturation, hue,
                 order):
    """JAX's ``color_jitter`` with explicit draws: apply (B,) bool; the
    brightness, contrast and saturation factors and the hue angle in
    radians (B,); order (B, 4) int, the permutation of the four
    adjustments (0 brightness, 1 contrast, 2 saturation, 3 hue) each image
    applies. Every adjustment is computed at each slot and selected, as
    under JAX's vmap; then clip to [0, 1]."""
    out = images
    for slot in range(4):
        cands = torch.stack([adjust_brightness(out, brightness),
                             adjust_contrast(out, contrast),
                             adjust_saturation(out, saturation),
                             adjust_hue(out, hue)])
        pick = order[:, slot].long()
        out = cands[pick, torch.arange(images.shape[0],
                                       device=images.device)]
    out = torch.clamp(out, 0.0, 1.0)
    return torch.where(apply[:, None, None, None], out, images)


def affine_matrix(h: int, w: int, theta_deg, scale, translate, shear_deg):
    """Forward pixel-space transforms (B, 3, 3) fp32, input px -> output
    px, centre origin: centre · translate · rotate · shear · scale ·
    uncentre, multiplied left to right as JAX's ``_affine_matrix``.
    theta_deg and scale (B,), translate and shear_deg (B, 2)."""
    b = theta_deg.shape[0]
    dev = theta_deg.device

    def eye():
        return torch.eye(3, dtype=torch.float32, device=dev).repeat(b, 1, 1)

    theta = torch.deg2rad(theta_deg)
    sh = torch.deg2rad(shear_deg)
    rot = eye()
    rot[:, 0, 0] = torch.cos(theta)
    rot[:, 0, 1] = -torch.sin(theta)
    rot[:, 1, 0] = torch.sin(theta)
    rot[:, 1, 1] = torch.cos(theta)
    shear_m = eye()
    shear_m[:, 0, 1] = torch.tan(sh[:, 0])
    shear_m[:, 1, 0] = torch.tan(sh[:, 1])
    scale_m = eye()
    scale_m[:, 0, 0] = scale
    scale_m[:, 1, 1] = scale
    trans = eye()
    trans[:, 0, 2] = translate[:, 0] * w
    trans[:, 1, 2] = translate[:, 1] * h
    center = eye()
    center[:, 0, 2] = w / 2.0
    center[:, 1, 2] = h / 2.0
    uncenter = eye()
    uncenter[:, 0, 2] = -w / 2.0
    uncenter[:, 1, 2] = -h / 2.0
    out = center
    for m in (trans, rot, shear_m, scale_m, uncenter):
        out = out @ m
    return out


_PASS2_COLS = 128
_PASS3_ROWS = 32


def shear_max_skew() -> float:
    """The |x shear| the shear warp's intermediate canvas covers:
    ``ARSVT_SHEAR_MAXSKEW``, 1.75 by default, as in JAX."""
    return float(os.environ.get("ARSVT_SHEAR_MAXSKEW", "1.75"))


def _band_weights(pos, n: int):
    """pos (..., J) fractional source positions -> (..., J, n) two-tap
    linear-interpolation weights max(0, 1 - |pos - i|); out-of-range
    positions get zero rows."""
    i = torch.arange(n, dtype=torch.float32, device=pos.device)
    wgt = pos[..., None] - i
    return wgt.abs_().neg_().add_(1.0).clamp_(min=0.0)


# the bytes of one band-weight tensor (pass 2's (N, 128, H, H) or pass 3's
# (N, 32, W, Wp), fp32) the shear warp lets a chunk of images build at once
_BAND_BYTES = 1 << 30


def _shear_chunk(images, inv):
    """`shear_matmul_warp` on one chunk of images."""
    n, h, w, c = images.shape
    dt = images.dtype
    m = inv.float()
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    b3 = m01 / m00
    a2 = m11 - m10 * b3
    pad = int(np.ceil(shear_max_skew() * max(h, w)))
    wp = w + 2 * pad
    dev = images.device

    # pass 1: x' = m00 (j - pad) + m02 over the padded x axis
    j1 = torch.arange(wp, dtype=torch.float32, device=dev) - pad
    pos1 = m00[:, None] * j1[None, :] + m02[:, None]  # (N, wp)
    c1m = _band_weights(pos1, w).to(dt)  # (N, wp, w)
    t1 = torch.einsum("nji,nhic->nhjc", c1m, images).to(dt)  # (N, H, wp, C)
    del c1m

    # pass 2: y' = a2 y + m10 (j - pad) + m12, one (h, h) band per column
    yy = torch.arange(h, dtype=torch.float32, device=dev)
    t2 = torch.empty_like(t1)
    for j0 in range(0, wp, _PASS2_COLS):
        cols = min(_PASS2_COLS, wp - j0)
        j = torch.arange(j0, j0 + cols, dtype=torch.float32,
                         device=dev) - pad
        posv = a2[:, None, None] * yy[None, None, :] + (
            m10[:, None] * j[None, :] + m12[:, None])[:, :, None]
        cm = _band_weights(posv, h).to(dt)  # (N, cols, h_out, h_in)
        t2[:, :, j0:j0 + cols] = torch.einsum(
            "nkyu,nukc->nykc", cm, t1[:, :, j0:j0 + cols]).to(dt)
        del cm
    del t1

    # pass 3: x = (j - pad) sampled at x_out + b3 y + pad, per row
    xx = torch.arange(w, dtype=torch.float32, device=dev)
    out = torch.empty((n, h, w, c), dtype=dt, device=dev)
    for y0 in range(0, h, _PASS3_ROWS):
        rows = min(_PASS3_ROWS, h - y0)
        y = torch.arange(y0, y0 + rows, dtype=torch.float32, device=dev)
        pos3 = xx[None, None, :] + b3[:, None, None] * y[None, :, None] + pad
        cm = _band_weights(pos3, wp).to(dt)  # (N, rows, w, wp)
        out[:, y0:y0 + rows] = torch.einsum(
            "nsxj,nsjc->nsxc", cm, t2[:, y0:y0 + rows]).to(dt)
        del cm
    return out


def shear_matmul_warp(images, inv):
    """JAX's ``_shear_matmul_warp`` on (N, H, W, C) images with the
    out->src maps inv (N, 3, 3): x scale + translate, then y scale +
    shear per column, then x shear per row, each a band-matrix product;
    zeros outside the source. Chunked over images so that no band tensor
    exceeds `_BAND_BYTES` (an image's result does not depend on the
    others)."""
    n, h, w, _ = images.shape
    wp = w + 2 * int(np.ceil(shear_max_skew() * max(h, w)))
    per_image = 4 * max(_PASS2_COLS * h * h, _PASS3_ROWS * w * wp)
    chunk = max(1, _BAND_BYTES // per_image)
    if n <= chunk:
        return _shear_chunk(images, inv)
    return torch.cat([_shear_chunk(images[i:i + chunk], inv[i:i + chunk])
                      for i in range(0, n, chunk)])


def _src_coords(h: int, w: int, inv):
    """The source position (sx, sy), each (N, H*W) fp32, of every output
    pixel (row-major) under the out->src maps inv (N, 3, 3)."""
    dev = inv.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    coords = torch.stack([xx.reshape(-1), yy.reshape(-1),
                          torch.ones(h * w, device=dev)])  # (3, HW)
    src = inv.float() @ coords
    return src[:, 0], src[:, 1]


def _gather_px(images, yi, xi):
    """Pixels (N, HW, C) at the integer-valued float positions (yi, xi)
    (N, HW); 0 outside the image (JAX's ``_gather_px``)."""
    n, h, w, c = images.shape
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
    vals = torch.gather(images.reshape(n, h * w, c), 1,
                        idx[..., None].expand(n, h * w, c))
    return torch.where(valid[..., None], vals, 0.0)


def bilinear_gather_warp(images, inv):
    """JAX's gather warps ``_bilinear_warp_taps``, ``_flat`` and
    ``_patch`` (``augment.py:267-363``), which compute tap for tap the same
    result: each output pixel blends the four source pixels around its
    source position, zeros outside, the weights in the images' dtype."""
    n, h, w, c = images.shape
    sx, sy = _src_coords(h, w, inv)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx = (sx - x0).to(images.dtype)[..., None]
    wy = (sy - y0).to(images.dtype)[..., None]
    out = (_gather_px(images, y0, x0) * (1 - wy) * (1 - wx)
           + _gather_px(images, y0, x0 + 1) * (1 - wy) * wx
           + _gather_px(images, y0 + 1, x0) * wy * (1 - wx)
           + _gather_px(images, y0 + 1, x0 + 1) * wy * wx)
    return out.reshape(n, h, w, c)


def _lanczos4_weights(frac):
    """The 8 Lanczos-4 tap weights at offsets -3..4 from floor(src),
    normalised to sum 1 (JAX's ``_lanczos4_weights``)."""
    ws = []
    for i in range(8):
        t = (frac - (i - 3.0)).abs()
        pt = math.pi * torch.clamp(t, min=1e-8)
        val = 4.0 * torch.sin(pt) * torch.sin(pt / 4.0) / (pt * pt)
        ws.append(torch.where(t < 1e-6, 1.0,
                              torch.where(t < 4.0, val, 0.0)))
    total = sum(ws)
    return [wi / total for wi in ws]


def lanczos4_warp(images, inv, variant: str | None = None):
    """JAX's ``_lanczos4_warp``: an 8 x 8-tap Lanczos-4 resample at the
    source positions, out-of-image taps reading 0 with no renormalisation
    at the border, accumulated in fp32 and clamped to [0, 1]. `variant`
    is not read (Lanczos-4 has one form): it gives the call
    `bilinear_warp`'s signature."""
    n, h, w, c = images.shape
    sx, sy = _src_coords(h, w, inv)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wxs = _lanczos4_weights(sx - x0)
    wys = _lanczos4_weights(sy - y0)
    out = torch.zeros((n, h * w, c), dtype=torch.float32, device=images.device)
    for j in range(8):
        row = torch.zeros_like(out)
        for i in range(8):
            row += _gather_px(images, y0 + (j - 3), x0 + (i - 3)) \
                * wxs[i][..., None]
        out += row * wys[j][..., None]
    return torch.clamp(out, 0.0, 1.0).reshape(n, h, w, c)


WARP_VARIANTS = {"taps": bilinear_gather_warp, "flat": bilinear_gather_warp,
                 "patch": bilinear_gather_warp,
                 "shear_matmul": shear_matmul_warp}

def bilinear_warp(images, inv, variant: str | None = None):
    """JAX's ``_bilinear_warp``: the images (N, H, W, C) sampled at inv
    (N, 3, 3) @ output coordinates through the named variant (None reads
    ``ARSVT_WARP_VARIANT``, else ``shear_matmul``), in bf16 under
    ``ARSVT_AUGMENT_BF16``."""
    name = variant or os.environ.get("ARSVT_WARP_VARIANT", "shear_matmul")
    if name not in WARP_VARIANTS:
        raise KeyError(f"unknown warp variant {name!r}; one of "
                       f"{sorted(WARP_VARIANTS)}")
    return WARP_VARIANTS[name](augment_input_cast(images), inv)


# JAX's ``_WARPS``: the resampler of each interpolation, fn(images, inv,
# variant)
_WARPS = {"bilinear": bilinear_warp, "lanczos4": lanczos4_warp}


def transform_boxes(boxes, mask, fwd, h: int, w: int, *,
                    min_visibility: float, min_area_px: float,
                    method: str = "ellipse"):
    """JAX's ``_transform_boxes``, batched: normalised xyxy boxes (B, M, 4)
    through the forward matrices fwd (B, 3, 3); the new box is the axis-
    aligned box of the transformed inscribed ellipse ("ellipse", the
    reference's rule) or of the four transformed corners ("largest_box"),
    clipped to the image; a box stays valid if it keeps `min_area_px` of
    clipped area and `min_visibility` of its area."""
    px = boxes * torch.tensor([w, h, w, h], dtype=boxes.dtype,
                              device=boxes.device)
    x1, y1, x2, y2 = px.unbind(-1)
    f = fwd[:, None]  # (B, 1, 3, 3) against (B, M) coordinates
    if method == "ellipse":
        a = (x2 - x1) / 2.0
        b = (y2 - y1) / 2.0
        cx = (x1 + x2) / 2.0
        cy = (y1 + y2) / 2.0
        ncx = f[..., 0, 0] * cx + f[..., 0, 1] * cy + f[..., 0, 2]
        ncy = f[..., 1, 0] * cx + f[..., 1, 1] * cy + f[..., 1, 2]
        hx = torch.sqrt((f[..., 0, 0] * a) ** 2 + (f[..., 0, 1] * b) ** 2)
        hy = torch.sqrt((f[..., 1, 0] * a) ** 2 + (f[..., 1, 1] * b) ** 2)
        nx1, nx2 = ncx - hx, ncx + hx
        ny1, ny2 = ncy - hy, ncy + hy
    elif method == "largest_box":
        corners = torch.stack([torch.stack([x1, y1], -1),
                               torch.stack([x2, y1], -1),
                               torch.stack([x1, y2], -1),
                               torch.stack([x2, y2], -1)], dim=2)
        hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
        new = torch.einsum("bij,bmkj->bmki", fwd, hom)[..., :2]
        nx1, ny1 = new[..., 0].amin(dim=2), new[..., 1].amin(dim=2)
        nx2, ny2 = new[..., 0].amax(dim=2), new[..., 1].amax(dim=2)
    else:
        raise ValueError(f"unknown box method {method!r}")
    full_area = torch.clamp(nx2 - nx1, min=0) * torch.clamp(ny2 - ny1, min=0)
    cx1, cy1 = torch.clamp(nx1, 0, w), torch.clamp(ny1, 0, h)
    cx2, cy2 = torch.clamp(nx2, 0, w), torch.clamp(ny2, 0, h)
    clip_area = torch.clamp(cx2 - cx1, min=0) * torch.clamp(cy2 - cy1, min=0)
    visibility = clip_area / torch.clamp(full_area, min=1e-6)
    new_mask = mask & (clip_area >= min_area_px) & \
        (visibility >= min_visibility)
    out = torch.stack([cx1 / w, cy1 / h, cx2 / w, cy2 / h], dim=-1)
    return out.to(boxes.dtype), new_mask


def random_affine(images, boxes, mask, apply, theta_deg, scale, translate,
                  shear_deg, *, min_visibility: float = 0.1,
                  min_area_px: float = 1.0, box_method: str = "ellipse",
                  interpolation: str = "bilinear",
                  warp_variant: str | None = None):
    """JAX's ``random_affine`` with explicit draws: apply (B,) bool,
    theta_deg and scale (B,), translate and shear_deg (B, 2); the images
    resampled by `bilinear_warp` (`warp_variant`) or, with interpolation
    "lanczos4", `lanczos4_warp`. Only the images that apply are warped;
    the others (in the warp's output dtype, as JAX casts them), their
    boxes and masks pass through."""
    b, h, w, _ = images.shape
    fwd = affine_matrix(h, w, theta_deg, scale, translate, shear_deg)
    new_boxes, new_mask = transform_boxes(
        boxes, mask, fwd, h, w, min_visibility=min_visibility,
        min_area_px=min_area_px, method=box_method)
    warp = _WARPS[interpolation]
    # in the warp's output dtype: the bilinear warps' input cast,
    # Lanczos-4's fp32 sums
    out = (augment_input_cast(images) if warp is bilinear_warp
           else images.float()).clone()
    # `apply` stays on the host in the train step's draws, so picking the
    # images to warp waits on nothing
    idx = apply.cpu().nonzero().flatten().to(images.device)
    if idx.numel():
        out[idx] = warp(images[idx], torch.linalg.inv(fwd[idx]),
                        warp_variant)
    sel = apply.to(images.device)[:, None]
    return (out, torch.where(sel[..., None], new_boxes, boxes),
            torch.where(sel, new_mask, mask))


@dataclasses.dataclass(frozen=True)
class DetectionAugmentConfig:
    """JAX's ``DetectionAugmentConfig``: parity with the reference's train
    pipeline, parameter by parameter."""

    image_size: int = 224
    shadow_p: float = 0.5
    shadow_num: tuple = (1, 3)
    shadow_intensity: tuple = (0.2, 0.7)
    shadow_roi: tuple = (0.0, 0.7, 1.0, 1.0)
    flip_p: float = 0.5
    affine_p: float = 0.5
    degrees: float = 45.0
    scale: tuple = (0.95, 1.05)
    translate: float = 0.05
    shear: float = 15.0
    box_rotate_method: str = "ellipse"
    jitter_p: float = 0.6
    jitter_brightness: float = 0.1
    jitter_contrast: float = 0.15
    jitter_saturation: float = 0.2
    jitter_hue: float = 0.03
    dropout_p: float = 0.25
    dropout_holes: tuple = (1, 3)
    dropout_size: tuple = (0.05, 0.12)
    dropout_fill: float = 1.0
    min_visibility: float = 0.1
    min_area_px: float = 1.0
    interpolation: str = "bilinear"
    warp_variant: str = ""


@dataclasses.dataclass(frozen=True)
class DetectionDraws:
    """The per-image values of one detection augmentation: (B,) or
    (B, K) each, K the most shadows or holes."""

    shadow_apply: torch.Tensor
    shadow_n: torch.Tensor
    shadow_angle: torch.Tensor
    shadow_ox: torch.Tensor
    shadow_oy: torch.Tensor
    shadow_intensity: torch.Tensor
    flip: torch.Tensor
    affine_apply: torch.Tensor
    theta_deg: torch.Tensor
    scale: torch.Tensor
    translate: torch.Tensor
    shear_deg: torch.Tensor
    jitter_apply: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    order: torch.Tensor
    hole_apply: torch.Tensor
    hole_n: torch.Tensor
    hole_h: torch.Tensor
    hole_w: torch.Tensor
    hole_y: torch.Tensor
    hole_x: torch.Tensor

    def to(self, device) -> "DetectionDraws":
        """Every value on `device`, except `affine_apply`, which stays on
        the host: `random_affine` reads it there to pick the images it
        warps."""
        return DetectionDraws(*(
            t if f.name == "affine_apply" else t.to(device)
            for f, t in ((f, getattr(self, f.name))
                         for f in dataclasses.fields(self))))


def warp_variant(cfg) -> str:
    """The bilinear warp JAX's `_bilinear_warp` takes for a classify or
    detection config: the config's, else ``ARSVT_WARP_VARIANT``, else
    ``shear_matmul``."""
    return cfg.warp_variant or os.environ.get("ARSVT_WARP_VARIANT",
                                              "shear_matmul")


def check_detection_supported(cfg: DetectionAugmentConfig) -> None:
    """Raise KeyError for an unknown resampler name where JAX's lookups
    would (``_WARPS[interpolation]``, then ``_BILINEAR_VARIANTS[variant]``),
    before any draw."""
    if _WARPS[cfg.interpolation] is bilinear_warp:
        WARP_VARIANTS[warp_variant(cfg)]  # the lookup raises KeyError


def draw_detection_augment(gen: torch.Generator, n: int,
                           cfg: DetectionAugmentConfig) -> DetectionDraws:
    """The host draws for `detection_train_augment` on n images, from the
    distributions of ``augment.py:133-759``."""
    check_detection_supported(cfg)

    def uniform(lo, hi, *shape):
        return torch.rand((n, *shape), generator=gen) * (hi - lo) + lo

    def bernoulli(p):
        return torch.rand(n, generator=gen) < p

    def count(lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=gen)

    ks = cfg.shadow_num[1]
    rx1, ry1, rx2, ry2 = cfg.shadow_roi
    kh = cfg.dropout_holes[1]
    lo, hi = cfg.dropout_size
    before = dict(
        shadow_apply=bernoulli(cfg.shadow_p),
        shadow_n=count(*cfg.shadow_num),
        shadow_angle=uniform(0.0, math.pi, ks),
        shadow_ox=uniform(rx1, rx2, ks),
        shadow_oy=uniform(ry1, ry2, ks),
        shadow_intensity=uniform(*cfg.shadow_intensity, ks),
        flip=bernoulli(cfg.flip_p),
        affine_apply=bernoulli(cfg.affine_p),
        theta_deg=uniform(-cfg.degrees, cfg.degrees),
        scale=uniform(*cfg.scale),
        translate=uniform(-cfg.translate, cfg.translate, 2),
        shear_deg=uniform(-cfg.shear, cfg.shear, 2))
    j = draw_color_jitter(gen, n, p=cfg.jitter_p,
                          brightness=cfg.jitter_brightness,
                          contrast=cfg.jitter_contrast,
                          saturation=cfg.jitter_saturation,
                          hue=cfg.jitter_hue)
    return DetectionDraws(
        **before, jitter_apply=j.apply, brightness=j.brightness,
        contrast=j.contrast, saturation=j.saturation, hue=j.hue,
        order=j.order,
        hole_apply=bernoulli(cfg.dropout_p),
        hole_n=count(*cfg.dropout_holes),
        hole_h=uniform(lo, hi, kh),
        hole_w=uniform(lo, hi, kh),
        hole_y=uniform(0.0, 1.0, kh),
        hole_x=uniform(0.0, 1.0, kh),
    )


def detection_train_augment(images, boxes, mask, draws: DetectionDraws,
                            cfg: DetectionAugmentConfig):
    """The reference's train pipeline on canvas-sized images (B, H, W, C)
    in [0, 1] (fp32, or bf16 from `augment_input_cast`) with normalised
    xyxy boxes (B, M, 4) and validity (B, M), `draws` on the images'
    device: shadow → flip → affine → color jitter → coarse dropout →
    resize to cfg.image_size → normalize, each op in the dtype JAX's
    promotion gives it. Returns (images, boxes, mask)."""
    check_detection_supported(cfg)
    d = draws
    images = random_shadow(images, d.shadow_apply, d.shadow_n,
                           d.shadow_angle, d.shadow_ox, d.shadow_oy,
                           d.shadow_intensity, roi=cfg.shadow_roi)
    images = horizontal_flip(images, d.flip)
    boxes = flip_boxes(boxes, d.flip)
    images, boxes, mask = random_affine(
        images, boxes, mask, d.affine_apply, d.theta_deg, d.scale,
        d.translate, d.shear_deg, min_visibility=cfg.min_visibility,
        min_area_px=cfg.min_area_px, box_method=cfg.box_rotate_method,
        interpolation=cfg.interpolation, warp_variant=warp_variant(cfg))
    images = color_jitter(images, d.jitter_apply, d.brightness, d.contrast,
                          d.saturation, d.hue, d.order)
    images = coarse_dropout(images, d.hole_apply, d.hole_n, d.hole_h,
                            d.hole_w, d.hole_y, d.hole_x,
                            fill=cfg.dropout_fill)
    if images.shape[1] != cfg.image_size:
        images = resize(images, cfg.image_size)
    return normalize(images), boxes, mask


# ------------------------------------------------------------ randaugment

# JAX's ``_RA_OPS`` order (``augment.py:837-838``): a drawn index names one
RA_OPS = ("rotate", "posterize", "solarize", "brightness", "contrast",
          "color", "identity")
RA_ROTATE = RA_OPS.index("rotate")


@dataclasses.dataclass(frozen=True)
class RandAugmentDraws:
    """The per-image values of RandAugment's two rounds: op (B, 2) int64,
    the index into `RA_OPS` of each round's op, kept on the host; u (B, 2)
    fp32 in [0, 1), the one uniform each round's parameter key gives (an
    op that draws uniform(-1, 1) takes 2u - 1, JAX's map of the same
    bits; the identity ignores it)."""

    op: torch.Tensor
    u: torch.Tensor

    def to(self, device) -> "RandAugmentDraws":
        return RandAugmentDraws(self.op, self.u.to(device))


def draw_rand_augment(gen: torch.Generator, n: int) -> RandAugmentDraws:
    """The draws of JAX's ``rand_augment`` (``augment.py:860-906``, two
    rounds) for n images: a uniform op index and one uniform a round."""
    return RandAugmentDraws(op=torch.randint(0, len(RA_OPS), (n, 2),
                                             generator=gen),
                            u=torch.rand((n, 2), generator=gen))


def _signed(u):
    """``jax.random.uniform(key, minval=-1, maxval=1)`` from the bits that
    give uniform(key) = u: u · 2 - 1."""
    return u * 2.0 - 1.0


def _ra_posterize(images, u, m):
    bits = torch.round(8.0 - 4.0 * m * u)
    levels = torch.pow(2.0, bits)[:, None, None, None]
    return torch.floor(images * levels) / levels


def _ra_solarize(images, u, m):
    thresh = (1.0 - m * u)[:, None, None, None]
    return torch.where(images >= thresh, 1.0 - images, images)


def _ra_factor(u, m):
    return 1.0 + _signed(u) * 0.8 * m


def _ra_brightness(images, u, m):
    return torch.clamp(adjust_brightness(images, _ra_factor(u, m)), 0.0, 1.0)


def _ra_contrast(images, u, m):
    return torch.clamp(adjust_contrast(images, _ra_factor(u, m)), 0.0, 1.0)


def _ra_color(images, u, m):
    return torch.clamp(adjust_saturation(images, _ra_factor(u, m)), 0.0, 1.0)


_RA_POINTWISE = {RA_OPS.index("posterize"): _ra_posterize,
                 RA_OPS.index("solarize"): _ra_solarize,
                 RA_OPS.index("brightness"): _ra_brightness,
                 RA_OPS.index("contrast"): _ra_contrast,
                 RA_OPS.index("color"): _ra_color}


def ra_pointwise(images, op, u, magnitude: float):
    """One round's pointwise op on each image (rotate and identity pass
    the image through): op (B,) int on the host, u (B,) on the images'
    device. Each op runs on the images that drew it."""
    out = images
    for k, fn in _RA_POINTWISE.items():
        idx = (op == k).nonzero().flatten()
        if idx.numel():
            if out is images:
                out = images.clone()
            idx = idx.to(images.device)
            out[idx] = fn(images[idx], u[idx], magnitude)
    return out


def rotation_matrix(h: int, w: int, deg):
    """Forward maps (B, 3, 3) fp32 rotating by `deg` (B,) degrees about the
    image centre: centre · rotate · uncentre (``_ra_rotate_by_deg``)."""
    zeros = torch.zeros_like(deg)
    return affine_matrix(h, w, deg, torch.ones_like(deg),
                         torch.stack([zeros, zeros], -1),
                         torch.stack([zeros, zeros], -1))


def ra_rotate_by_deg(images, deg, variant: str | None = None):
    """JAX's ``_ra_rotate_by_deg`` on each image (B, H, W, C) by deg (B,):
    `bilinear_warp` at the inverse of the rotation about the centre."""
    h, w = images.shape[1:3]
    return bilinear_warp(images,
                         torch.linalg.inv(rotation_matrix(h, w, deg)),
                         variant)


def rand_augment(images, draws: RandAugmentDraws, *, magnitude: float = 0.5,
                 warp_variant: str | None = None):
    """JAX's ``rand_augment`` with ``num_ops=2`` in its fused form
    ``P2 ∘ W(θ1 + θ2) ∘ P1`` (``augment.py:881-906``): round r applies its
    pointwise op, or contributes its angle θr = (2u - 1) · 30 · magnitude
    when it drew rotate; the one warp at the summed angle sits between the
    rounds. Where both rounds rotate, that is one resample at θ1 + θ2 (as
    JAX's code does, not two warps as its docstring says). Only the
    images with a non-zero summed angle are warped: W(0) is the identity
    to the bit for every variant, so the result is JAX's.

    Raises TypeError under ``ARSVT_AUGMENT_BF16``, where JAX's trace fails
    (posterize promotes bf16 to fp32 and ``lax.switch`` refuses branches
    of two dtypes)."""
    if os.environ.get("ARSVT_AUGMENT_BF16") or images.dtype != torch.float32:
        raise TypeError(
            "RandAugment runs in fp32 only: JAX's rand_augment fails in bf16 "
            "(ARSVT_AUGMENT_BF16), its posterize branch returning fp32 where "
            "lax.switch needs every branch in the image's dtype")
    op, u = draws.op.cpu(), draws.u.to(images.device)
    m = magnitude
    rotating = op == RA_ROTATE
    # θ1 + θ2, each 0 where its round does not rotate
    deg = torch.where(rotating.to(u.device), _signed(u) * 30.0 * m,
                      0.0).sum(dim=1)
    images = ra_pointwise(images, op[:, 0], u[:, 0], m)
    idx = rotating.any(dim=1).nonzero().flatten().to(images.device)
    if idx.numel():
        images = images.index_copy(0, idx, ra_rotate_by_deg(
            images[idx], deg[idx], warp_variant))
    return ra_pointwise(images, op[:, 1], u[:, 1], m)
