"""On-device image augmentation (``arsvt_tpu/data/augment.py``): the
classification crop/flip, the detection pipeline (shadow → flip with boxes
→ affine with boxes → color jitter → coarse dropout → resize →
normalize), eval preprocessing and ImageNet normalization.

Images are batched NHWC fp32 in [0, 1]. Each random op is split in two: a
draw function that takes a `torch.Generator` and returns the per-image
values, and an apply function that takes those values explicitly (so a
test can feed it ``jax.random``'s own draws). The resample is JAX's
``jax.image.scale_and_translate`` with the linear (triangle) kernel and
antialiasing: a separable (in, out) weight matrix per axis, the kernel
widened by 1/scale when downscaling, normalized per output, zero where
the sample falls outside [-0.5, n - 0.5]; applied with two batched
products. ``F.interpolate(antialias=True)`` is a different filter.

The detection affine resamples with ``_shear_matmul_warp``, JAX's
default: three 1-D linear passes, each a product with a band matrix of
two-tap weights (``torch.einsum``; XLA's dots in JAX), chunked over
columns and rows as JAX chunks them. Boxes move through the affine matrix
itself (the ellipse or corner rule) and lose validity as JAX's.

JAX's warp switches are read from the environment at each call:
``ARSVT_SHEAR_MAXSKEW`` sizes the shear warp's pad (JAX reads it once, at
import) and ``ARSVT_WARP_VARIANT`` names the warp where the config leaves
``warp_variant`` empty; a variant other than ``shear_matmul`` raises.

Not ported yet: RandAugment, color jitter in the classification pipeline,
the gather warps and Lanczos-4, and the bf16 augmentation opt-in
(``ARSVT_AUGMENT_BF16``, which raises) — the ViT-L recipe (ROADMAP Queue
A item 8).
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


def shear_matmul_warp(images, inv):
    """JAX's ``_shear_matmul_warp`` on (N, H, W, C) images with the
    out->src maps inv (N, 3, 3): x scale + translate, then y scale +
    shear per column, then x shear per row, each a band-matrix product;
    zeros outside the source."""
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
                  min_area_px: float = 1.0, box_method: str = "ellipse"):
    """JAX's ``random_affine`` (bilinear through the shear warp) with
    explicit draws: apply (B,) bool, theta_deg and scale (B,), translate
    and shear_deg (B, 2). Only the images that apply are warped; the
    others, their boxes and masks pass through."""
    b, h, w, _ = images.shape
    fwd = affine_matrix(h, w, theta_deg, scale, translate, shear_deg)
    new_boxes, new_mask = transform_boxes(
        boxes, mask, fwd, h, w, min_visibility=min_visibility,
        min_area_px=min_area_px, method=box_method)
    out = images.clone()
    # `apply` stays on the host in the train step's draws, so picking the
    # images to warp waits on nothing
    idx = apply.cpu().nonzero().flatten().to(images.device)
    if idx.numel():
        inv = torch.linalg.inv(fwd[idx])
        out[idx] = shear_matmul_warp(images[idx], inv)
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


def warp_variant(cfg: DetectionAugmentConfig) -> str:
    """The bilinear warp JAX's `_bilinear_warp` takes: the config's, else
    ``ARSVT_WARP_VARIANT``, else ``shear_matmul``."""
    return cfg.warp_variant or os.environ.get("ARSVT_WARP_VARIANT",
                                              "shear_matmul")


def check_detection_supported(cfg: DetectionAugmentConfig) -> None:
    variant = warp_variant(cfg)
    if cfg.interpolation != "bilinear" or variant != "shear_matmul":
        raise NotImplementedError(
            f"detection augmentation with interpolation="
            f"{cfg.interpolation!r}, warp variant {variant!r} is not ported "
            "yet: the port resamples with the shear warp only (ROADMAP "
            "Queue A item 8, the ViT-L recipe's warps)")
    if os.environ.get("ARSVT_AUGMENT_BF16"):
        raise NotImplementedError(
            "ARSVT_AUGMENT_BF16 (the warp and the ops after it in bf16) is "
            "not ported yet (ROADMAP Queue A item 8, the ViT-L recipe)")


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
    return DetectionDraws(
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
        shear_deg=uniform(-cfg.shear, cfg.shear, 2),
        jitter_apply=bernoulli(cfg.jitter_p),
        brightness=uniform(1 - cfg.jitter_brightness,
                           1 + cfg.jitter_brightness),
        contrast=uniform(1 - cfg.jitter_contrast, 1 + cfg.jitter_contrast),
        saturation=uniform(1 - cfg.jitter_saturation,
                           1 + cfg.jitter_saturation),
        hue=uniform(-cfg.jitter_hue, cfg.jitter_hue) * 2.0 * math.pi,
        order=torch.argsort(torch.rand((n, 4), generator=gen), dim=1),
        hole_apply=bernoulli(cfg.dropout_p),
        hole_n=count(*cfg.dropout_holes),
        hole_h=uniform(lo, hi, kh),
        hole_w=uniform(lo, hi, kh),
        hole_y=uniform(0.0, 1.0, kh),
        hole_x=uniform(0.0, 1.0, kh),
    )


def detection_train_augment(images, boxes, mask, draws: DetectionDraws,
                            cfg: DetectionAugmentConfig):
    """The reference's train pipeline on canvas-sized fp32 images (B, H,
    W, C) in [0, 1] with normalised xyxy boxes (B, M, 4) and validity
    (B, M), `draws` on the images' device: shadow → flip → affine →
    color jitter → coarse dropout → resize to cfg.image_size → normalize.
    Returns (images, boxes, mask)."""
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
        min_area_px=cfg.min_area_px, box_method=cfg.box_rotate_method)
    images = color_jitter(images, d.jitter_apply, d.brightness, d.contrast,
                          d.saturation, d.hue, d.order)
    images = coarse_dropout(images, d.hole_apply, d.hole_n, d.hole_h,
                            d.hole_w, d.hole_y, d.hole_x,
                            fill=cfg.dropout_fill)
    if images.shape[1] != cfg.image_size:
        images = resize(images, cfg.image_size)
    return normalize(images), boxes, mask
