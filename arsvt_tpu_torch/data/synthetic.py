"""Synthetic datasets for smoke training, tests and the card's drive
(copy of ``arsvt_tpu/data/synthetic.py``).

A generated 6-class image set with a learnable class signal (a mean colour
per class, additive noise, and a brighter square whose position depends
on the class); 6-class shape images whose only signal is geometry and
texture; and a small COCO-format detection directory (images and
``_annotations.coco.json`` per split). numpy draws in JAX's order, so a
seed gives the JAX package's arrays and files to the bit.
"""

from __future__ import annotations

import json
import os

import numpy as np

from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES

# distinct mean colors per class — a signal tiny ViTs can learn in tens of
# steps, with additive noise so it is not linearly trivial
_CLASS_COLORS = np.array(
    [
        [0.2, 0.8, 0.8],  # glass
        [0.9, 0.9, 0.85],  # paper
        [0.7, 0.5, 0.2],  # cardboard
        [0.9, 0.3, 0.3],  # plastic
        [0.6, 0.6, 0.7],  # metal
        [0.25, 0.25, 0.2],  # trash
    ],
    dtype=np.float32,
)


def synthetic_classification_batches(
    *, batch_size: int, image_size: int, seed: int = 0, noise: float = 0.25,
    num_classes: int = len(RECYCLING_CLASSES),
):
    """Infinite generator of {"image": (B,S,S,3) f32, "label": (B,) i32}."""
    rng = np.random.default_rng(seed)
    while True:
        labels = rng.integers(0, num_classes, size=(batch_size,))
        base = _CLASS_COLORS[labels % len(_CLASS_COLORS)]
        imgs = np.broadcast_to(
            base[:, None, None, :], (batch_size, image_size, image_size, 3)
        ).copy()
        imgs += noise * rng.standard_normal(imgs.shape).astype(np.float32)
        # textured square patch whose position also correlates with class
        for i, lab in enumerate(labels):
            s = image_size // 4
            off = (int(lab) * s) % max(image_size - s, 1)
            imgs[i, off : off + s, off : off + s] += 0.5
        yield {
            "image": imgs.astype(np.float32),
            "label": labels.astype(np.int32),
        }


def _shape_mask(label: int, size: int, rng) -> np.ndarray:
    """Boolean mask of one randomly-placed/rotated/sized shape. The class
    signal is GEOMETRY/TEXTURE only — colors are sampled identically for
    every class (see synthetic_shape_image), so a color histogram or linear
    probe on mean color carries zero class information."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r = rng.uniform(0.22, 0.38) * size
    cy = rng.uniform(r, size - r)
    cx = rng.uniform(r, size - r)
    theta = rng.uniform(0, 2 * np.pi)
    u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
    dist = np.hypot(u, v)
    if label == 0:    # glass: filled disk
        return dist < r
    if label == 1:    # paper: thin rectangle
        return (np.abs(u) < r) & (np.abs(v) < 0.4 * r)
    if label == 2:    # cardboard: triangle
        return (v > -0.5 * r) & (np.abs(u) < (r - v) * 0.55)
    if label == 3:    # plastic: ring (annulus)
        return (dist < r) & (dist > 0.55 * r)
    if label == 4:    # metal: plus / cross
        return ((np.abs(u) < 0.32 * r) & (np.abs(v) < r)) | (
            (np.abs(v) < 0.32 * r) & (np.abs(u) < r))
    # trash: striped disk — same silhouette as class 0, texture differs
    stripes = np.sin(u * (2 * np.pi / (0.28 * r))) > 0
    return (dist < r) & stripes


def synthetic_shape_image(label: int, size: int, rng,
                          noise: float = 0.05) -> np.ndarray:
    """One fp32 [0,1] HWC image whose ONLY class signal is shape/texture."""
    for _ in range(20):
        fg = rng.uniform(0.1, 0.95, 3).astype(np.float32)
        bg = rng.uniform(0.1, 0.95, 3).astype(np.float32)
        if np.abs(fg - bg).sum() > 0.6:  # keep the shape visible
            break
    img = np.broadcast_to(bg, (size, size, 3)).copy()
    mask = _shape_mask(label, size, rng)
    img[mask] = fg
    img += noise * rng.standard_normal(img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def synthetic_shape_batches(*, batch_size: int, image_size: int,
                            seed: int = 0, num_classes: int = len(RECYCLING_CLASSES)):
    """Infinite non-color-separable 6-class batches (fresh draws from a
    disjoint seed make a held-out split)."""
    rng = np.random.default_rng(seed)
    while True:
        labels = rng.integers(0, num_classes, size=(batch_size,))
        imgs = np.stack([
            synthetic_shape_image(int(lab), image_size, rng)
            for lab in labels
        ])
        yield {
            "image": imgs.astype(np.float32),
            "label": labels.astype(np.int32),
        }


def make_synthetic_coco(
    root: str, *, splits=("train", "valid", "test"), images_per_split: int = 8,
    image_size: int = 64, max_boxes: int = 3, seed: int = 0,
) -> str:
    """Write a tiny COCO-format detection dataset; returns `root`."""
    rng = np.random.default_rng(seed)
    from PIL import Image

    for split in splits:
        split_dir = os.path.join(root, split)
        os.makedirs(split_dir, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for img_id in range(1, images_per_split + 1):
            fname = f"img_{img_id:04d}.jpg"
            img = rng.uniform(0.3, 0.7, (image_size, image_size, 3))
            n_boxes = int(rng.integers(0, max_boxes + 1))
            placed: list[tuple[float, float, float, float]] = []
            for _ in range(n_boxes):
                cat = int(rng.integers(0, len(RECYCLING_CLASSES)))
                # rejection-sample a non-overlapping placement: a later box
                # painted over an earlier one leaves the earlier annotation
                # with no visible evidence — unlearnable GT that teaches the
                # model to hallucinate
                for _attempt in range(20):
                    w = float(rng.uniform(8, image_size // 2))
                    h = float(rng.uniform(8, image_size // 2))
                    x = float(rng.uniform(0, image_size - w))
                    y = float(rng.uniform(0, image_size - h))
                    if all(
                        x >= px + pw or px >= x + w or y >= py + ph
                        or py >= y + h
                        for (px, py, pw, ph) in placed
                    ):
                        break
                else:
                    continue  # no free spot found — drop this box
                placed.append((x, y, w, h))
                img[int(y) : int(y + h), int(x) : int(x + w)] = _CLASS_COLORS[cat]
                annotations.append(
                    {
                        "id": ann_id,
                        "image_id": img_id,
                        # COCO bbox format: [x, y, w, h] in pixels
                        "bbox": [x, y, w, h],
                        "category_id": cat + 1,  # COCO ids are 1-based
                        "area": w * h,
                        "iscrowd": 0,
                    }
                )
                ann_id += 1
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(split_dir, fname), quality=95
            )
            images.append(
                {
                    "id": img_id,
                    "file_name": fname,
                    "width": image_size,
                    "height": image_size,
                }
            )
        coco = {
            "images": images,
            "annotations": annotations,
            "categories": [
                {"id": i + 1, "name": name, "supercategory": "waste"}
                for i, name in enumerate(RECYCLING_CLASSES)
            ],
        }
        with open(os.path.join(split_dir, "_annotations.coco.json"), "w") as f:
            json.dump(coco, f)
    return root
