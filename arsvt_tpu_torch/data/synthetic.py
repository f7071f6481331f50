"""Synthetic classification batches for smoke training and tests (copy of
``arsvt_tpu/data/synthetic.py::synthetic_classification_batches``).

A generated 6-class image set with a learnable class signal: a mean colour
per class, additive noise, and a brighter square whose position depends
on the class. numpy draws, so a seed gives the JAX package's arrays to the
bit.
"""

from __future__ import annotations

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
