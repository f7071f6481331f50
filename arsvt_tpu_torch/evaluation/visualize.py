"""Prediction visualization: predictions beside the ground truth (copy of
``arsvt_tpu/evaluation/visualize.py``).

Denormalizes with the ImageNet statistics where asked, draws the predicted
boxes with class and score next to the ground-truth boxes, and saves
``eval_batch_{i}_img_{j}.png``. matplotlib is imported inside the
functions, so serving never loads it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from arsvt_tpu_torch.data.augment import denormalize as _imagenet_denormalize
from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES

_COLORS = ["tab:red", "tab:blue", "tab:green", "tab:orange", "tab:purple",
           "tab:brown"]


def _to_display(image: np.ndarray, *, denormalize: bool) -> np.ndarray:
    img = np.asarray(image, np.float32)
    if denormalize:
        # the one normalization rule lives in data/augment.py
        img = _imagenet_denormalize(torch.from_numpy(img)).numpy()
    return np.clip(img, 0.0, 1.0)


def _draw_boxes(ax, boxes, labels, scores, names, h, w):
    import matplotlib.patches as patches

    for i in range(len(boxes)):
        x1, y1, x2, y2 = boxes[i]
        x1, y1, x2, y2 = x1 * w, y1 * h, x2 * w, y2 * h
        cls = int(labels[i])
        color = _COLORS[cls % len(_COLORS)]
        ax.add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, fill=False, linewidth=2,
            edgecolor=color,
        ))
        name = names[cls] if cls < len(names) else str(cls)
        text = f"{name} {scores[i]:.2f}" if scores is not None else name
        ax.text(x1, max(y1 - 2, 0), text, color="white", fontsize=8,
                bbox={"facecolor": color, "alpha": 0.7, "pad": 1})


def visualize_predictions(
    image,
    pred: dict,
    gt: dict | None = None,
    *,
    out_path: str,
    class_names=RECYCLING_CLASSES,
    denormalize: bool = False,
):
    """One image -> one PNG. pred: {'boxes' (N,4) xyxy norm, 'labels',
    'scores'}; gt: {'boxes', 'labels'} or None."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = _to_display(image, denormalize=denormalize)
    h, w = img.shape[:2]
    ncols = 2 if gt is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 6))
    axes = np.atleast_1d(axes)
    axes[0].imshow(img)
    axes[0].set_title("predictions")
    axes[0].axis("off")
    scores = pred.get("scores")
    _draw_boxes(axes[0], np.asarray(pred["boxes"]),
                np.asarray(pred["labels"]),
                None if scores is None else np.asarray(scores),
                class_names, h, w)
    if gt is not None:
        axes[1].imshow(img)
        axes[1].set_title("ground truth")
        axes[1].axis("off")
        _draw_boxes(axes[1], np.asarray(gt["boxes"]),
                    np.asarray(gt["labels"]), None, class_names, h, w)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return out_path


def visualize_batch(images, posts, targets=None, *, out_dir: str,
                    batch_index: int = 0, max_images: int = 2,
                    class_names=RECYCLING_CLASSES, denormalize: bool = False):
    """The first `max_images` images of one batch, one PNG each. posts:
    output of `post_process` (arrays or tensors)."""
    paths = []
    n = min(int(images.shape[0]), max_images)
    for j in range(n):
        valid = np.asarray(posts["valid"][j])
        pred = {
            "boxes": np.asarray(posts["boxes"][j])[valid],
            "labels": np.asarray(posts["labels"][j])[valid],
            "scores": np.asarray(posts["scores"][j])[valid],
        }
        gt = None
        if targets is not None:
            gmask = np.asarray(targets["mask"][j])
            gt = {
                "boxes": np.asarray(targets["boxes"][j])[gmask],
                "labels": np.asarray(targets["labels"][j])[gmask],
            }
        paths.append(visualize_predictions(
            np.asarray(images[j]), pred, gt,
            out_path=os.path.join(
                out_dir, f"eval_batch_{batch_index}_img_{j}.png"
            ),
            class_names=class_names, denormalize=denormalize,
        ))
    return paths
