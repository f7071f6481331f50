"""Classification evaluation and the streaming sorter-loop classifier
(counterpart of ``arsvt_tpu/evaluation/classify.py``'s
``evaluate_classifier`` and ``StreamingClassifier``).

`evaluate_classifier` sweeps batches into top-1, per-class accuracy and a
confusion matrix. `StreamingClassifier`: JPEG/PNG decode -> letterbox ->
rescale/normalize on the device -> classify, with a rolling p50 latency
meter. Both run on the card unless the caller asks for the CPU. The int8
option (``quantize``) is not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from arsvt_tpu_torch.core.dtypes import (
    check_unit_range_images,
    to_unit_float,
    tree_map,
)
from arsvt_tpu_torch.data.augment import eval_preprocess, normalize
from arsvt_tpu_torch.data.pipeline import letterbox_u8, load_image_u8
from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES, class_name
from arsvt_tpu_torch.models.classifier import apply_image_classifier
from arsvt_tpu_torch.objectives.classification import confusion_matrix
from arsvt_tpu_torch.utils.latency import LatencyWindow


def resolve_device(device=None) -> torch.device:
    """`None` means the card; without one, that raises instead of running
    on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def evaluate_classifier(params, batches, backbone_cfg, num_classes: int, *,
                        compute_dtype=torch.bfloat16,
                        normalize_inputs: bool = False, device=None) -> dict:
    """Full eval sweep -> {top1, per_class_accuracy, confusion_matrix, n}.

    `batches` yields {"image": (B, H, W, C) uint8 or [0,1] float, "label":
    (B,) int}, as numpy arrays or tensors. `normalize_inputs` must match
    the training contract (``cfg.augment != "none"``): then each image is
    resized to the model's size and ImageNet-normalized, as the train
    step's eval does.
    """
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    correct, total = 0, 0
    conf = np.zeros((num_classes, num_classes), np.int64)
    with torch.inference_mode():
        for batch in batches:
            images = torch.as_tensor(np.asarray(batch["image"])).to(dev)
            labels = torch.as_tensor(np.asarray(batch["label"])).to(dev)
            x = to_unit_float(images, torch.float32)
            if normalize_inputs:
                x = eval_preprocess(x, size=backbone_cfg.image_size)
            logits = apply_image_classifier(
                params, x.to(compute_dtype), backbone_cfg, num_classes)
            preds = logits.argmax(dim=-1)
            correct += int((preds == labels).sum())
            total += int(labels.shape[0])
            conf += confusion_matrix(preds, labels,
                                     num_classes).cpu().numpy()
    per_class = {}
    for i, name in enumerate(RECYCLING_CLASSES[:num_classes]):
        row = conf[i].sum()
        per_class[name] = float(conf[i, i] / row) if row else float("nan")
    return {
        "top1": correct / total if total else float("nan"),
        "per_class_accuracy": per_class,
        "confusion_matrix": conf.tolist(),
        "n": total,
    }


class StreamingClassifier(LatencyWindow):
    """Single-image classify path for the physical sorter loop.

    `__call__` takes one HWC uint8 or [0,1]-float image and returns
    (class_index, class_name, probs). uint8 is rescaled and (when
    `normalize_inputs`, the default, matching checkpoints trained with
    augment != "none") ImageNet-normalized inside the forward, in fp32,
    before the cast to `compute_dtype`. `params` is the port's parameter
    tree (``models/bridge.py`` or ``init_image_classifier``); it is moved
    to `device` once.
    """

    def __init__(self, params, backbone_cfg, num_classes: int, *,
                 compute_dtype=torch.bfloat16,
                 normalize_inputs: bool = True, device=None):
        self._device = resolve_device(device)
        self._cfg = backbone_cfg
        self._n = num_classes
        self._compute_dtype = compute_dtype
        self._normalize_inputs = normalize_inputs
        self._latencies = self.new_window()
        self._params = tree_map(lambda t: t.to(self._device), params)
        # warm-up: the first CUDA forward builds the kernels and creates
        # the library handles, so the first real frame is not an outlier
        s = backbone_cfg.image_size
        self._infer_batched(np.zeros((1, s, s, 3), np.uint8))

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def image_size(self) -> int:
        return self._cfg.image_size

    def _infer_batched(self, images) -> tuple[np.ndarray, np.ndarray]:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(images))
            x = x.to(self._device)
            x = to_unit_float(x, torch.float32)
            if self._normalize_inputs:
                x = normalize(x)
            logits = apply_image_classifier(
                self._params, x.to(self._compute_dtype), self._cfg, self._n)
            # the one device-to-host copy of the call; argmax on the host
            # picks the first maximum, as jnp.argmax does
            probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        return probs.argmax(axis=-1), probs

    def __call__(self, image) -> tuple[int, str, np.ndarray]:
        t0 = time.perf_counter()
        if self._normalize_inputs:
            check_unit_range_images(
                image, "StreamingClassifier(normalize_inputs=True)")
        idx, probs = self._infer_batched(np.asarray(image)[None])
        idx = int(idx[0])
        self._latencies.append(time.perf_counter() - t0)
        return idx, class_name(idx), probs[0]

    def infer_batch(self, images) -> tuple[np.ndarray, np.ndarray]:
        """Batched forward for the serving micro-batcher: (B, S, S, 3)
        uint8 or [0,1]-float images -> (class_idx[B], probs[B, C])."""
        if self._normalize_inputs:
            check_unit_range_images(images,
                                    "infer_batch(normalize_inputs=True)")
        return self._infer_batched(images)

    def classify_path(self, path: str) -> tuple[int, str, np.ndarray]:
        """Full sorter-loop step: decode (PIL, EXIF-upright) -> letterbox
        -> rescale/normalize -> classify. The latency sample includes the
        decode."""
        t0 = time.perf_counter()
        image, _ = letterbox_u8(load_image_u8(path), self._cfg.image_size)
        result = self(image)
        self.replace_last_latency(time.perf_counter() - t0)
        return result
