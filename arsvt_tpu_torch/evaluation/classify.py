"""Classification evaluation and the streaming sorter-loop engines
(counterpart of ``arsvt_tpu/evaluation/classify.py``'s
``evaluate_classifier``, ``StreamingClassifier`` and
``StreamingDetector``).

`evaluate_classifier` sweeps batches into top-1, per-class accuracy and a
confusion matrix. `StreamingClassifier`: JPEG/PNG decode -> letterbox ->
rescale/normalize on the device -> classify. `StreamingDetector`: the same
front end -> DETR forward -> post-processing (confidence threshold and
class-aware NMS). Both engines keep a rolling latency window. All run on
the card unless the caller asks for the CPU. ``quantize="int8"`` runs the
W8A8 backbone of ``models/quantized.py`` (int8 products with per-token
activation scales, int8 weights on the device) in all three.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from arsvt_tpu_torch.core.devices import resolve_device
from arsvt_tpu_torch.core.dtypes import (
    check_unit_range_images,
    to_unit_float,
    tree_map,
)
from arsvt_tpu_torch.data.augment import eval_preprocess, normalize
from arsvt_tpu_torch.data.pipeline import load_letterboxed_single
from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES, class_name
from arsvt_tpu_torch.evaluation.detect import post_process
from arsvt_tpu_torch.models.classifier import apply_image_classifier
from arsvt_tpu_torch.models.detector import apply_detector
from arsvt_tpu_torch.models.quantized import (
    apply_detector_int8,
    apply_image_classifier_int8,
    quantize_detector,
    quantize_image_classifier,
)
from arsvt_tpu_torch.objectives.classification import confusion_matrix
from arsvt_tpu_torch.utils.latency import LatencyWindow


def check_quantize(quantize) -> None:
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")


def classifier_params(params, backbone_cfg, quantize, device) -> dict:
    """The tree an engine serves: `params` on `device`, quantized there
    when `quantize` is "int8"."""
    check_quantize(quantize)
    params = tree_map(lambda t: t.to(device), params)
    if quantize == "int8":
        params = quantize_image_classifier(params, backbone_cfg)
    return params


def detector_params(params, detector_cfg, quantize, device) -> dict:
    """`classifier_params` for a detector tree."""
    check_quantize(quantize)
    params = tree_map(lambda t: t.to(device), params)
    if quantize == "int8":
        params = quantize_detector(params, detector_cfg)
    return params


def classifier_logits(params, x, backbone_cfg, num_classes: int,
                      quantize) -> torch.Tensor:
    """x (B, H, W, C) in the compute dtype -> fp32 logits, through the
    int8 backbone when `quantize` is "int8"."""
    if quantize == "int8":
        return apply_image_classifier_int8(params, x, backbone_cfg,
                                           num_classes, compute_dtype=x.dtype)
    return apply_image_classifier(params, x, backbone_cfg, num_classes)


def detector_outputs(params, x, detector_cfg, quantize) -> dict:
    """x (B, H, W, C) in the compute dtype -> the raw head outputs, through
    the int8 backbone when `quantize` is "int8"."""
    if quantize == "int8":
        return apply_detector_int8(params, x, detector_cfg,
                                   compute_dtype=x.dtype)
    return apply_detector(params, x, detector_cfg)


def evaluate_classifier(params, batches, backbone_cfg, num_classes: int, *,
                        compute_dtype=torch.bfloat16,
                        normalize_inputs: bool = False,
                        quantize: str | None = None, device=None) -> dict:
    """Full eval sweep -> {top1, per_class_accuracy, confusion_matrix, n}.

    `batches` yields {"image": (B, H, W, C) uint8 or [0,1] float, "label":
    (B,) int}, as numpy arrays or tensors. `normalize_inputs` must match
    the training contract (``cfg.augment != "none"``): then each image is
    resized to the model's size and ImageNet-normalized, as the train
    step's eval does. `quantize="int8"` runs the W8A8 backbone.
    """
    dev = resolve_device(device)
    params = classifier_params(params, backbone_cfg, quantize, dev)
    correct, total = 0, 0
    conf = np.zeros((num_classes, num_classes), np.int64)
    with torch.inference_mode():
        for batch in batches:
            images = torch.as_tensor(np.asarray(batch["image"])).to(dev)
            labels = torch.as_tensor(np.asarray(batch["label"])).to(dev)
            x = to_unit_float(images, torch.float32)
            if normalize_inputs:
                x = eval_preprocess(x, size=backbone_cfg.image_size)
            logits = classifier_logits(params, x.to(compute_dtype),
                                       backbone_cfg, num_classes, quantize)
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
    to `device` once, and quantized there once with `quantize="int8"`.
    `preprocess`, where given, maps each image `__call__` receives before
    the range check and the forward (not `infer_batch`'s).
    """

    def __init__(self, params, backbone_cfg, num_classes: int, *,
                 compute_dtype=torch.bfloat16, preprocess=None,
                 normalize_inputs: bool = True,
                 quantize: str | None = None, device=None):
        self._device = resolve_device(device)
        self._cfg = backbone_cfg
        self._n = num_classes
        self._compute_dtype = compute_dtype
        self._preprocess = preprocess
        self._normalize_inputs = normalize_inputs
        self._quantize = quantize
        self._latencies = self.new_window()
        self._params = classifier_params(params, backbone_cfg, quantize,
                                         self._device)
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
            logits = classifier_logits(
                self._params, x.to(self._compute_dtype), self._cfg, self._n,
                self._quantize)
            # the one device-to-host copy of the call; argmax on the host
            # picks the first maximum, as jnp.argmax does
            probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        return probs.argmax(axis=-1), probs

    def __call__(self, image) -> tuple[int, str, np.ndarray]:
        t0 = time.perf_counter()
        if self._preprocess is not None:
            image = self._preprocess(image)
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
        """Full sorter-loop step: decode (EXIF-upright; the C++ core where
        it is built, PIL otherwise, ``data/native_loader.py``) -> letterbox
        -> rescale/normalize -> classify. The latency sample includes the
        decode."""
        t0 = time.perf_counter()
        result = self(load_letterboxed_single(path, self._cfg.image_size))
        self.replace_last_latency(time.perf_counter() - t0)
        return result


class StreamingDetector(LatencyWindow):
    """Single-image detect path for the sorter's detection mode: decode ->
    letterbox -> rescale/normalize on the device -> DETR forward -> one
    copy of the raw outputs to the host -> `post_process` there
    (confidence threshold, class-aware NMS, sort by score).

    `normalize_inputs` must match the training contract: True for
    checkpoints trained with augment="detection" (the pipeline
    normalizes), False for augment="none". `params` is the port's detector
    tree (``models/bridge.py`` or ``init_detector``); it is moved to
    `device` once. `quantize="int8"`: the W8A8 backbone, the DETR head in
    floating point (``models/quantized.py``).
    """

    def __init__(self, params, detector_cfg, *, compute_dtype=torch.bfloat16,
                 conf_threshold: float = 0.5, nms_threshold: float = 0.5,
                 normalize_inputs: bool = True, quantize: str | None = None,
                 device=None):
        check_quantize(quantize)
        self._device = resolve_device(device)
        self._cfg = detector_cfg
        self._compute_dtype = compute_dtype
        self._conf = conf_threshold
        self._nms = nms_threshold
        self._normalize_inputs = normalize_inputs
        self._quantize = quantize
        self._latencies = self.new_window()
        self._params = detector_params(params, detector_cfg, quantize,
                                       self._device)
        # warm-up: the first CUDA forward builds the kernels and creates
        # the library handles, so the first real frame is not an outlier
        s = self.image_size
        self.forward(np.zeros((s, s, 3), np.uint8))

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def image_size(self) -> int:
        return self._cfg.backbone.image_size

    def forward(self, image) -> dict:
        """One HWC uint8 or [0,1]-float image -> the raw head outputs on
        the host: {"class_logits": (Q, C+1), "boxes_cxcywh": (Q, 4)}, fp32
        tensors."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(image))
            x = to_unit_float(x.to(self._device), torch.float32)
            if self._normalize_inputs:
                x = normalize(x)
            out = detector_outputs(self._params,
                                   x[None].to(self._compute_dtype), self._cfg,
                                   self._quantize)
            # the one device-to-host copy of the call
            raw = torch.cat([out["class_logits"][0],
                             out["boxes_cxcywh"][0]], dim=-1).cpu()
        c = out["class_logits"].shape[-1]
        return {"class_logits": raw[:, :c], "boxes_cxcywh": raw[:, c:]}

    def detect_path(self, path: str) -> dict:
        """Full sorter-loop step from an image file -> {"boxes": (N, 4)
        xyxy in [0,1] of the letterboxed frame, "labels": (N,) int32,
        "scores": (N,), "class_names"}: the kept detections, highest score
        first, as numpy arrays. The latency sample includes the decode."""
        t0 = time.perf_counter()
        raw = self.forward(load_letterboxed_single(path, self.image_size))
        out = post_process(raw["class_logits"][None],
                           raw["boxes_cxcywh"][None],
                           conf_threshold=self._conf,
                           nms_threshold=self._nms)
        out = {k: v[0].numpy() for k, v in out.items()}
        sel = out["valid"]
        result = {
            "boxes": out["boxes"][sel],
            "labels": out["labels"][sel],
            "scores": out["scores"][sel],
            "class_names": [class_name(i) for i in out["labels"][sel]],
        }
        self._latencies.append(time.perf_counter() - t0)
        return result
