"""Serve a ``torch.export`` artifact (counterpart of
``arsvt_tpu/serving/artifact.py``).

`load_artifact_engine(path)` loads an artifact written by
``serving/export.py`` (weights inside, preprocessing contract fixed at
export) and wraps it in the surface the HTTP server drives
(`__call__` / `infer_batch` / `classify_path`, or `detect_path`;
`latency_stats`, `image_size`, `device`). The task comes from the
program's output structure (classify: a pair ``(class_idx, probs)``;
detect: the ``{boxes, scores, labels, valid}`` dict), the input contract
(image size, dtype) from its input spec.

A serving box needs this module, the kernels' custom-op registrations
(``ops/library.py``) and the artifact: it imports nothing of ``models/``,
``train/`` or ``objectives/``. On the card the loaded program launches the
same kernels (#1, #3, and #8 where it was exported with the fused MLP) as
the engines in process, and their wrappers count the launches.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from arsvt_tpu_torch.core.devices import resolve_device
from arsvt_tpu_torch.core.dtypes import check_unit_range_images
from arsvt_tpu_torch.data.pipeline import load_letterboxed_single
from arsvt_tpu_torch.data.taxonomy import class_name
from arsvt_tpu_torch.serving.export import input_spec, load_exported
from arsvt_tpu_torch.utils.latency import LatencyWindow


def artifact_task(exported) -> str:
    """Classify or detect, from the program's output structure alone."""
    spec = exported.call_spec.out_spec
    if spec.type is dict and "boxes" in spec.context:
        return "detect"
    if spec.type in (tuple, list) and spec.num_children == 2:
        return "classify"
    raise ValueError(f"unrecognized artifact output structure: {spec}")


class _ArtifactEngine(LatencyWindow):
    """Shared plumbing: the input contract, the loaded program, the
    latency window."""

    def __init__(self, exported, device: torch.device):
        val = input_spec(exported)
        shape = val.shape
        if len(shape) != 4 or shape[3] != 3 or shape[1] != shape[2]:
            raise ValueError(f"artifact input is not a (b, S, S, 3) image "
                             f"batch: {tuple(shape)}")
        self.image_size = int(shape[1])
        self._input_dtype = val.dtype
        self._device = device
        self._program = exported.module()
        self._latencies = self.new_window()
        # warm-up: the first CUDA call builds the kernels and creates the
        # library handles, so the first real frame is not an outlier
        self._run(np.zeros((1, self.image_size, self.image_size, 3),
                           np.uint8))

    @property
    def device(self) -> torch.device:
        return self._device

    def _to_input(self, images) -> torch.Tensor:
        """(B, S, S, 3) uint8 or [0,1]-float images -> the artifact's exact
        input dtype on its device. The artifact rescales and normalizes
        inside its graph, per the contract fixed at export."""
        arr = np.asarray(images)
        s = self.image_size
        if arr.shape[1:] != (s, s, 3):
            raise ValueError(f"expected ({s}, {s}, 3) images, got "
                             f"{arr.shape[1:]}")
        # already-normalized or [0,255]-scaled floats would be mangled
        # silently by the uint8 round trip or the unit-float pass-through
        check_unit_range_images(arr, "artifact engines")
        if not self._input_dtype.is_floating_point:
            if np.issubdtype(arr.dtype, np.floating):
                arr = np.clip(np.round(arr * 255.0), 0, 255)
            x = torch.from_numpy(np.ascontiguousarray(arr.astype(np.uint8)))
        else:
            if np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.float32) / 255.0
            x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        return x.to(device=self._device, dtype=self._input_dtype)

    def _run(self, images):
        with torch.inference_mode():
            return self._program(self._to_input(images))


class ArtifactClassifier(_ArtifactEngine):
    """StreamingClassifier-compatible engine over a classify artifact."""

    def infer_batch(self, images) -> tuple[np.ndarray, np.ndarray]:
        """Batched forward for the serving micro-batcher: (B, S, S, 3)
        uint8 or [0,1]-float -> (class_idx [B], probs [B, C])."""
        idx, probs = self._run(images)
        return idx.cpu().numpy(), probs.cpu().numpy()

    def __call__(self, image):
        t0 = time.perf_counter()
        idx, probs = self.infer_batch(np.asarray(image)[None])
        idx = int(idx[0])
        self._latencies.append(time.perf_counter() - t0)
        return idx, class_name(idx), probs[0]

    def classify_path(self, path: str):
        t0 = time.perf_counter()
        result = self(load_letterboxed_single(path, self.image_size))
        self.replace_last_latency(time.perf_counter() - t0)
        return result


class ArtifactDetector(_ArtifactEngine):
    """StreamingDetector-compatible engine over a detect artifact."""

    def detect_path(self, path: str) -> dict:
        t0 = time.perf_counter()
        image = load_letterboxed_single(path, self.image_size)
        out = self._run(image[None])
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        sel = out["valid"]
        result = {
            "boxes": out["boxes"][sel],
            "labels": out["labels"][sel],
            "scores": out["scores"][sel],
            "class_names": [class_name(i) for i in out["labels"][sel]],
        }
        self._latencies.append(time.perf_counter() - t0)
        return result


def load_artifact_engine(path: str, device=None):
    """Artifact file -> ArtifactClassifier or ArtifactDetector on `device`
    (None: the card; it raises without one)."""
    dev = resolve_device(device)
    exported = load_exported(path, dev)
    if artifact_task(exported) == "detect":
        return ArtifactDetector(exported, dev)
    return ArtifactClassifier(exported, dev)
