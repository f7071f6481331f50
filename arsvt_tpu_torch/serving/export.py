"""Serving artifacts through ``torch.export`` (counterpart of
``arsvt_tpu/serving/export.py``, which uses ``jax.export``).

An artifact is one file holding the whole serving computation and its
weights: a uint8 image batch -> [0,1] rescale -> ImageNet normalize (when
the checkpoint's contract asks for it) -> the bf16 or int8 W8A8 forward ->
softmax (classify: ``(class_idx int32 [B], probs fp32 [B, C])``) or
``post_process`` at the thresholds baked in (detect: ``{boxes, scores,
labels, valid}``). The batch dimension is symbolic, so one artifact
serves every batch size. The weights are the buffers of a small
``nn.Module`` that wraps the parameter tree (int8 tensors cannot be
parameters), so the file carries them.

The kernels on the path (#1 at head_dim 64, #3 elsewhere and in the DETR
cross-attention, #8 when ``ARSVT_ENABLE_FUSED_MLP`` is set at export) are
in the graph as the custom ops of ``ops/library.py``; `load_exported`
registers them before it loads a file, so the loaded program launches the
same kernels as the engines in process. Each op has a CUDA and a CPU
implementation, so an artifact runs on either device once its state is
moved there (``torch.export.passes.move_to_device_pass``). The
``ops/dispatch.py`` switches are read while tracing and baked in.

    python -m arsvt_tpu_torch.serving.export --checkpoint-dir checkpoints \\
        --out model.pt2 [--int8] [--conf-threshold 0.5 --nms-threshold 0.5]

This module imports the model code only inside the functions that trace,
so the artifact loader (``serving/artifact.py``) can use `load_exported`
without it.
"""

from __future__ import annotations

import os

import torch

from arsvt_tpu_torch.core.devices import resolve_device
from arsvt_tpu_torch.core.dtypes import tree_map, tree_map_with_path
from arsvt_tpu_torch.ops import library

# torch.export specializes a dimension of size 1, so the example batch
# that traces the symbolic one is larger
EXAMPLE_BATCH = 2
# the devices an artifact runs on, its state moved there
PLATFORMS = ("cuda", "cpu")
ARTIFACT_SUFFIX = ".pt2"


class ServingModule(torch.nn.Module):
    """A parameter tree as buffers, and `serve(params, images)` as the
    forward."""

    def __init__(self, params: dict, serve):
        super().__init__()

        def register(path, t):
            name = path.replace("/", "__")
            self.register_buffer(name, t.detach().contiguous())
            return name

        self._names = tree_map_with_path(register, params)
        self._serve = serve

    def forward(self, images):
        params = tree_map(lambda name: getattr(self, name), self._names)
        return self._serve(params, images)


def _trace(params, serve, image_size: int, input_dtype, device):
    module = ServingModule(params, serve)
    example = torch.zeros((EXAMPLE_BATCH, image_size, image_size, 3),
                          dtype=input_dtype, device=device)
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        return torch.export.export(module, (example,),
                                   dynamic_shapes={"images": {0: batch}})


def _unit_input(images, normalize_inputs):
    from arsvt_tpu_torch.core.dtypes import to_unit_float
    from arsvt_tpu_torch.data.augment import normalize

    x = to_unit_float(images, torch.float32)
    return normalize(x) if normalize_inputs else x


def export_classifier(params, backbone_cfg, num_classes: int, *,
                      compute_dtype=torch.bfloat16,
                      normalize_inputs: bool = True,
                      quantize: str | None = None,
                      input_dtype=torch.uint8, device=None):
    """Classifier params -> ``torch.export.ExportedProgram`` mapping
    (B, S, S, 3) images (uint8 by default; `input_dtype` overrides) to
    (class_idx [B] int32, probs [B, num_classes] fp32), B symbolic. Traced
    on `device` (None: the card), where the weights are moved and, with
    `quantize="int8"`, quantized."""
    from arsvt_tpu_torch.evaluation.classify import (
        classifier_logits,
        classifier_params,
    )

    dev = resolve_device(device)
    params = classifier_params(params, backbone_cfg, quantize, dev)

    def serve(params, images):
        x = _unit_input(images, normalize_inputs)
        logits = classifier_logits(params, x.to(compute_dtype),
                                   backbone_cfg, num_classes, quantize)
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(dim=-1).to(torch.int32), probs

    return _trace(params, serve, backbone_cfg.image_size, input_dtype, dev)


def export_detector(params, detector_cfg, *, compute_dtype=torch.bfloat16,
                    normalize_inputs: bool = True,
                    quantize: str | None = None,
                    conf_threshold: float = 0.5, nms_threshold: float = 0.5,
                    input_dtype=torch.uint8, device=None):
    """Detector params -> ``torch.export.ExportedProgram`` mapping
    (B, S, S, 3) images to the post-processed {boxes [B, Q, 4], scores
    [B, Q], labels [B, Q], valid [B, Q]} (confidence threshold and
    class-aware NMS at the thresholds given here). Traced on `device`
    (None: the card)."""
    from arsvt_tpu_torch.evaluation.classify import (
        detector_outputs,
        detector_params,
    )
    from arsvt_tpu_torch.evaluation.detect import post_process

    dev = resolve_device(device)
    params = detector_params(params, detector_cfg, quantize, dev)

    def serve(params, images):
        x = _unit_input(images, normalize_inputs)
        out = detector_outputs(params, x.to(compute_dtype), detector_cfg,
                               quantize)
        return post_process(out["class_logits"], out["boxes_cxcywh"],
                            conf_threshold=conf_threshold,
                            nms_threshold=nms_threshold)

    return _trace(params, serve, detector_cfg.backbone.image_size,
                  input_dtype, dev)


def save_exported(exported, path: str) -> None:
    """Write an ExportedProgram to one file, named ``*.pt2`` (the
    extension ``torch.export`` expects of its archives)."""
    if not path.endswith(ARTIFACT_SUFFIX):
        raise ValueError(f"an artifact's file name ends in {ARTIFACT_SUFFIX}, "
                         f"got {path!r}")
    torch.export.save(exported, path)


def load_exported(path: str, device=None):
    """Load an artifact onto `device` (None: the card): register the
    kernels' custom ops, read the file, and move its state and the devices
    its graph names to `device` where they differ. Run it with
    ``.module()(images)``."""
    dev = resolve_device(device)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no artifact at {path}")
    library.register_all()
    exported = torch.export.load(path)
    if program_device(exported).type != dev.type:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, dev)
    return exported


def input_spec(exported):
    """The fake tensor of an ExportedProgram's image input: its shape
    (the batch symbolic), dtype and device."""
    name = exported.graph_signature.user_inputs[0]
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name == name:
            return node.meta["val"]
    raise ValueError("the program has no image input")


def program_device(exported) -> torch.device:
    """The device of an ExportedProgram's image input."""
    return torch.device(input_spec(exported).device)


def export_checkpoint(checkpoint_dir: str, out_path: str, *,
                      step: int | None = None,
                      quantize: str | None = None,
                      conf_threshold: float | None = None,
                      nms_threshold: float | None = None,
                      device=None) -> dict:
    """A training checkpoint of the port -> an artifact file at
    `out_path`, traced on `device` (None: the card). The architecture and
    the preprocessing contract come from the config inside the checkpoint.
    The thresholds apply to detect checkpoints (default 0.5 each); for a
    classify checkpoint they are an error. Returns the manifest, with
    JAX's keys."""
    from arsvt_tpu_torch.serving.loading import load_inference_bundle

    if not out_path.endswith(ARTIFACT_SUFFIX):
        raise ValueError(f"an artifact's file name ends in {ARTIFACT_SUFFIX}, "
                         f"got {out_path!r}")
    params, cfg = load_inference_bundle(checkpoint_dir, step=step)
    normalize_inputs = cfg.augment != "none"
    manifest = {
        "task": cfg.task,
        "normalize_inputs": normalize_inputs,
        "quantize": quantize,
        "path": out_path,
    }
    if cfg.task == "detect":
        from arsvt_tpu_torch.train.config import resolve_detector

        det_cfg = resolve_detector(cfg)
        conf = 0.5 if conf_threshold is None else conf_threshold
        nms = 0.5 if nms_threshold is None else nms_threshold
        exported = export_detector(
            params, det_cfg, normalize_inputs=normalize_inputs,
            quantize=quantize, conf_threshold=conf, nms_threshold=nms,
            device=device)
        image_size = det_cfg.backbone.image_size
        manifest.update(conf_threshold=conf, nms_threshold=nms)
    else:
        if conf_threshold is not None or nms_threshold is not None:
            raise ValueError(
                "conf/nms thresholds apply to detect checkpoints; "
                f"{checkpoint_dir} holds a {cfg.task!r} checkpoint")
        from arsvt_tpu_torch.train.config import resolve_backbone

        bb_cfg = resolve_backbone(cfg)
        exported = export_classifier(
            params, bb_cfg, cfg.num_classes,
            normalize_inputs=normalize_inputs, quantize=quantize,
            device=device)
        image_size = bb_cfg.image_size
    save_exported(exported, out_path)
    manifest.update(
        image_size=image_size,
        platforms=list(PLATFORMS),
        input="(b, {s}, {s}, 3) uint8".format(s=image_size),
    )
    return manifest


def main(argv=None):
    import argparse
    import json

    from arsvt_tpu_torch.core.devices import platform_device

    p = argparse.ArgumentParser(
        description="Export a training checkpoint of the port as a "
                    "self-contained torch.export serving artifact (on the "
                    "card unless ARSVT_PLATFORM=cpu).")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--out", required=True,
                   help="output artifact path, ending in .pt2")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--int8", action="store_true",
                   help="export the W8A8 quantized backbone")
    p.add_argument("--conf-threshold", type=float, default=None,
                   help="detect checkpoints only (default 0.5)")
    p.add_argument("--nms-threshold", type=float, default=None,
                   help="detect checkpoints only (default 0.5)")
    args = p.parse_args(argv)
    manifest = export_checkpoint(
        args.checkpoint_dir, args.out, step=args.step,
        quantize="int8" if args.int8 else None,
        conf_threshold=args.conf_threshold,
        nms_threshold=args.nms_threshold, device=platform_device())
    print(json.dumps(manifest))


if __name__ == "__main__":
    main()
