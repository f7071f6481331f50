"""Checkpoint → inference-bundle loading shared by the serving surfaces and
the eval CLI (counterpart of ``arsvt_tpu/serving/loading.py``).

Every entry point rebuilds the model from the config stored inside the
checkpoint, so a checkpoint is never served under another architecture.
"""

from __future__ import annotations


def load_inference_bundle(checkpoint_dir: str, *, step: int | None = None):
    """Restore (params, TrainConfig) from one of the port's training
    checkpoints (``train/checkpoint.py``; the latest step unless `step`).

    Params only: the optimizer moments stay unread in the memory-mapped
    file. The tensors are on the CPU; an engine or a `Trainer` moves them
    to its device. Raises FileNotFoundError when the directory holds no
    checkpoint.
    """
    from arsvt_tpu_torch.train.checkpoint import (
        load_params_for_eval,
        peek_config,
    )
    from arsvt_tpu_torch.train.config import (
        resolve_backbone,
        resolve_detector,
    )

    cfg = peek_config(checkpoint_dir, step=step)
    if cfg.task == "detect":
        from arsvt_tpu_torch.models.detector import init_detector

        params_like = init_detector(resolve_detector(cfg))
    else:
        from arsvt_tpu_torch.models.classifier import init_image_classifier

        params_like = init_image_classifier(resolve_backbone(cfg),
                                            cfg.num_classes)
    params, _ = load_params_for_eval(checkpoint_dir, cfg, params_like,
                                     step=step)
    return params, cfg
