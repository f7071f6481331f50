"""arsvt_tpu_torch — the PyTorch/CUDA port of ``arsvt_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the numerical reference.
Module names mirror ``arsvt_tpu`` so each has an obvious counterpart, and
each subpackage re-exports the JAX subpackage's names, lazily:

    core/        dtype policy, unit-float rescale, tree helpers, the
                 explicit random streams (`Rng`)
    data/        taxonomy, synthetic data, COCO and folder datasets, the
                 host pipeline and native decoder, on-device augmentation
                 (crop/flip, RandAugment, jitter, mixup, the detection ops)
    ops/         patch embed, LayerNorm, tanh-GELU MLP, attention, remat,
                 int8 products, dropout masks, and the hand-written Hopper
                 kernels (``csrc/*.cu``, built at their first CUDA call:
                 the encoder and head-major attention forwards and
                 backwards, their save-probs variants, the fused MLP, AdamW
                 and the dropout mask) with their plain PyTorch versions
    models/      ViT/DeiT backbone, classifier and DETR heads, detector,
                 presets, int8 models, checkpoint conversion, JAX bridge
    objectives/  cross-entropy, mixup, top-1, confusion matrix, boxes,
                 Hungarian matcher, detection and triplet losses
    parallel/    data- and tensor-parallel training on torch.distributed:
                 the (data, model) grid, sharding rules, multi-process
                 wiring, the Megatron operators, a multi-process dry run
    train/       config, optimizer and schedules, gradient accumulation,
                 classifier and detector steps (distillation too), the
                 Trainer, checkpoints and the training CLI
    evaluation/  classifier and detector evaluation, streaming engines,
                 post-processing, the eval CLI, visualisation
    serving/     HTTP server (/classify, /detect), micro-batcher,
                 checkpoint loading, ``torch.export`` artifacts
    utils/       metric logging, latency windows, FLOP counts, profiling

The package imports neither JAX nor ``arsvt_tpu``. Importing it, or any
subpackage, loads nothing heavy: kernels are built at their first CUDA
call, and re-exported names load their module at first use.
"""

__version__ = "0.1.0"
