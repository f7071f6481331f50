"""arsvt_tpu_torch — the PyTorch/CUDA port of ``arsvt_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the numerical reference.
Module names mirror ``arsvt_tpu`` so each has an obvious counterpart:

    core/        dtype policy, unit-float rescale, tree helpers, seeded
                 generators
    data/        taxonomy, host decode + letterbox, ImageNet normalize,
                 crop/flip and eval augmentation
    ops/         patch embed, LayerNorm, tanh-GELU MLP (with their
                 backward), attention references and dispatch, and the
                 hand-written Hopper kernels (``csrc/*.cu``: encoder
                 attention forward and backward, head-major attention
                 forward, AdamW) with their plain PyTorch versions
    models/      ViT/DeiT backbone, classifier and DETR heads, detector,
                 presets, JAX bridge (parameters and optimizer state)
    objectives/  cross-entropy, top-1, confusion matrix; box utilities
    train/       config, optimizer and schedules, gradient accumulation,
                 classifier train and eval steps
    evaluation/  classifier evaluation, streaming single-image classifier
                 and detector, detection post-processing
    serving/     HTTP server (/classify, /detect) and micro-batcher

The package imports neither JAX nor ``arsvt_tpu``. Importing it loads
nothing heavy: kernels are built at their first CUDA call.
"""

__version__ = "0.1.0"
