"""arsvt_tpu_torch — the PyTorch/CUDA port of ``arsvt_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the numerical reference.
Module names mirror ``arsvt_tpu`` so each has an obvious counterpart:

    core/        dtype policy, unit-float rescale
    data/        taxonomy, host decode + letterbox, ImageNet normalize
    ops/         patch embed, LayerNorm, tanh-GELU MLP, attention references,
                 and the hand-written Hopper kernels (``csrc/*.cu``) with
                 their plain PyTorch versions
    models/      ViT/DeiT backbone, classifier head, presets, JAX bridge
    evaluation/  streaming single-image classifier
    serving/     HTTP server and micro-batcher

The package imports neither JAX nor ``arsvt_tpu``. Importing it loads
nothing heavy: kernels are built at their first CUDA call.
"""

__version__ = "0.1.0"
