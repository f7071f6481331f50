"""Compute ops: plain PyTorch ops and the hand-written Hopper kernels
(counterpart of ``arsvt_tpu/ops``)."""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "multi_head_attention": "attention",
    "sdpa_reference": "attention",
    "layer_norm": "layernorm",
    "gelu_mlp": "mlp",
    "patch_embed": "patch_embed",
    "extract_patches": "patch_embed",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
