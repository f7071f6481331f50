"""The switches of ``arsvt_tpu/ops/dispatch.py``, read from the same
environment variables at call time, on any device.

Two training opt-ins:

- ``ARSVT_ATTN_SAVE_PROBS=1``: at head_dim 64 a training forward takes the
  save-probs encoder attention (kernels ``csrc/encoder_attention_savep_
  {fwd,bwd}.cu``), which keeps the normalised bf16 probabilities for the
  backward instead of rebuilding them from q, k and the log-sum-exp.
- ``ARSVT_ENABLE_FUSED_MLP=1``: every tanh-GELU MLP (the ViT blocks and the
  DETR head's FFN, train and eval) runs fc1 → GELU → fc2 as one kernel
  (``csrc/fused_mlp_{fwd,bwd}.cu``) that saves only a bf16 u.

The JAX package also gates both on ``use_pallas()`` (a TPU backend or
``ARSVT_FORCE_PALLAS``). The port honours them on any device, so a CPU
run takes the same route through the kernels' plain versions, and
``ARSVT_DISABLE_PALLAS=1`` turns both off, as it turns off ``use_pallas()``
in JAX. The port's default-route kernels (#1/#2, #3/#4, AdamW) are not
Pallas and keep running under it.

Three switches that take a route off (JAX ``dispatch.py:35-36, 48-74``):
- ``ARSVT_DISABLE_FUSED_ATTN=1``: head_dim-64 layers leave the fused
  qkv-proj → #1/#2 → out-proj Function for qkv-proj → #3/#4 → out-proj;
- ``ARSVT_ATTN_JNP=1``: the fused head_dim-64 route is off (JAX
  ``dispatch.py:69``), and `multi_head_attention` and
  `self_attention_from_qkv` run the plain `sdpa_reference` on CPU tensors;
  on the card they stay on #3/#4, since the plain version is no kernel, so
  there the switch takes the route of ``ARSVT_DISABLE_FUSED_ATTN``;
- ``ARSVT_DISABLE_LN_VJP=1``: `layer_norm` runs plain autograd over its
  forward math instead of its custom backward.
"""

from __future__ import annotations

import os


def _opt_in(name: str) -> bool:
    if os.environ.get("ARSVT_DISABLE_PALLAS"):
        return False
    return bool(os.environ.get(name))


def use_attn_save_probs() -> bool:
    return _opt_in("ARSVT_ATTN_SAVE_PROBS")


def use_fused_mlp() -> bool:
    return _opt_in("ARSVT_ENABLE_FUSED_MLP")


def force_plain_attention(x) -> bool:
    """``ARSVT_ATTN_JNP`` on a CPU tensor `x`: attention through
    `sdpa_reference`."""
    return bool(os.environ.get("ARSVT_ATTN_JNP")) and x.device.type == "cpu"


def use_fused_encoder_attention() -> bool:
    """The fused head_dim-64 route, unless ``ARSVT_DISABLE_FUSED_ATTN`` or
    ``ARSVT_ATTN_JNP`` takes it off."""
    return not (os.environ.get("ARSVT_DISABLE_FUSED_ATTN")
                or os.environ.get("ARSVT_ATTN_JNP"))


def use_ln_vjp() -> bool:
    """LayerNorm's custom backward, unless ``ARSVT_DISABLE_LN_VJP``."""
    return not os.environ.get("ARSVT_DISABLE_LN_VJP")
