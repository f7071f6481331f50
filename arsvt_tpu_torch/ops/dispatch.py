"""The two training opt-ins of ``arsvt_tpu/ops/dispatch.py``, read from
the same environment variables at call time.

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
