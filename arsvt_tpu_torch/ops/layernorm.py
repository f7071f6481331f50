"""LayerNorm forward with fp32 statistics (counterpart of
``arsvt_tpu/ops/layernorm.py``; the serving path needs no backward)."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """Biased variance and ``rsqrt(var + eps)`` in fp32, output cast back
    to x's dtype. Callers pass the config's ``ln_eps``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * scale.float() + bias.float()
    return y.to(x.dtype)
