"""LayerNorm with fp32 statistics and a lean backward (counterpart of
``arsvt_tpu/ops/layernorm.py`` and its custom VJP).

The backward saves x in its own dtype plus fp32 (mean, rstd) and uses the
closed form dx = rstd * (g*γ - mean(g*γ) - x̂ * mean(g*γ*x̂)).
``ARSVT_DISABLE_LN_VJP`` (``ops/dispatch.py``) runs plain autograd over the
same forward math instead, as JAX's switch runs XLA's autodiff.
"""

from __future__ import annotations

import torch

from arsvt_tpu_torch.ops.dispatch import use_ln_vjp


def _ln_fwd_math(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * scale.float() + bias.float()
    return y.to(x.dtype), mean, rstd


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = _ln_fwd_math(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        gf = g.float()
        xhat = (x.float() - mean) * rstd
        gs = gf * scale.float()
        m1 = gs.mean(dim=-1, keepdim=True)
        m2 = (gs * xhat).mean(dim=-1, keepdim=True)
        dx = (rstd * (gs - m1 - xhat * m2)).to(x.dtype)
        axes = tuple(range(g.dim() - 1))
        dscale = (gf * xhat).sum(dim=axes).to(scale.dtype)
        dbias = gf.sum(dim=axes).to(scale.dtype)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """Biased variance and ``rsqrt(var + eps)`` in fp32, output cast back
    to x's dtype. Callers pass the config's ``ln_eps``."""
    if use_ln_vjp():
        return _LayerNorm.apply(x, scale, bias, eps)
    return _ln_fwd_math(x, scale, bias, eps)[0]
