"""tanh-GELU MLP (counterpart of ``arsvt_tpu/ops/mlp.py``).

By default both products stay ``torch.matmul``, as the JAX package leaves
them to XLA, and `gelu_tanh` has the JAX package's compact VJP: it saves
only u and applies the closed-form derivative in fp32. With
``ARSVT_ENABLE_FUSED_MLP`` set (``ops/dispatch.py``), `gelu_mlp` runs fc1 →
GELU → fc2 as the fused kernels of ``ops/fused_mlp.py`` instead, in
training and eval, wherever it is called: the ViT blocks and the DETR
head's FFN. The remat policies reach in here: fc1's product carries the
``mlp_u`` tag of ``remat_policy="names"``, and ``remat_tail`` (the
``mlp_tail`` policy) checkpoints GELU → fc2 and keeps the unfused route.
"""

from __future__ import annotations

import torch

from arsvt_tpu_torch.ops.dispatch import use_fused_mlp
from arsvt_tpu_torch.ops.fused_mlp import fused_gelu_mlp
from arsvt_tpu_torch.ops.remat import checkpoint_name, remat_call

_C = 0.7978845608028654  # sqrt(2/pi)
_A = 0.044715


class _GeluTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        t = torch.tanh(_C * (u + _A * u * u * u))
        return 0.5 * u * (1.0 + t)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        uf = u.float()
        t = torch.tanh(_C * (uf + _A * uf * uf * uf))
        d = 0.5 * (1.0 + t) + 0.5 * uf * (1.0 - t * t) * _C * (
            1.0 + 3.0 * _A * uf * uf)
        return (g.float() * d).to(u.dtype)


def gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, in u's dtype — not the erf GELU."""
    return _GeluTanh.apply(u)


def _tail(u, w2, b2):
    h = gelu_tanh(u)
    with checkpoint_name("mlp_fc2"):
        out = torch.matmul(h, w2.to(u.dtype))
    return out if b2 is None else out + b2.to(u.dtype)


def gelu_mlp(x, w1, b1, w2, b2, *, remat_tail: bool = False) -> torch.Tensor:
    """x: (..., D); w1: (D, M); w2: (M, D). Returns (..., D) in x.dtype.

    Unfused, each product emits x's dtype and its bias is added in that
    dtype; fused, the kernel's fp32 sums and bias adds round once at the
    end (`fused_gelu_mlp`). `remat_tail` checkpoints GELU → fc2 (u is
    saved, gelu(u) replays in the backward) and, as in JAX, wins over
    ``ARSVT_ENABLE_FUSED_MLP``: the fused kernel keeps a residual plan of
    its own. `b2` None leaves fc2 unbiased: a tensor-parallel rank's
    partial sums, biased after their all-reduce.
    """
    if not remat_tail and use_fused_mlp():
        if b2 is None:  # the kernel adds a bias: a zero one adds nothing
            b2 = w2.new_zeros(w2.shape[1])
        return fused_gelu_mlp(x, w1, b1, w2, b2)
    with checkpoint_name("mlp_u"):
        u = torch.matmul(x, w1.to(x.dtype))
    u = u + b1.to(x.dtype)
    if remat_tail:
        return remat_call(_tail, u, w2, b2)
    return _tail(u, w2, b2)
