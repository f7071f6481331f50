"""The kernels' forwards as ``torch.library`` custom ops.

A kernel bound with ctypes is invisible to PyTorch's dispatcher, so
``torch.export`` could not trace a call of it (a fake tensor has no
pointer to launch on). Each forward on the serving path is therefore also
registered as a custom op in the ``arsvt`` namespace, with a fake
implementation that gives only the output shapes and dtypes:

- ``arsvt::encoder_attention_fwd`` (#1, ``ops/encoder_attention.py``):
  qkv (B, S, 3D) -> out (B, S, D) in qkv's dtype, lse (B, H, 1, S) fp32;
- ``arsvt::flash_attention_fwd`` (#3, ``ops/flash_attention.py``): q
  (B, H, Sq, d), k and v (B, H, Sk, d) -> O like q, lse (B, H, 1, Sq) fp32;
- ``arsvt::fused_mlp_fwd`` (#8, ``ops/fused_mlp.py``): x (N, D) -> out
  (N, D) in x's dtype, u (N, M) bf16;
- ``arsvt::layer_norm_fwd`` (``ops/layernorm.py``, a port-only kernel):
  x (..., D), scale, bias (D,), eps -> y like x, mean and rstd fp32 of
  shape x.shape[:-1];
- ``arsvt::gelu_tanh_fwd`` (``ops/mlp.py``, a port-only kernel): u -> h
  like u.

The real implementation of each is the module's wrapper, for every
device: on a CUDA tensor it launches the kernel (and adds to the module's
launch count) or raises, on a CPU tensor it runs the plain version. The
model code calls the ops, so eager serving and training, and a program
exported from them and loaded again, all reach the same kernels. Each op
is registered where its wrapper is defined; `register_all` imports those
modules, which is all a process that loads an exported program needs.
"""

from __future__ import annotations

import torch

NAMESPACE = "arsvt"
KERNEL_OPS = ("encoder_attention_fwd", "flash_attention_fwd",
              "fused_mlp_fwd", "layer_norm_fwd", "gelu_tanh_fwd")


def kernel_op(name: str, schema: str):
    """Decorator: register `fn` as the custom op ``arsvt::<name>`` with an
    explicit `schema` (no inputs mutated; its outputs are new tensors)."""
    def wrap(fn):
        return torch.library.custom_op(f"{NAMESPACE}::{name}", fn,
                                       mutates_args=(), schema=schema)
    return wrap


def register_all() -> dict:
    """Import the kernel modules (their import registers the ops) and
    return {name: op} for the ops of `KERNEL_OPS`."""
    from arsvt_tpu_torch.ops import (  # noqa: F401
        encoder_attention,
        flash_attention,
        fused_mlp,
        layernorm,
        mlp,
    )

    namespace = getattr(torch.ops, NAMESPACE)
    return {name: getattr(namespace, name) for name in KERNEL_OPS}
