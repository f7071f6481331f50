"""Int8 W8A8 inference primitives (counterpart of ``arsvt_tpu/ops/quant.py``).

- `quantize_weight`: offline per-output-channel symmetric int8, one fp32
  scale per output column;
- `quantize_activation`: per-token (last-dim) symmetric int8 at run time;
- `quant_dense`: both, an s8 x s8 -> s32 product, then the fp32 dequant by
  the outer product of the two scales, then the bias;
- `dequantize_weight`: the inverse of `quantize_weight` (test oracle).

Symmetric on both sides (no zero points), range +-127, eps 1e-8, in JAX's
order of operations; ``torch.round`` rounds half to even, as ``jnp.round``.

The int8 product is not a Pallas kernel in the JAX package (XLA lowers
``jnp.dot(int8, int8, preferred_element_type=int32)``), so here it is a
PyTorch call too: ``torch._int_mm`` (cuBLASLt on the card), exact int32 on
either device. Where its CUDA shape rules fail (rows > 16, K and N
multiples of 8) the operands are zero-padded, which leaves every integer
sum unchanged; there is no float product on any route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.fx.experimental.symbolic_shapes import statically_known_true

# int8 symmetric range: +-127 (not -128) so negation stays in range
_QMAX = 127.0
_EPS = 1e-8
# torch._int_mm on the card: more than 16 rows, K and N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def quantize_weight(w: torch.Tensor, *, axis: int = -2) -> dict:
    """Per-output-channel symmetric int8 of a dense kernel (..., in, out);
    `axis` is the contraction (input) dimension, reduced away in the scale.
    Returns {"q": int8 same shape, "scale": fp32 without `axis`}, with
    q * scale ~= w."""
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / _QMAX
    q = torch.clamp(torch.round(w / scale), -_QMAX, _QMAX).to(torch.int8)
    return {"q": q, "scale": scale.squeeze(axis)}


def quantize_activation(x: torch.Tensor):
    """Per-token (last-dim) symmetric int8: (..., D) -> (int8 x, fp32
    per-row scale (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / _QMAX
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def _pad_to(n: int, multiple: int) -> int:
    return -n % multiple


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact, through
    ``torch._int_mm``. Zero rows, zero K columns and zero N columns pad the
    operands to the card's shape rules and are sliced off again. While
    ``torch.export`` traces a symbolic row count that may be 16 or fewer,
    16 zero rows are added whatever it is."""
    m, k = a.shape
    n = b.shape[1]
    if isinstance(m, int):
        pad_m = max(_MIN_ROWS - m, 0)
    else:
        pad_m = 0 if statically_known_true(m >= _MIN_ROWS) else _MIN_ROWS - 1
    pad_k, pad_n = _pad_to(k, _ALIGN), _pad_to(n, _ALIGN)
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    acc = torch._int_mm(a.contiguous(), b.contiguous())
    if pad_m or pad_n:
        acc = acc[:m, :n]
    return acc


def quant_dense(x: torch.Tensor, qw: dict, bias: torch.Tensor | None = None,
                *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """W8A8 dense: x (..., in) times qw {"q": (in, out) int8, "scale":
    (out,) fp32}. The product accumulates in int32; the dequant is
    ``acc * (x_scale * w_scale)`` in fp32, then ``+ bias`` in fp32, then
    the cast to `out_dtype` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    qx, x_scale = quantize_activation(x)
    lead = qx.shape[:-1]
    acc = int8_matmul(qx.reshape(-1, qx.shape[-1]), qw["q"])
    acc = acc.reshape(*lead, acc.shape[-1])
    out = acc.float() * (x_scale * qw["scale"].float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def dequantize_weight(qw: dict, *, axis: int = -2) -> torch.Tensor:
    """Inverse of `quantize_weight`: q * scale in fp32."""
    return qw["q"].float() * qw["scale"].unsqueeze(axis)
