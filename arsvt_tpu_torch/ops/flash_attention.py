"""Head-major attention forward (counterpart of
``arsvt_tpu/ops/pallas/flash_attention.py``'s ``_fwd`` → ``_fwd_kernel``).

- `flash_attention_fwd`: q (B, H, Sq, d), k and v (B, H, Sk, d) → O (B, H,
  Sq, d) and lse (B, H, 1, Sq) fp32, keys at or past `kv_len` masked;
  kernel ``csrc/flash_attention_fwd.cu``;
- `flash_attention`: the DETR cross-attention's entry (``flash_attention``
  in JAX), with an explicit `mask` routed to the reference;
- `flash_self_attention_packed`: the encoder self-attention of backbones
  whose head_dim the encoder-attention kernels do not take, from the packed
  (B, S, 3D) projection output.

On a CUDA tensor the wrapper launches the hand-written kernel or raises;
on a CPU tensor it runs `flash_attention_fwd_plain`, which repeats the
kernel's arithmetic in plain PyTorch. There is no fallback from one to
the other. Forward only, no dropout: the backward (Pallas kernel #4) is
not ported, so a forward that would build a graph raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops.attention import (
    merge_heads,
    sdpa_reference,
    split_heads,
)

MAX_HEAD_DIM = 128
# -0.7 * float32 max, the TPU kernel's mask value (``flash_attention.py:44``)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process: the wrapper adds one where it launches
# and nowhere else, so a run can show that its path went through the
# kernel.
LAUNCHES = 0

_fn = None


def _check(q, k, v, kv_len):
    """Validate the operands; returns kv_len."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be (B, H, S, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k and v must be (B={b}, H={h}, Sk, d={d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    sk = k.shape[2]
    if min(b, h, sq, sk, d) < 1:
        raise ValueError(f"empty attention operands {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} is above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"attention takes float32 or bfloat16 operands of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len must be in [1, {sk}], got {kv_len}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the head-major attention backward (Pallas kernel #4, "
            "flash_attention.py::_bwd_kernel) is not ported yet: run this "
            "forward under torch.inference_mode() or torch.no_grad()")
    return kv_len


def flash_attention_fwd_plain(q, k, v, kv_len: int):
    """Plain PyTorch version of the kernel, in its arithmetic order: fp32
    scores times scale, key columns at or past `kv_len` set to MASK_VALUE,
    p = exp(s - rowmax) left unnormalised and rounded to v's dtype before
    the product, the product summed in fp32, then divided by l = rowsum(p).
    Returns (O (B, H, Sq, d) in q's dtype, lse (B, H, 1, Sq) fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_len < k.shape[2]:
        col = torch.arange(k.shape[2], device=s.device)
        s = torch.where(col < kv_len, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    lse = (m + torch.log(l)).transpose(-1, -2)  # (B, H, 1, Sq)
    return (o / l).to(q.dtype), lse.contiguous()


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention_fwd").arsvt_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_fwd(q, k, v, *, kv_len: int | None = None):
    """q (B, H, Sq, d), k and v (B, H, Sk, d), float32 or bfloat16, head_dim
    1..128; keys at or past `kv_len` (default Sk) are masked.

    Returns (O (B, H, Sq, d) in q's dtype, lse (B, H, 1, Sq) fp32). On the
    card the operands must be contiguous; the kernel reads element by
    element, so any tensor's own alignment is enough.
    """
    global LAUNCHES
    kv_len = _check(q, k, v, kv_len)
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_fwd_plain(q, k, v, kv_len)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("attention runs on cpu or cuda with q, k and v on "
                         f"one device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention on the card needs contiguous q, k, v")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, 1, sq), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, sq, sk, kv_len, d,
                 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, lse


def flash_attention(q, k, v, *, mask=None):
    """Attention of q (B, H, Sq, d) over k/v (B, H, Sk, d) -> (B, H, Sq, d),
    as ``flash_attention.py::flash_attention``: through the kernel over
    every key, or through `sdpa_reference` where a `mask` (True = attend)
    is given."""
    if mask is not None:
        return sdpa_reference(q, k, v, mask=mask)
    out, _ = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    return out


def flash_self_attention_packed(qkv_flat, num_heads: int):
    """(B, S, 3D) fused-QKV projection output -> (B, S, D) attention out,
    as ``flash_attention.py::flash_self_attention_packed``: the heads are
    split into contiguous (B, H, S, d) tensors for the kernel and merged
    back."""
    q, k, v = (t.contiguous() for t in split_heads(qkv_flat, num_heads))
    out, _ = flash_attention_fwd(q, k, v)
    return merge_heads(out)
