"""Encoder attention core on the packed (B, S, 3D) projection output.

Counterpart of ``arsvt_tpu/ops/pallas/flash_attention.py::_fwd_direct``
(the forward Pallas kernel ``_fwd_kernel_direct``). On a CUDA tensor
`encoder_attention_fwd` launches the hand-written kernel in
``csrc/encoder_attention_fwd.cu`` or raises; on a CPU tensor it runs
`encoder_attention_fwd_plain`, which repeats the kernel's arithmetic in
plain PyTorch. There is no fallback from one to the other.

Outputs keep the JAX layouts: O as (B, S, D) with head h in columns
h*d .. h*d+d, and the log-sum-exp as (B, H, 1, S) fp32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops.attention import merge_heads, split_heads

SUPPORTED_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process: the wrapper adds one per launch and
# nowhere else, so a run can show that its path went through the kernel.
LAUNCHES = 0

_fn = None


def _check(qkv: torch.Tensor, num_heads: int) -> int:
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, S, 3D), got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // 3
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"num_heads={num_heads} does not divide D={d}")
    head_dim = d // num_heads
    if head_dim != SUPPORTED_HEAD_DIM:
        raise ValueError(
            f"encoder attention supports head_dim {SUPPORTED_HEAD_DIM}, "
            f"got {head_dim} (D={d}, H={num_heads})"
        )
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"encoder attention takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.shape[0] < 1 or qkv.shape[1] < 1:
        raise ValueError(f"empty qkv {tuple(qkv.shape)}")
    return head_dim


def encoder_attention_fwd_plain(qkv: torch.Tensor, num_heads: int):
    """Plain PyTorch version of the kernel, in its arithmetic order:
    fp32 scores, p = exp(s - rowmax) left unnormalised and rounded to v's
    dtype before the product, the product summed in fp32, then divided by
    l = rowsum(p). Returns (out (B, S, D), lse (B, H, 1, S) fp32)."""
    q, k, v = split_heads(qkv, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = merge_heads((o / l).to(qkv.dtype))
    lse = (m + torch.log(l)).transpose(-1, -2)  # (B, H, 1, S)
    return out, lse.contiguous()


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("encoder_attention_fwd").arsvt_encoder_attention_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def encoder_attention_fwd(qkv: torch.Tensor, num_heads: int):
    """qkv: (B, S, 3D) float32 or bfloat16 with head_dim 64.

    Returns (out (B, S, D) in qkv's dtype, lse (B, H, 1, S) fp32).
    """
    global LAUNCHES
    head_dim = _check(qkv, num_heads)
    if qkv.device.type == "cpu":
        return encoder_attention_fwd_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"encoder attention runs on cpu or cuda, got "
                         f"{qkv.device}")
    if not qkv.is_contiguous():
        raise ValueError("encoder attention needs a contiguous qkv")
    if qkv.data_ptr() % 16:
        raise ValueError("encoder attention needs a 16-byte aligned qkv")
    b, s, three_d = qkv.shape
    out = torch.empty((b, s, three_d // 3), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((b, num_heads, 1, s), dtype=torch.float32,
                      device=qkv.device)
    fn = _kernel()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s,
                 num_heads, head_dim, _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"encoder_attention_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, lse
