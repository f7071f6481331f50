"""Attention references (counterpart of ``arsvt_tpu/ops/attention.py``).

`sdpa_reference` is the numerics oracle with an fp32 softmax; the
head split and merge of the packed (B, S, 3D) layout are shared with the
encoder-attention kernel's plain version (``ops/encoder_attention.py``).
The model does not call these: its attention core is that kernel.
"""

from __future__ import annotations

import math

import torch


def split_heads(qkv_flat: torch.Tensor, num_heads: int):
    """(B, S, 3D) packed projection -> q, k, v, each (B, H, S, d)."""
    b, s, three_d = qkv_flat.shape
    head_dim = three_d // 3 // num_heads
    qkv = qkv_flat.reshape(b, s, 3, num_heads, head_dim)
    qkv = qkv.permute(2, 0, 3, 1, 4)  # (3, B, H, S, d)
    return qkv[0], qkv[1], qkv[2]


def merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, H, S, d) -> (B, S, H*d)."""
    b, h, s, d = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, s, h * d)


def sdpa_reference(q, k, v) -> torch.Tensor:
    """Scaled dot-product attention, fp32 softmax island.

    q: (B, H, Sq, d), k/v: (B, H, Sk, d). Returns (B, H, Sq, d) in
    q.dtype. The probabilities are normalized before the cast to v's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def self_attention_from_qkv(qkv_flat: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Packed self-attention through the reference: (B, S, 3D) -> (B, S, D)."""
    q, k, v = split_heads(qkv_flat, num_heads)
    return merge_heads(sdpa_reference(q, k, v))
