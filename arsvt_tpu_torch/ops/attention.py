"""Multi-head attention (counterpart of ``arsvt_tpu/ops/attention.py``).

`sdpa_reference` is the numerics oracle with an fp32 softmax; the head
split and merge of the packed (B, S, 3D) layout are shared with the
kernels' plain versions. `multi_head_attention` and
`self_attention_from_qkv` dispatch as the JAX functions do: to the
head-major attention kernel (``ops/flash_attention.py``) unless the caller
forces the reference, as the DETR decoder's self-attention over its few
queries does on every device. ``ARSVT_ATTN_JNP`` sends CPU tensors to the
reference; on the card it leaves them on the kernels, which compute the
same function (the reference is no kernel), and takes the fused
head_dim-64 route off (``ops/dispatch.py``).
"""

from __future__ import annotations

import math

import torch

from arsvt_tpu_torch.ops.dispatch import force_plain_attention
from arsvt_tpu_torch.ops.dropout import SiteDropout, call_dropout


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


def sdpa_reference(q, k, v, *, mask=None, dropout_rate: float = 0.0,
                   dropout_rng=None, head_range=None) -> torch.Tensor:
    """Scaled dot-product attention, fp32 softmax island.

    q: (B, H, Sq, d), k/v: (B, H, Sk, d); mask: broadcastable to
    (B, H, Sq, Sk) with True = attend (others get -1e30). Returns
    (B, H, Sq, d) in q.dtype. The probabilities are normalized before the
    cast to v's dtype. With `dropout_rate` > 0 and a `dropout_rng` (a
    ``core/prng.py::Rng``), inverted dropout on the normalized
    probabilities, as JAX's, under the kernels' mask of the rng's seed
    (`head_range` = (h0, H) of a tensor-parallel rank's heads).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    rate, seed, offsets = call_dropout(dropout_rate, dropout_rng,
                                       q.shape[1], head_range)
    if rate > 0.0:  # one launch each way on the card (`SiteDropout`)
        probs = SiteDropout.apply(probs, seed, rate, offsets,
                                  tuple(probs.shape), "mul")
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def multi_head_attention(q, k, v, *, mask=None, force_reference: bool = False,
                         dropout_rate: float = 0.0, dropout_rng=None,
                         head_range=None) -> torch.Tensor:
    """q (B, H, Sq, d), k/v (B, H, Sk, d) -> (B, H, Sq, d): the kernels, or
    `sdpa_reference` when forced, under ``ARSVT_ATTN_JNP`` on the CPU or
    when a `mask` is given. Dropout on the probabilities with `dropout_rate` > 0
    and a `dropout_rng` (``core/prng.py::Rng``), in-kernel or in the
    reference, with one mask; `head_range` as `sdpa_reference`'s."""
    if force_reference or force_plain_attention(q):
        return sdpa_reference(q, k, v, mask=mask, dropout_rate=dropout_rate,
                              dropout_rng=dropout_rng, head_range=head_range)
    from arsvt_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, mask=mask, dropout_rate=dropout_rate,
                           dropout_rng=dropout_rng, head_range=head_range)


def self_attention_from_qkv(qkv_flat: torch.Tensor, num_heads: int, *,
                            force_reference: bool = False,
                            dropout_rate: float = 0.0,
                            dropout_rng=None, head_range=None) -> torch.Tensor:
    """Packed self-attention: (B, S, 3D) projection output -> (B, S, D),
    through `flash_self_attention_packed` or, when forced or under
    ``ARSVT_ATTN_JNP`` on the CPU, the reference; dropout and `head_range` as
    `multi_head_attention`'s."""
    if not (force_reference or force_plain_attention(qkv_flat)):
        from arsvt_tpu_torch.ops.flash_attention import (
            flash_self_attention_packed,
        )

        return flash_self_attention_packed(qkv_flat, num_heads,
                                           dropout_rate=dropout_rate,
                                           dropout_rng=dropout_rng,
                                           head_range=head_range)
    q, k, v = split_heads(qkv_flat, num_heads)
    return merge_heads(sdpa_reference(q, k, v, dropout_rate=dropout_rate,
                                      dropout_rng=dropout_rng,
                                      head_range=head_range))
