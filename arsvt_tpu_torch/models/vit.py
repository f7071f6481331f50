"""ViT / DeiT backbone (counterpart of ``arsvt_tpu/models/vit.py``).

Parameters are a plain tree of tensors with the JAX tree's keys and
per-layer shapes; where JAX stacks the blocks on a leading depth axis for
``lax.scan``, this tree holds a list of per-layer dicts and the forward is
a Python loop. Images are NHWC. Pre-LN blocks:
``x += out_proj(attn(qkv_proj(LN1(x)))); x += mlp(LN2(x))``, then a
final LN. The attention routes by what the port's kernels take: at
head_dim 64 (every ViT preset) qkv-proj → attention → out-proj is one
autograd Function over the encoder-attention kernels
(``ops/encoder_attention.py``), for serving and training alike; any other
head_dim (the DeiT-400 detector backbone's 16) runs qkv-proj → the
head-major attention kernel (``ops/flash_attention.py``, forward only) →
out-proj, as ``vit.py``'s non-fused branch does. Dropout (residual,
positional and attention) and remat are not ported: a training forward
that would need them raises.
"""

from __future__ import annotations

import dataclasses

import torch

from arsvt_tpu_torch.core.dtypes import tree_map
from arsvt_tpu_torch.ops.attention import self_attention_from_qkv
from arsvt_tpu_torch.ops.encoder_attention import (
    SUPPORTED_HEAD_DIM,
    fused_encoder_attention,
)
from arsvt_tpu_torch.ops.layernorm import layer_norm
from arsvt_tpu_torch.ops.mlp import gelu_mlp
from arsvt_tpu_torch.ops.patch_embed import patch_embed


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_dim: int = 768
    dropout: float = 0.0
    attn_dropout: float = 0.0
    distilled: bool = False  # DeiT: CLS + DIST tokens
    # LayerNorm epsilon; 1e-5 is torch nn.LayerNorm's default. Converted
    # checkpoints carry their source's value.
    ln_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_special_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def seq_len(self) -> int:
        return self.num_patches + self.num_special_tokens

    @property
    def head_dim(self) -> int:
        if self.embed_dim % self.num_heads:
            raise ValueError("num_heads must divide embed_dim")
        return self.embed_dim // self.num_heads


def _trunc_normal(gen: torch.Generator, shape, std: float = 0.02):
    # truncated at ±2σ, like the JAX init of tokens and pos-embeds
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    return std * t


def _linear_init(gen: torch.Generator, fan_in: int, shape):
    # LeCun-normal, as the JAX init of every kernel
    return (1.0 / fan_in) ** 0.5 * torch.randn(shape, generator=gen)


def init_backbone(cfg: BackboneConfig, seed: int = 0, *,
                  device="cpu") -> dict:
    """Seeded fp32 init with the JAX tree's keys and shapes (blocks as a
    list of per-layer dicts). Drawn on the CPU from a `torch.Generator`,
    so a seed gives the same weights on every device; the values differ
    from ``jax.random``'s."""
    gen = torch.Generator().manual_seed(seed)
    d, m = cfg.embed_dim, cfg.mlp_dim
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_channels

    def ln():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    def linear(fan_in, fan_out):
        return {"kernel": _linear_init(gen, fan_in, (fan_in, fan_out)),
                "bias": torch.zeros(fan_out)}

    params = {
        "patch_embed": linear(patch_dim, d),
        "cls_token": _trunc_normal(gen, (1, 1, d)),
        "pos_embed": _trunc_normal(gen, (1, cfg.seq_len, d)),
        "blocks": [
            {
                "ln1": ln(),
                "attn": {"qkv": linear(d, 3 * d), "proj": linear(d, d)},
                "ln2": ln(),
                "mlp": {"fc1": linear(d, m), "fc2": linear(m, d)},
            }
            for _ in range(cfg.depth)
        ],
        "ln_f": ln(),
    }
    if cfg.distilled:
        params["dist_token"] = _trunc_normal(gen, (1, 1, d))
    return tree_map(lambda t: t.to(device), params)


def _encoder_block(x: torch.Tensor, bp: dict,
                   cfg: BackboneConfig) -> torch.Tensor:
    """One pre-LN block; bp holds one layer's parameters. Each projection
    emits x's dtype and adds its bias in that dtype, as the JAX block."""
    attn_p = bp["attn"]
    y = layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"], eps=cfg.ln_eps)
    wqkv, bqkv = (attn_p["qkv"][k].to(y.dtype) for k in ("kernel", "bias"))
    wproj, bproj = (attn_p["proj"][k].to(y.dtype)
                    for k in ("kernel", "bias"))
    if cfg.head_dim == SUPPORTED_HEAD_DIM:
        x = x + fused_encoder_attention(y, wqkv, bqkv, wproj, bproj,
                                        cfg.num_heads)
    else:
        attn = self_attention_from_qkv(torch.matmul(y, wqkv) + bqkv,
                                       cfg.num_heads)
        x = x + (torch.matmul(attn, wproj) + bproj)

    y = layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"], eps=cfg.ln_eps)
    mlp = bp["mlp"]
    y = gelu_mlp(y, mlp["fc1"]["kernel"], mlp["fc1"]["bias"],
                 mlp["fc2"]["kernel"], mlp["fc2"]["bias"])
    return x + y


def check_train_supported(cfg: BackboneConfig, *, remat: bool = False):
    """Raise for the training features this port does not have yet."""
    if cfg.dropout > 0.0 or cfg.attn_dropout > 0.0:
        raise NotImplementedError(
            f"training with dropout={cfg.dropout} / attn_dropout="
            f"{cfg.attn_dropout} is not ported yet (ROADMAP Queue A, "
            "detector training, brings in-kernel attention dropout)")
    if remat:
        raise NotImplementedError(
            "remat is not ported yet (ROADMAP Queue A, the ViT-L recipe)")


def apply_backbone(params: dict, images: torch.Tensor,
                   cfg: BackboneConfig, *, train: bool = False) -> torch.Tensor:
    """images: (B, H, W, C) in the compute dtype -> all tokens (B, S, D)
    after the final LN (special tokens first; heads pick what they use).

    `train` marks a training forward: it is the same computation (no
    dropout is ported) and raises where the config would need dropout.
    """
    if train:
        check_train_supported(cfg)
    b = images.shape[0]
    x = patch_embed(images, params["patch_embed"]["kernel"],
                    params["patch_embed"]["bias"],
                    patch_size=cfg.patch_size)  # (B, N, D)
    specials = [params["cls_token"].expand(b, 1, cfg.embed_dim)]
    if cfg.distilled:
        specials.append(params["dist_token"].expand(b, 1, cfg.embed_dim))
    x = torch.cat([t.to(x.dtype) for t in specials] + [x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    for bp in params["blocks"]:
        x = _encoder_block(x, bp, cfg)
    return layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"],
                      eps=cfg.ln_eps)
