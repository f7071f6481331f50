"""Heads (counterpart of ``arsvt_tpu/models/heads.py``): the linear
classifier and the DETR detection decoder.

Classifier: pooled special token(s) -> fp32 logits. For DeiT backbones
the CLS and DIST tokens get separate heads whose logits are averaged.

DETR: learned object queries go through pre-LN decoder blocks
(self-attention over the queries, cross-attention to the patch tokens, a
tanh-GELU FFN), then fp32 class logits (background last) and sigmoid
cxcywh boxes through heads shared by every layer. The blocks are a list
of per-layer dicts with the JAX tree's keys, run by a Python loop where
JAX scans. The cross-attention runs the head-major attention kernels
(forward and backward, with in-kernel dropout); the self-attention over
the few queries runs the reference on every device, as in JAX. A training
forward takes an `rng` (``core/prng.py::Rng``): layer i draws from
``rng.fold_in(i)``, its three residual sites (self-attention,
cross-attention, FFN) at ``fold_in(0..2)`` and its self- and
cross-attention probabilities at ``fold_in(3)`` and ``(4)``, as JAX splits
the layer key five ways.
"""

from __future__ import annotations

import dataclasses

import torch

from arsvt_tpu_torch.core.dtypes import tree_map
from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.models.vit import (
    _linear_init,
    _trunc_normal,
    site_dropout,
)
from arsvt_tpu_torch.ops.attention import (
    multi_head_attention,
    self_attention_from_qkv,
)
from arsvt_tpu_torch.ops.layernorm import layer_norm
from arsvt_tpu_torch.ops.mlp import gelu_mlp


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    num_classes: int = 6
    distilled: bool = False


def init_classifier(cfg: ClassifierConfig, embed_dim: int, *,
                    device="cpu") -> dict:
    """Zero-init heads (standard fine-tune practice)."""
    def head():
        return {"kernel": torch.zeros(embed_dim, cfg.num_classes,
                                      device=device),
                "bias": torch.zeros(cfg.num_classes, device=device)}

    params = {"head": head()}
    if cfg.distilled:
        params["head_dist"] = head()
    return params


def _logits(token: torch.Tensor, head: dict) -> torch.Tensor:
    # the product of the token-dtype operands, summed in fp32, plus the
    # fp32 bias (JAX: preferred_element_type=float32)
    kernel = head["kernel"].to(token.dtype)
    return torch.matmul(token.float(), kernel.float()) + head["bias"].float()


def apply_classifier(params: dict, tokens: torch.Tensor,
                     cfg: ClassifierConfig, *, return_heads: bool = False):
    """tokens: (B, S, D) with CLS [, DIST] first -> logits (B, C) fp32.

    Distilled backbones average the CLS and DIST head logits;
    `return_heads=True` returns them apart, (logits_cls, logits_dist), the
    distillation training surface."""
    logits = _logits(tokens[:, 0], params["head"])
    if cfg.distilled and "head_dist" not in params:
        raise ValueError(
            "distilled classifier config but params lack 'head_dist' — "
            "checkpoint/config mismatch (e.g. converted from a "
            "non-distilled source); silently evaluating CLS-only would "
            "change numbers without an error"
        )
    if cfg.distilled:
        logits_d = _logits(tokens[:, 1], params["head_dist"])
        if return_heads:
            return logits, logits_d
        return (logits + logits_d) / 2.0
    if return_heads:
        raise ValueError(
            "return_heads requires a distilled backbone (DIST token + head)"
        )
    return logits


@dataclasses.dataclass(frozen=True)
class DetrHeadConfig:
    num_classes: int = 6          # foreground classes; +1 background logit
    num_queries: int = 25
    depth: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    dropout: float = 0.0
    attn_dropout: float = 0.0
    ln_eps: float = 1e-5


def init_detr_head(cfg: DetrHeadConfig, embed_dim: int, seed: int = 0, *,
                   device="cpu") -> dict:
    """Seeded fp32 init with the JAX tree's keys and per-layer shapes
    (blocks as a list of per-layer dicts), drawn on the CPU from a
    `torch.Generator`; the values differ from ``jax.random``'s."""
    gen = torch.Generator().manual_seed(seed)
    d, f = embed_dim, cfg.ffn_dim

    def ln():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    def linear(fan_in, fan_out):
        return {"kernel": _linear_init(gen, fan_in, (fan_in, fan_out)),
                "bias": torch.zeros(fan_out)}

    params = {
        "queries": _trunc_normal(gen, (cfg.num_queries, d)),
        "blocks": [
            {
                "ln_self": ln(),
                "self_attn": {"qkv": linear(d, 3 * d),
                              "proj": linear(d, d)},
                "ln_cross_q": ln(),
                "ln_cross_kv": ln(),
                "cross_attn": {"q": linear(d, d), "kv": linear(d, 2 * d),
                               "proj": linear(d, d)},
                "ln_mlp": ln(),
                "mlp": {"fc1": linear(d, f), "fc2": linear(f, d)},
            }
            for _ in range(cfg.depth)
        ],
        "ln_f": ln(),
        "class_head": linear(d, cfg.num_classes + 1),
        "bbox_head": linear(d, 4),
    }
    return tree_map(lambda t: t.to(device), params)


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    # the product emits x's dtype and adds the bias in it, as the JAX block
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)


def _mha_from_proj(x_q, x_kv, num_heads: int, head_dim: int, *,
                   dropout_rate: float = 0.0, dropout_rng: Rng | None = None):
    """Cross-attention of projected queries (B, Sq, D) over projected
    keys/values (B, Sk, 2D) -> (B, Sq, D), through the kernels."""
    b, sq, d = x_q.shape
    sk = x_kv.shape[1]
    q = x_q.reshape(b, sq, num_heads, head_dim).permute(0, 2, 1, 3)
    kv = x_kv.reshape(b, sk, 2, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    out = multi_head_attention(q, kv[0], kv[1], dropout_rate=dropout_rate,
                               dropout_rng=dropout_rng)
    return out.permute(0, 2, 1, 3).reshape(b, sq, d)


def _decoder_block(x, memory, bp: dict, cfg: DetrHeadConfig, head_dim: int,
                   *, train: bool = False, rng: Rng | None = None):
    k1 = k2 = k3 = kp1 = kp2 = None
    if train and rng is not None:
        k1, k2, k3, kp1, kp2 = (rng.fold_in(site) for site in range(5))
    attn_rate = cfg.attn_dropout if train else 0.0

    # self-attention over the queries: the packed reference on every
    # device, as JAX forces it (a kernel launch costs more than Q <= 100)
    y = layer_norm(x, bp["ln_self"]["scale"], bp["ln_self"]["bias"],
                   eps=cfg.ln_eps)
    sa = self_attention_from_qkv(_linear(y, bp["self_attn"]["qkv"]),
                                 cfg.num_heads, force_reference=True,
                                 dropout_rate=attn_rate, dropout_rng=kp1)
    x = x + site_dropout(_linear(sa, bp["self_attn"]["proj"]), cfg.dropout,
                         k1, train=train)

    # cross-attention to the patch tokens
    yq = layer_norm(x, bp["ln_cross_q"]["scale"], bp["ln_cross_q"]["bias"],
                    eps=cfg.ln_eps)
    ykv = layer_norm(memory, bp["ln_cross_kv"]["scale"],
                     bp["ln_cross_kv"]["bias"], eps=cfg.ln_eps)
    ca = _mha_from_proj(_linear(yq, bp["cross_attn"]["q"]),
                        _linear(ykv, bp["cross_attn"]["kv"]),
                        cfg.num_heads, head_dim, dropout_rate=attn_rate,
                        dropout_rng=kp2)
    x = x + site_dropout(_linear(ca, bp["cross_attn"]["proj"]), cfg.dropout,
                         k2, train=train)

    # FFN
    y = layer_norm(x, bp["ln_mlp"]["scale"], bp["ln_mlp"]["bias"],
                   eps=cfg.ln_eps)
    mlp = bp["mlp"]
    y = gelu_mlp(y, mlp["fc1"]["kernel"], mlp["fc1"]["bias"],
                 mlp["fc2"]["kernel"], mlp["fc2"]["bias"])
    return x + site_dropout(y, cfg.dropout, k3, train=train)


def _detr_outputs(params: dict, h: torch.Tensor, cfg: DetrHeadConfig):
    """Shared final LN and heads: (…, Q, D) -> fp32 logits and boxes."""
    h = layer_norm(h, params["ln_f"]["scale"], params["ln_f"]["bias"],
                   eps=cfg.ln_eps)
    return {"class_logits": _logits(h, params["class_head"]),
            "boxes_cxcywh": torch.sigmoid(_logits(h, params["bbox_head"]))}


def apply_detr_head(params: dict, memory: torch.Tensor, cfg: DetrHeadConfig,
                    embed_dim: int, *, train: bool = False,
                    rng: Rng | None = None, return_aux: bool = False):
    """memory: patch tokens (B, N, D) -> {'class_logits': (B, Q, C+1),
    'boxes_cxcywh': (B, Q, 4) in [0, 1]}, both fp32. `train` with an `rng`
    applies the config's dropout (see the module docstring).

    `return_aux=True` returns (outputs, aux) with aux the outputs of the
    intermediate layers through the shared heads, {'class_logits':
    (L-1, B, Q, C+1), 'boxes_cxcywh': (L-1, B, Q, 4)}, or None for a
    one-layer decoder.
    """
    if embed_dim % cfg.num_heads:
        raise ValueError("detr num_heads must divide embed_dim")
    head_dim = embed_dim // cfg.num_heads
    b = memory.shape[0]
    x = params["queries"][None].expand(b, cfg.num_queries,
                                       embed_dim).to(memory.dtype)
    states = []
    for i, bp in enumerate(params["blocks"]):
        x = _decoder_block(x, memory, bp, cfg, head_dim, train=train,
                           rng=None if rng is None else rng.fold_in(i))
        states.append(x)
    outputs = _detr_outputs(params, x, cfg)
    if not return_aux:
        return outputs
    if cfg.depth < 2:
        return outputs, None  # no intermediate layers to supervise
    return outputs, _detr_outputs(params, torch.stack(states[:-1]), cfg)
