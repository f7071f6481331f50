"""ViT / DeiT backbone (counterpart of ``arsvt_tpu/models/vit.py``).

Parameters are a plain tree of tensors with the JAX tree's keys and
per-layer shapes; where JAX stacks the blocks on a leading depth axis for
``lax.scan``, this tree holds a list of per-layer dicts and the forward is
a Python loop. Images are NHWC. Pre-LN blocks:
``x += drop(out_proj(attn(qkv_proj(LN1(x))))); x += drop(mlp(LN2(x)))``,
then a final LN. The attention routes by what the port's kernels take: at
head_dim 64 (every ViT preset) qkv-proj → attention → out-proj is one
autograd Function over the encoder-attention kernels
(``ops/encoder_attention.py``), for serving and training alike, and a
training forward with ``ARSVT_ATTN_SAVE_PROBS`` set takes its save-probs
variant instead (``vit.py:182-185``; eval keeps the default kernels); any
other head_dim (the DeiT-400 detector backbone's 16), and head_dim 64
under ``ARSVT_DISABLE_FUSED_ATTN`` or ``ARSVT_ATTN_JNP``, runs qkv-proj →
the head-major attention kernels (``ops/flash_attention.py``, forward and
backward, with in-kernel attention dropout; the plain reference under
``ARSVT_ATTN_JNP`` on the CPU) → out-proj, as ``vit.py``'s non-fused branch does. The MLP is ``ops/mlp.py::gelu_mlp``, which takes the
fused-MLP kernels when ``ARSVT_ENABLE_FUSED_MLP`` is set.

A training forward takes an explicit `rng` (``core/prng.py::Rng``) in
place of JAX's key: positional dropout from ``rng.fold_in(0)``, layer i
from ``rng.fold_in(1, i)`` with its attention-residual, MLP-residual and
attention-probability sites at ``fold_in(0)``, ``(1)`` and ``(2)``.
Without an rng nothing is dropped, as in JAX. Attention dropout runs in
the kernels on every route, seeded from the probability site's
``seed32()``; the residual and positional sites draw the same rule's
mask of the activation (``ops/dropout.py::dropout``), so every mask is a
function of the site and of global indices.

Under tensor parallelism (``parallel/tensor_parallel.py``) a block holds
its rank's heads of qkv and proj and its share of fc1 and fc2: the
attention and MLP run on them between `enter` and `leave`, and the proj
and fc2 biases are added once, after `leave`.

``remat=True`` rematerialises the blocks under JAX's five policies
(``ops/remat.py``): ``full``, ``dots`` and ``names`` checkpoint each
block, ``all_but_mlp`` each MLP and ``mlp_tail`` each GELU → fc2. Every
dropout site draws from its own ``Rng``, so the backward's replay
redraws the same masks.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from arsvt_tpu_torch.core.dtypes import tree_map
from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.ops.attention import self_attention_from_qkv
from arsvt_tpu_torch.ops.dispatch import (
    use_attn_save_probs,
    use_fused_encoder_attention,
)
from arsvt_tpu_torch.ops.dropout import dropout
from arsvt_tpu_torch.ops.encoder_attention import (
    SUPPORTED_HEAD_DIM,
    fused_encoder_attention,
    fused_encoder_attention_savep,
)
from arsvt_tpu_torch.ops.layernorm import layer_norm
from arsvt_tpu_torch.ops.mlp import gelu_mlp
from arsvt_tpu_torch.ops.patch_embed import patch_embed
from arsvt_tpu_torch.ops.remat import BLOCK_POLICIES, check_policy, remat_call
from arsvt_tpu_torch.parallel.tensor_parallel import active, enter, leave


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


def tp_heads(num_heads: int, tp):
    """(local heads, head_range) of a layer of `num_heads` under the
    tensor-parallel shard `tp` (None: all heads, no range)."""
    if tp is None:
        return num_heads, None
    h0, count = tp.heads(num_heads)
    return count, (h0, num_heads)


def row_product(x, kernel, bias, tp):
    """x @ kernel + bias for a row-sharded kernel: under `tp` the partial
    sums go through `leave` and the bias is added once, after it."""
    out = torch.matmul(x, kernel.to(x.dtype))
    return leave(out, tp) + bias.to(x.dtype)


def _encoder_block(x: torch.Tensor, bp: dict, cfg: BackboneConfig, *,
                   train: bool = False, rng: Rng | None = None,
                   remat_mlp: bool = False,
                   remat_mlp_tail: bool = False, tp=None) -> torch.Tensor:
    """One pre-LN block; bp holds one layer's parameters (a rank's shards
    under the tensor-parallel `tp`). Each projection emits x's dtype and
    adds its bias in that dtype, as the JAX block. `remat_mlp` checkpoints
    the MLP (``all_but_mlp``), `remat_mlp_tail` its GELU → fc2
    (``mlp_tail``)."""
    k1 = k2 = kp = None
    if train and rng is not None:
        k1, k2, kp = (rng.fold_in(site) for site in range(3))
    heads, head_range = tp_heads(cfg.num_heads, tp)
    attn_p = bp["attn"]
    y = enter(layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                         eps=cfg.ln_eps), tp)
    wqkv, bqkv = (attn_p["qkv"][k].to(y.dtype) for k in ("kernel", "bias"))
    wproj, bproj = (attn_p["proj"][k].to(y.dtype)
                    for k in ("kernel", "bias"))
    if cfg.head_dim == SUPPORTED_HEAD_DIM and use_fused_encoder_attention():
        attn_dropping = train and cfg.attn_dropout > 0.0 and kp is not None
        fused = (fused_encoder_attention_savep
                 if train and use_attn_save_probs()
                 else fused_encoder_attention)
        attn = fused(y, wqkv, bqkv, wproj, None if tp else bproj, heads,
                     dropout_rate=cfg.attn_dropout if attn_dropping else 0.0,
                     dropout_rng=kp, head_range=head_range)
        if tp is not None:
            attn = leave(attn, tp) + bproj
    else:
        attn = self_attention_from_qkv(
            torch.matmul(y, wqkv) + bqkv, heads,
            dropout_rate=cfg.attn_dropout if train else 0.0, dropout_rng=kp,
            head_range=head_range)
        attn = row_product(attn, wproj, bproj, tp)
    x = x + dropout(attn, cfg.dropout, k1, train=train)

    y = enter(layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                         eps=cfg.ln_eps), tp)
    mlp = bp["mlp"]
    b2 = mlp["fc2"]["bias"]
    mlp_args = (y, mlp["fc1"]["kernel"], mlp["fc1"]["bias"],
                mlp["fc2"]["kernel"], None if tp else b2)
    if remat_mlp:
        y = remat_call(gelu_mlp, *mlp_args)
    else:
        y = gelu_mlp(*mlp_args, remat_tail=remat_mlp_tail)
    if tp is not None:
        y = leave(y, tp) + b2.to(y.dtype)
    return x + dropout(y, cfg.dropout, k2, train=train)


def apply_backbone(params: dict, images: torch.Tensor,
                   cfg: BackboneConfig, *, train: bool = False,
                   rng: Rng | None = None, remat: bool = False,
                   remat_policy: str = "full") -> torch.Tensor:
    """images: (B, H, W, C) in the compute dtype -> all tokens (B, S, D)
    after the final LN (special tokens first; heads pick what they use).

    `train` with an `rng` applies the config's positional, residual and
    attention dropout (see the module docstring). `remat` rematerialises
    the blocks under `remat_policy` (one of ``ops/remat.py``'s
    ``REMAT_POLICIES``; an unknown one raises ValueError, as in JAX).
    """
    check_policy(remat, remat_policy)
    b = images.shape[0]
    x = patch_embed(images, params["patch_embed"]["kernel"],
                    params["patch_embed"]["bias"],
                    patch_size=cfg.patch_size)  # (B, N, D)
    specials = [params["cls_token"].expand(b, 1, cfg.embed_dim)]
    if cfg.distilled:
        specials.append(params["dist_token"].expand(b, 1, cfg.embed_dim))
    x = torch.cat([t.to(x.dtype) for t in specials] + [x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    x = dropout(x, cfg.dropout, None if rng is None else rng.fold_in(0),
                train=train)
    block_remat = remat and remat_policy in BLOCK_POLICIES
    tp = active()
    for i, bp in enumerate(params["blocks"]):
        block = functools.partial(
            _encoder_block, cfg=cfg, train=train,
            rng=None if rng is None else rng.fold_in(1, i),
            remat_mlp=remat and remat_policy == "all_but_mlp",
            remat_mlp_tail=remat and remat_policy == "mlp_tail", tp=tp)
        x = (remat_call(block, x, bp, policy=remat_policy) if block_remat
             else block(x, bp))
    return layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"],
                      eps=cfg.ln_eps)
