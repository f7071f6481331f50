"""Int8 W8A8 ViT/DeiT inference (counterpart of
``arsvt_tpu/models/quantized.py``).

The five matmul weight families of the backbone (patch embed, fused QKV,
attention out-projection, MLP fc1 and fc2) are quantized once, per output
channel (``ops/quant.py``), and the eval forward runs each of those
products as an s8 x s8 -> s32 product with per-token activation scales.
LayerNorms, biases, the CLS/DIST tokens, the pos-embed, the classifier
head, the DETR head and the triplet projection stay floating point.

The trees keep the port's layout (blocks as a list of per-layer dicts); a
quantized kernel is {"q": int8 (in, out), "scale": fp32 (out,)}.
``models/bridge.py`` carries JAX's quantized pytrees across.

The attention core follows the port's routing: at head_dim 64 the
encoder-attention forward kernel (#1, the op ``arsvt::encoder_attention_
fwd``) on the quantized qkv, at any other head_dim the head-major kernel
(#3, through `self_attention_from_qkv`). Eval only: no backward, no
dropout.
"""

from __future__ import annotations

import torch

from arsvt_tpu_torch.models.heads import (
    ClassifierConfig,
    apply_classifier,
    apply_detr_head,
)
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.ops.attention import self_attention_from_qkv
from arsvt_tpu_torch.ops.encoder_attention import (
    SUPPORTED_HEAD_DIM,
    encoder_attention_fwd_op,
)
from arsvt_tpu_torch.ops.layernorm import layer_norm
from arsvt_tpu_torch.ops.mlp import gelu_tanh
from arsvt_tpu_torch.ops.patch_embed import extract_patches
from arsvt_tpu_torch.ops.quant import quant_dense, quantize_weight


def _qlinear(p: dict) -> dict:
    return {"kernel": quantize_weight(p["kernel"], axis=-2),
            "bias": p["bias"]}


def quantize_backbone(bb: dict, cfg: BackboneConfig) -> dict:
    """Backbone params -> the quantized-inference tree: the five matmul
    kernels become {"q", "scale"}, every other leaf is carried as is."""
    qbackbone = {
        "patch_embed": _qlinear(bb["patch_embed"]),
        "cls_token": bb["cls_token"],
        "pos_embed": bb["pos_embed"],
        "blocks": [
            {
                "ln1": bp["ln1"],
                "attn": {"qkv": _qlinear(bp["attn"]["qkv"]),
                         "proj": _qlinear(bp["attn"]["proj"])},
                "ln2": bp["ln2"],
                "mlp": {"fc1": _qlinear(bp["mlp"]["fc1"]),
                        "fc2": _qlinear(bp["mlp"]["fc2"])},
            }
            for bp in bb["blocks"]
        ],
        "ln_f": bb["ln_f"],
    }
    if cfg.distilled:
        qbackbone["dist_token"] = bb["dist_token"]
    return qbackbone


def quantize_image_classifier(params: dict, cfg: BackboneConfig) -> dict:
    """Classifier params -> quantized tree; the head stays fp."""
    return {"backbone": quantize_backbone(params["backbone"], cfg),
            "classifier": params["classifier"]}


def quantize_detector(params: dict, cfg) -> dict:
    """Detector params (`cfg` a DetectorConfig) -> quantized tree: only the
    backbone quantizes; the DETR head and the triplet projection stay
    fp."""
    return {"backbone": quantize_backbone(params["backbone"], cfg.backbone),
            "detr": params["detr"],
            "triplet_proj": params["triplet_proj"]}


def _attention(qkv: torch.Tensor, cfg: BackboneConfig) -> torch.Tensor:
    if cfg.head_dim == SUPPORTED_HEAD_DIM:
        return encoder_attention_fwd_op(qkv, cfg.num_heads, 0.0, 0, 0,
                                        cfg.num_heads, 0)[0]
    return self_attention_from_qkv(qkv, cfg.num_heads)


def apply_backbone_int8(qparams: dict, images: torch.Tensor,
                        cfg: BackboneConfig, *,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Quantized eval forward: images (B, H, W, C) -> tokens (B, S, D)
    after the final LN, in `compute_dtype`. JAX's block: every projection
    through `quant_dense` (its output in the activations' dtype), the
    attention core in `compute_dtype` through the kernels."""
    b = images.shape[0]
    x = images.to(compute_dtype)
    patches = extract_patches(x, cfg.patch_size)
    x = quant_dense(patches, qparams["patch_embed"]["kernel"],
                    qparams["patch_embed"]["bias"], out_dtype=compute_dtype)
    specials = [qparams["cls_token"].to(compute_dtype).expand(
        b, 1, cfg.embed_dim)]
    if cfg.distilled:
        specials.append(qparams["dist_token"].to(compute_dtype).expand(
            b, 1, cfg.embed_dim))
    x = torch.cat(specials + [x], dim=1)
    x = x + qparams["pos_embed"].to(compute_dtype)
    for bp in qparams["blocks"]:
        y = layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                       eps=cfg.ln_eps)
        attn_p = bp["attn"]
        qkv = quant_dense(y, attn_p["qkv"]["kernel"], attn_p["qkv"]["bias"])
        attn = _attention(qkv, cfg)
        x = x + quant_dense(attn, attn_p["proj"]["kernel"],
                            attn_p["proj"]["bias"])
        y = layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                       eps=cfg.ln_eps)
        mlp = bp["mlp"]
        h = gelu_tanh(quant_dense(y, mlp["fc1"]["kernel"],
                                  mlp["fc1"]["bias"]))
        x = x + quant_dense(h, mlp["fc2"]["kernel"], mlp["fc2"]["bias"])
    return layer_norm(x, qparams["ln_f"]["scale"], qparams["ln_f"]["bias"],
                      eps=cfg.ln_eps)


def apply_image_classifier_int8(qparams: dict, images: torch.Tensor,
                                cfg: BackboneConfig, num_classes: int, *,
                                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, num_classes) fp32, int8
    backbone."""
    tokens = apply_backbone_int8(qparams["backbone"], images, cfg,
                                 compute_dtype=compute_dtype)
    head_cfg = ClassifierConfig(num_classes=num_classes,
                                distilled=cfg.distilled)
    return apply_classifier(qparams["classifier"], tokens, head_cfg)


def apply_detector_int8(qparams: dict, images: torch.Tensor, cfg, *,
                        compute_dtype=torch.bfloat16) -> dict:
    """Quantized detector eval (`cfg` a DetectorConfig): int8 backbone, fp
    DETR head. Returns apply_detector's {'class_logits', 'boxes_cxcywh'}."""
    tokens = apply_backbone_int8(qparams["backbone"], images, cfg.backbone,
                                 compute_dtype=compute_dtype)
    memory = tokens[:, cfg.backbone.num_special_tokens:]
    return apply_detr_head(qparams["detr"], memory, cfg.head,
                           cfg.backbone.embed_dim)
