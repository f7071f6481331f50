"""Analytic FLOP counts for the TFLOP/s in the training rows (copy of
``arsvt_tpu/utils/flops.py`` on the port's configs).

Counting convention: 1 MAC = 2 FLOPs, forward only; the caller scales by
the backward/remat multiplier (`train_flops_multiplier`). A distillation
teacher's forward is not counted, as in the JAX package.
"""

from __future__ import annotations

from arsvt_tpu_torch.models.vit import BackboneConfig


def backbone_fwd_gflops(bb: BackboneConfig) -> float:
    """Forward GFLOPs per image for the ViT/DeiT backbone."""
    s = bb.seq_len
    d, mlp = bb.embed_dim, bb.mlp_dim
    per_block = (
        2 * s * d * (3 * d)        # qkv projection
        + 2 * s * d * d            # output projection
        + 2 * 2 * s * d * mlp      # MLP fc1 + fc2
        + 2 * 2 * s * s * d        # QK^T and PV
    )
    patch_embed = 2 * bb.num_patches * (
        bb.patch_size * bb.patch_size * bb.in_channels
    ) * d
    return (bb.depth * per_block + patch_embed) / 1e9


def detr_head_fwd_gflops(head, embed_dim: int, num_patches: int) -> float:
    """Forward GFLOPs per image for the DETR decoder head."""
    q, n, d, ffn = head.num_queries, num_patches, embed_dim, head.ffn_dim
    per_block = (
        2 * q * d * (3 * d) + 2 * q * d * d          # self-attn proj
        + 2 * q * q * d * 2                           # self-attn matmuls
        + 2 * q * d * d + 2 * n * d * (2 * d)         # cross q / kv proj
        + 2 * q * d * d                               # cross out proj
        + 2 * q * n * d * 2                           # cross-attn matmuls
        + 2 * 2 * q * d * ffn                         # FFN
    )
    heads = 2 * q * d * (head.num_classes + 1) + 2 * q * d * 4
    return (head.depth * per_block + heads) / 1e9


def train_flops_multiplier(remat: bool, remat_policy: str = "full") -> float:
    """Forward-equivalents per train step: forward + backward (~2x the
    forward) + the policy's recompute: the whole forward for "full",
    "dots" and "names", fc1 + GELU (~0.3x) for "all_but_mlp", the GELU
    alone for "mlp_tail"."""
    if not remat:
        return 3.0
    return {"all_but_mlp": 3.3, "mlp_tail": 3.05}.get(remat_policy, 4.0)


def train_gflops_per_image(cfg) -> float:
    """Per-image GFLOPs of one train step under `cfg` (TrainConfig). The
    deep-supervision aux losses rerun only the shared output heads per
    intermediate decoder layer: negligible, ignored."""
    from arsvt_tpu_torch.train.config import (
        resolve_backbone,
        resolve_detector,
    )

    if cfg.task == "detect":
        det = resolve_detector(cfg)
        fwd = backbone_fwd_gflops(det.backbone) + detr_head_fwd_gflops(
            det.head, det.backbone.embed_dim, det.backbone.num_patches
        )
    else:
        fwd = backbone_fwd_gflops(resolve_backbone(cfg))
    return fwd * train_flops_multiplier(cfg.remat, cfg.remat_policy)
