"""Linear classifier head (counterpart of the classifier part of
``arsvt_tpu/models/heads.py``).

Pooled special token(s) -> fp32 logits. For DeiT backbones the CLS and
DIST tokens get separate heads whose logits are averaged.
"""

from __future__ import annotations

import dataclasses

import torch


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
                     cfg: ClassifierConfig) -> torch.Tensor:
    """tokens: (B, S, D) with CLS [, DIST] first -> logits (B, C) fp32."""
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
        return (logits + logits_d) / 2.0
    return logits
