"""Patch embedding as one matmul (counterpart of ``arsvt_tpu/ops/patch_embed.py``).

A stride=kernel convolution is a reshape plus one (B·N, p²·C) × (p²·C, D)
product. `Conv2d` is not used: cuDNN runs an fp32 convolution in TF32 by
default, and the kernel layout here is the JAX one, (p·p·C, D) in
(p, p, C) row-major order over NHWC images.
"""

from __future__ import annotations

import torch


def extract_patches(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, p*p*C) non-overlapping patches, row-major."""
    b, h, w, c = images.shape
    p = patch_size
    if h % p or w % p:
        raise ValueError(f"image {h}x{w} not divisible by patch {p}")
    x = images.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, Hp, Wp, p, p, C)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def patch_embed(images: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor, *, patch_size: int) -> torch.Tensor:
    """images: (B, H, W, C); kernel: (p*p*C, D); bias: (D,). -> (B, N, D).

    The product accumulates in fp32 and the bias is added in fp32 before
    the cast to the image dtype. Both operands are rounded to the image
    dtype first and then widened, so a bf16 input gives the exact bf16
    products summed in fp32 (JAX's ``preferred_element_type=float32``).
    """
    patches = extract_patches(images, patch_size)
    out = (
        torch.matmul(patches.float(), kernel.to(patches.dtype).float())
        + bias.float()
    )
    return out.to(images.dtype)
