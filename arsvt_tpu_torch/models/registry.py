"""Named backbone presets (copy of the backbone part of
``arsvt_tpu/models/registry.py``).

The backbone forward takes head_dim 64 only (its attention kernel's
width): ``deit_ref_400_16_224`` (d=16) and the ``*_test_8_32`` presets
(d=16) are listed for parity with the JAX table but do not run yet.
"""

from __future__ import annotations

from arsvt_tpu_torch.models.vit import BackboneConfig

PRESETS: dict[str, BackboneConfig] = {
    "vit_tiny_16_224": BackboneConfig(
        image_size=224, patch_size=16, embed_dim=192, depth=12,
        num_heads=3, mlp_dim=768,
    ),
    "vit_small_16_224": BackboneConfig(
        image_size=224, patch_size=16, embed_dim=384, depth=12,
        num_heads=6, mlp_dim=1536,
    ),
    "vit_base_16_224": BackboneConfig(
        image_size=224, patch_size=16, embed_dim=768, depth=12,
        num_heads=12, mlp_dim=3072,
    ),
    "vit_large_16_384": BackboneConfig(
        image_size=384, patch_size=16, embed_dim=1024, depth=24,
        num_heads=16, mlp_dim=4096,
    ),
    "deit_ref_400_16_224": BackboneConfig(
        image_size=224, patch_size=16, embed_dim=400, depth=12,
        num_heads=25, mlp_dim=1600, dropout=0.1, attn_dropout=0.1,
        distilled=True,
    ),
    "vit_demo_8_96": BackboneConfig(
        image_size=96, patch_size=8, embed_dim=192, depth=6,
        num_heads=3, mlp_dim=768,
    ),
    "vit_test_8_32": BackboneConfig(
        image_size=32, patch_size=8, embed_dim=32, depth=2,
        num_heads=2, mlp_dim=64,
    ),
    "deit_test_8_32": BackboneConfig(
        image_size=32, patch_size=8, embed_dim=32, depth=2,
        num_heads=2, mlp_dim=64, distilled=True,
    ),
}


def get_preset(name: str) -> BackboneConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
