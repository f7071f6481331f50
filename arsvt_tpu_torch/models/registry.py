"""Named model presets (copy of ``arsvt_tpu/models/registry.py``).

Every preset runs: head_dim 64 backbones through the encoder-attention
kernels, the others (``deit_ref_400_16_224`` and the ``*_test_8_32``
presets, d=16) through the head-major attention kernels, forward and
backward.
"""

from __future__ import annotations

from arsvt_tpu_torch.models.detector import DetectorConfig
from arsvt_tpu_torch.models.heads import DetrHeadConfig
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

DETECTOR_PRESETS: dict[str, DetectorConfig] = {
    # reference train config: 5 queries, 6-layer decoder, 8 heads, ffn 2048
    "deit_detector_ref": DetectorConfig(
        backbone=PRESETS["deit_ref_400_16_224"],
        head=DetrHeadConfig(num_classes=6, num_queries=5, depth=6,
                            num_heads=8, ffn_dim=2048, dropout=0.1,
                            attn_dropout=0.1),
    ),
    # reference eval-script config: ViT-B backbone, 100 queries
    "vit_base_detector": DetectorConfig(
        backbone=PRESETS["vit_base_16_224"],
        head=DetrHeadConfig(num_classes=6, num_queries=100, depth=6,
                            num_heads=8, ffn_dim=2048),
    ),
    "detector_test": DetectorConfig(
        backbone=PRESETS["deit_test_8_32"],
        head=DetrHeadConfig(num_classes=6, num_queries=5, depth=2,
                            num_heads=2, ffn_dim=64),
    ),
    "detector_demo_96": DetectorConfig(
        backbone=BackboneConfig(
            image_size=96, patch_size=8, embed_dim=192, depth=6,
            num_heads=3, mlp_dim=768,
        ),
        head=DetrHeadConfig(num_classes=6, num_queries=10, depth=3,
                            num_heads=4, ffn_dim=512),
    ),
}


def get_preset(name: str) -> BackboneConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]


def get_detector_preset(name: str) -> DetectorConfig:
    if name not in DETECTOR_PRESETS:
        raise KeyError(
            f"unknown detector preset {name!r}; have "
            f"{sorted(DETECTOR_PRESETS)}")
    return DETECTOR_PRESETS[name]
