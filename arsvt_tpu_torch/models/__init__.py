"""ViT/DeiT backbone, classifier head, presets and the JAX parameter bridge."""
