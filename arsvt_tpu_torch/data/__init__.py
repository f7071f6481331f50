"""Taxonomy, host decode + letterbox, and ImageNet normalization."""
