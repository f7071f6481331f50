"""Compute ops: plain PyTorch ops and the hand-written Hopper kernels."""
