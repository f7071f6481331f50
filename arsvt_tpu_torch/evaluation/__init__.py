"""Streaming single-image classification."""
