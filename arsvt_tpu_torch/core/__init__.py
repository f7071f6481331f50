"""Dtype policy and image rescaling."""
