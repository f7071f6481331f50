"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card; without one, that raises instead of running
    on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def platform_device() -> str:
    """``ARSVT_PLATFORM``: unset (the card) or "cpu"."""
    platform = os.environ.get("ARSVT_PLATFORM", "")
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"ARSVT_PLATFORM={platform!r}: the port runs on 'cpu' "
                     "or the card")
