"""Explicit random streams (counterpart of ``arsvt_tpu/core/prng.py``).

Every stochastic op takes an explicit `torch.Generator`. The train step
seeds one CPU generator per (seed, step, microbatch) and draws the
per-image values there, then copies them to the device: CPU and CUDA
generators give different streams, so host draws are what lets a step on
the card and the same step on the CPU see the same augmentation.
``jax.random``'s values cannot be reproduced; tests that need them feed
them in explicitly.

`Rng` is the counterpart of a JAX key threaded through a forward: a tuple
of ints that `fold_in` extends, from which a dropout site takes a 32-bit
kernel seed (`seed32`) or a generator on its compute device
(`generator`). Both are derived on the host, so no site waits on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def _mix(keys, words: int = 1) -> np.ndarray:
    return np.random.SeedSequence([int(k) for k in keys]).generate_state(
        words, np.uint64 if words == 1 else np.uint32)


def generator(*keys: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of non-negative ints, mixed by
    numpy's SeedSequence so neighbouring tuples give unrelated streams."""
    return torch.Generator().manual_seed(int(_mix(keys)[0]))


class Rng:
    """An immutable tuple of non-negative ints naming one random stream:
    ``Rng(seed, step, microbatch).fold_in(layer).fold_in(site)``."""

    __slots__ = ("keys",)

    def __init__(self, *keys: int):
        if any(int(k) < 0 for k in keys):
            raise ValueError(f"Rng keys must be non-negative, got {keys}")
        self.keys = tuple(int(k) for k in keys)

    def fold_in(self, *more: int) -> "Rng":
        return Rng(*self.keys, *more)

    def seed32(self) -> int:
        """The stream's 32-bit seed, as a kernel's dropout takes it."""
        return int(_mix(self.keys, 2)[0])

    def generator(self, device="cpu") -> torch.Generator:
        """A generator on `device` seeded from the stream."""
        return torch.Generator(device=device).manual_seed(
            int(_mix(self.keys)[0]))

    def __repr__(self) -> str:
        return f"Rng{self.keys}"
