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
seed (`seed32`), derived on the host, so no site waits on the card. Every
dropout mask is a function of that seed and of global indices
(``ops/dropout.py``); `row0`, the first row of the caller's slice in the
global microbatch (a data-parallel rank's), rides beside the keys and
never changes the seed, so every rank holds the same `Rng`.
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

    __slots__ = ("keys", "row0")

    def __init__(self, *keys: int, row0: int = 0):
        if any(int(k) < 0 for k in keys) or row0 < 0:
            raise ValueError(f"Rng keys and row0 must be non-negative, got "
                             f"{keys}, {row0}")
        self.keys = tuple(int(k) for k in keys)
        self.row0 = int(row0)

    def fold_in(self, *more: int) -> "Rng":
        return Rng(*self.keys, *more, row0=self.row0)

    def at_row(self, row0: int) -> "Rng":
        """The same stream for a slice starting at global row `row0`."""
        return Rng(*self.keys, row0=row0)

    def seed32(self) -> int:
        """The stream's 32-bit seed, as every dropout mask takes it."""
        return int(_mix(self.keys, 2)[0])

    def __repr__(self) -> str:
        return (f"Rng{self.keys}" if not self.row0
                else f"Rng{self.keys}@{self.row0}")
