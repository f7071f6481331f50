"""Explicit random streams (counterpart of ``arsvt_tpu/core/prng.py``).

Every stochastic op takes an explicit `torch.Generator`. The train step
seeds one CPU generator per (seed, step, microbatch) and draws the
per-image values there, then copies them to the device: CPU and CUDA
generators give different streams, so host draws are what lets a step on
the card and the same step on the CPU see the same augmentation.
``jax.random``'s values cannot be reproduced; tests that need them feed
them in explicitly.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(*keys: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of non-negative ints, mixed by
    numpy's SeedSequence so neighbouring tuples give unrelated streams."""
    seed = np.random.SeedSequence([int(k) for k in keys]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))
