"""Dropout: the counter-based mask of the attention kernels and the plain
dropout of the residual and positional sites.

The TPU kernels draw their attention-dropout mask from the TPU's own
generator, seeded per (call seed, absolute batch item, head)
(``arsvt_tpu/ops/pallas/flash_attention.py:70-77``, ``:114-120``). The
port draws it from Philox4x32-10 keyed on (seed, b·H + h) with the counter
(query row, key column): every element's bits depend on those four numbers
alone, never on a tiling, so the forward kernel, both launches of the
backward, the packed and unpacked entries and the plain versions all
rebuild the identical mask. An element is kept where its bits are below
``min(int((1 - rate)·2^32), 2^32 - 1)``, JAX's rule. `keep_bits` is the
plain PyTorch Philox in int64 arithmetic (32x32-bit products split into
16-bit halves so that nothing overflows); the CUDA kernels carry the same
rounds.

`dropout` is ``arsvt_tpu/models/vit.py:140-145``: inverted dropout from a
generator on the tensor's device (XLA ops in JAX, so no kernel here).
"""

from __future__ import annotations

import numpy as np
import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """Keep an element iff its 32 bits are below this (JAX's rule)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int((1.0 - rate) * 2**32), 2**32 - 1)


def inv_keep(rate: float) -> float:
    """1/(1 - rate) rounded to fp32: JAX multiplies by the Python
    constant, which the fp32 product rounds so."""
    return float(np.float32(1.0 / (1.0 - rate)))


def apply_mask(x: torch.Tensor, keep: torch.Tensor, rate: float):
    """x where kept, scaled by 1/(1 - rate); 0 where dropped."""
    return torch.where(keep, x * inv_keep(rate), torch.zeros_like(x))


def kernel_args(rate: float, seed: int) -> tuple:
    """(seed, threshold, inv_keep, dropout flag): the attention kernels'
    C arguments for one call; no dropout at rate 0."""
    if rate > 0.0:
        return (int(seed) & 0xFFFFFFFF, keep_threshold(rate), inv_keep(rate),
                1)
    return 0, 0, 1.0, 0


def call_dropout(rate: float, rng) -> tuple[float, int]:
    """(rate, seed) of one attention call: dropout only with a rate and an
    rng (a ``core/prng.py::Rng``), as JAX drops only with a rate and a key;
    the seed is the rng's `seed32`, taken on the host."""
    if rate > 0.0 and rng is not None:
        return float(rate), rng.seed32()
    return 0.0, 0


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and a tensor
    of 32-bit values held in int64."""
    p_lo = m * (x & 0xFFFF)   # < 2^48
    p_hi = m * (x >> 16)      # < 2^48
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def keep_bits(seed: int, bh, row, col) -> torch.Tensor:
    """Philox4x32-10 with key (seed, bh) and counter (row, col, 0, 0); the
    first output word, as int64 values in [0, 2^32). `bh`, `row` and `col`
    are int64 tensors that broadcast together."""
    bh, row, col = (torch.as_tensor(t, dtype=torch.int64) for t in
                    (bh, row, col))
    shape = torch.broadcast_shapes(bh.shape, row.shape, col.shape)
    device = bh.device
    c0 = row.expand(shape) & _MASK32
    c1 = col.expand(shape) & _MASK32
    c2 = torch.zeros(shape, dtype=torch.int64, device=device)
    c3 = torch.zeros(shape, dtype=torch.int64, device=device)
    k0 = torch.full(shape, int(seed) & _MASK32, dtype=torch.int64,
                    device=device)
    k1 = bh.expand(shape) & _MASK32
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return c0


def keep_mask(seed: int, batch: int, heads: int, sq: int, sk: int,
              rate: float, device="cpu") -> torch.Tensor:
    """(B, H, Sq, Sk) bool: True where the attention kernels keep the
    probability of query row i for key column j, for the call seed
    `seed`. Built one batch item at a time, so its int64 temporaries stay
    at a few times one item's H·Sq·Sk."""
    threshold = keep_threshold(rate)
    row = torch.arange(sq, dtype=torch.int64, device=device)[None, :, None]
    col = torch.arange(sk, dtype=torch.int64, device=device)[None, None, :]
    out = torch.empty((batch, heads, sq, sk), dtype=torch.bool,
                      device=device)
    for b in range(batch):
        bh = (b * heads + torch.arange(heads, dtype=torch.int64,
                                       device=device))[:, None, None]
        out[b] = keep_bits(seed, bh, row, col) < threshold
    return out


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            *, train: bool) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), in x's dtype; the identity unless training
    with a rate and a generator (JAX: unless training with a key)."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
