"""Dropout: one counter-based mask rule for every dropout site of the port.

The TPU kernels draw their attention-dropout mask from the TPU's own
generator, seeded per (call seed, absolute batch item, head)
(``arsvt_tpu/ops/pallas/flash_attention.py:70-77``, ``:114-120``). The
port draws it from Philox4x32-10 keyed on (seed, b·H + h) with the counter
(query row, key column): every element's bits depend on those four numbers
alone, never on a tiling, so the forward kernel, both launches of the
backward, the packed and unpacked entries and the plain versions all
rebuild the identical mask. An element is kept where its bits are below
``min(int((1 - rate)·2^32), 2^32 - 1)``, JAX's rule. `keep_bits` is the
plain PyTorch Philox in int64 arithmetic (32x32-bit products whose
wrapped int64 bits give both words); the CUDA kernels carry the same
rounds.

b and h are global: a launch that holds rows b0.. of the microbatch and
heads h0.. of H (a rank of a data- or tensor-parallel step) keys element
(b, h) on (b0 + b)·H + h0 + h, and a one-process call passes the offsets
(0, its heads, 0). So a parallel step draws the one-process step's mask.

The residual and positional sites (JAX: ``jax.random.bernoulli`` at
``arsvt_tpu/models/vit.py:140-145``) and the reference attention draw by
the same rule: a (B, S, D) activation is viewed as (B, 1, S, D), so its
key word is the global batch row, its counter (token, feature); reference
attention probabilities as (B, H, Sq, Sk), the layout of #3/#4, so the
reference and the kernels drop the same probabilities. Each such site is
`SiteDropout`, one launch of ``csrc/dropout_mask.cu``'s apply kernel each
way (`dropout_apply`: keep ? x·s : +0, the mask drawn in the kernel): the
backward is the same function of the gradient, so the mask is replayed
from the seed and no tensor is saved. On a CPU tensor `dropout_apply` runs
`dropout_apply_plain`, the eager where over `keep_mask`. The mask is a function of (site seed, global index) alone, on every device
and every world size.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from arsvt_tpu_torch.ops import build

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF

# Launches of the apply kernel (one a `dropout_apply` call on the card: a
# site's forward, its replay under remat, or its backward).
APPLY_LAUNCHES = 0

# the site's scale rule: x / (1 - rate) (the residual and positional
# sites) or x * inv_keep(rate) (the reference attention, as the kernels'
# plain versions)
SCALE_MODES = ("div", "mul")
# the apply kernel's dtype codes (csrc/dropout_mask.cu)
_APPLY_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_apply_fn = None


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


def mask_offsets(offsets, heads: int) -> tuple[int, int, int]:
    """(b0, H, h0) of a launch over `heads` local heads: `offsets` as
    given, or (0, heads, 0), the one-process call."""
    if offsets is None:
        return 0, int(heads), 0
    b0, total, h0 = (int(v) for v in offsets)
    if b0 < 0 or h0 < 0 or h0 + heads > total:
        raise ValueError(f"mask offsets (b0, H, h0) = {offsets} do not hold "
                         f"{heads} heads")
    return b0, total, h0


def call_dropout(rate: float, rng, heads: int = 1,
                 head_range=None) -> tuple[float, int, tuple]:
    """(rate, seed, offsets) of one attention call: dropout only with a
    rate and an rng (a ``core/prng.py::Rng``), as JAX drops only with a
    rate and a key; the seed is the rng's `seed32`, taken on the host.
    offsets = (b0, H, h0): the rng's `row0` and `head_range` = (h0, H) of
    a tensor-parallel rank's `heads`, by default (0, heads)."""
    h0, total = (0, heads) if head_range is None else head_range
    if rate > 0.0 and rng is not None:
        return float(rate), rng.seed32(), (rng.row0, total, h0)
    return 0.0, 0, (0, total, h0)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and a tensor
    of 32-bit values held in int64. The 64-bit product wraps past 2^63 in
    int64; its two's-complement bits are the true product's, so both words
    are exact (the arithmetic shift's sign bits fall outside the mask)."""
    p = m * x
    return (p >> 32) & _MASK32, p & _MASK32


def keep_bits(seed: int, bh, row, col) -> torch.Tensor:
    """Philox4x32-10 with key (seed, bh) and counter (row, col, 0, 0); the
    first output word, as int64 values in [0, 2^32). `bh`, `row` and `col`
    are int64 tensors that broadcast together. The keys stay as small as
    they come (k0 a Python int, k1 `bh`'s own shape), and the counter
    words take the full shape only as the rounds make them so."""
    bh, row, col = (torch.as_tensor(t, dtype=torch.int64) for t in
                    (bh, row, col))
    shape = torch.broadcast_shapes(bh.shape, row.shape, col.shape)
    c0, c1 = row & _MASK32, col & _MASK32
    c2 = c3 = 0
    k0, k1 = int(seed) & _MASK32, bh & _MASK32
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = (_mulhilo(PHILOX_M1, c2) if isinstance(c2, torch.Tensor)
                    else (0, 0))
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return c0.expand(shape)


def keep_mask(seed: int, batch: int, heads: int, sq: int, sk: int,
              rate: float, device="cpu", *, offsets=None) -> torch.Tensor:
    """(B, H, Sq, Sk) bool: True where the attention kernels keep the
    probability of query row i for key column j, for the call seed
    `seed`, with the launch at `offsets` = (b0, H, h0) (`mask_offsets`).
    Built one batch item at a time, so its int64 temporaries stay at a few
    times one item's H·Sq·Sk."""
    threshold = keep_threshold(rate)
    b0, total, h0 = mask_offsets(offsets, heads)
    row = torch.arange(sq, dtype=torch.int64, device=device)[None, :, None]
    col = torch.arange(sk, dtype=torch.int64, device=device)[None, None, :]
    out = torch.empty((batch, heads, sq, sk), dtype=torch.bool,
                      device=device)
    for b in range(batch):
        bh = ((b0 + b) * total + h0 + torch.arange(
            heads, dtype=torch.int64, device=device))[:, None, None]
        out[b] = keep_bits(seed, bh, row, col) < threshold
    return out


def kernel_scale(rate: float, scale_mode: str) -> float:
    """The scale s with which the apply kernel's x·s reproduces the eager
    site on the card: PyTorch's CUDA division by a host scalar
    multiplies by the fp32 reciprocal (``aten/src/ATen/native/cuda/
    BinaryDivTrueKernel.cu``), so x / (1 - rate) is x · fp32(1 /
    fp32(1 - rate)), and x * inv_keep(rate) is that product. Both are one
    fp32 multiply (``chip_smoke.py`` phase 3(a) holds the bits)."""
    if scale_mode == "div":
        one_minus = np.float32(1.0 - rate)
        return float(np.float32(1.0) / one_minus)
    if scale_mode == "mul":
        return inv_keep(rate)
    raise ValueError(f"scale_mode must be one of {SCALE_MODES}, got "
                     f"{scale_mode!r}")


def dropout_apply_plain(x: torch.Tensor, seed: int, rate: float, offsets,
                        view, scale_mode: str) -> torch.Tensor:
    """The eager site: x where `keep_mask` of the (B, H, R, C) `view` at
    `offsets` keeps, scaled by x / (1 - rate) ("div") or `apply_mask`'s
    x * inv_keep(rate) ("mul"); +0 where dropped."""
    if scale_mode not in SCALE_MODES:
        raise ValueError(f"scale_mode must be one of {SCALE_MODES}, got "
                         f"{scale_mode!r}")
    b, h, r, c = view
    keep = keep_mask(seed, b, h, r, c, rate, x.device,
                     offsets=offsets).view(x.shape)
    if scale_mode == "mul":
        return apply_mask(x, keep, rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _apply_kernel():
    global _apply_fn
    if _apply_fn is None:
        fn = build.load("dropout_mask").arsvt_dropout_apply
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
            ctypes.c_uint32, ctypes.c_uint32] + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _apply_fn = fn
    return _apply_fn


def dropout_apply(x: torch.Tensor, seed: int, rate: float, offsets, view,
                  scale_mode: str) -> torch.Tensor:
    """keep ? x·s : +0 over x viewed as `view` = (B, H, R, C) at `offsets`
    = (b0, H', h0) (`mask_offsets`), in x's dtype: on the card one launch
    of the apply kernel (counted; fp32 and bf16), on the CPU
    `dropout_apply_plain`."""
    if x.device.type == "cpu":
        return dropout_apply_plain(x, seed, rate, offsets, view, scale_mode)
    if x.device.type != "cuda":
        raise ValueError(f"dropout_apply runs on cpu or cuda, got "
                         f"{x.device}")
    if x.dtype not in _APPLY_DTYPES:
        raise TypeError(f"dropout_apply takes float32 or bfloat16, got "
                        f"{x.dtype}")
    b, h, r, c = (int(n) for n in view)
    if b * h * r * c != x.numel():
        raise ValueError(f"view {tuple(view)} does not hold x of shape "
                         f"{tuple(x.shape)}")
    global APPLY_LAUNCHES
    threshold = keep_threshold(rate)
    scale = kernel_scale(rate, scale_mode)
    b0, total, h0 = mask_offsets(offsets, h)
    x = x.contiguous()  # a copy where x is a strided view, not a fallback
    out = torch.empty_like(x)
    fn = _apply_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(out.data_ptr(), x.data_ptr(), _APPLY_DTYPES[x.dtype], b, h,
                 r, c, int(seed) & _MASK32, threshold, b0, total, h0, scale,
                 stream)
    if err != 0:
        raise RuntimeError(f"dropout_apply kernel launch failed: CUDA error "
                           f"{err}")
    APPLY_LAUNCHES += 1
    return out


class SiteDropout(torch.autograd.Function):
    """One dropout site: `dropout_apply` on x forward and on the gradient
    backward (dx = keep ? g·s : +0, the eager where's and scale's
    backward to the bit), so a site is one launch each way on the card.
    It saves no tensor, only (seed, rate, offsets, view, scale_mode): the
    backward draws the mask again."""

    @staticmethod
    def forward(ctx, x, seed, rate, offsets, view, scale_mode):
        ctx.site = (seed, rate, offsets, view, scale_mode)
        return dropout_apply(x, seed, rate, offsets, view, scale_mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return (dropout_apply(grad, *ctx.site),) + (None,) * 5


def site_view(x: torch.Tensor) -> tuple[int, int, int, int]:
    """A residual or positional site's view of x (B, ..., D): (B, 1, R, D),
    R the product of the middle dims."""
    b, d = x.shape[0], x.shape[-1]
    rows = x[0].numel() // d if x.dim() > 1 else 1
    return b, 1, rows, d


def dropout(x: torch.Tensor, rate: float, rng, *,
            train: bool) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), in x's dtype; the identity unless training
    with a rate and an rng (JAX: unless training with a key). The mask is
    the site's (`site_view`, keyed on the global batch row ``rng.row0 + b``
    with counter (token, feature)), drawn and applied by `SiteDropout`."""
    if not train or rate == 0.0 or rng is None:
        return x
    return SiteDropout.apply(x, rng.seed32(), rate, (rng.row0, 1, 0),
                             site_view(x), "div")
