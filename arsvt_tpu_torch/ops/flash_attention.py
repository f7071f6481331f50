"""Head-major attention, forward and backward (counterpart of
``arsvt_tpu/ops/pallas/flash_attention.py``'s ``_fwd`` → ``_fwd_kernel``
and ``_bwd_call`` → ``_bwd_kernel`` with their custom VJPs).

- `flash_attention_fwd`: q (B, H, Sq, d), k and v (B, H, Sk, d) → O (B, H,
  Sq, d) and lse (B, H, 1, Sq) fp32, keys at or past `kv_len` masked,
  optional dropout on the probabilities; kernel
  ``csrc/flash_attention_fwd.cu``;
- `flash_attention_bwd`: dq, dk, dv from q, k, v, O, dO and lse, replaying
  the forward's dropout mask; kernel ``csrc/flash_attention_bwd.cu`` (two
  launches a call: dq, then dk/dv);
- `flash_attention`: the DETR cross-attention's entry (JAX's `_flash` /
  `_flash_dropout`), an autograd Function over the two kernels, with an
  explicit `mask` routed to the reference;
- `flash_self_attention_packed`: the encoder self-attention of backbones
  whose head_dim the encoder-attention kernels do not take, from the packed
  (B, S, 3D) projection output; it saves only (qkv_flat, O, lse) and
  re-splits the heads in the backward (JAX's `_packed_fwd_impl` /
  `_packed_bwd_impl`).

Dropout (rate > 0 with an `Rng`): the mask is ``ops/dropout.py``'s Philox
keyed on (call seed, (b0 + b)·H + h0 + h) with counter (row, col), so the
forward, the backward and the plain versions draw the same one; the call
seed is the rng's `seed32`, taken on the host, and `offsets` = (b0, H, h0)
place the call's rows and heads in the global batch and head set (the
rng's `row0`, a tensor-parallel rank's `head_range`; (0, heads, 0) by
default). l and lse are the values before dropout.

On a CUDA tensor each wrapper launches its hand-written kernel or raises;
on a CPU tensor it runs its ``*_plain`` version, which repeats the
kernel's arithmetic in plain PyTorch. There is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops.attention import (
    merge_heads,
    sdpa_reference,
    split_heads,
)
from arsvt_tpu_torch.ops.dropout import (
    apply_mask,
    call_dropout,
    kernel_args,
    keep_mask,
    keep_threshold,
    mask_offsets,
)
from arsvt_tpu_torch.ops.library import kernel_op

# -0.7 * float32 max, the TPU kernel's mask value (``flash_attention.py:44``)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process: each wrapper adds one where it launches
# and nowhere else, so a run can show that its path went through the
# kernels. One backward call (its dq and dk/dv kernels, launched together)
# counts one. The DROPOUT_ counters count, beside them, the launches that
# ran the dropout branch.
LAUNCHES = 0
LAUNCHES_BWD = 0
DROPOUT_LAUNCHES = 0
DROPOUT_LAUNCHES_BWD = 0

_fn = None
_bwd_fn = None


def _check(q, k, v, kv_len, dropout_rate):
    """Validate the operands; returns kv_len."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be (B, H, S, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k and v must be (B={b}, H={h}, Sk, d={d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    sk = k.shape[2]
    if min(b, h, sq, sk, d) < 1:
        raise ValueError(f"empty attention operands {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"attention takes float32 or bfloat16 operands of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len must be in [1, {sk}], got {kv_len}")
    keep_threshold(dropout_rate)  # raises outside [0, 1)
    return kv_len


def _scores(q, k, kv_len):
    """fp32 scores times scale, key columns at or past kv_len at
    MASK_VALUE."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_len < k.shape[2]:
        col = torch.arange(k.shape[2], device=s.device)
        s = torch.where(col < kv_len, s, MASK_VALUE)
    return s


def flash_attention_fwd_plain(q, k, v, kv_len: int,
                              dropout_rate: float = 0.0, seed: int = 0,
                              offsets=None):
    """Plain PyTorch version of the kernel, in its arithmetic order: fp32
    scores times scale, key columns at or past `kv_len` set to MASK_VALUE,
    p = exp(s - rowmax) left unnormalised; under dropout p is zeroed where
    dropped and scaled by 1/(1 - rate) where kept; p is rounded to v's
    dtype before the product, the product summed in fp32, then divided by
    l = rowsum(p) taken before dropout. Returns (O (B, H, Sq, d) in q's
    dtype, lse (B, H, 1, Sq) fp32)."""
    s = _scores(q, k, kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p_use = p
    if dropout_rate > 0.0:
        b, h, sq, sk = p.shape
        p_use = apply_mask(p, keep_mask(seed, b, h, sq, sk, dropout_rate,
                                        p.device, offsets=offsets),
                           dropout_rate)
    o = torch.einsum("bhqk,bhkd->bhqd", p_use.to(v.dtype).float(), v.float())
    lse = (m + torch.log(l)).transpose(-1, -2)  # (B, H, 1, Sq)
    return (o / l).to(q.dtype), lse.contiguous()


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention_fwd").arsvt_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _on_card(tensors, what):
    """True for CPU tensors' plain path, False for the card; raises for a
    mix of devices, another device or non-contiguous card tensors."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} runs on cpu or cuda with every operand on "
                         f"one device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} on the card needs contiguous operands")
    return True


def flash_attention_fwd(q, k, v, *, kv_len: int | None = None,
                        dropout_rate: float = 0.0, seed: int = 0,
                        offsets=None):
    """q (B, H, Sq, d), k and v (B, H, Sk, d), float32 or bfloat16, head_dim
    d >= 1 (past 128 the kernels split the output columns, any d runs);
    keys at or past `kv_len` (default Sk) are masked; with
    `dropout_rate` > 0 the probabilities are dropped by the mask of call
    seed `seed`.

    Returns (O (B, H, Sq, d) in q's dtype, lse (B, H, 1, Sq) fp32, taken
    before dropout); `offsets` = (b0, H, h0) place the mask (module
    docstring). On the card the operands must be contiguous; the
    kernel stages rows by 16-byte copies where they are 16-byte aligned and
    element by element elsewhere, so any tensor's own alignment is enough.
    """
    global LAUNCHES, DROPOUT_LAUNCHES
    kv_len = _check(q, k, v, kv_len, dropout_rate)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd builds no graph (the kernel's output has "
            "no grad_fn): call flash_attention or "
            "flash_self_attention_packed, whose backward runs "
            "flash_attention_bwd")
    if not _on_card((q, k, v), "attention"):
        return flash_attention_fwd_plain(q, k, v, kv_len, dropout_rate, seed,
                                         offsets)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, 1, sq), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, sq, sk, kv_len, d,
                 1.0 / math.sqrt(d), *kernel_args(dropout_rate, seed),
                 *mask_offsets(offsets, h), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    DROPOUT_LAUNCHES += dropout_rate > 0.0
    return out, lse


@kernel_op("flash_attention_fwd", "(Tensor q, Tensor k, Tensor v, "
           "int kv_len, float dropout_rate, int seed, int b0, "
           "int mask_heads, int h0) -> (Tensor, Tensor)")
def flash_attention_fwd_op(q, k, v, kv_len, dropout_rate, seed, b0,
                           mask_heads, h0):
    """`flash_attention_fwd` as the custom op ``arsvt::flash_attention_fwd``
    (``ops/library.py``): what the model code calls."""
    return flash_attention_fwd(q, k, v, kv_len=kv_len,
                               dropout_rate=dropout_rate, seed=seed,
                               offsets=(b0, mask_heads, h0))


@flash_attention_fwd_op.register_fake
def _(q, k, v, kv_len, dropout_rate, seed, b0, mask_heads, h0):
    b, h, sq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, 1, sq), dtype=torch.float32))


def flash_attention_bwd_plain(q, k, v, o, do, lse, kv_len: int,
                              dropout_rate: float = 0.0, seed: int = 0,
                              offsets=None):
    """Plain PyTorch version of the backward kernel, at its rounding
    points: p = exp(s - lse) from fp32 scores (keys at or past `kv_len` at
    MASK_VALUE), delta = rowsum(O * dO) and dP = dO v^T in fp32; under
    dropout dP and p_v = p are zeroed where dropped and scaled by 1/(1 -
    rate) where kept (p_v = p without); dS = p (dP - delta); dS is rounded
    to q/k's dtype before dq and dk, p_v to dO's dtype before dv; products
    summed in fp32. Returns (dq, dk, dv) in the operands' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, kv_len) - lse.transpose(-1, -2))
    delta = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    p_v = p
    if dropout_rate > 0.0:
        b, h, sq, sk = p.shape
        keep = keep_mask(seed, b, h, sq, sk, dropout_rate, p.device,
                         offsets=offsets)
        dp = apply_mask(dp, keep, dropout_rate)
        p_v = apply_mask(p, keep, dropout_rate)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p_v.to(do.dtype).float(),
                      do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("flash_attention_bwd").arsvt_flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def flash_attention_bwd(q, k, v, o, do, lse, *, kv_len: int | None = None,
                        dropout_rate: float = 0.0, seed: int = 0,
                        offsets=None):
    """Backward of `flash_attention_fwd`: q, O and dO (B, H, Sq, d), k and
    v (B, H, Sk, d), all of one dtype; lse (B, H, 1, Sq) fp32 from the
    forward; `kv_len`, `dropout_rate`, `seed` and `offsets` as the
    forward's.

    Returns (dq, dk, dv) shaped and typed like q, k and v.
    """
    global LAUNCHES_BWD, DROPOUT_LAUNCHES_BWD
    kv_len = _check(q, k, v, kv_len, dropout_rate)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if lse.shape != (b, h, 1, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be {(b, h, 1, sq)} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not _on_card((q, k, v, o, do, lse), "attention backward"):
        return flash_attention_bwd_plain(q, k, v, o, do, lse, kv_len,
                                         dropout_rate, seed, offsets)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk,
                 kv_len, d, 1.0 / math.sqrt(d),
                 *kernel_args(dropout_rate, seed), *mask_offsets(offsets, h),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    LAUNCHES_BWD += 1
    DROPOUT_LAUNCHES_BWD += dropout_rate > 0.0
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """JAX's `_flash` / `_flash_dropout`: saves (q, k, v, O, lse) and runs
    the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, rate, seed, offsets):
        out, lse = flash_attention_fwd_op(q, k, v, k.shape[2], rate, seed,
                                          *offsets)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.dropout = (rate, seed, offsets)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        rate, seed, offsets = ctx.dropout
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, g.to(out.dtype).contiguous(), lse,
            dropout_rate=rate, seed=seed, offsets=offsets)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, mask=None, dropout_rate: float = 0.0,
                    dropout_rng=None, head_range=None):
    """Attention of q (B, H, Sq, d) over k/v (B, H, Sk, d) -> (B, H, Sq, d),
    as ``flash_attention.py::flash_attention``: through the kernels over
    every key, or through `sdpa_reference` where a `mask` (True = attend)
    is given. `dropout_rng` (a ``core/prng.py::Rng``) with `dropout_rate` >
    0 drops probabilities by the mask of its seed, in-kernel or in the
    reference; `head_range` = (h0, H) places a tensor-parallel rank's
    heads."""
    if mask is not None:
        return sdpa_reference(q, k, v, mask=mask, dropout_rate=dropout_rate,
                              dropout_rng=dropout_rng, head_range=head_range)
    rate, seed, offsets = call_dropout(dropout_rate, dropout_rng, q.shape[1],
                                       head_range)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), rate, seed, offsets)


def _split_contiguous(qkv_flat, num_heads):
    return tuple(t.contiguous() for t in split_heads(qkv_flat, num_heads))


class _FlashPacked(torch.autograd.Function):
    """JAX's `_packed_nodrop` / `_packed_dropout`: saves only (qkv_flat,
    O, lse); the backward re-derives the (B, H, S, d) q, k and v."""

    @staticmethod
    def forward(ctx, qkv_flat, num_heads, rate, seed, offsets):
        q, k, v = _split_contiguous(qkv_flat, num_heads)
        out, lse = flash_attention_fwd_op(q, k, v, k.shape[2], rate, seed,
                                          *offsets)
        ctx.save_for_backward(qkv_flat, out, lse)
        ctx.args = (num_heads, rate, seed, offsets)
        return merge_heads(out)

    @staticmethod
    def backward(ctx, g):
        qkv_flat, out, lse = ctx.saved_tensors
        num_heads, rate, seed, offsets = ctx.args
        b, s, three_d = qkv_flat.shape
        hd = three_d // 3 // num_heads
        q, k, v = _split_contiguous(qkv_flat, num_heads)
        do = g.reshape(b, s, num_heads, hd).permute(0, 2, 1, 3)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, do.to(out.dtype).contiguous(), lse,
            dropout_rate=rate, seed=seed, offsets=offsets)
        dqkv = torch.stack([dq, dk, dv])  # (3, B, H, S, hd)
        dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(b, s, three_d)
        return dqkv.to(qkv_flat.dtype), None, None, None, None


def flash_self_attention_packed(qkv_flat, num_heads: int, *,
                                dropout_rate: float = 0.0, dropout_rng=None,
                                head_range=None):
    """(B, S, 3D) fused-QKV projection output -> (B, S, D) attention out,
    as ``flash_attention.py::flash_self_attention_packed``: the heads are
    split into contiguous (B, H, S, d) tensors for the kernels and merged
    back; the backward re-splits them from the saved qkv_flat;
    `head_range` as `flash_attention`'s."""
    rate, seed, offsets = call_dropout(dropout_rate, dropout_rng, num_heads,
                                       head_range)
    return _FlashPacked.apply(qkv_flat, num_heads, rate, seed, offsets)
