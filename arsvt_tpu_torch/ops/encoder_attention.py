"""Encoder attention on the packed (B, S, 3D) projection output.

Counterpart of ``arsvt_tpu/ops/pallas/flash_attention.py``'s direct-layout
kernels and of its ``fused_encoder_attention`` custom VJP:

- `encoder_attention_fwd` (``_fwd_direct`` → ``_fwd_kernel_direct``),
  kernel ``csrc/encoder_attention_fwd.cu``;
- `encoder_attention_bwd` (``_bwd_direct`` → ``_bwd_kernel_direct``),
  kernel ``csrc/encoder_attention_bwd.cu``;
- `fused_encoder_attention`, qkv-proj → attention → out-proj as one
  `torch.autograd.Function` whose forward runs the first kernel and whose
  backward runs the second;
- the save-probs variants (``ARSVT_ATTN_SAVE_PROBS``, training only):
  `encoder_attention_fwd_savep` (``_fwd_direct_savep`` →
  ``_fwd_kernel_direct_savep``, kernel ``csrc/encoder_attention_savep_
  fwd.cu``), which also writes the normalised probabilities P in bf16;
  `encoder_attention_bwd_savep` (``_bwd_direct_savep`` →
  ``_bwd_kernel_direct_savep``, kernel ``csrc/encoder_attention_savep_
  bwd.cu``), which reads P back instead of rebuilding it; and
  `fused_encoder_attention_savep`, the Function over the two.

On a CUDA tensor each wrapper launches its hand-written kernel or raises;
on a CPU tensor it runs its ``*_plain`` version, which repeats the
kernel's arithmetic in plain PyTorch. There is no fallback from one to the
other. Layouts are the JAX ones: O, dq, dk and dv as (B, S, D) with head h
in columns h*d .. h*d+d, the log-sum-exp as (B, H, 1, S) fp32, P as
(B, H, S, S) bf16.

Attention dropout (``dropout_rate`` > 0, the TPU kernels' dropout
branches): every kernel and plain version takes ``dropout_rate``, ``seed``
and ``offsets`` = (b0, H, h0) and draws ``ops/dropout.py``'s Philox mask
keyed on (seed, (b0 + b)·H + h0 + h) with counter (query row, key
column), the mask of the head-major kernels; the Functions carry (rate,
seed, offsets) from the forward to the backward, the seed is the ``kp``
site's ``Rng.seed32()``, taken on the host, and the offsets place a
data- or tensor-parallel rank's rows and heads ((0, heads, 0) for one
process). l, lse and P are the values before dropout.
"""

from __future__ import annotations

import ctypes
import math

import torch

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops.attention import merge_heads, split_heads
from arsvt_tpu_torch.ops.library import kernel_op
from arsvt_tpu_torch.ops.dropout import (
    apply_mask,
    call_dropout,
    kernel_args,
    keep_mask,
    keep_threshold,
    mask_offsets,
)

SUPPORTED_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process: each wrapper adds to its own count where
# it launches and nowhere else, so a run can show that its path went
# through the kernels. One backward call launches two kernels (dq, then
# dk/dv) and counts both. The DROPOUT_ counts add, beside those, the
# launches that ran the dropout branch (dropout flag 1).
LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_LAUNCHES_PER_CALL = 2
SAVEP_LAUNCHES = 0
SAVEP_BWD_LAUNCHES = 0
SAVEP_BWD_LAUNCHES_PER_CALL = 2
DROPOUT_LAUNCHES = 0
DROPOUT_BWD_LAUNCHES = 0
DROPOUT_SAVEP_LAUNCHES = 0
DROPOUT_SAVEP_BWD_LAUNCHES = 0

_fn = None
_bwd_fn = None
_savep_fn = None
_savep_bwd_fn = None


def _check(qkv: torch.Tensor, num_heads: int,
           dropout_rate: float = 0.0) -> int:
    """Validate the packed qkv and the rate; returns the head dim."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, S, 3D), got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // 3
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"num_heads={num_heads} does not divide D={d}")
    head_dim = d // num_heads
    if head_dim != SUPPORTED_HEAD_DIM:
        raise ValueError(
            f"encoder attention supports head_dim {SUPPORTED_HEAD_DIM}, "
            f"got {head_dim} (D={d}, H={num_heads})"
        )
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"encoder attention takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.shape[0] < 1 or qkv.shape[1] < 1:
        raise ValueError(f"empty qkv {tuple(qkv.shape)}")
    keep_threshold(dropout_rate)  # raises outside [0, 1)
    return head_dim


def _keep(p: torch.Tensor, dropout_rate: float, seed: int, offsets=None):
    """The call's keep mask for probabilities shaped like p (B, H, S, S)
    at `offsets` = (b0, H, h0), or None at rate 0."""
    if dropout_rate == 0.0:
        return None
    b, h, sq, sk = p.shape
    return keep_mask(seed, b, h, sq, sk, dropout_rate, p.device,
                     offsets=offsets)


def _dropped(x: torch.Tensor, keep, dropout_rate: float) -> torch.Tensor:
    return x if keep is None else apply_mask(x, keep, dropout_rate)


def encoder_attention_fwd_plain(qkv: torch.Tensor, num_heads: int,
                                dropout_rate: float = 0.0, seed: int = 0,
                                offsets=None):
    """Plain PyTorch version of the kernel, in its arithmetic order:
    fp32 scores, p = exp(s - rowmax) left unnormalised; under dropout p is
    zeroed where dropped and scaled by 1/(1 - rate) where kept; p is rounded
    to v's dtype before the product, the product summed in fp32, then
    divided by l = rowsum(p) taken before dropout. Returns (out (B, S, D),
    lse (B, H, 1, S) fp32)."""
    q, k, v = split_heads(qkv, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p_use = _dropped(p, _keep(p, dropout_rate, seed, offsets), dropout_rate)
    o = torch.einsum("bhqk,bhkd->bhqd", p_use.to(v.dtype).float(),
                     v.float())
    out = merge_heads((o / l).to(qkv.dtype))
    lse = (m + torch.log(l)).transpose(-1, -2)  # (B, H, 1, S)
    return out, lse.contiguous()


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("encoder_attention_fwd").arsvt_encoder_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda(tensors, what: str) -> None:
    """Every tensor contiguous, 16-byte aligned and on qkv's CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} runs on cpu or cuda with every input on "
                         "one device")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} needs contiguous, 16-byte aligned "
                             "inputs")


def encoder_attention_fwd(qkv: torch.Tensor, num_heads: int, *,
                          dropout_rate: float = 0.0, seed: int = 0,
        offsets=None):
    """qkv: (B, S, 3D) float32 or bfloat16 with head_dim 64; with
    `dropout_rate` > 0 the probabilities are dropped by the mask of call
    seed `seed`.

    Returns (out (B, S, D) in qkv's dtype, lse (B, H, 1, S) fp32, taken
    before dropout).
    """
    global LAUNCHES, DROPOUT_LAUNCHES
    head_dim = _check(qkv, num_heads, dropout_rate)
    if qkv.device.type == "cpu":
        return encoder_attention_fwd_plain(qkv, num_heads, dropout_rate,
                                           seed, offsets)
    _check_cuda((qkv,), "encoder attention")
    b, s, three_d = qkv.shape
    out = torch.empty((b, s, three_d // 3), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((b, num_heads, 1, s), dtype=torch.float32,
                      device=qkv.device)
    fn = _kernel()
    args = kernel_args(dropout_rate, seed)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s,
                 num_heads, head_dim, *args, *mask_offsets(offsets, num_heads), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"encoder_attention_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    DROPOUT_LAUNCHES += args[3]
    return out, lse


@kernel_op("encoder_attention_fwd", "(Tensor qkv, int num_heads, "
           "float dropout_rate, int seed, int b0, int mask_heads, int h0) "
           "-> (Tensor, Tensor)")
def encoder_attention_fwd_op(qkv, num_heads, dropout_rate, seed, b0,
                             mask_heads, h0):
    """`encoder_attention_fwd` as the custom op ``arsvt::encoder_attention_
    fwd`` (``ops/library.py``): what the model code calls."""
    return encoder_attention_fwd(qkv, num_heads, dropout_rate=dropout_rate,
                                 seed=seed, offsets=(b0, mask_heads, h0))


@encoder_attention_fwd_op.register_fake
def _(qkv, num_heads, dropout_rate, seed, b0, mask_heads, h0):
    b, s, three_d = qkv.shape
    return (qkv.new_empty((b, s, three_d // 3)),
            qkv.new_empty((b, num_heads, 1, s), dtype=torch.float32))


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, D) -> (B, H, S, d)."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).permute(0, 2, 1, 3)


def encoder_attention_bwd_plain(qkv, out, dout, lse, num_heads: int,
                                dropout_rate: float = 0.0, seed: int = 0,
                                offsets=None):
    """Plain PyTorch version of the backward kernel, at its rounding
    points: p = exp(s - lse) from fp32 scores, delta = rowsum(O * dO) and
    dP = dO v^T in fp32; under dropout dP and p_v = p are zeroed where
    dropped and scaled by 1/(1 - rate) where kept (p_v = p without); dS =
    p (dP - delta); dS is rounded to q/k's dtype before dq and dk, p_v to
    dO's dtype before dv; products summed in fp32. Returns (dq, dk, dv),
    each (B, S, D) in qkv's dtype."""
    q, k, v = split_heads(qkv, num_heads)
    o, do = _heads(out, num_heads), _heads(dout, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.transpose(-1, -2))
    delta = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    keep = _keep(p, dropout_rate, seed, offsets)
    dp = _dropped(torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()),
                  keep, dropout_rate)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    p_v = _dropped(p, keep, dropout_rate)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_v.to(dout.dtype).float(),
                      do.float())
    return tuple(merge_heads(t.to(qkv.dtype)) for t in (dq, dk, dv))


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("encoder_attention_bwd").arsvt_encoder_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def encoder_attention_bwd(qkv, out, dout, lse, num_heads: int, *,
                          dropout_rate: float = 0.0, seed: int = 0,
        offsets=None):
    """Backward of `encoder_attention_fwd`: qkv (B, S, 3D); out and dout
    (B, S, D) in qkv's dtype; lse (B, H, 1, S) fp32 from the forward;
    `dropout_rate` and `seed` as the forward's.

    Returns (dq, dk, dv), each (B, S, D) in qkv's dtype.
    """
    global BWD_LAUNCHES, DROPOUT_BWD_LAUNCHES
    head_dim = _check(qkv, num_heads, dropout_rate)
    b, s, three_d = qkv.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (b, s, three_d // 3) or t.dtype != qkv.dtype:
            raise ValueError(
                f"{name} must be {(b, s, three_d // 3)} {qkv.dtype}, got "
                f"{tuple(t.shape)} {t.dtype}")
    if lse.shape != (b, num_heads, 1, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be {(b, num_heads, 1, s)} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    tensors = (qkv, out, dout, lse)
    if all(t.device.type == "cpu" for t in tensors):
        return encoder_attention_bwd_plain(qkv, out, dout, lse, num_heads,
                                           dropout_rate, seed, offsets)
    _check_cuda(tensors, "encoder attention backward")
    dq, dk, dv = (torch.empty_like(out) for _ in range(3))
    delta = torch.empty((b, num_heads, s), dtype=torch.float32,
                        device=qkv.device)
    fn = _bwd_kernel()
    args = kernel_args(dropout_rate, seed)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, s, num_heads, head_dim,
                 *args, *mask_offsets(offsets, num_heads), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"encoder_attention_bwd kernel launch failed: CUDA error {err}")
    BWD_LAUNCHES += BWD_LAUNCHES_PER_CALL
    DROPOUT_BWD_LAUNCHES += BWD_LAUNCHES_PER_CALL * args[3]
    return dq, dk, dv


def encoder_attention_fwd_savep_plain(qkv: torch.Tensor, num_heads: int,
                                      dropout_rate: float = 0.0,
                                      seed: int = 0, offsets=None):
    """Plain PyTorch version of the save-probs forward kernel, at its
    rounding points: fp32 scores, p = exp(s - rowmax), l = rowsum(p), the
    normalised p / l stored as bf16 P; then, under dropout, zeroed where
    dropped and scaled by 1/(1 - rate) where kept; rounded to v's dtype and
    multiplied by v with fp32 sums; no division after the product. Returns
    (out (B, S, D) in qkv's dtype, P (B, H, S, S) bf16, before dropout)."""
    q, k, v = split_heads(qkv, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    p_use = _dropped(p, _keep(p, dropout_rate, seed, offsets), dropout_rate)
    o = torch.einsum("bhqk,bhkd->bhqd", p_use.to(v.dtype).float(),
                     v.float())
    return merge_heads(o.to(qkv.dtype)), p.to(torch.bfloat16)


def _savep_kernel():
    global _savep_fn
    if _savep_fn is None:
        fn = build.load(
            "encoder_attention_savep_fwd").arsvt_encoder_attention_savep_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _savep_fn = fn
    return _savep_fn


def encoder_attention_fwd_savep(qkv: torch.Tensor, num_heads: int, *,
                                dropout_rate: float = 0.0, seed: int = 0,
        offsets=None):
    """qkv: (B, S, 3D) float32 or bfloat16 with head_dim 64; with
    `dropout_rate` > 0 the probabilities that multiply v are dropped by the
    mask of call seed `seed`.

    Returns (out (B, S, D) in qkv's dtype, P (B, H, S, S) bf16: the
    normalised attention probabilities before dropout, for
    `encoder_attention_bwd_savep`).
    """
    global SAVEP_LAUNCHES, DROPOUT_SAVEP_LAUNCHES
    head_dim = _check(qkv, num_heads, dropout_rate)
    if qkv.device.type == "cpu":
        return encoder_attention_fwd_savep_plain(qkv, num_heads,
                                                 dropout_rate, seed, offsets)
    _check_cuda((qkv,), "save-probs attention")
    b, s, three_d = qkv.shape
    out = torch.empty((b, s, three_d // 3), dtype=qkv.dtype,
                      device=qkv.device)
    probs = torch.empty((b, num_heads, s, s), dtype=torch.bfloat16,
                        device=qkv.device)
    fn = _savep_kernel()
    args = kernel_args(dropout_rate, seed)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), probs.data_ptr(), b, s,
                 num_heads, head_dim, *args, *mask_offsets(offsets, num_heads), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"encoder_attention_fwd_savep kernel launch "
                           f"failed: CUDA error {err}")
    SAVEP_LAUNCHES += 1
    DROPOUT_SAVEP_LAUNCHES += args[3]
    return out, probs


def encoder_attention_bwd_savep_plain(qkv, probs, dout, num_heads: int,
                                      dropout_rate: float = 0.0,
                                      seed: int = 0, offsets=None):
    """Plain PyTorch version of the save-probs backward kernel, at its
    rounding points: p = P in fp32, dP = dO v^T in fp32; under dropout dP
    and p_v = p are zeroed where dropped and scaled by 1/(1 - rate) where
    kept (p_v = p without); delta = rowsum(dP * p), dS = p (dP - delta);
    dS is rounded to q/k's dtype before dq and dk, p_v to dO's dtype before
    dv; products summed in fp32. No scores, no lse, no O. Returns (dq, dk,
    dv), each (B, S, D) in qkv's dtype."""
    q, k, v = split_heads(qkv, num_heads)
    do = _heads(dout, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = probs.float()
    keep = _keep(p, dropout_rate, seed, offsets)
    dp = _dropped(torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()),
                  keep, dropout_rate)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    p_v = _dropped(p, keep, dropout_rate)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_v.to(dout.dtype).float(),
                      do.float())
    return tuple(merge_heads(t.to(qkv.dtype)) for t in (dq, dk, dv))


def _savep_bwd_kernel():
    global _savep_bwd_fn
    if _savep_bwd_fn is None:
        fn = build.load(
            "encoder_attention_savep_bwd").arsvt_encoder_attention_savep_bwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _savep_bwd_fn = fn
    return _savep_bwd_fn


def encoder_attention_bwd_savep(qkv, probs, dout, num_heads: int, *,
                                dropout_rate: float = 0.0, seed: int = 0,
        offsets=None):
    """Backward of `encoder_attention_fwd_savep`: qkv (B, S, 3D); P
    (B, H, S, S) bf16 from the forward; dout (B, S, D) in qkv's dtype;
    `dropout_rate` and `seed` as the forward's.

    Returns (dq, dk, dv), each (B, S, D) in qkv's dtype.
    """
    global SAVEP_BWD_LAUNCHES, DROPOUT_SAVEP_BWD_LAUNCHES
    head_dim = _check(qkv, num_heads, dropout_rate)
    b, s, three_d = qkv.shape
    if dout.shape != (b, s, three_d // 3) or dout.dtype != qkv.dtype:
        raise ValueError(f"dout must be {(b, s, three_d // 3)} {qkv.dtype}, "
                         f"got {tuple(dout.shape)} {dout.dtype}")
    if probs.shape != (b, num_heads, s, s) or probs.dtype != torch.bfloat16:
        raise ValueError(f"probs must be {(b, num_heads, s, s)} bfloat16, "
                         f"got {tuple(probs.shape)} {probs.dtype}")
    tensors = (qkv, probs, dout)
    if all(t.device.type == "cpu" for t in tensors):
        return encoder_attention_bwd_savep_plain(qkv, probs, dout, num_heads,
                                                 dropout_rate, seed, offsets)
    _check_cuda(tensors, "save-probs attention backward")
    dq, dk, dv = (torch.empty_like(dout) for _ in range(3))
    delta = torch.empty((b, num_heads, s), dtype=torch.float32,
                        device=qkv.device)
    fn = _savep_bwd_kernel()
    args = kernel_args(dropout_rate, seed)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), probs.data_ptr(), dout.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, s, num_heads, head_dim, *args,
                 *mask_offsets(offsets, num_heads), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"encoder_attention_bwd_savep kernel launch "
                           f"failed: CUDA error {err}")
    SAVEP_BWD_LAUNCHES += SAVEP_BWD_LAUNCHES_PER_CALL
    DROPOUT_SAVEP_BWD_LAUNCHES += SAVEP_BWD_LAUNCHES_PER_CALL * args[3]
    return dq, dk, dv


class _FusedEncoderAttention(torch.autograd.Function):
    """Mirror of ``flash_attention.py::_enc_attn_nodrop`` and
    ``_enc_attn_dropout``'s custom VJPs (``_enc_attn_fwd_impl`` /
    ``_enc_attn_bwd_impl``): (rate, seed) ride from the forward to the
    backward."""

    @staticmethod
    def forward(ctx, y, wqkv, bqkv, wproj, bproj, num_heads, rate, seed,
                offsets):
        qkv = torch.matmul(y, wqkv) + bqkv
        attn, lse = encoder_attention_fwd_op(qkv, num_heads, rate, seed,
                                             *offsets)
        out = _project(attn, wproj, bproj)
        ctx.save_for_backward(y, qkv, attn, lse, wqkv, wproj)
        ctx.args = (num_heads, rate, seed, offsets)
        ctx.bias_dtypes = (bqkv.dtype,
                           None if bproj is None else bproj.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        y, qkv, attn, lse, wqkv, wproj = ctx.saved_tensors
        num_heads, rate, seed, offsets = ctx.args
        return _encoder_attention_grads(
            ctx, g, y, attn, wqkv, wproj,
            lambda dattn: encoder_attention_bwd(qkv, attn, dattn, lse,
                                                num_heads, dropout_rate=rate,
                                                seed=seed, offsets=offsets))


def _project(attn, wproj, bproj):
    """The output projection; a tensor-parallel rank passes no bias
    (bproj None) and adds it once after the all-reduce of its partial
    sums."""
    out = torch.matmul(attn, wproj)
    return out if bproj is None else out + bproj


def _encoder_attention_grads(ctx, g, y, attn, wqkv, wproj, core_bwd):
    """The backward shared by both Functions: the output projection, the
    attention core (`core_bwd`, dattn -> dq, dk, dv), then the qkv
    projection."""
    b, s, d = y.shape
    # a tensor-parallel rank holds a = H_r·64 of the attention's columns
    a = attn.shape[-1]
    g2, a2 = g.reshape(b * s, d), attn.reshape(b * s, a)
    dwproj = a2.T @ g2
    dbproj = g2.sum(dim=0)
    dattn = (g2 @ wproj.T).reshape(b, s, a)
    # the qkv projection per column slice of the packed weight: no
    # (B, S, 3D) cotangent is ever formed
    slices = [t.reshape(b * s, a) for t in core_bwd(
        dattn.to(attn.dtype).contiguous())]
    weights = (wqkv[:, :a], wqkv[:, a:2 * a], wqkv[:, 2 * a:])
    dy = sum(t @ w.T for t, w in zip(slices, weights)).reshape(b, s, d)
    y2 = y.reshape(b * s, d)
    dwqkv = torch.cat([y2.T @ t for t in slices], dim=1)
    dbqkv = torch.cat([t.sum(dim=0) for t in slices])
    dt_bqkv, dt_bproj = ctx.bias_dtypes
    return (dy.to(y.dtype), dwqkv.to(wqkv.dtype), dbqkv.to(dt_bqkv),
            dwproj.to(wproj.dtype),
            None if dt_bproj is None else dbproj.to(dt_bproj), None, None,
            None, None)


class _FusedEncoderAttentionSaveP(torch.autograd.Function):
    """Mirror of ``flash_attention.py::_enc_attn_savep_nodrop`` and
    ``_enc_attn_savep_dropout``'s custom VJPs (``_enc_attn_savep_fwd_impl``
    / ``_enc_attn_savep_bwd_impl``): saves (y, qkv, attn, P) and the
    weights, no lse; (rate, seed) ride from the forward to the backward."""

    @staticmethod
    def forward(ctx, y, wqkv, bqkv, wproj, bproj, num_heads, rate, seed,
                offsets):
        qkv = torch.matmul(y, wqkv) + bqkv
        attn, probs = encoder_attention_fwd_savep(
            qkv, num_heads, dropout_rate=rate, seed=seed, offsets=offsets)
        out = _project(attn, wproj, bproj)
        ctx.save_for_backward(y, qkv, attn, probs, wqkv, wproj)
        ctx.args = (num_heads, rate, seed, offsets)
        ctx.bias_dtypes = (bqkv.dtype,
                           None if bproj is None else bproj.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        y, qkv, attn, probs, wqkv, wproj = ctx.saved_tensors
        num_heads, rate, seed, offsets = ctx.args
        return _encoder_attention_grads(
            ctx, g, y, attn, wqkv, wproj,
            lambda dattn: encoder_attention_bwd_savep(
                qkv, probs, dattn, num_heads, dropout_rate=rate, seed=seed,
                offsets=offsets))


def fused_encoder_attention(y, wqkv, bqkv, wproj, bproj, num_heads: int, *,
                            dropout_rate: float = 0.0, dropout_rng=None,
                            head_range=None):
    """out_proj(attention(qkv_proj(y))): y (B, S, D); wqkv (D, 3D), bqkv
    (3D,), wproj (D, D), bproj (D,) or None (a tensor-parallel rank's
    partial sums, biased after the all-reduce), all in the compute dtype;
    `head_range` = (h0, H) places a rank's heads in the mask. Returns
    (B, S, D). `dropout_rng` (a ``core/prng.py::Rng``) with `dropout_rate`
    > 0 drops attention probabilities in the kernels, from its seed.

    A `torch.autograd.Function` that saves (y, qkv, attn, lse) and the
    weights and runs the backward kernel; under `torch.inference_mode`
    (serving) it builds no graph and runs the forward alone. One attention
    path thus serves and trains.
    """
    rate, seed, offsets = call_dropout(dropout_rate, dropout_rng, num_heads,
                                       head_range)
    return _FusedEncoderAttention.apply(y, wqkv, bqkv, wproj, bproj,
                                        num_heads, rate, seed, offsets)


def fused_encoder_attention_savep(y, wqkv, bqkv, wproj, bproj,
                                  num_heads: int, *,
                                  dropout_rate: float = 0.0,
                                  dropout_rng=None, head_range=None):
    """`fused_encoder_attention` with the save-probs backward: saves P
    (B, H, S, S) bf16 in place of the lse, so the backward kernel skips
    the q k^T recompute, the exp and the O operand. Same arguments and
    result."""
    rate, seed, offsets = call_dropout(dropout_rate, dropout_rng, num_heads,
                                       head_range)
    return _FusedEncoderAttentionSaveP.apply(y, wqkv, bqkv, wproj, bproj,
                                             num_heads, rate, seed, offsets)
