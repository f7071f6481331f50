"""Fused tanh-GELU MLP (counterpart of ``arsvt_tpu/ops/pallas/fused_mlp.py``,
taken when ``ARSVT_ENABLE_FUSED_MLP`` is set, see ``ops/dispatch.py``).

- `fused_mlp_fwd` (``_fwd`` → ``_fwd_kernel``), kernel
  ``csrc/fused_mlp_fwd.cu``: out = gelu(x w1 + b1) w2 + b2 with the hidden
  kept on chip, and the pre-activation u emitted in bf16;
- `fused_mlp_bwd` (``_bwd`` → ``_bwd_dx_kernel`` and ``_bwd_dw_kernel``),
  kernel ``csrc/fused_mlp_bwd.cu``, two launches: dx (and du in bf16), then
  dw1, db1, dw2 in fp32, from the saved u with no product recomputed;
- `fused_gelu_mlp`, a `torch.autograd.Function` over the two that saves
  (x, u, w1, w2).

On a CUDA tensor each wrapper launches its hand-written kernels or raises;
on a CPU tensor it runs its ``*_plain`` version, which repeats the
kernels' arithmetic in plain PyTorch. There is no fallback from one to the
other. bf16 runs on Hopper's wgmma fed by TMA (``csrc/mlp_gemm.cuh``), two
launches a call in each direction; the forward's hidden h makes one round
trip through a scratch the wrapper allocates. fp32, the parity path, runs
on the row-tile kernel (``csrc/mlp_tile.cuh``). The kernels take any D and
M >= 1, as JAX's kernels do: where both are multiples of 8 and every
pointer is 16-byte aligned they copy rows by TMA (bf16) or 16-byte
cp.async (fp32); elsewhere they take their ragged route, which loads and
stores the edges of rows element by element, with the same arithmetic.
fp32 takes D up to what the row-tile kernel's staged rows leave of a
block's shared memory (``mlp_tile.cuh::max_d``, 1,728), and a launch past
it raises a ValueError that names the bound; bf16 has no such bound.
"""

from __future__ import annotations

import ctypes

import torch

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops.library import kernel_op

_C = 0.7978845608028654  # sqrt(2/pi)
_A = 0.044715
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_ERROR_INVALID_VALUE = 1

# Kernel launches in this process, counted where each wrapper launches. A
# forward call launches two kernels in bf16 (u and h, then out) and one in
# fp32 (the row-tile kernel); a backward call two in either (dx/du, then
# the weight gradients). Each counts all of its launches.
LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_LAUNCHES_PER_CALL = {torch.bfloat16: 2, torch.float32: 1}
BWD_LAUNCHES_PER_CALL = 2

_fwd_fn = None
_bwd_fn = None


def _gelu(u: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_C * (u + _A * u * u * u))
    return 0.5 * u * (1.0 + t)


def _gelu_grad(u: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_C * (u + _A * u * u * u))
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _C * (
        1.0 + 3.0 * _A * u * u)


def _check(x2d, w1, w2) -> tuple[int, int, int]:
    """Validate shapes and types; returns (n, D, M)."""
    if x2d.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("fused MLP takes x (n, D), w1 (D, M), w2 (M, D)")
    n, d = x2d.shape
    m = w1.shape[1]
    if w1.shape != (d, m) or w2.shape != (m, d):
        raise ValueError(f"fused MLP shapes x {tuple(x2d.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} disagree")
    if x2d.dtype not in _DTYPE_CODES or w1.dtype != x2d.dtype or \
            w2.dtype != x2d.dtype:
        raise TypeError(f"fused MLP takes x, w1 and w2 all float32 or all "
                        f"bfloat16, got {x2d.dtype}, {w1.dtype}, {w2.dtype}")
    if min(n, d, m) < 1:
        raise ValueError(f"fused MLP needs n, D and M >= 1, got n={n} D={d} "
                         f"M={m}")
    return n, d, m


def max_d(dtype: torch.dtype) -> int | None:
    """The largest D the kernels take in `dtype` (the C entry's
    ``arsvt_fused_mlp_max_d``), or None where D has no such bound (bf16):
    the fp32 row-tile kernel keeps each block's rows of x (or dO) over the
    full D in shared memory, as the TPU kernel keeps them in VMEM."""
    fn = build.load("fused_mlp_fwd").arsvt_fused_mlp_max_d
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    bound = fn(_DTYPE_CODES[dtype])
    return bound if bound > 0 else None


def _launch_error(err: int, what: str, d: int, dtype: torch.dtype):
    """The error for a launch that returned CUDA error `err`; a D past the
    fp32 kernels' shared-memory bound reads as such."""
    bound = max_d(dtype) if err == _CUDA_ERROR_INVALID_VALUE else None
    if bound is not None and d > bound:
        return ValueError(
            f"the {what} kernel stages its rows of the input over the full "
            f"D in shared memory: it takes D <= {bound} in {dtype}, got "
            f"D={d}")
    return RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _cuda_args(tensors, what: str) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} runs on cpu or cuda with every input on "
                         "one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous inputs")


def fused_mlp_fwd_plain(x2d, w1, b1, w2, b2):
    """Plain PyTorch version of the forward kernel, at its rounding points:
    u = x w1 + b1 in fp32, h = gelu(u) rounded to x's dtype, out = h w2 +
    b2 in fp32 cast to x's dtype. Returns (out (n, D), u (n, M) bf16)."""
    u = x2d.float() @ w1.float() + b1.float()
    h = _gelu(u).to(x2d.dtype)
    out = h.float() @ w2.float() + b2.float()
    return out.to(x2d.dtype), u.to(torch.bfloat16)


def _fwd_kernel():
    global _fwd_fn
    if _fwd_fn is None:
        fn = build.load("fused_mlp_fwd").arsvt_fused_mlp_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fwd_fn = fn
    return _fwd_fn


def fused_mlp_fwd(x2d, w1, b1, w2, b2):
    """x2d (n, D), w1 (D, M), w2 (M, D) in one of float32 and bfloat16;
    b1 (M,) and b2 (D,) in any float dtype, added in fp32.

    Returns (out (n, D) in x's dtype, u (n, M) bf16).
    """
    global LAUNCHES
    n, d, m = _check(x2d, w1, w2)
    if b1.shape != (m,) or b2.shape != (d,):
        raise ValueError(f"biases must be ({m},) and ({d},), got "
                         f"{tuple(b1.shape)} and {tuple(b2.shape)}")
    if all(t.device.type == "cpu" for t in (x2d, w1, b1, w2, b2)):
        return fused_mlp_fwd_plain(x2d, w1, b1, w2, b2)
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    _cuda_args((x2d, w1, b1, w2, b2), "fused MLP forward")
    out = torch.empty_like(x2d)
    u = torch.empty((n, m), dtype=torch.bfloat16, device=x2d.device)
    # bf16: the hidden h (n, M) between the two launches, for this call only
    h = torch.empty_like(u) if x2d.dtype == torch.bfloat16 else None
    fn = _fwd_kernel()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(x2d.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), out.data_ptr(), u.data_ptr(),
                 None if h is None else h.data_ptr(), n, d, m,
                 _DTYPE_CODES[x2d.dtype], stream)
    if err != 0:
        raise _launch_error(err, "fused MLP forward", d, x2d.dtype)
    LAUNCHES += FWD_LAUNCHES_PER_CALL[x2d.dtype]
    return out, u


@kernel_op("fused_mlp_fwd", "(Tensor x2d, Tensor w1, Tensor b1, Tensor w2, "
           "Tensor b2) -> (Tensor, Tensor)")
def fused_mlp_fwd_op(x2d, w1, b1, w2, b2):
    """`fused_mlp_fwd` as the custom op ``arsvt::fused_mlp_fwd``
    (``ops/library.py``): what the model code calls."""
    return fused_mlp_fwd(x2d, w1, b1, w2, b2)


@fused_mlp_fwd_op.register_fake
def _(x2d, w1, b1, w2, b2):
    return (torch.empty_like(x2d),
            x2d.new_empty((x2d.shape[0], w1.shape[1]), dtype=torch.bfloat16))


def fused_mlp_bwd_plain(x2d, u, w1, w2, dout):
    """Plain PyTorch version of the backward kernels, at their rounding
    points: dh = dO w2^T in fp32, du = dh gelu'(u) from the bf16 u, rounded
    to bf16; dx = du w1^T in fp32 cast to x's dtype; h = gelu(u) rounded to
    dO's dtype; dw1 = x^T du, db1 = sum(du), dw2 = h^T dO in fp32.
    Returns (dx (n, D), dw1 (D, M), db1 (M,), dw2 (M, D))."""
    uf = u.float()
    du = ((dout.float() @ w2.float().T) * _gelu_grad(uf)).to(torch.bfloat16)
    dx = (du.float() @ w1.float().T).to(x2d.dtype)
    h = _gelu(uf).to(dout.dtype)
    dw1 = x2d.float().T @ du.float()
    db1 = du.float().sum(dim=0)
    dw2 = h.float().T @ dout.float()
    return dx, dw1, db1, dw2


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("fused_mlp_bwd").arsvt_fused_mlp_bwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def fused_mlp_bwd(x2d, u, w1, w2, dout):
    """Backward of `fused_mlp_fwd`: x2d (n, D), u (n, M) bf16 from the
    forward, w1 (D, M), w2 (M, D), dout (n, D) in x's dtype.

    Returns (dx (n, D) in x's dtype, dw1 (D, M), db1 (M,), dw2 (M, D) in
    fp32).
    """
    global BWD_LAUNCHES
    n, d, m = _check(x2d, w1, w2)
    if u.shape != (n, m) or u.dtype != torch.bfloat16:
        raise ValueError(f"u must be {(n, m)} bfloat16, got "
                         f"{tuple(u.shape)} {u.dtype}")
    if dout.shape != (n, d) or dout.dtype != x2d.dtype:
        raise ValueError(f"dout must be {(n, d)} {x2d.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    tensors = (x2d, u, w1, w2, dout)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_mlp_bwd_plain(x2d, u, w1, w2, dout)
    _cuda_args(tensors, "fused MLP backward")
    dev = x2d.device
    dx = torch.empty_like(x2d)
    du = torch.empty_like(u)
    h = torch.empty((n, m), dtype=x2d.dtype, device=dev)
    dw1 = torch.empty((d, m), dtype=torch.float32, device=dev)
    db1 = torch.empty((m,), dtype=torch.float32, device=dev)
    dw2 = torch.empty((m, d), dtype=torch.float32, device=dev)
    fn = _bwd_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x2d.data_ptr(), u.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 dout.data_ptr(), dx.data_ptr(), du.data_ptr(), h.data_ptr(),
                 dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), n, d, m,
                 _DTYPE_CODES[x2d.dtype], stream)
    if err != 0:
        raise _launch_error(err, "fused MLP backward", d, x2d.dtype)
    BWD_LAUNCHES += BWD_LAUNCHES_PER_CALL
    return dx, dw1, db1, dw2


class _FusedGeluMlp(torch.autograd.Function):
    """Mirror of ``fused_mlp.py::_fused_mlp``'s custom VJP (``_vjp_fwd`` /
    ``_vjp_bwd``): saves (x, u, w1, w2); db2 = sum(g) in fp32 outside the
    kernel; every weight gradient is cast to its parameter's dtype."""

    @staticmethod
    def forward(ctx, x2d, w1, b1, w2, b2):
        out, u = fused_mlp_fwd_op(x2d, w1, b1, w2, b2)
        ctx.save_for_backward(x2d, u, w1, w2)
        ctx.bias_dtypes = (b1.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, u, w1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2 = fused_mlp_bwd(x2d, u, w1, w2, g.contiguous())
        db2 = g.float().sum(dim=0)
        dt_b1, dt_b2 = ctx.bias_dtypes
        return (dx, dw1.to(w1.dtype), db1.to(dt_b1), dw2.to(w2.dtype),
                db2.to(dt_b2))


def fused_gelu_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """x: (..., D); w1: (D, M); w2: (M, D) -> (..., D) in x's dtype. The
    weights are cast to x's dtype (as the JAX callers do); the biases are
    added in fp32 from their own dtype."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).contiguous()
    out = _FusedGeluMlp.apply(x2d, w1.to(x.dtype).contiguous(), b1,
                              w2.to(x.dtype).contiguous(), b2)
    return out.reshape(shape)
