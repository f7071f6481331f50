"""LayerNorm with fp32 statistics and a lean backward (counterpart of
``arsvt_tpu/ops/layernorm.py`` and its custom VJP).

The backward saves x in its own dtype plus fp32 (mean, rstd) and uses the
closed form dx = rstd * (g*γ - mean(g*γ) - x̂ * mean(g*γ*x̂)).

Both directions are kernels of ``csrc/layernorm.cu`` (JAX's LayerNorm is
jit code that XLA fuses; no Pallas kernel stands behind them):

- `layer_norm_fwd`: y, mean, rstd in one launch (counted in `LAUNCHES`),
  also the custom op ``arsvt::layer_norm_fwd`` (``ops/library.py``) that
  the model code reaches;
- `layer_norm_bwd`: dx and the column partials of dscale and dbias in one
  launch, their sum over blocks in a second that launches while the first
  runs and waits for it on the card (two counted in `BWD_LAUNCHES` a
  call), deterministic.

On a CUDA tensor each wrapper launches its kernel or raises, for a failed
build, a failed launch and a dtype the kernel does not take alike; on a
CPU tensor it runs its ``*_plain`` version, the eager math the port ran
before. ``ARSVT_DISABLE_LN_VJP`` (``ops/dispatch.py``) runs plain autograd
over the forward's plain version instead, on any device, as JAX's switch
runs XLA's autodiff: no kernel then.
"""

from __future__ import annotations

import ctypes

import torch

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops.dispatch import use_ln_vjp
from arsvt_tpu_torch.ops.library import kernel_op

# Kernel launches in this process: one a forward call, two a backward call.
LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_LAUNCHES_PER_CALL = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fwd_fn = None
_bwd_fn = None
_blocks_fn = None
_grids: dict[tuple, int] = {}  # (device, rows, D, dtype code) -> blocks


def layer_norm_fwd_plain(x, scale, bias, eps: float):
    """``_ln_fwd_math``: x (..., D) -> (y in x's dtype, mean, rstd fp32 of
    shape x.shape[:-1]); the biased variance about the mean, in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * scale.float() + bias.float()
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def layer_norm_bwd_plain(x, g, scale, mean, rstd):
    """``_ln_vjp_bwd`` over x and g (rows, D): (dx in x's dtype, dscale and
    dbias in scale's dtype)."""
    gf = g.float()
    mean, rstd = mean[..., None], rstd[..., None]
    xhat = (x.float() - mean) * rstd
    gs = gf * scale.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gs - m1 - xhat * m2)).to(x.dtype)
    dscale = (gf * xhat).sum(dim=0).to(scale.dtype)
    dbias = gf.sum(dim=0).to(scale.dtype)
    return dx, dscale, dbias


def _code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"the LayerNorm kernels take {what} in float32 or "
                        f"bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def _on_one_card(tensors, what: str) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} runs on cpu or cuda with every input on "
                         "one device")


def _check_params(x, scale, bias) -> int:
    d = x.shape[-1] if x.dim() else 0
    if d < 1 or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"LayerNorm takes x (..., D) and scale, bias (D,), "
                         f"got {tuple(x.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    return d


def _fwd_kernel():
    global _fwd_fn
    if _fwd_fn is None:
        fn = build.load("layernorm").arsvt_layer_norm_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fwd_fn = fn
    return _fwd_fn


def _bwd_kernels():
    global _bwd_fn, _blocks_fn
    if _bwd_fn is None:
        lib = build.load("layernorm")
        blocks = lib.arsvt_layer_norm_bwd_blocks
        blocks.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        blocks.restype = ctypes.c_int
        fn = lib.arsvt_layer_norm_bwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [
            ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _blocks_fn, _bwd_fn = blocks, fn
    return _blocks_fn, _bwd_fn


def _bwd_blocks(device, rows: int, d: int, code: int) -> int:
    """The backward's grid on `device` (the rows of its scratch), asked of
    the kernel library once a shape."""
    key = (device.index if device.index is not None else
           torch.cuda.current_device(), rows, d, code)
    blocks = _grids.get(key)
    if blocks is None:
        with torch.cuda.device(device):
            blocks = _blocks_fn(rows, d, code)
        if blocks < 1:
            raise ValueError(f"the LayerNorm backward kernel takes D up to "
                             f"16,384 on this card, got D={d}")
        _grids[key] = blocks
    return blocks


def layer_norm_fwd(x, scale, bias, eps: float):
    """x (..., D) in float32 or bfloat16, scale and bias (D,) each in either
    -> (y like x, mean and rstd fp32 of shape x.shape[:-1])."""
    global LAUNCHES
    d = _check_params(x, scale, bias)
    x = x.contiguous()  # a copy where x is a strided view, not a fallback
    if all(t.device.type == "cpu" for t in (x, scale, bias)):
        return layer_norm_fwd_plain(x, scale, bias, eps)
    _on_one_card((x, scale, bias), "LayerNorm forward")
    codes = (_code(x, "x"), _code(scale, "scale"), _code(bias, "bias"))
    fn = _fwd_kernel()
    scale, bias = scale.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    mean = x.new_empty(x.shape[:-1], dtype=torch.float32)
    rstd = torch.empty_like(mean)
    rows = mean.numel()
    if rows == 0:
        return y, mean, rstd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), x.data_ptr(),
                 scale.data_ptr(), bias.data_ptr(), rows, d, *codes,
                 float(eps), stream)
    if err != 0:
        raise RuntimeError(f"LayerNorm forward kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return y, mean, rstd


def layer_norm_bwd(x, g, scale, mean, rstd):
    """Backward of `layer_norm_fwd` from its residuals: x and g (..., D) in
    one dtype, scale (D,), mean and rstd fp32 of shape x.shape[:-1] ->
    (dx like x, dscale and dbias (D,) in scale's dtype)."""
    global BWD_LAUNCHES
    d = x.shape[-1]
    if g.shape != x.shape or scale.shape != (d,) or \
            mean.shape != x.shape[:-1] or rstd.shape != mean.shape:
        raise ValueError(f"LayerNorm backward shapes x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, scale {tuple(scale.shape)}, "
                         f"mean {tuple(mean.shape)} disagree")
    x2, g2 = x.reshape(-1, d), g.reshape(-1, d)
    tensors = (x2, g2, scale, mean, rstd)
    if all(t.device.type == "cpu" for t in tensors):
        dx, dscale, dbias = layer_norm_bwd_plain(x2, g2, scale,
                                                 mean.reshape(-1),
                                                 rstd.reshape(-1))
        return dx.reshape(x.shape), dscale, dbias
    _on_one_card(tensors, "LayerNorm backward")
    codes = (_code(x, "x"), _code(scale, "scale"))
    if g.dtype != x.dtype or mean.dtype != torch.float32 or \
            rstd.dtype != torch.float32:
        raise TypeError(f"LayerNorm backward takes g in x's dtype and fp32 "
                        f"statistics, got x {x.dtype}, g {g.dtype}, mean "
                        f"{mean.dtype}, rstd {rstd.dtype}")
    _bwd_kernels()
    x2, g2, scale = x2.contiguous(), g2.contiguous(), scale.contiguous()
    mean, rstd = mean.contiguous(), rstd.contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    dscale = x2.new_empty((d,), dtype=scale.dtype)
    dbias = torch.empty_like(dscale)
    if rows == 0:
        return dx.reshape(x.shape), dscale.zero_(), dbias.zero_()
    blocks = _bwd_blocks(x.device, rows, d, codes[0])
    scratch = x2.new_empty((2, blocks, d), dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _bwd_fn(dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                      scratch.data_ptr(), blocks, x2.data_ptr(),
                      g2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                      scale.data_ptr(), rows, d, *codes, stream)
    if err != 0:
        raise RuntimeError(f"LayerNorm backward kernel launch failed: CUDA "
                           f"error {err}")
    BWD_LAUNCHES += BWD_LAUNCHES_PER_CALL
    return dx.reshape(x.shape), dscale, dbias


@kernel_op("layer_norm_fwd", "(Tensor x, Tensor scale, Tensor bias, "
           "float eps) -> (Tensor, Tensor, Tensor)")
def layer_norm_fwd_op(x, scale, bias, eps):
    """`layer_norm_fwd` as the custom op ``arsvt::layer_norm_fwd``
    (``ops/library.py``): what the model code calls."""
    return layer_norm_fwd(x, scale, bias, eps)


@layer_norm_fwd_op.register_fake
def _(x, scale, bias, eps):
    stats = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return x.new_empty(x.shape), stats, torch.empty_like(stats)


class _LayerNorm(torch.autograd.Function):
    """Saves (x, scale, mean, rstd), JAX's residuals; dscale and dbias come
    back in scale's dtype, as JAX casts them."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd_op(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, g, scale, mean, rstd)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """Biased variance and ``rsqrt(var + eps)`` in fp32, output cast back
    to x's dtype. Callers pass the config's ``ln_eps``. Without a gradient
    to take (serving, eval, an export trace) it is the custom op alone."""
    if not use_ln_vjp():
        return layer_norm_fwd_plain(x, scale, bias, eps)[0]
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return layer_norm_fwd_op(x, scale, bias, eps)[0]
