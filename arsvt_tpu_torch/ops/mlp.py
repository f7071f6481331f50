"""tanh-GELU MLP (counterpart of ``arsvt_tpu/ops/mlp.py``).

By default both products stay ``torch.matmul``, as the JAX package leaves
them to XLA, and `gelu_tanh` has the JAX package's compact VJP: it saves
only u and applies the closed-form derivative in fp32. Both directions of
the GELU are kernels of ``csrc/gelu_tanh.cu`` (JAX's is jit code that XLA
fuses; no Pallas kernel stands behind it): `gelu_tanh_fwd` (one launch,
counted in `LAUNCHES`; also the custom op ``arsvt::gelu_tanh_fwd`` of
``ops/library.py`` that the model code reaches) and `gelu_tanh_bwd` (one
launch, `BWD_LAUNCHES`). On a CUDA tensor each launches its kernel or
raises; on a CPU tensor it runs its ``*_plain`` version, the eager chain
the kernel reproduces to the bit (the forward rounds to u's dtype after
every op, as eager PyTorch and JAX's XLA do). fc1's bias add stays an
eager add before it, so the ``mlp_u`` tag and the remat policies see
fc1's product as they did.

The bf16 forward has two routes of the kernel, with the same bits: from
`TABLE_MIN_ELEMENTS` elements up a lookup in a table of the chain at all
65,536 bf16 inputs, held in each SM's shared memory (`TABLE_ROUTE_LAUNCHES`
counts these launches among `LAUNCHES`); below it, and in fp32, the
chain's arithmetic. The table is filled on the card by the kernel's own
arithmetic at the first table-route call on a device (one launch, counted
apart in `TABLE_LAUNCHES`, then one wait for the stream), kept for the
process, and never filled while a CUDA graph is being captured: a capture
before it exists takes the arithmetic route. `gelu_tanh_table_plain` and
`gelu_tanh_gather_plain` are the table and its lookup in plain PyTorch.

With ``ARSVT_ENABLE_FUSED_MLP`` set (``ops/dispatch.py``), `gelu_mlp` runs
fc1 → GELU → fc2 as the fused kernels of ``ops/fused_mlp.py`` instead, in
training and eval, wherever it is called: the ViT blocks and the DETR
head's FFN. The remat policies reach in here: fc1's product carries the
``mlp_u`` tag of ``remat_policy="names"``, and ``remat_tail`` (the
``mlp_tail`` policy) checkpoints GELU → fc2 and keeps the unfused route.
"""

from __future__ import annotations

import ctypes

import torch

from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops.dispatch import use_fused_mlp
from arsvt_tpu_torch.ops.fused_mlp import fused_gelu_mlp
from arsvt_tpu_torch.ops.library import kernel_op
from arsvt_tpu_torch.ops.remat import checkpoint_name, remat_call

_C = 0.7978845608028654  # sqrt(2/pi)
_A = 0.044715
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process: one a forward call (either route), one
# a backward call, one a table filled.
LAUNCHES = 0
TABLE_ROUTE_LAUNCHES = 0
TABLE_LAUNCHES = 0
BWD_LAUNCHES = 0

# The bf16 forward takes the table route from this many elements up:
# below it the arithmetic route is faster, since the table route fills 128
# KB of shared memory on every SM it runs on. On an H100 the table route
# won from (394, 3,072) up and lost at B = 1 serving's (197, 3,072)
# (chip_smoke.py phase 3(c) times both routes by size).
TABLE_MIN_ELEMENTS = 1 << 20
TABLE_SIZE = 1 << 16  # one entry a bf16 bit pattern

_fwd_fn = None
_bwd_fn = None
_table_fn = None
_table_fwd_fn = None
_tables: dict[int, torch.Tensor] = {}  # device index -> the filled table


def gelu_tanh_fwd_plain(u: torch.Tensor) -> torch.Tensor:
    """The eager chain in u's dtype, each op rounded to it."""
    t = torch.tanh(_C * (u + _A * u * u * u))
    return 0.5 * u * (1.0 + t)


def gelu_tanh_bwd_plain(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g times the closed-form derivative at u, in fp32, rounded once to
    u's dtype."""
    uf = u.float()
    t = torch.tanh(_C * (uf + _A * uf * uf * uf))
    d = 0.5 * (1.0 + t) + 0.5 * uf * (1.0 - t * t) * _C * (
        1.0 + 3.0 * _A * uf * uf)
    return (g.float() * d).to(u.dtype)


def gelu_tanh_table_plain(dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """The forward chain at every bf16 input: entry i is
    `gelu_tanh_fwd_plain` of the bf16 whose bits, read as an unsigned
    16-bit integer, are i."""
    if dtype != torch.bfloat16:
        raise TypeError(f"the GELU table is bfloat16's (2^16 inputs), not "
                        f"{dtype}'s")
    bits = torch.arange(TABLE_SIZE, dtype=torch.int32)
    signed = torch.where(bits >= TABLE_SIZE // 2, bits - TABLE_SIZE, bits)
    return gelu_tanh_fwd_plain(signed.to(torch.int16).view(torch.bfloat16))


def gelu_tanh_gather_plain(table: torch.Tensor,
                           u: torch.Tensor) -> torch.Tensor:
    """The table route's lookup: table[bits(u)], u's bf16 bits read as an
    unsigned 16-bit index."""
    index = u.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    return table[index]


def _kernel(name: str, argtypes):
    fn = getattr(build.load("gelu_tanh"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _elementwise(argc: int):
    return [ctypes.c_void_p] * argc + [ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_void_p]


def _cuda_code(tensors, what: str) -> int:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} runs on cpu or cuda with every input on "
                         "one device")
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    return _DTYPE_CODES[dtype]


def _capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _launch(what: str, device, fn, *args) -> None:
    """fn(*args, stream) on `device`'s current stream; raises on an error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _table(u: torch.Tensor) -> torch.Tensor:
    """The filled table of u's device: filled here by its first caller, who
    then waits for the stream, so every later caller on any stream finds it
    written."""
    global TABLE_LAUNCHES, _table_fn
    index = _device_index(u.device)
    table = _tables.get(index)
    if table is None:
        if _capturing():
            raise RuntimeError("the GELU table is not filled during a CUDA "
                               "graph capture")
        if _table_fn is None:
            _table_fn = _kernel("arsvt_gelu_tanh_table",
                                [ctypes.c_void_p, ctypes.c_void_p])
        table = u.new_empty(TABLE_SIZE)
        _launch("gelu_tanh table", u.device, _table_fn, table.data_ptr())
        TABLE_LAUNCHES += 1
        torch.cuda.current_stream(u.device).synchronize()
        _tables[index] = table
    return table


def forward_route(u: torch.Tensor) -> str:
    """The route a CUDA tensor u takes: "table" for bf16 from
    `TABLE_MIN_ELEMENTS` elements up, unless a CUDA graph is being captured
    before the device's table exists; else "arithmetic"."""
    if u.dtype != torch.bfloat16 or u.numel() < TABLE_MIN_ELEMENTS:
        return "arithmetic"
    if _device_index(u.device) not in _tables and _capturing():
        return "arithmetic"
    return "table"


def gelu_tanh_fwd(u: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """gelu(u) in u's dtype (float32 or bfloat16 on the card). `route`
    ("table", bf16 only, or "arithmetic") overrides `forward_route`; both
    give the same bits."""
    global LAUNCHES, TABLE_ROUTE_LAUNCHES, _fwd_fn, _table_fwd_fn
    if u.device.type == "cpu":
        return gelu_tanh_fwd_plain(u)
    code = _cuda_code((u,), "gelu_tanh forward")
    route = forward_route(u) if route is None else route
    if route not in ("table", "arithmetic"):
        raise ValueError(f"gelu_tanh forward routes are 'table' and "
                         f"'arithmetic', got {route!r}")
    if route == "table" and u.dtype != torch.bfloat16:
        raise TypeError(f"the GELU table route takes bfloat16, got {u.dtype}")
    u = u.contiguous()  # a copy where u is a strided view, not a fallback
    h = torch.empty_like(u)
    if u.numel() == 0:
        return h
    if route == "table":
        table = _table(u)
        if _table_fwd_fn is None:
            _table_fwd_fn = _kernel(
                "arsvt_gelu_tanh_fwd_table",
                [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p])
        _launch("gelu_tanh forward", u.device, _table_fwd_fn, h.data_ptr(),
                u.data_ptr(), table.data_ptr(), u.numel())
        TABLE_ROUTE_LAUNCHES += 1
    else:
        if _fwd_fn is None:
            _fwd_fn = _kernel("arsvt_gelu_tanh_fwd", _elementwise(2))
        _launch("gelu_tanh forward", u.device, _fwd_fn, h.data_ptr(),
                u.data_ptr(), u.numel(), code)
    LAUNCHES += 1
    return h


def gelu_tanh_bwd(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * gelu'(u) in u's dtype; g of u's shape and dtype on the card."""
    global BWD_LAUNCHES, _bwd_fn
    if g.shape != u.shape:
        raise ValueError(f"gelu_tanh backward: g {tuple(g.shape)} is not u's "
                         f"shape {tuple(u.shape)}")
    if u.device.type == "cpu" and g.device.type == "cpu":
        return gelu_tanh_bwd_plain(u, g)
    code = _cuda_code((u, g), "gelu_tanh backward")
    if _bwd_fn is None:
        _bwd_fn = _kernel("arsvt_gelu_tanh_bwd", _elementwise(3))
    u, g = u.contiguous(), g.contiguous()
    du = torch.empty_like(u)
    if u.numel() == 0:
        return du
    _launch("gelu_tanh backward", u.device, _bwd_fn, du.data_ptr(),
            u.data_ptr(), g.data_ptr(), u.numel(), code)
    BWD_LAUNCHES += 1
    return du


@kernel_op("gelu_tanh_fwd", "(Tensor u) -> Tensor")
def gelu_tanh_fwd_op(u):
    """`gelu_tanh_fwd` as the custom op ``arsvt::gelu_tanh_fwd``
    (``ops/library.py``): what the model code calls."""
    return gelu_tanh_fwd(u)


@gelu_tanh_fwd_op.register_fake
def _(u):
    return u.new_empty(u.shape)


class _GeluTanh(torch.autograd.Function):
    """Saves only u, as JAX's custom VJP does."""

    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return gelu_tanh_fwd_op(u)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return gelu_tanh_bwd(u, g)


def gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, in u's dtype — not the erf GELU.
    Without a gradient to take it is the custom op alone."""
    if torch.is_grad_enabled() and u.requires_grad:
        return _GeluTanh.apply(u)
    return gelu_tanh_fwd_op(u)


def _tail(u, w2, b2):
    h = gelu_tanh(u)
    with checkpoint_name("mlp_fc2"):
        out = torch.matmul(h, w2.to(u.dtype))
    return out if b2 is None else out + b2.to(u.dtype)


def gelu_mlp(x, w1, b1, w2, b2, *, remat_tail: bool = False) -> torch.Tensor:
    """x: (..., D); w1: (D, M); w2: (M, D). Returns (..., D) in x.dtype.

    Unfused, each product emits x's dtype and its bias is added in that
    dtype; fused, the kernel's fp32 sums and bias adds round once at the
    end (`fused_gelu_mlp`). `remat_tail` checkpoints GELU → fc2 (u is
    saved, gelu(u) replays in the backward) and, as in JAX, wins over
    ``ARSVT_ENABLE_FUSED_MLP``: the fused kernel keeps a residual plan of
    its own. `b2` None leaves fc2 unbiased: a tensor-parallel rank's
    partial sums, biased after their all-reduce.
    """
    if not remat_tail and use_fused_mlp():
        if b2 is None:  # the kernel adds a bias: a zero one adds nothing
            b2 = w2.new_zeros(w2.shape[1])
        return fused_gelu_mlp(x, w1, b1, w2, b2)
    with checkpoint_name("mlp_u"):
        u = torch.matmul(x, w1.to(x.dtype))
    u = u + b1.to(x.dtype)
    if remat_tail:
        return remat_call(_tail, u, w2, b2)
    return _tail(u, w2, b2)
