"""The Hopper redesigns of the port's GELU backward and LayerNorm forward
(``csrc/gelu_tanh.cu``, ``csrc/layernorm.cu``), and the fused MLP's launch
set-up kept a device (``csrc/mlp_gemm.cuh``), on the CPU, where no kernel
runs:

- (a) the plain GELU backward, the chain the kernel gives to the bit, at
  all 65,536 bf16 u: against JAX's ``_gelu_bwd`` at
  ``test_gelu_plain_matches_jax``'s limits with ±0, subnormal and seeded
  g, NaN in the same places; with ±Inf and NaN g too, its bf16 result
  the fp32 one rounded once;
- (b) with the launchers replaced by recorders, the GELU backward on
  tensors that report a CUDA device at 3(c)'s shapes, both dtypes: one
  launch counted, the arguments passed as they are, no plain version, and
  no table of the forward's filled;
- (c) the LayerNorm forward's wrapper at every preset width, the element
  route's 770 and the block route's 1,280: one launch counted, the
  arguments passed as they are, no plain version reached;
- (d) no launcher in ``csrc/`` keeps a function-level ``static`` of device
  state (SM counts, function attributes) that is not indexed by device.

The card holds the kernels to these plain versions (``chip_smoke.py``
phase 3(c)).
"""

import contextlib
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.ops.mlp import _gelu_bwd as jax_gelu_bwd
from arsvt_tpu_torch.ops import layernorm as ln_ops
from arsvt_tpu_torch.ops import mlp as mlp_ops

torch.set_num_threads(1)  # tier-1 runs several xdist workers

TABLE = mlp_ops.TABLE_SIZE
CSRC = Path(mlp_ops.__file__).resolve().parent.parent / "csrc"
PLAIN = ((ln_ops, "layer_norm_fwd_plain"), (ln_ops, "layer_norm_bwd_plain"),
         (mlp_ops, "gelu_tanh_fwd_plain"), (mlp_ops, "gelu_tanh_bwd_plain"))
# test_torch_layernorm_gelu.py::test_gelu_plain_matches_jax's bf16 limit
GELU_BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -8)
# the widths the LayerNorm forward is instantiated for (192, 384, 400, 768,
# 1,024), its element route (770) and its block route (1,280)
LN_WIDTHS = (192, 384, 400, 768, 1024, 770, 1280)
# 3(c)'s GELU shapes (rows, MLP width) and a tail past the 16-byte vectors
GELU_SHAPES = ((6304, 3072), (6336, 1600), (9232, 4096), (197, 3072),
               (1, 1001))


def _all_bf16() -> torch.Tensor:
    """The 65,536 bf16 values, entry i the one whose bits read as an
    unsigned 16-bit integer are i."""
    bits = np.arange(TABLE, dtype=np.uint16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _g_special() -> torch.Tensor:
    """±0, the smallest and largest bf16 subnormals of either sign, ±Inf,
    NaN."""
    tiny, top = 2.0 ** -133, 2.0 ** -126 - 2.0 ** -133
    return torch.tensor([0.0, -0.0, tiny, -tiny, top, -top, np.inf, -np.inf,
                         np.nan]).bfloat16()


def _g_seeded() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(21).standard_normal(
        24).astype(np.float32) * 4).bfloat16()


def _crossed(g0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every bf16 u against every value of g0."""
    u0 = _all_bf16()
    return u0.repeat(g0.numel()), g0.repeat_interleave(u0.numel())


def _g_finite_special() -> torch.Tensor:
    """The finite values of `_g_special`: ±0 and subnormals."""
    g = _g_special()
    return g[torch.isfinite(g)]


@pytest.mark.parametrize("make_g", [_g_finite_special, _g_seeded],
                         ids=["zeros_subnormal_g", "seeded_g"])
def test_the_plain_backward_over_every_input_matches_jax(make_g):
    """(a) At all 65,536 bf16 u, each against every finite g: the plain
    backward against JAX's ``_gelu_bwd`` in bf16, within
    ``test_gelu_plain_matches_jax``'s bf16 limit (XLA's tanh and PyTorch's
    differ in the last bits), NaN and ±Inf in the same places. (Against
    ±Inf g such a last bit turns a derivative of 0 into a tiny one near
    saturation, so Inf meets NaN: the card holds the kernel to the plain
    version there, bit for bit.)"""
    u, g = _crossed(make_g())
    got = mlp_ops.gelu_tanh_bwd_plain(u, g).float().numpy()
    (ref,) = jax_gelu_bwd(*(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) for t in (u, g)))
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], **GELU_BF16_TOL)


@pytest.mark.parametrize("make_g", [_g_special, _g_seeded],
                         ids=["special_g", "seeded_g"])
def test_the_plain_backward_rounds_the_fp32_product_once(make_g):
    """(a) What the kernel's bits are held to on the card: in bf16 the
    plain backward is its fp32 result on the same values rounded once to
    bf16 (no bf16 rounding inside the chain), at every bf16 u and g, the
    sign of zero and NaN included."""
    u, g = _crossed(make_g())
    once = mlp_ops.gelu_tanh_bwd_plain(u.float(), g.float()).bfloat16()
    np.testing.assert_array_equal(_bits(mlp_ops.gelu_tanh_bwd_plain(u, g)),
                                  _bits(once))


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers' CUDA
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Card:
    """Recorders in place of the kernels and the stream: each launch is
    appended to `launches` as (entry, args)."""

    def __init__(self, monkeypatch):
        self.launches = []

        def refuse(*a, **kw):
            raise AssertionError("a CUDA tensor reached a plain version")

        for module, name in PLAIN:
            monkeypatch.setattr(module, name, refuse)
        for name in ("LAUNCHES", "TABLE_ROUTE_LAUNCHES", "TABLE_LAUNCHES",
                     "BWD_LAUNCHES"):
            monkeypatch.setattr(mlp_ops, name, 0)
        monkeypatch.setattr(ln_ops, "LAUNCHES", 0)
        monkeypatch.setattr(mlp_ops, "_tables", {})
        for name in ("_fwd_fn", "_table_fn", "_table_fwd_fn", "_bwd_fn"):
            monkeypatch.setattr(mlp_ops, name, self._recorder(name))
        monkeypatch.setattr(ln_ops, "_fwd_fn", self._recorder("ln_fwd"))
        monkeypatch.setattr(torch.cuda, "device",
                            lambda device: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: types.SimpleNamespace(
                                cuda_stream=7, synchronize=lambda: None))

    def _recorder(self, name):
        def launch(*args):
            self.launches.append((name, args))
            return 0
        return launch

    def names(self):
        return [n for n, _ in self.launches]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", GELU_SHAPES, ids=[
    f"{r}x{m}" for r, m in GELU_SHAPES])
def test_the_gelu_backward_launches_once_as_given(monkeypatch, shape,
                                                  dtype):
    """(b) A backward call on tensors that report a CUDA device at 3(c)'s
    shapes (ViT-B's, the detector's, ViT-L's, B = 1's rows x the MLP
    width) and a tail of 1,001: one launch of the backward's kernel,
    counted in BWD_LAUNCHES, with du, u, g, the element count, the dtype
    code and the stream as they are; du in u's dtype and shape; no plain
    version runs, and neither the forward's counters nor its table
    move."""
    card = _Card(monkeypatch)
    u = torch.empty(shape, dtype=dtype).as_subclass(_OnCuda)  # never read
    g = torch.empty(shape, dtype=dtype).as_subclass(_OnCuda)
    du = mlp_ops.gelu_tanh_bwd(u, g)
    assert card.names() == ["_bwd_fn"] and mlp_ops.BWD_LAUNCHES == 1
    assert du.shape == u.shape and du.dtype == dtype
    _, args = card.launches[0]
    assert args == (du.data_ptr(), u.data_ptr(), g.data_ptr(), u.numel(),
                    {torch.float32: 0, torch.bfloat16: 1}[dtype], 7)
    assert (mlp_ops.LAUNCHES, mlp_ops.TABLE_LAUNCHES) == (0, 0)
    assert mlp_ops._tables == {}


@pytest.mark.parametrize("dtypes", ["bfloat16/bfloat16", "float32/float32",
                                    "bfloat16/float32"])
@pytest.mark.parametrize("d", LN_WIDTHS)
def test_the_layernorm_forward_launches_once_as_given(monkeypatch, d,
                                                      dtypes):
    """(c) A forward call on tensors that report a CUDA device, at every
    width the kernel is instantiated for and at the element and block
    routes' widths: one launch counted in LAUNCHES, the pointers of x, the
    parameters and the outputs, the rows, D, the dtype codes, eps and the
    stream passed as they are, outputs in their dtypes and shapes; no plain
    version runs."""
    card = _Card(monkeypatch)
    xt, pt = (getattr(torch, n) for n in dtypes.split("/"))
    codes = {torch.float32: 0, torch.bfloat16: 1}
    x = torch.zeros(3, 7, d, dtype=xt).as_subclass(_OnCuda)
    scale = torch.zeros(d, dtype=pt).as_subclass(_OnCuda)
    bias = torch.zeros(d, dtype=pt).as_subclass(_OnCuda)
    y, mean, rstd = ln_ops.layer_norm_fwd(x, scale, bias, 1e-6)
    assert ln_ops.LAUNCHES == 1 and card.names() == ["ln_fwd"]
    assert y.shape == x.shape and y.dtype == xt
    assert mean.shape == rstd.shape == (3, 7)
    assert mean.dtype == rstd.dtype == torch.float32
    args = card.launches[0][1]
    assert args[:6] == (y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                        x.data_ptr(), scale.data_ptr(), bias.data_ptr())
    assert args[6:11] == (21, d, codes[xt], codes[pt], codes[pt])
    assert args[11] == pytest.approx(1e-6) and args[12] == 7


# A function-level static that holds no device state: the entry point of
# cuTensorMapEncodeTiled (`hopper.cuh::encode_tiled`), one a process.
PROCESS_WIDE = {("hopper.cuh", "fn")}
_STATIC = re.compile(r"^\s+static\s+(?:const\s+)?(?!_)[\w:<>]+\s+(\w+)\s*"
                     r"((?:\[[^\]]+\])*)")


def _function_statics() -> list[tuple[str, str, str, str]]:
    """(file, name, array dimensions, the enclosing function's body) of
    every static declared inside a function in csrc/."""
    found = []
    for path in sorted(CSRC.glob("*.cu*")):
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            m = _STATIC.match(line)
            if not m or "constexpr" in line:  # compile-time, no state
                continue
            start = max(j for j in range(i) if lines[j] and
                        not lines[j][0].isspace() and "(" in lines[j])
            end = next(j for j in range(i, len(lines))
                       if lines[j].startswith("}"))
            found.append((path.name, m.group(1), m.group(2),
                          "\n".join(lines[start:end + 1])))
    return found


def test_no_launcher_keeps_device_state_once_a_process():
    """(d) Every static inside a function of csrc/ is an array indexed by
    the device that cudaGetDevice returned in that function (the fused
    MLP's SM count and shared-memory attribute, the GELU table's
    attribute, the LayerNorm forward's grid), or holds no device state
    (`PROCESS_WIDE`). A per-process static set at the first call would
    leave every other card without its attribute."""
    statics = _function_statics()
    names = {(f, n) for f, n, _, _ in statics}
    assert {("mlp_gemm.cuh", "setup"), ("gelu_tanh.cu", "allowed"),
            ("layernorm.cu", "held")} <= names
    for file, name, dims, body in statics:
        if (file, name) in PROCESS_WIDE:
            continue
        dev = re.search(r"cudaGetDevice\(&(\w+)\)", body)
        assert dims and dev, (
            f"{file}: `static {name}` is kept once a process, not a device")
        assert re.search(rf"\b{name}\[{dev.group(1)}\]", body), (
            f"{file}: `static {name}{dims}` is not indexed by the device")
