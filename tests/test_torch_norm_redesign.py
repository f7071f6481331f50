"""The Hopper redesigns of the port's GELU forward and LayerNorm backward
(``csrc/gelu_tanh.cu``, ``csrc/layernorm.cu``) on the CPU, where no
kernel runs:

- (a) every one of the 65,536 bf16 inputs through the plain GELU chain
  against JAX's ``gelu_tanh`` in bf16, at ``test_gelu_plain_matches_jax``'s
  limits, NaN and ±Inf in the same places;
- (b) the table route's mechanism in plain PyTorch: `gelu_tanh_table_plain`
  gathered by unsigned bit pattern equals the chain to the bit, on every
  input, random tensors, -0.0 and subnormals;
- (c) with the launchers replaced by recorders, a tensor that reports a
  CUDA device reaches the table route or the arithmetic route by
  `TABLE_MIN_ELEMENTS` (fp32 always the arithmetic one), never a plain
  version; the table is filled once a device, counted apart, and never
  while a CUDA graph is being captured;
- (d) the LayerNorm backward's launches a call and the scratch the
  wrapper passes follow the kernel library's plan.

The card holds the kernels to these plain versions (``chip_smoke.py``
phase 3(c)).
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.ops.mlp import gelu_tanh as jax_gelu_tanh
from arsvt_tpu_torch.ops import layernorm as ln_ops
from arsvt_tpu_torch.ops import mlp as mlp_ops

torch.set_num_threads(1)  # tier-1 runs several xdist workers

TABLE = mlp_ops.TABLE_SIZE
PLAIN = ((ln_ops, "layer_norm_fwd_plain"), (ln_ops, "layer_norm_bwd_plain"),
         (mlp_ops, "gelu_tanh_fwd_plain"), (mlp_ops, "gelu_tanh_bwd_plain"))


def _all_bf16() -> torch.Tensor:
    """The 65,536 bf16 values, entry i the one whose bits read as an
    unsigned 16-bit integer are i."""
    bits = np.arange(TABLE, dtype=np.uint16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def test_every_bf16_input_of_the_plain_chain_matches_jax():
    """(a) The plain chain at all 65,536 bf16 inputs against JAX's
    gelu_tanh in bf16, within 2^-7 absolute and relative (XLA's tanh and
    PyTorch's differ in the last bits, and each op of the chain rounds to
    bf16 in both); NaN and ±Inf in the same places."""
    u = _all_bf16()
    got = mlp_ops.gelu_tanh_fwd_plain(u).float().numpy()
    ref = np.asarray(jax_gelu_tanh(jnp.asarray(u.float().numpy()).astype(
        jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() == 65280  # 2 x 127 NaN payloads, ±Inf and their NaN
    np.testing.assert_allclose(got[fin], ref[fin], atol=2.0 ** -7,
                               rtol=2.0 ** -7)


def _random_bf16():
    return torch.from_numpy(np.random.default_rng(20).standard_normal(
        (37, 301)).astype(np.float32) * 4).bfloat16()


def _subnormals():
    # bf16 subnormals: exponent field 0, mantissa 1 ... 127, either sign
    bits = np.concatenate([np.arange(1, 128), np.arange(1, 128) | 0x8000])
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16).copy()
                            ).view(torch.bfloat16)


@pytest.mark.parametrize("make", [
    _all_bf16, _random_bf16, lambda: torch.tensor([-0.0, 0.0, -0.0]).bfloat16(),
    _subnormals], ids=["every_input", "random", "signed_zeros", "subnormals"])
def test_the_table_gathered_by_bits_is_the_chain(make):
    """(b) `gelu_tanh_table_plain` gathered by u's bits read unsigned
    equals the chain on u to the bit (NaN payloads and the sign of zero
    included)."""
    u = make()
    table = mlp_ops.gelu_tanh_table_plain(torch.bfloat16)
    assert table.shape == (TABLE,) and table.dtype == torch.bfloat16
    got = mlp_ops.gelu_tanh_gather_plain(table, u)
    assert got.shape == u.shape and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got),
                                  _bits(mlp_ops.gelu_tanh_fwd_plain(u)))


def test_the_table_is_bf16s_alone():
    with pytest.raises(TypeError, match="bfloat16"):
        mlp_ops.gelu_tanh_table_plain(torch.float32)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers' CUDA
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Card:
    """Recorders in place of the kernels, the stream and the capture
    state: each launch is appended to `launches` as (entry, args)."""

    def __init__(self, monkeypatch, capturing=False):
        self.launches = []
        self.capturing = capturing
        self.streams = 7

        def refuse(*a, **kw):
            raise AssertionError("a CUDA tensor reached a plain version")

        for module, name in PLAIN:
            monkeypatch.setattr(module, name, refuse)
        for name in ("LAUNCHES", "TABLE_ROUTE_LAUNCHES", "TABLE_LAUNCHES",
                     "BWD_LAUNCHES"):
            monkeypatch.setattr(mlp_ops, name, 0)
        monkeypatch.setattr(ln_ops, "BWD_LAUNCHES", 0)
        monkeypatch.setattr(mlp_ops, "_tables", {})
        for name in ("_fwd_fn", "_table_fn", "_table_fwd_fn", "_bwd_fn"):
            monkeypatch.setattr(mlp_ops, name, self._recorder(name))
        monkeypatch.setattr(mlp_ops, "_capturing", lambda: self.capturing)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda device: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: types.SimpleNamespace(
                                cuda_stream=self.streams,
                                synchronize=lambda: None))

    def _recorder(self, name):
        def launch(*args):
            self.launches.append((name, args))
            return 0
        return launch

    def names(self):
        return [n for n, _ in self.launches]


def _u(n, dtype=torch.bfloat16):
    return torch.zeros(n, dtype=dtype).as_subclass(_OnCuda)


@pytest.mark.parametrize("dtype,offset,route", [
    (torch.bfloat16, 0, "table"), (torch.bfloat16, 1, "table"),
    (torch.bfloat16, -1, "arithmetic"), (torch.float32, 0, "arithmetic"),
    (torch.float32, 1, "arithmetic")],
    ids=["bf16_at_threshold", "bf16_above", "bf16_below", "fp32_at",
         "fp32_above"])
def test_a_cuda_tensor_takes_its_route_by_the_threshold(monkeypatch, dtype,
                                                       offset, route):
    """(c) bf16 from `TABLE_MIN_ELEMENTS` elements up takes the table route
    (the table filled first), below it and in fp32 the arithmetic one:
    one forward launch either way, counted in LAUNCHES, the table route's
    also in TABLE_ROUTE_LAUNCHES; no plain version runs."""
    card = _Card(monkeypatch)
    u = _u(mlp_ops.TABLE_MIN_ELEMENTS + offset, dtype)
    assert mlp_ops.forward_route(u) == route
    h = mlp_ops.gelu_tanh_fwd(u)
    assert h.shape == u.shape and h.dtype == dtype
    if route == "table":
        assert card.names() == ["_table_fn", "_table_fwd_fn"]
        table = mlp_ops._tables[0]
        _, (h_ptr, u_ptr, t_ptr, n, stream) = card.launches[1]
        assert (t_ptr, n, stream) == (table.data_ptr(), u.numel(), 7)
        assert table.shape == (TABLE,) and table.dtype == torch.bfloat16
    else:
        assert card.names() == ["_fwd_fn"]
        _, (h_ptr, u_ptr, n, code, stream) = card.launches[0]
        assert (n, code, stream) == (u.numel(), {torch.float32: 0,
                                                 torch.bfloat16: 1}[dtype], 7)
    assert (h_ptr, u_ptr) == (h.data_ptr(), u.data_ptr())
    assert (mlp_ops.LAUNCHES, mlp_ops.TABLE_ROUTE_LAUNCHES,
            mlp_ops.TABLE_LAUNCHES) == ((1, 1, 1) if route == "table"
                                        else (1, 0, 0))


def test_the_table_is_filled_once_a_device(monkeypatch):
    """(c) Three table-route forwards fill the table once and launch the
    lookup three times; the fill is counted in TABLE_LAUNCHES alone."""
    card = _Card(monkeypatch)
    for _ in range(3):
        mlp_ops.gelu_tanh_fwd(_u(mlp_ops.TABLE_MIN_ELEMENTS))
    assert card.names() == ["_table_fn"] + ["_table_fwd_fn"] * 3
    _, (table_ptr, stream) = card.launches[0]
    assert table_ptr == mlp_ops._tables[0].data_ptr() and stream == 7
    assert (mlp_ops.LAUNCHES, mlp_ops.TABLE_ROUTE_LAUNCHES,
            mlp_ops.TABLE_LAUNCHES) == (3, 3, 1)


def test_a_capture_never_fills_the_table(monkeypatch):
    """(c) While a CUDA graph is captured, a bf16 forward above the
    threshold takes the arithmetic route until the table exists, and a
    forced table route raises instead of filling it; once filled outside
    the capture, the capture takes the table route."""
    card = _Card(monkeypatch, capturing=True)
    u = _u(mlp_ops.TABLE_MIN_ELEMENTS)
    assert mlp_ops.forward_route(u) == "arithmetic"
    mlp_ops.gelu_tanh_fwd(u)
    with pytest.raises(RuntimeError, match="capture"):
        mlp_ops.gelu_tanh_fwd(u, route="table")
    assert card.names() == ["_fwd_fn"] and mlp_ops.TABLE_LAUNCHES == 0
    card.capturing = False
    mlp_ops.gelu_tanh_fwd(u)
    card.capturing = True
    assert mlp_ops.forward_route(u) == "table"
    mlp_ops.gelu_tanh_fwd(u)
    assert card.names() == ["_fwd_fn", "_table_fn", "_table_fwd_fn",
                            "_table_fwd_fn"]


@pytest.mark.parametrize("route", ["table", "arithmetic"])
def test_a_forced_route_is_taken_at_any_size(monkeypatch, route):
    """(c) `route` overrides the threshold (phase 3(c) holds both routes
    to the plain chain at every size); the table route refuses fp32 and an
    unknown route raises, both before any launch."""
    card = _Card(monkeypatch)
    mlp_ops.gelu_tanh_fwd(_u(1001), route=route)
    assert card.names()[-1] == {"table": "_table_fwd_fn",
                                "arithmetic": "_fwd_fn"}[route]
    card.launches.clear()
    with pytest.raises(TypeError, match="bfloat16"):
        mlp_ops.gelu_tanh_fwd(_u(8, torch.float32), route="table")
    with pytest.raises(ValueError, match="routes"):
        mlp_ops.gelu_tanh_fwd(_u(8), route="lookup")
    assert card.launches == []


def test_the_backward_is_unchanged_by_the_routes(monkeypatch):
    """(c) The GELU backward launches its one kernel whatever the size."""
    card = _Card(monkeypatch)
    u = _u(mlp_ops.TABLE_MIN_ELEMENTS)
    mlp_ops.gelu_tanh_bwd(u, u)
    assert card.names() == ["_bwd_fn"] and mlp_ops.BWD_LAUNCHES == 1
    assert mlp_ops.TABLE_LAUNCHES == 0


def test_the_layernorm_backward_takes_its_plan(monkeypatch):
    """(d) A backward call on tensors that report a CUDA device: two
    launches counted (the row kernel and the column sums, its programmatic
    dependent), the grid asked of the kernel library once a shape and
    passed on, an fp32 scratch of (2, blocks, D) for the block partials,
    the outputs in their dtypes; no plain version runs."""
    card = _Card(monkeypatch)
    grids = []

    def blocks_fn(rows, d, code):
        grids.append((rows, d, code))
        return 5

    monkeypatch.setattr(ln_ops, "_blocks_fn", blocks_fn)
    monkeypatch.setattr(ln_ops, "_bwd_fn", card._recorder("ln_bwd"))
    monkeypatch.setattr(ln_ops, "_grids", {})
    x = torch.randn(3, 7, 40).bfloat16().as_subclass(_OnCuda)
    scale = torch.randn(40).as_subclass(_OnCuda)
    stats = torch.randn(3, 7).as_subclass(_OnCuda)
    scratch = []
    real_new_empty = torch.Tensor.new_empty

    def spy(self, *args, **kw):
        t = real_new_empty(self, *args, **kw)
        scratch.append(t)
        return t

    monkeypatch.setattr(torch.Tensor, "new_empty", spy)
    for _ in range(2):
        dx, dscale, dbias = ln_ops.layer_norm_bwd(x, x, scale, stats, stats)
    assert ln_ops.BWD_LAUNCHES_PER_CALL == 2
    assert ln_ops.BWD_LAUNCHES == 2 * ln_ops.BWD_LAUNCHES_PER_CALL
    assert grids == [(21, 40, 1)]  # once a shape
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dscale.dtype == dbias.dtype == torch.float32
    assert dscale.shape == dbias.shape == (40,)
    parts = {t.data_ptr(): t for t in scratch if t.shape == (2, 5, 40)}
    assert card.names() == ["ln_bwd", "ln_bwd"]
    args = card.launches[-1][1]
    assert args[3] in parts and parts[args[3]].dtype == torch.float32
    assert args[4] == 5
    assert args[10:] == (21, 40, 1, 0, 7)  # rows, D, x bf16, scale fp32,
    #                                        the stream
