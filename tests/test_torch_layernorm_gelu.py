"""The port's LayerNorm and tanh-GELU (``ops/layernorm.py``, ``ops/mlp.py``)
on the CPU, where their wrappers run the plain versions of the kernels
``csrc/layernorm.cu`` and ``csrc/gelu_tanh.cu`` (held against the plain
versions on the card by ``chip_smoke.py`` phase 3(c)):

- the plain LayerNorm, forward and backward, against the JAX package's
  custom VJP, at widths 32 to 770, leading shapes of rank 1-3 (x of rank
  2-4), x and scale in fp32 and bf16, at ``test_torch_train_ops.py``'s
  limits;
- the plain GELU, forward and backward, against JAX's ``gelu_tanh``, also
  with ±Inf and NaN;
- CPU tensors take the plain versions and launch nothing; a tensor that
  reports a CUDA device reaches the kernel or raises, never the plain
  version;
- both custom ops under ``torch.library.opcheck``;
- under remat, both ops are replayed and never saved, and the calls of
  every policy, route and model follow ``chip_smoke.py::norm_launches``,
  the launch tables of the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.ops.layernorm import layer_norm as jax_layer_norm
from arsvt_tpu.ops.mlp import gelu_tanh as jax_gelu_tanh
from arsvt_tpu_torch.core.dtypes import tree_leaves
from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.models.detector import apply_detector, init_detector
from arsvt_tpu_torch.models.registry import get_detector_preset
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.ops import layernorm as ln_ops
from arsvt_tpu_torch.ops import library, remat
from arsvt_tpu_torch.ops import mlp as mlp_ops
from arsvt_tpu_torch.ops.layernorm import (
    layer_norm,
    layer_norm_bwd,
    layer_norm_fwd,
)
from arsvt_tpu_torch.ops.mlp import gelu_tanh, gelu_tanh_bwd, gelu_tanh_fwd

torch.set_num_threads(1)  # tier-1 runs several xdist workers

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# test_torch_train_ops.py's limits: fp32 sum order only; bf16 a bf16 ulp
LN_TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
          "bfloat16": dict(atol=2.0 ** -7, rtol=2.0 ** -7)}
GELU_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
            "bfloat16": dict(atol=2.0 ** -8, rtol=2.0 ** -8)}
COUNTED = ((ln_ops, "LAUNCHES"), (ln_ops, "BWD_LAUNCHES"),
           (mlp_ops, "LAUNCHES"), (mlp_ops, "BWD_LAUNCHES"))
PLAIN = ((ln_ops, "layer_norm_fwd_plain"), (ln_ops, "layer_norm_bwd_plain"),
         (mlp_ops, "gelu_tanh_fwd_plain"), (mlp_ops, "gelu_tanh_bwd_plain"))


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


class _Calls:
    """Counts the plain versions' calls (the kernels' launches on the
    card: one a forward, one a backward call)."""

    def __init__(self, monkeypatch):
        self.counts = dict.fromkeys((name for _, name in PLAIN), 0)
        for module, name in PLAIN:
            monkeypatch.setattr(module, name, self._spy(name,
                                                        getattr(module, name)))

    def _spy(self, name, fn):
        def spy(*a, **kw):
            self.counts[name] += 1
            return fn(*a, **kw)
        return spy

    def take(self) -> dict:
        """{chip_smoke counter name: launches} since the last take."""
        c, self.counts = self.counts, dict.fromkeys(self.counts, 0)
        return {"layer_norm_fwd": c["layer_norm_fwd_plain"],
                "layer_norm_bwd": ln_ops.BWD_LAUNCHES_PER_CALL
                * c["layer_norm_bwd_plain"],
                "gelu_tanh_fwd": c["gelu_tanh_fwd_plain"],
                "gelu_tanh_bwd": c["gelu_tanh_bwd_plain"]}


@pytest.mark.parametrize("dtypes", ["float32/float32", "bfloat16/bfloat16",
                                    "bfloat16/float32", "float32/bfloat16"])
@pytest.mark.parametrize("lead", [(6,), (2, 5), (2, 3, 4)],
                         ids=["rank2", "rank3", "rank4"])
@pytest.mark.parametrize("d", [32, 192, 400, 768, 770])
def test_layer_norm_plain_matches_jax(d, lead, dtypes):
    """y and the gradients of sum(LN(x) * w) with respect to x, scale and
    bias, the port's wrapper on CPU tensors (the plain versions) against
    JAX's custom VJP on the same inputs; the bf16 limit wherever x or the
    parameters are bf16. Mean and rstd against numpy in float64."""
    xt, st = dtypes.split("/")
    tol = LN_TOL["bfloat16" if "bfloat16" in dtypes else "float32"]
    x = _rand(lead + (d,), d, 3.0) + 0.5
    scale, bias = _rand((d,), d + 1), _rand((d,), d + 2)
    w = _rand(lead + (d,), d + 3)

    def jloss(x, s, b):
        return jnp.sum(jax_layer_norm(x, s, b, eps=1e-6).astype(jnp.float32)
                       * w)

    jx = jnp.asarray(x).astype(_JAX[xt])
    js, jb = (jnp.asarray(a).astype(_JAX[st]) for a in (scale, bias))
    jy = jax_layer_norm(jx, js, jb, eps=1e-6)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(jx, js, jb)
    tx = torch.from_numpy(x).to(_TORCH[xt]).requires_grad_(True)
    ts, tb = (torch.from_numpy(a).to(_TORCH[st]).requires_grad_(True)
              for a in (scale, bias))
    y = layer_norm(tx, ts, tb, eps=1e-6)
    assert y.dtype == _TORCH[xt] and y.shape == tx.shape
    np.testing.assert_allclose(_np(y), _np(jy), err_msg="y", **tol)
    got = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(),
                              (tx, ts, tb))
    for name, g, r, dt in zip(("dx", "dscale", "dbias"), got, ref,
                              (xt, st, st)):
        assert g.dtype == _TORCH[dt]
        np.testing.assert_allclose(_np(g), _np(r), err_msg=name, **tol)
    _, mean, rstd = layer_norm_fwd(tx.detach(), ts.detach(), tb.detach(),
                                   1e-6)
    x64 = tx.detach().double().numpy()
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == tx.shape[:-1]
    np.testing.assert_allclose(mean.numpy(), x64.mean(-1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x64.var(-1) + 1e-6),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("planted", [False, True],
                         ids=["finite", "inf_nan"])
def test_gelu_plain_matches_jax(dtype, planted):
    """gelu(u) and the gradient of sum(gelu(u) * w), the port's wrapper on
    CPU tensors against JAX's custom VJP, at the limits of
    ``test_torch_train_ops.py::test_gelu_grad_matches_jax`` (XLA's tanh
    and PyTorch's differ in the last bits; in bf16 each op of the chain
    rounds, in both). With ±Inf and NaN planted, the non-finite values
    agree in place: u = -Inf gives NaN forward, as the eager chain does,
    +Inf gives +Inf; NaN stays NaN; the gradient is NaN at all three."""
    u = _rand((4, 250), 16, 4.0)
    w = _rand((4, 250), 17)
    if planted:
        u[0, :3] = (np.inf, -np.inf, np.nan)
    ju, jw = (jnp.asarray(a).astype(_JAX[dtype]) for a in (u, w))
    jh = jax_gelu_tanh(ju)
    ref = jax.grad(lambda v: jnp.sum(
        (jax_gelu_tanh(v) * jw).astype(jnp.float32)))(ju)
    tu = torch.from_numpy(u).to(_TORCH[dtype]).requires_grad_(True)
    tw = torch.from_numpy(w).to(_TORCH[dtype])
    h = gelu_tanh(tu)
    (got,) = torch.autograd.grad((h * tw).float().sum(), (tu,))
    assert h.dtype == got.dtype == _TORCH[dtype]
    tol = GELU_TOL[dtype]
    fwd_tol = dict(atol=2.0 ** -7, rtol=2.0 ** -7) if dtype == "bfloat16" \
        else tol
    np.testing.assert_allclose(_np(h), _np(jh), equal_nan=True, **fwd_tol)
    np.testing.assert_allclose(_np(got), _np(ref), equal_nan=True, **tol)
    if planted:
        assert _np(h)[0, 0] == np.inf
        assert np.isnan(_np(h)[0, 1:3]).all()
        assert np.isnan(_np(got)[0, :3]).all()
        assert np.isfinite(_np(h)[:, 3:]).all()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(
        monkeypatch):
    """Forward and backward of both ops on CPU tensors, with and without a
    gradient: each call reaches its plain version once and no counter
    moves."""
    before = [getattr(m, a) for m, a in COUNTED]
    calls = _Calls(monkeypatch)
    x = torch.randn(3, 5, 24, requires_grad=True)
    scale = torch.randn(24, requires_grad=True)
    bias = torch.randn(24, requires_grad=True)
    y = gelu_tanh(layer_norm(x, scale, bias))
    y.sum().backward()
    with torch.no_grad():
        gelu_tanh(layer_norm(x, scale, bias))
    assert calls.take() == {
        "layer_norm_fwd": 2, "layer_norm_bwd": ln_ops.BWD_LAUNCHES_PER_CALL,
        "gelu_tanh_fwd": 2, "gelu_tanh_bwd": 1}
    assert [getattr(m, a) for m, a in COUNTED] == before


def test_disable_ln_vjp_runs_plain_autograd(monkeypatch):
    """``ARSVT_DISABLE_LN_VJP``: autograd over the forward's plain math (no
    kernel, no custom backward), equal to the custom backward within the
    fp32 limit."""
    x = torch.from_numpy(_rand((4, 7, 40), 3)).requires_grad_(True)
    scale = torch.from_numpy(_rand((40,), 4)).requires_grad_(True)
    bias = torch.from_numpy(_rand((40,), 5)).requires_grad_(True)
    w = torch.from_numpy(_rand((4, 7, 40), 6))
    ref = torch.autograd.grad((layer_norm(x, scale, bias) * w).sum(),
                              (x, scale, bias))
    monkeypatch.setenv("ARSVT_DISABLE_LN_VJP", "1")
    calls = _Calls(monkeypatch)
    y = layer_norm(x, scale, bias)
    assert y.grad_fn.name() != "_LayerNormBackward"
    got = torch.autograd.grad((y * w).sum(), (x, scale, bias))
    assert calls.take()["layer_norm_bwd"] == 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(),
                                   **LN_TOL["float32"])


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers' CUDA
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_a_cuda_tensor_never_reaches_the_plain_versions(monkeypatch):
    """On a CUDA tensor each wrapper builds and launches its kernel or
    raises, uncounted: without nvcc the build raises; a dtype the kernels
    do not take raises before any build."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    def no_nvcc(name):
        raise RuntimeError(f"nvcc not found (building {name})")

    for module, name in PLAIN:
        monkeypatch.setattr(module, name, refuse)
    for module, name in ((ln_ops, "_fwd_fn"), (ln_ops, "_bwd_fn"),
                         (mlp_ops, "_fwd_fn"), (mlp_ops, "_bwd_fn")):
        monkeypatch.setattr(module, name, None)
    monkeypatch.setattr(ln_ops.build, "load", no_nvcc)
    before = [getattr(m, a) for m, a in COUNTED]
    x = torch.randn(2, 5, 8).as_subclass(_OnCuda)
    scale, bias = (torch.randn(8).as_subclass(_OnCuda) for _ in range(2))
    stats = torch.randn(2, 5).as_subclass(_OnCuda)
    with pytest.raises(RuntimeError, match="building layernorm"):
        layer_norm_fwd(x, scale, bias, 1e-5)
    with pytest.raises(RuntimeError, match="building layernorm"):
        layer_norm_bwd(x, x, scale, stats, stats)
    with pytest.raises(RuntimeError, match="building gelu_tanh"):
        gelu_tanh_fwd(x)
    with pytest.raises(RuntimeError, match="building gelu_tanh"):
        gelu_tanh_bwd(x, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layer_norm_fwd(x.half(), scale, bias, 1e-5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layer_norm_fwd(x, scale.double(), bias, 1e-5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gelu_tanh_fwd(x.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gelu_tanh_bwd(x, x.bfloat16())
    assert [getattr(m, a) for m, a in COUNTED] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_ops_pass_opcheck(dtype):
    """torch.library.opcheck: schema, fake implementation against the
    real one (the plain versions on the CPU), dispatch; scale in the other
    dtype than x as well."""
    ops = library.register_all()
    gen = torch.Generator().manual_seed(0)
    dt = _TORCH[dtype]
    x = torch.randn(3, 7, 40, generator=gen).to(dt)
    scale, bias = (torch.randn(40, generator=gen) for _ in range(2))
    torch.library.opcheck(ops["layer_norm_fwd"], (x, scale, bias, 1e-5))
    torch.library.opcheck(ops["layer_norm_fwd"],
                          (x, scale.to(dt), bias.to(dt), 1e-6))
    torch.library.opcheck(ops["gelu_tanh_fwd"],
                          (torch.randn(5, 33, generator=gen).to(dt),))


SMALL = dict(image_size=32, patch_size=8, embed_dim=64, depth=2,
             num_heads=2, mlp_dim=128)
ROUTES = {"default": (), "opt_in": ("ARSVT_ATTN_SAVE_PROBS",
                                    "ARSVT_ENABLE_FUSED_MLP")}


def _route(monkeypatch, route):
    monkeypatch.delenv("ARSVT_DISABLE_PALLAS", raising=False)
    for env in ROUTES["opt_in"]:
        monkeypatch.delenv(env, raising=False)
    for env in ROUTES[route]:
        monkeypatch.setenv(env, "1")


def _grads(apply, params, images, **kw):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = apply(params, images, **kw)
    outs = out.values() if isinstance(out, dict) else [out]
    loss = sum(_sum_all(o) for o in outs)
    torch.autograd.grad(loss, leaves, allow_unused=True)


def _sum_all(o):
    if isinstance(o, dict):
        return sum(_sum_all(v) for v in o.values())
    return o.float().square().mean()


@pytest.mark.parametrize("policy", remat.REMAT_POLICIES)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_remat_replays_both_ops_and_never_saves_them(route, policy,
                                                     monkeypatch):
    """A training forward and backward of a 2-layer backbone under each
    policy: the calls of both ops follow ``chip_smoke.py::norm_launches``
    (JAX's dots and names save neither op's output, so the block policies
    replay both LayerNorms of a block, every policy replays the unfused
    GELU), and under the selective policies the policy marks every call of
    either op PREFER_RECOMPUTE."""
    import chip_smoke
    from arsvt_tpu_torch.models.vit import apply_backbone, init_backbone

    _route(monkeypatch, route)
    seen = []
    if policy in remat._SELECTIVE:
        inner = remat._SELECTIVE[policy]

        def spy(ctx, op, *args, **kwargs):
            decision = inner(ctx, op, *args, **kwargs)
            seen.append((str(op), decision))
            return decision

        monkeypatch.setitem(remat._SELECTIVE, policy, spy)
    calls = _Calls(monkeypatch)
    cfg = BackboneConfig(**dict(SMALL, dropout=0.1, attn_dropout=0.1))
    images = torch.rand(2, 32, 32, 3)
    _grads(apply_backbone, init_backbone(cfg, 0), images, cfg=cfg,
           train=True, rng=Rng(3), remat=policy != "none",
           remat_policy=policy.replace("none", "full"))
    assert calls.take() == chip_smoke.norm_launches(
        cfg, micro=1, policy=policy, fused_mlp=route == "opt_in")
    if policy in remat._SELECTIVE:
        mine = [d for op, d in seen if op in ("arsvt.layer_norm_fwd.default",
                                              "arsvt.gelu_tanh_fwd.default")]
        unfused = route == "default"
        # 2 LayerNorms (and a GELU) a block, asked in the forward (the
        # replay reads the forward's marks)
        assert len(mine) == cfg.depth * (2 + unfused)
        assert set(mine) == {
            torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_detector_calls_follow_the_launch_table(route, monkeypatch):
    """``detector_test``: a training forward with the intermediate layers'
    outputs (aux) and its backward, then a forward without a gradient, on
    both routes: the calls as ``chip_smoke.py::norm_launches`` counts
    them, the DETR head's 4 LayerNorms and GELU a layer and its final
    LayerNorm, once more over the stacked intermediate layers."""
    import chip_smoke

    _route(monkeypatch, route)
    cfg = get_detector_preset("detector_test")
    params = init_detector(cfg, seed=0)
    images = torch.rand(2, cfg.backbone.image_size, cfg.backbone.image_size,
                        3)
    calls = _Calls(monkeypatch)
    _grads(apply_detector, params, images, cfg=cfg, train=True, rng=Rng(4),
           return_aux=True)
    fused = route == "opt_in"
    assert calls.take() == chip_smoke.norm_launches(cfg, micro=1, aux=True,
                                                    fused_mlp=fused)
    with torch.no_grad():
        apply_detector(params, images, cfg)
    assert calls.take() == chip_smoke.norm_launches(cfg, forwards=1,
                                                    fused_mlp=fused)
