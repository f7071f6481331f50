"""Rematerialisation (``ops/remat.py``, ``models/vit.py``, ``ops/mlp.py``)
against the JAX package's five policies on the CPU, at the two-layer
head_dim-64 ViT of ``test_torch_train.py`` (D = 128, H = 2, MLP 256; batch
3 where a batch axis must not be mistaken for the depth axis).

- What a policy keeps: the activations the port still holds after a
  forward, per layer (a two-layer run less a one-layer run), equal in
  elements to JAX's per-layer residuals (``jax.ad_checkpoint.
  saved_residuals``, the function behind ``print_saved_residuals``), on
  the default and the opt-in route. JAX runs its
  Pallas route (``ARSVT_FORCE_PALLAS``, kernels interpreted), as on a
  TPU, so its ``flash_out`` / ``flash_lse`` tags exist.
- How often each kernel's forward runs per layer and microbatch, the
  table below, at dropout 0 and 0.1 on both routes, with gradients equal
  to the bit to the port's own step without remat (dropout replays).
- The selective policies see the kernel ops and the products in the
  forward and again in the replay.
- A classifier step under each policy against JAX's step under the same
  policy (the limits of ``test_torch_train.py``; the detector's is in
  ``test_torch_detect_train.py``).
"""

import math
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from arsvt_tpu.models import registry as jax_registry
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.models.vit import apply_backbone as jax_apply_backbone
from arsvt_tpu.models.vit import init_backbone as jax_init_backbone
from arsvt_tpu.ops.pallas import flash_attention as jax_flash_attention
from arsvt_tpu.ops.pallas import fused_adamw as jax_fused_adamw
from arsvt_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from arsvt_tpu_torch.core.dtypes import tree_leaves, tree_map
from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.models import registry
from arsvt_tpu_torch.models.bridge import to_jax_params
from arsvt_tpu_torch.models.vit import (
    BackboneConfig,
    apply_backbone,
    init_backbone,
)
from arsvt_tpu_torch.ops import remat
from arsvt_tpu_torch.train.config import TrainConfig
from arsvt_tpu_torch.train.train_step import make_classifier_step_fns
from test_torch_train import (
    ATOL_PARAMS,
    PRESET,
    RTOL_LOSS,
    RTOL_NORM,
    SMALL,
    _assert_trees_close,
    _start,
)
from test_torch_train_opt_in import ROUTES, _Calls, _InterpretPallas

torch.set_num_threads(1)  # tier-1 runs several xdist workers

POLICIES = remat.REMAT_POLICIES
ROUTE_ENVS = {"default": (), "opt_in": ROUTES["both"]}
# forward launches per layer and microbatch: #1 (default route), #5, #8
# and #9 calls (opt-in route); #2 and #6 run once a layer everywhere
TABLE = {
    "none": (1, 1, 1, 1),
    "full": (2, 2, 2, 1),
    "dots": (2, 2, 2, 1),
    "names": (1, 2, 2, 1),
    "all_but_mlp": (1, 1, 2, 1),
    "mlp_tail": (1, 1, 0, 0),
}


@pytest.fixture(autouse=True)
def _tiny_preset_and_pallas(monkeypatch):
    monkeypatch.setitem(jax_registry.PRESETS, PRESET,
                        JaxBackboneConfig(**SMALL))
    monkeypatch.setitem(registry.PRESETS, PRESET, BackboneConfig(**SMALL))
    monkeypatch.setenv("ARSVT_FORCE_PALLAS", "1")
    for env in ("ARSVT_ATTN_SAVE_PROBS", "ARSVT_ENABLE_FUSED_MLP",
                "ARSVT_DISABLE_PALLAS"):
        monkeypatch.delenv(env, raising=False)
    for module in (jax_flash_attention, jax_fused_mlp, jax_fused_adamw):
        monkeypatch.setattr(module, "pl", _InterpretPallas())
    with jax.default_matmul_precision("highest"):
        yield


def _set_route(monkeypatch, route):
    for env in ROUTE_ENVS[route]:
        monkeypatch.setenv(env, "1")


class _Held(TorchDispatchMode):
    """Weak references to every tensor an op returns inside it."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs += [weakref.ref(t) for t in tree_flatten(out)[0]
                      if isinstance(t, torch.Tensor)]
        return out


def _port_held_elements(depth, policy):
    """Floating elements the port holds after a training forward of
    `depth` layers at batch 3 (the parameters and the input excluded)."""
    cfg = BackboneConfig(**dict(SMALL, depth=depth))
    params = init_backbone(cfg, 0)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    images = torch.rand(3, 32, 32, 3)
    held = _Held()
    with held:
        out = apply_backbone(params, images, cfg, train=True, rng=Rng(1),
                             remat=policy != "none",
                             remat_policy=policy.replace("none", "full"))
    own = {t.untyped_storage().data_ptr() for t in leaves + [images]}
    storages = {}
    for ref in held.refs:
        t = ref()
        if t is None or not t.is_floating_point():
            continue
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            storages[st.data_ptr()] = st.nbytes() // t.element_size()
    del out
    return sum(storages.values())


def _jax_layer_elements(policy):
    """JAX's residual elements per layer: the float residuals its scan
    stacks on a leading depth axis, over the depth."""
    cfg = JaxBackboneConfig(**SMALL)
    params = jax_init_backbone(jax.random.PRNGKey(0), cfg)
    images = jnp.ones((3, 32, 32, 3))

    def loss(p):
        return jax_apply_backbone(
            p, images, cfg, train=True, rng=jax.random.PRNGKey(1),
            remat=policy != "none",
            remat_policy=policy.replace("none", "full")).sum()

    total = 0
    for aval, where in saved_residuals(loss, params):
        if ("argument" in where or aval.ndim < 3
                or aval.shape[0] != cfg.depth
                or not jnp.issubdtype(aval.dtype, jnp.floating)):
            continue
        total += math.prod(aval.shape)
    return total // cfg.depth


@pytest.mark.parametrize("policy", ("none",) + POLICIES)
@pytest.mark.parametrize("route", sorted(ROUTE_ENVS))
def test_a_layer_keeps_what_jax_keeps(route, policy, monkeypatch):
    """Per layer, in units of B·S·D with r = M / D (2 here; 4 in ViT-L):
    none 8 + 2r (x, y, qkv, attn, x2, y2, u, gelu(u)), full 1, dots 5 + r
    (x and the products of qkv, proj and fc1: JAX keeps no dot the
    backward does not read, and fc2's feeds only adds), names 2 + r (x,
    attn, u), all_but_mlp 8,
    mlp_tail 8 + r, plus the LayerNorm statistics and the lse (or P on
    the opt-in route)."""
    _set_route(monkeypatch, route)
    port = _port_held_elements(2, policy) - _port_held_elements(1, policy)
    assert port == _jax_layer_elements(policy)
    bsd = 3 * 17 * 128
    r = SMALL["mlp_dim"] // SMALL["embed_dim"]
    units = {"none": 8 + 2 * r, "full": 1, "dots": 5 + r, "names": 2 + r,
             "all_but_mlp": 8, "mlp_tail": 8 + r}[policy]
    if route == "default":
        assert units <= port / bsd < units + 0.05


def _backbone_grads(cfg, policy, seed=0):
    params = init_backbone(cfg, seed)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    images = torch.from_numpy(np.random.default_rng(seed).random(
        (2, 32, 32, 3)).astype(np.float32))
    out = apply_backbone(params, images, cfg, train=True, rng=Rng(7, 0, 1),
                         remat=policy != "none",
                         remat_policy=policy.replace("none", "full"))
    # a fixed random direction: the final LayerNorm keeps the tokens'
    # norms, so a loss of the norms would send no gradient
    probe = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed + 1))
    loss = (out.float() * probe).mean()
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("route", sorted(ROUTE_ENVS))
def test_forward_calls_follow_the_table_and_replays_are_exact(
        route, dropout, policy, monkeypatch):
    """One forward and backward of the 2-layer backbone with residual and
    attention dropout `dropout`: each kernel's calls (the plain versions
    here, the launches on the card) as the table gives them, and loss and
    gradients equal to the bit to the run without remat, the masks
    redrawn in the replay (``mlp_tail`` runs the unfused MLP, so on the
    opt-in route its reference is the no-remat run with the fused MLP
    off)."""
    _set_route(monkeypatch, route)
    cfg = BackboneConfig(**dict(SMALL, dropout=dropout,
                                attn_dropout=dropout))
    calls = _Calls(monkeypatch)
    loss, grads = _backbone_grads(cfg, policy)
    got = calls.take()
    fwd1, fwd5, fwd8, bwd9 = (2 * n for n in TABLE[policy])
    if route == "default":
        want = {"encoder_attention_fwd_plain": fwd1,
                "encoder_attention_bwd_plain": 2}
    else:
        want = {"encoder_attention_fwd_savep_plain": fwd5,
                "encoder_attention_bwd_savep_plain": 2,
                "fused_mlp_fwd_plain": fwd8, "fused_mlp_bwd_plain": bwd9}
    assert {k: v for k, v in got.items() if v} == {
        k: v for k, v in want.items() if v}
    if policy == "mlp_tail" and route == "opt_in":
        monkeypatch.delenv("ARSVT_ENABLE_FUSED_MLP")
    ref_loss, ref_grads = _backbone_grads(cfg, "none")
    assert all(float(g.abs().max()) > 0 for g in ref_grads)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["dots", "names"])
def test_selective_policy_sees_the_kernel_ops_in_forward_and_replay(
        policy, monkeypatch):
    """The policy function is asked about the attention kernel's custom op
    and the products inside the autograd Function during the forward and
    marks what the policy names; the replay takes the saved outputs (the
    kernel's forward runs again under ``dots`` only) and recomputes the
    rest (PyTorch's replay reads the forward's marks)."""
    seen = []
    inner = remat._SELECTIVE[policy]

    def spy(ctx, op, *args, **kwargs):
        decision = inner(ctx, op, *args, **kwargs)
        seen.append((str(op), decision))
        return decision

    monkeypatch.setitem(remat._SELECTIVE, policy, spy)
    calls = _Calls(monkeypatch)
    _backbone_grads(BackboneConfig(**SMALL), policy)
    saved = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    kernel = [d for op, d in seen
              if op == "arsvt.encoder_attention_fwd.default"]
    mms = [d for op, d in seen if op == "aten.mm.default"]
    assert len(kernel) == 2 and len(mms) == 8  # two blocks
    if policy == "dots":  # qkv, proj, fc1 of each block; not fc2
        assert kernel.count(saved) == 0 and mms.count(saved) == 6
    else:  # each block's kernel op and fc1's product
        assert kernel.count(saved) == 2 and mms.count(saved) == 2
    assert {op for op, d in seen if d == saved} <= {
        "arsvt.encoder_attention_fwd.default", "aten.mm.default"}
    assert calls.take()["encoder_attention_fwd_plain"] == (
        4 if policy == "dots" else 2)


@pytest.mark.parametrize("policy,foreign", [("dots", "mlp_fc2"),
                                            ("names", "mlp_u")])
def test_a_tag_open_in_another_thread_leaves_the_policy_as_it_is(
        policy, foreign, monkeypatch):
    """A `checkpoint_name` tag held open by another thread (a served
    forward beside a training step) is not read by this thread's policy:
    the step saves the products it saves alone."""
    seen = []
    inner = remat._SELECTIVE[policy]

    def spy(ctx, op, *args, **kwargs):
        decision = inner(ctx, op, *args, **kwargs)
        if op is torch.ops.aten.mm.default:
            seen.append(decision)
        return decision

    monkeypatch.setitem(remat._SELECTIVE, policy, spy)
    opened, done = threading.Event(), threading.Event()

    def hold():
        with remat.checkpoint_name(foreign):
            opened.set()
            done.wait(60)

    other = threading.Thread(target=hold)
    other.start()
    try:
        assert opened.wait(60)
        _backbone_grads(BackboneConfig(**SMALL), policy)
    finally:
        done.set()
        other.join()
    saved = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert len(seen) == 8
    assert seen.count(saved) == (6 if policy == "dots" else 2)


def test_an_unknown_policy_raises_as_in_jax():
    cfg = BackboneConfig(**SMALL)
    params = init_backbone(cfg, 0)
    images = torch.rand(1, 32, 32, 3)
    with pytest.raises(ValueError, match="remat_policy"):
        apply_backbone(params, images, cfg, remat=True, remat_policy="some")
    apply_backbone(params, images, cfg, remat=False, remat_policy="some")
    with pytest.raises(ValueError, match="remat_policy"):
        jax_apply_backbone(
            jax_init_backbone(jax.random.PRNGKey(0), JaxBackboneConfig(
                **SMALL)), jnp.ones((1, 32, 32, 3)),
            JaxBackboneConfig(**SMALL), remat=True, remat_policy="some")
    with pytest.raises(ValueError, match="remat_policy"):
        make_classifier_step_fns(TrainConfig(
            preset=PRESET, remat=True, remat_policy="some"), device="cpu")


def _clone(state):
    def copy(x):
        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    return {"params": tree_map(copy, state["params"]),
            "opt_state": tree_map(copy, state["opt_state"]),
            "step": state["step"]}


@pytest.mark.parametrize("policy", POLICIES)
def test_classifier_step_under_each_policy_matches_jax(policy):
    """Two steps (batch 8 as 2 microbatches, fp32) with ``remat=True``
    under `policy` on both sides: loss, accuracy, grad_norm and the
    parameters within test_torch_train.py's limits of JAX's step; the
    port's step without remat gives the same loss and update to the
    bit."""
    (jstep, _, jstate), (step, _, state), rng = _start(
        "none", remat=True, remat_policy=policy)
    _, plain_step, _ = make_classifier_step_fns(TrainConfig(
        preset=PRESET, batch_size=8, grad_accum=2, bf16=False,
        warmup_steps=1, fused_adamw=True), device="cpu")
    plain = _clone(state)
    base_rng = jax.random.PRNGKey(1)
    for t in range(2):
        batch = {"image": rng.integers(0, 256, (8, 32, 32, 3),
                                       dtype=np.uint8),
                 "label": rng.integers(0, 6, 8).astype(np.int32)}
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        state, m = step(state, batch)
        plain, pm = plain_step(plain, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=RTOL_LOSS)
        assert float(m["accuracy"]) == float(jm["accuracy"])
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_NORM)
        _assert_trees_close(to_jax_params(state["params"]), jstate["params"],
                            f"params step {t}", atol=ATOL_PARAMS)
        assert float(m["loss"]) == float(pm["loss"])
        assert float(m["grad_norm"]) == float(pm["grad_norm"])
        for a, b in zip(tree_leaves(state["params"]),
                        tree_leaves(plain["params"])):
            assert torch.equal(a, b)
