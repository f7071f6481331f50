"""The port's classifier step on the two no-remat opt-in routes against the
JAX package's ``make_classifier_step_fns`` with the same switches, step
for step, at the tiny ViT of ``test_torch_train.py`` (D=128, H=2, depth
2, MLP 256, batch 8 as 2 microbatches): ``ARSVT_ATTN_SAVE_PROBS`` (kernels
#5/#6), ``ARSVT_ENABLE_FUSED_MLP`` (#8/#9) and both.

The JAX step runs its Pallas kernels (``ARSVT_FORCE_PALLAS=1``) in
interpret mode: the ``pl`` of its three kernel modules is swapped for one
whose ``pallas_call`` always interprets, so its jitted step runs #1, #2,
#5, #6, #7, #8 and #9 as the TPU would, on the CPU. The port reads the
same switches and runs the kernels' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from arsvt_tpu.models import registry as jax_registry
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.ops.pallas import flash_attention as jax_flash_attention
from arsvt_tpu.ops.pallas import fused_adamw as jax_fused_adamw
from arsvt_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from arsvt_tpu_torch.models import registry
from arsvt_tpu_torch.models.bridge import opt_state_to_jax, to_jax_params
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.ops import encoder_attention, fused_mlp
from test_torch_train import (
    PRESET,
    SMALL,
    _assert_trees_close,
    _jax_opt_dict,
    _start,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

LR = 1e-4
ROUTES = {
    "save_probs": ("ARSVT_ATTN_SAVE_PROBS",),
    "fused_mlp": ("ARSVT_ENABLE_FUSED_MLP",),
    "both": ("ARSVT_ATTN_SAVE_PROBS", "ARSVT_ENABLE_FUSED_MLP"),
}
# fp32 on both sides. P, u and du are rounded to bf16 on both sides, and a
# last-bit difference (XLA's tanh against PyTorch's, another summation
# order) flips single roundings by one bf16 ulp, which moves the gradient
# of that row. Measured over the three routes and 3 steps: loss 1.4e-6
# relative, grad_norm 1.7e-5, moments 4.7e-4 of each leaf's largest value,
# parameters 0.14 lr. Held: loss 1e-5 (the default route's limit),
# grad_norm 5e-5, moments 2e-3, parameters 0.5 lr (the default route's).
RTOL_LOSS = 1e-5
RTOL_NORM = 5e-5
RTOL_MOMENT = 2e-3
ATOL_PARAMS = 0.5 * LR
# bf16 on both sides: test_torch_train.py's bf16 limits (loss 3e-2,
# grad_norm 2e-2, first moment 6e-2 relative L2 per leaf, parameters 8 lr);
# measured 5.7e-3, 7.1e-3, 2.8e-2 and 3.0 lr, the eval loss 6.6e-3.
RTOL_LOSS_BF16 = 3e-2
RTOL_NORM_BF16 = 2e-2
RL2_MOMENT_BF16 = 6e-2
ATOL_PARAMS_BF16 = 8 * LR


class _InterpretPallas:
    """``pl`` with every ``pallas_call`` run in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        return pl.pallas_call(*args, **{**kw, "interpret": True})


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


class _Calls:
    """Count calls of the plain versions the port's wrappers run on the
    CPU (on the card the same calls are kernel launches)."""

    NAMES = ((encoder_attention, "encoder_attention_fwd_plain"),
             (encoder_attention, "encoder_attention_fwd_savep_plain"),
             (encoder_attention, "encoder_attention_bwd_plain"),
             (encoder_attention, "encoder_attention_bwd_savep_plain"),
             (fused_mlp, "fused_mlp_fwd_plain"),
             (fused_mlp, "fused_mlp_bwd_plain"))

    def __init__(self, monkeypatch):
        self.counts = {name: 0 for _, name in self.NAMES}
        for module, name in self.NAMES:
            monkeypatch.setattr(module, name, self._spy(name,
                                                        getattr(module, name)))

    def _spy(self, name, fn):
        def spy(*a, **kw):
            self.counts[name] += 1
            return fn(*a, **kw)
        return spy

    def take(self):
        out = dict(self.counts)
        self.counts = dict.fromkeys(self.counts, 0)
        return out


def _expected_calls(route, *, train: bool, forwards: int):
    """Calls per forward (and backward) of the 2-layer model."""
    savep = train and "ARSVT_ATTN_SAVE_PROBS" in ROUTES[route]
    fused = "ARSVT_ENABLE_FUSED_MLP" in ROUTES[route]
    layers = 2 * forwards
    return {
        "encoder_attention_fwd_plain": 0 if savep else layers,
        "encoder_attention_fwd_savep_plain": layers if savep else 0,
        "encoder_attention_bwd_plain": 0 if savep or not train else layers,
        "encoder_attention_bwd_savep_plain": layers if savep else 0,
        "fused_mlp_fwd_plain": layers if fused else 0,
        "fused_mlp_bwd_plain": layers if fused and train else 0,
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_three_steps_and_eval_match_jax_on_the_opt_in_route(route, dtype,
                                                            monkeypatch):
    """3 train steps (step 0 has lr 0) and one eval step, batch 8 as 2
    microbatches, no augmentation, fused AdamW, random head. Per step:
    loss, accuracy, grad_norm, parameters and both moments (fp32), or loss,
    grad_norm, each leaf's first moment and the parameters (bf16); then the
    eval step's loss, correct count and confusion matrix. The port's
    kernels are counted: the train steps take the route's kernels, and
    eval runs #8 where the MLP is fused but never #5."""
    for env in ROUTES[route]:
        monkeypatch.setenv(env, "1")
    bf16 = dtype == "bfloat16"
    calls = _Calls(monkeypatch)
    (jstep, jeval, jstate), (step, eval_step, state), rng = _start(
        "none", bf16=bf16)
    base_rng = jax.random.PRNGKey(1)
    for t in range(3):
        batch = {"image": rng.integers(0, 256, (8, 32, 32, 3),
                                       dtype=np.uint8),
                 "label": rng.integers(0, 6, 8).astype(np.int32)}
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"])) and np.isfinite(
            float(m["grad_norm"]))
        params = to_jax_params(state["params"])
        got = opt_state_to_jax(state["opt_state"])
        ref = _jax_opt_dict(jstate["opt_state"])
        if not bf16:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=RTOL_LOSS)
            assert float(m["accuracy"]) == float(jm["accuracy"])
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]),
                                       rtol=RTOL_NORM)
            _assert_trees_close(params, jstate["params"], f"params step {t}",
                                atol=ATOL_PARAMS)
            for key in ("mu", "nu"):
                _assert_trees_close(got[key], ref[key], f"{key} step {t}",
                                    rtol_of_max=RTOL_MOMENT)
        else:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=RTOL_LOSS_BF16)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]),
                                       rtol=RTOL_NORM_BF16)
            for a, b in zip(jax.tree_util.tree_leaves(got["mu"]),
                            jax.tree_util.tree_leaves(ref["mu"])):
                rel = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert rel <= RL2_MOMENT_BF16, f"mu step {t}: {rel}"
            _assert_trees_close(params, jstate["params"], f"params step {t}",
                                atol=ATOL_PARAMS_BF16)
    # 3 steps x 2 microbatches
    assert calls.take() == _expected_calls(route, train=True, forwards=6)

    ev = {"image": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
          "label": rng.integers(0, 6, 8).astype(np.int32),
          "valid": (np.arange(8) < 7).astype(np.int32)}
    je = jeval(jstate["params"], jax.tree_util.tree_map(jnp.asarray, ev))
    e = eval_step(state["params"], ev)
    assert calls.take() == _expected_calls(route, train=False, forwards=1)
    np.testing.assert_allclose(float(e["loss"]), float(je["loss"]),
                               rtol=RTOL_LOSS_BF16 if bf16 else RTOL_LOSS)
    assert int(e["count"]) == int(je["count"]) == 7
    if not bf16:  # bf16: a near-tie may flip one prediction
        assert int(e["correct"]) == int(je["correct"])
        np.testing.assert_array_equal(e["confusion"].numpy(),
                                      np.asarray(je["confusion"]))
