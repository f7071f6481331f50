"""The port's classifier train and eval steps against the JAX package's
``make_classifier_step_fns`` on the CPU, step for step, at a tiny ViT
with head_dim 64 (image 32, patch 8, D=128, H=2, depth 2, MLP 256).

Both sides start from the same weights and optimizer state (carried over
by the bridge), take the same batches, and, with augmentation on, the same
per-image draws: JAX's own, replayed here from its key chain and fed to
the port through the apply functions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax._src.transform as optax_transform
import pytest
import torch

from arsvt_tpu.evaluation.classify import (
    evaluate_classifier as jax_evaluate_classifier,
)
from arsvt_tpu.models import registry as jax_registry
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu.train.optim import _find_state
from arsvt_tpu.train.train_step import (
    make_classifier_step_fns as jax_make_step_fns,
)
from arsvt_tpu_torch.data.augment import CropFlipDraws
from arsvt_tpu_torch.evaluation.classify import evaluate_classifier
from arsvt_tpu_torch.models import registry
from arsvt_tpu_torch.models.bridge import (
    from_jax_params,
    opt_state_from_jax,
    opt_state_to_jax,
    to_jax_params,
)
from arsvt_tpu_torch.models.classifier import init_image_classifier
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.train.accum import (
    accumulated_value_and_grad,
    microbatch_split,
)
from arsvt_tpu_torch.train.config import TrainConfig
from arsvt_tpu_torch.train.train_step import make_classifier_step_fns

torch.set_num_threads(1)  # tier-1 runs several xdist workers

PRESET = "vit_port_test_8_32"
SMALL = dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
             num_heads=2, mlp_dim=256)
LR = 1e-4  # TrainConfig's default learning rate
# Tolerances of the step-for-step comparison, fp32 on both sides, same
# arithmetic in another summation order (measured: loss 2e-6 relative,
# grad_norm 1e-6 relative, moments 8e-6 of each leaf's largest value):
RTOL_LOSS = 1e-5
RTOL_NORM = 1e-5
RTOL_MOMENT = 5e-5  # times the leaf's largest |value|
# Adam's first updates are close to lr * sign(g): a gradient element that
# lies within fp32 summation noise of zero moves by a visibly different
# amount on the two sides, bounded by lr. Measured 2.2e-5 after 3 steps.
ATOL_PARAMS = 0.5 * LR
# bf16 on both sides: activations, matmul inputs and weight gradients are
# rounded to bf16 at each side's own rounding points (JAX's CPU step runs
# its jnp attention, the port the kernel's order), a few bf16 ulps (2^-8
# relative) compounding through the layers. Measured over 3 steps: loss
# 9.4e-3 relative, grad_norm 4.7e-3, each leaf's first moment 2.1e-2
# relative L2, parameters 3.8 lr (the sign-like Adam steps again).
RTOL_LOSS_BF16 = 3e-2
RTOL_NORM_BF16 = 2e-2
RL2_MOMENT_BF16 = 6e-2
ATOL_PARAMS_BF16 = 8 * LR


@pytest.fixture(autouse=True)
def _tiny_preset(monkeypatch):
    monkeypatch.setitem(jax_registry.PRESETS, PRESET,
                        JaxBackboneConfig(**SMALL))
    monkeypatch.setitem(registry.PRESETS, PRESET, BackboneConfig(**SMALL))
    with jax.default_matmul_precision("highest"):
        yield


def _jax_opt_dict(opt_state):
    adam = _find_state(opt_state, optax_transform.ScaleByAdamState)
    sched = _find_state(opt_state, optax_transform.ScaleByScheduleState)
    return jax.tree_util.tree_map(np.asarray, {
        "count": opt_state.count,
        "lr_scale": opt_state.hyperparams["lr_scale"],
        "adam_count": adam.count, "mu": adam.mu, "nu": adam.nu,
        "schedule_count": sched.count,
    })


def _replay_jax_draws(base_rng, step, accum, per_micro):
    """The crop/flip draws JAX's train step makes inside its jit: step rng
    fold_in(base, step), microbatch rng fold_in(step rng, a) (accum > 1),
    one split for the augmentation, one key per image, then the splits of
    classification_train_augment and random_resized_crop."""
    out = []
    step_rng = jax.random.fold_in(base_rng, step)
    for a in range(accum):
        rng = jax.random.fold_in(step_rng, a) if accum > 1 else step_rng
        _, aug_rng = jax.random.split(rng)
        vals = []
        for key in jax.random.split(aug_rng, per_micro):
            k1, k2, _, _ = jax.random.split(key, 4)
            ka, kr, kx, ky = jax.random.split(k1, 4)
            vals.append((
                jax.random.uniform(ka, (), minval=0.65, maxval=1.0),
                jax.random.uniform(kr, (), minval=jnp.log(3 / 4),
                                   maxval=jnp.log(4 / 3)),
                jax.random.uniform(ky, (), minval=0.0, maxval=1.0),
                jax.random.uniform(kx, (), minval=0.0, maxval=1.0),
                jax.random.bernoulli(k2, 0.5)))
        out.append(CropFlipDraws(*(
            torch.from_numpy(np.array([np.asarray(v) for v in col]))
            for col in zip(*vals))))
    return out


def _start(augment="none", bf16=False, **over):
    """Both step functions and both states from the same JAX init, with a
    seeded random head (the zero head sends no gradient into the
    backbone); `over` sets more config fields on both sides."""
    kw = dict(preset=PRESET, batch_size=8, grad_accum=2, augment=augment,
              bf16=bf16, warmup_steps=1, fused_adamw=True, canvas=40,
              **over)
    jinit, jstep, jeval = jax_make_step_fns(JaxTrainConfig(**kw))
    _, step, eval_step = make_classifier_step_fns(TrainConfig(**kw),
                                                  device="cpu")
    jstate = jinit(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jstate["params"]["classifier"]["head"] = {
        "kernel": jnp.asarray(rng.standard_normal((128, 6)) * 0.3,
                              jnp.float32),
        "bias": jnp.asarray(rng.standard_normal(6) * 0.1, jnp.float32),
    }
    cfg = BackboneConfig(**SMALL)
    state = {
        "params": from_jax_params(
            jax.tree_util.tree_map(np.asarray, jstate["params"]), cfg),
        "opt_state": opt_state_from_jax(
            _jax_opt_dict(jstate["opt_state"]), cfg),
        "step": 0,
    }
    return (jstep, jeval, jstate), (step, eval_step, state), rng


def _assert_trees_close(got, ref, what, *, atol=0.0, rtol_of_max=0.0):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        b = np.asarray(b)
        tol = atol + rtol_of_max * float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("augment", ["none", "crop_flip"])
def test_three_train_steps_and_eval_match_jax(augment):
    """Batch 8 as 2 microbatches, fp32, fused AdamW, warmup 1 (step 0 has
    lr 0). Per step: loss, accuracy, grad_norm, parameters, both moments
    and the counts; then one eval step: loss, correct, confusion."""
    (jstep, jeval, jstate), (step, eval_step, state), rng = _start(augment)
    size = 40 if augment == "crop_flip" else 32  # crop_flip: a 40 canvas
    base_rng = jax.random.PRNGKey(1)
    before = to_jax_params(state["params"])
    for t in range(3):
        batch = {"image": rng.integers(0, 256, (8, size, size, 3),
                                       dtype=np.uint8),
                 "label": rng.integers(0, 6, 8).astype(np.int32)}
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        draws = (_replay_jax_draws(base_rng, t, 2, 4)
                 if augment == "crop_flip" else None)
        state, m = step(state, batch, draws=draws)
        assert state["step"] == t + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=RTOL_LOSS)
        assert float(m["accuracy"]) == float(jm["accuracy"])
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_NORM)
        params = to_jax_params(state["params"])
        _assert_trees_close(params, jstate["params"], f"params step {t}",
                            atol=ATOL_PARAMS)
        if t == 0:  # lr 0: the parameters did not move
            for a, b in zip(jax.tree_util.tree_leaves(params),
                            jax.tree_util.tree_leaves(before)):
                np.testing.assert_array_equal(a, b)
        ref = _jax_opt_dict(jstate["opt_state"])
        got = opt_state_to_jax(state["opt_state"])
        for key in ("count", "adam_count", "schedule_count"):
            assert int(got[key]) == int(ref[key]) == t + 1
        for key in ("mu", "nu"):
            _assert_trees_close(got[key], ref[key], f"{key} step {t}",
                                rtol_of_max=RTOL_MOMENT)

    ev = {"image": rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8),
          "label": rng.integers(0, 6, 8).astype(np.int32),
          "valid": (np.arange(8) < 7).astype(np.int32)}
    je = jeval(jstate["params"], jax.tree_util.tree_map(jnp.asarray, ev))
    e = eval_step(state["params"], ev)
    np.testing.assert_allclose(float(e["loss"]), float(je["loss"]),
                               rtol=RTOL_LOSS)
    assert int(e["correct"]) == int(je["correct"])
    assert int(e["count"]) == int(je["count"]) == 7
    np.testing.assert_array_equal(e["confusion"].numpy(),
                                  np.asarray(je["confusion"]))


def test_bf16_train_steps_track_jax():
    """bf16 on both sides, batch 8 as 2 microbatches, random head, 3 steps
    (step 0 has lr 0): loss, accuracy, grad_norm, each leaf's first moment
    (0.1 x the clipped gradient after step 0, so the backbone's bf16
    gradients are held leaf by leaf) and the parameters."""
    (jstep, _, jstate), (step, _, state), rng = _start("none", bf16=True)
    base_rng = jax.random.PRNGKey(1)
    for t in range(3):
        batch = {"image": rng.integers(0, 256, (8, 32, 32, 3),
                                       dtype=np.uint8),
                 "label": rng.integers(0, 6, 8).astype(np.int32)}
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=RTOL_LOSS_BF16)
        # one image of eight may flip on a near-tie of its top two logits
        assert abs(float(m["accuracy"]) - float(jm["accuracy"])) <= 0.126
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=RTOL_NORM_BF16)
        got = opt_state_to_jax(state["opt_state"])["mu"]
        ref = _jax_opt_dict(jstate["opt_state"])["mu"]
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= RL2_MOMENT_BF16, f"mu step {t}: {rel}"
        _assert_trees_close(to_jax_params(state["params"]), jstate["params"],
                            f"params step {t}", atol=ATOL_PARAMS_BF16)


def test_microbatches_are_strided_rows_and_must_divide():
    batch = {"image": torch.arange(8).reshape(8, 1),
             "label": torch.arange(8)}
    parts = microbatch_split(batch, 2)
    assert parts[0]["label"].tolist() == [0, 2, 4, 6]
    assert parts[1]["label"].tolist() == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="must divide the batch dim"):
        microbatch_split(batch, 3)


def test_grad_accum_equals_full_batch():
    """accum=2 against accum=1 on the same batch: the gradients (fp32, sum
    order only: atol 1e-6 relative to each leaf's largest value), the loss
    (rtol 1e-6), and the parameters after one train step with a constant
    lr (ATOL_PARAMS, as above)."""
    cfg = BackboneConfig(**SMALL)
    params = init_image_classifier(cfg, 6, seed=2)
    params["classifier"]["head"]["kernel"].normal_(
        generator=torch.Generator().manual_seed(3))
    from arsvt_tpu_torch.core.dtypes import tree_leaves
    from arsvt_tpu_torch.models.classifier import apply_image_classifier
    from arsvt_tpu_torch.objectives.classification import (
        softmax_cross_entropy,
    )

    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    rng = np.random.default_rng(4)
    batch = {"image": torch.from_numpy(rng.random((8, 32, 32, 3)).astype(
                 np.float32)),
             "label": torch.from_numpy(rng.integers(0, 6, 8))}

    def loss_fn(mb, a):
        logits = apply_image_classifier(params, mb["image"], cfg, 6,
                                        train=True)
        return softmax_cross_entropy(logits, mb["label"], num_classes=6), {}

    (l1, _), g1 = accumulated_value_and_grad(loss_fn, leaves, batch, 1)
    (l2, _), g2 = accumulated_value_and_grad(loss_fn, leaves, batch, 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))

    finals = []
    for accum in (1, 2):
        tcfg = TrainConfig(preset=PRESET, grad_accum=accum, bf16=False,
                           schedule="constant", warmup_steps=0)
        init_fn, step, _ = make_classifier_step_fns(tcfg, device="cpu")
        state = init_fn(seed=5)
        state, _ = step(state, {"image": (batch["image"] * 255).to(
            torch.uint8), "label": batch["label"]})
        finals.append(tree_leaves(state["params"]))
        with pytest.raises(ValueError, match="must divide the batch dim"):
            make_classifier_step_fns(tcfg.with_overrides(grad_accum=3),
                                     device="cpu")[1](state, batch)
    for a, b in zip(*finals):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=ATOL_PARAMS, rtol=0)


def test_evaluate_classifier_matches_jax():
    """Two batches of 40-pixel uint8 images through the resize/normalize
    eval path, fp32 both sides: the same top-1, per-class accuracy and
    confusion matrix."""
    (_, _, jstate), (_, _, state), rng = _start("none")
    batches = [{"image": rng.integers(0, 256, (6, 40, 40, 3),
                                      dtype=np.uint8),
                "label": rng.integers(0, 6, 6).astype(np.int32)}
               for _ in range(2)]
    ref = jax_evaluate_classifier(
        jstate["params"], iter([jax.tree_util.tree_map(jnp.asarray, b)
                                for b in batches]),
        JaxBackboneConfig(**SMALL), 6, compute_dtype=jnp.float32,
        normalize_inputs=True)
    got = evaluate_classifier(state["params"], iter(batches),
                              BackboneConfig(**SMALL), 6,
                              compute_dtype=torch.float32,
                              normalize_inputs=True, device="cpu")
    assert got["n"] == ref["n"] == 12
    assert got["top1"] == ref["top1"]
    assert got["confusion_matrix"] == ref["confusion_matrix"]
    np.testing.assert_equal(got["per_class_accuracy"],
                            ref["per_class_accuracy"])


def test_step_fns_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(preset=PRESET, bf16=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_classifier_step_fns(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_classifier({}, iter([]), BackboneConfig(**SMALL), 6)
    make_classifier_step_fns(cfg, device="cpu")


def replay_recipe_draws(base_rng, step, accum, per_micro, *,
                        rand_augment, mixup_alpha):
    """JAX's draws inside its train step with RandAugment and mixup: per
    microbatch rng (as `_replay_jax_draws`), one split for the
    augmentation (crop, flip and RandAugment of one key per image), one
    for mixup (λ ~ Beta and a permutation). Returns (CropFlipDraws or
    None per microbatch, MixupDraws or None per microbatch)."""
    from arsvt_tpu_torch.objectives.classification import MixupDraws
    from test_torch_augment import jax_classify_draws

    augs, mixes = [], []
    step_rng = jax.random.fold_in(base_rng, step)
    for a in range(accum):
        rng = jax.random.fold_in(step_rng, a) if accum > 1 else step_rng
        rng, aug_rng = jax.random.split(rng)
        augs.append(jax_classify_draws(
            jax.random.split(aug_rng, per_micro), rand_augment=rand_augment))
        if mixup_alpha > 0:
            _, mix_rng = jax.random.split(rng)
            k_lam, k_perm = jax.random.split(mix_rng)
            mixes.append(MixupDraws(
                float(jax.random.beta(k_lam, mixup_alpha, mixup_alpha, ())),
                torch.from_numpy(np.array(jax.random.permutation(
                    k_perm, per_micro)))))
    return augs, (mixes or None)


# With RandAugment the pixels entering posterize and solarize differ by a
# few fp32 ulps (each side's crop weights and rotation inverse, within
# 1e-5: test_torch_randaugment.py), and those two ops are steps: now and
# then a pixel lands on the other side of a level or the threshold and
# moves by up to 1/16. Measured over 3 steps: loss 2.4e-4 relative,
# grad_norm 1.4e-5, moments 1.0e-3 of each leaf's largest value,
# parameters 0.34 lr. Held for the RandAugment recipes: loss 1e-3,
# grad_norm 1e-4, moments 3e-3; the parameters at the fp32 limit. The
# other recipes keep the fp32 limits above.
RTOL_LOSS_RA = 1e-3
RTOL_NORM_RA = 1e-4
RTOL_MOMENT_RA = 3e-3
RECIPES = {
    "mixup": dict(augment="crop_flip", mixup_alpha=0.2),
    "remat": dict(augment="crop_flip", remat=True),
    "randaugment": dict(augment="randaugment"),
    "vit_large_384": dict(augment="randaugment", mixup_alpha=0.2,
                          label_smoothing=0.1, remat=True),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_steps_match_jax(recipe):
    """3 steps (batch 8 as 2 microbatches, fp32, a 40 canvas) of the ViT-L
    recipe's features, one at a time and all together as in
    ``TRAIN_PRESETS["vit_large_384"]`` (RandAugment, mixup 0.2, label
    smoothing 0.1, full remat), against JAX's step with its own draws fed
    in: loss, accuracy (the argmax of the mixed labels), grad_norm, the
    parameters and both moments."""
    kw = RECIPES[recipe]
    ra = kw["augment"] == "randaugment"
    rtol_loss, rtol_norm, rtol_moment = (
        (RTOL_LOSS_RA, RTOL_NORM_RA, RTOL_MOMENT_RA) if ra
        else (RTOL_LOSS, RTOL_NORM, RTOL_MOMENT))
    (jstep, _, jstate), (step, _, state), rng = _start(**kw)
    base_rng = jax.random.PRNGKey(5)
    for t in range(3):
        batch = {"image": rng.integers(0, 256, (8, 40, 40, 3),
                                       dtype=np.uint8),
                 "label": rng.integers(0, 6, 8).astype(np.int32)}
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        augs, mixes = replay_recipe_draws(
            base_rng, t, 2, 4, rand_augment=ra,
            mixup_alpha=kw.get("mixup_alpha", 0.0))
        state, m = step(state, batch, draws=augs, mixup_draws=mixes)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=rtol_loss)
        assert float(m["accuracy"]) == float(jm["accuracy"])
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=rtol_norm)
        _assert_trees_close(to_jax_params(state["params"]), jstate["params"],
                            f"params step {t}", atol=ATOL_PARAMS)
        ref = _jax_opt_dict(jstate["opt_state"])
        got = opt_state_to_jax(state["opt_state"])
        for key in ("mu", "nu"):
            _assert_trees_close(got[key], ref[key], f"{key} step {t}",
                                rtol_of_max=rtol_moment)


def test_attention_dropout_builds_at_head_dim_64():
    cfg = TrainConfig(preset=PRESET, bf16=False, attn_dropout=0.1)
    init_fn, train_step, _ = make_classifier_step_fns(cfg, device="cpu")
    assert callable(init_fn) and callable(train_step)
