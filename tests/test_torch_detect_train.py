"""The port's detector train and eval steps against the JAX package's
``make_detector_step_fns`` on the CPU, step for step, at the
``detector_test`` preset (DeiT backbone 32 wide, head_dim 16; 5 queries,
2 decoder layers, aux loss on), fp32, no dropout, no augmentation.

Both sides start from the same weights and optimizer state (carried over
by the bridge) and take the same batches. JAX matches on the device with
its Jonker-Volgenant solver, the port with scipy on the host: with
continuous random costs the optimum is unique, so both pick the same
assignment and the losses agree to fp32 summation noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax._src.transform as optax_transform
import pytest
import torch

from arsvt_tpu.evaluation.detect import (
    evaluate_detector as jax_evaluate_detector,
)
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu.train.detect_step import (
    make_detector_step_fns as jax_make_step_fns,
)
from arsvt_tpu.train.optim import _find_state
from arsvt_tpu_torch.core.dtypes import tree_leaves
from arsvt_tpu_torch.evaluation.detect import evaluate_detector
from arsvt_tpu_torch.models import bridge
from arsvt_tpu_torch.models.registry import get_detector_preset
from arsvt_tpu_torch.train.config import TrainConfig
from arsvt_tpu_torch.train.detect_step import make_detector_step_fns

torch.set_num_threads(1)  # tier-1 runs several xdist workers

LR = 1e-4
# fp32 on both sides, the same arithmetic in other summation orders; the
# matched pairs are the same, so the loss parts differ by fp32 noise:
RTOL_LOSS = 1e-5
RTOL_NORM = 1e-4
# the parameters after the steps, as one vector: relative L2
RL2_PARAMS = 1e-4
# Adam's first updates are close to lr * sign(g): an element whose
# gradient lies within fp32 noise of zero moves differently, by at most
# ~lr (the classifier step's bound).
ATOL_PARAMS = LR
# eval outputs: one fp32 forward, logits and boxes of magnitude <= 5
ATOL_OUT = 1e-5

KW = dict(preset="detector_test", task="detect", batch_size=8, grad_accum=2,
          augment="none", bf16=False, warmup_steps=1, attn_dropout=0.0,
          fused_adamw=True, learning_rate=LR)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
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


def _batch(rng, n=8, m=6, size=32):
    lo = rng.uniform(0.05, 0.6, (n, m, 2))
    wh = rng.uniform(0.1, 0.35, (n, m, 2))
    return {
        "image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
        "boxes": np.concatenate([lo, lo + wh], -1).astype(np.float32),
        # three classes: the batch-hard triplet finds positives
        "labels": rng.integers(0, 3, (n, m)).astype(np.int32),
        "mask": np.arange(m)[None, :] < rng.integers(1, m + 1, (n, 1)),
    }


def _start(**over):
    kw = dict(KW, **over)
    jinit, jstep, jeval = jax_make_step_fns(JaxTrainConfig(**kw))
    _, step, eval_step = make_detector_step_fns(TrainConfig(**kw),
                                                device="cpu")
    jstate = jinit(jax.random.PRNGKey(0))
    cfg = get_detector_preset("detector_test")
    state = {
        "params": bridge.detector_from_jax_params(
            jax.tree_util.tree_map(np.asarray, jstate["params"]), cfg),
        "opt_state": bridge.detector_opt_state_from_jax(
            _jax_opt_dict(jstate["opt_state"]), cfg),
        "step": 0,
    }
    return (jstep, jeval, jstate), (step, eval_step, state)


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x)) for x in
                           jax.tree_util.tree_leaves(tree)])


def test_three_train_steps_eval_and_evaluate_detector_match_jax():
    """Batch 8 as 2 microbatches, 3 steps (step 0 has lr 0): loss and every
    part, grad_norm, the parameters and the counts; then eval_step with a
    pad row and evaluate_detector over two batches."""
    (jstep, jeval, jstate), (step, eval_step, state) = _start()
    rng = np.random.default_rng(0)
    base_rng = jax.random.PRNGKey(1)
    for t in range(3):
        batch = _batch(rng)
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        state, m = step(state, batch)
        assert set(m) == set(jm) == {
            "loss", "loss_ce", "loss_bbox", "loss_giou", "cardinality_error",
            "loss_triplet", "grad_norm"}
        for k in jm:
            if k != "grad_norm":
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=RTOL_LOSS, atol=1e-7,
                                           err_msg=f"{k} step {t}")
        assert float(jm["loss_triplet"]) > 0.0
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_NORM)
        got = bridge.detector_to_jax_params(state["params"])
        a, b = _flat(got), _flat(jstate["params"])
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= RL2_PARAMS
        np.testing.assert_allclose(a, b, atol=ATOL_PARAMS, rtol=0)
        opt = bridge.detector_opt_state_to_jax(state["opt_state"])
        for key in ("count", "adam_count", "schedule_count"):
            assert int(opt[key]) == t + 1

    evs = [dict(_batch(rng), valid=(np.arange(8) < 7).astype(np.int32)),
           _batch(rng)]
    je = jeval(jstate["params"], jax.tree_util.tree_map(jnp.asarray, evs[0]))
    e = eval_step(state["params"], evs[0])
    assert int(e["count"]) == int(je["count"]) == 7
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou",
              "cardinality_error", "total"):
        np.testing.assert_allclose(float(e[k]), float(je[k]),
                                   rtol=RTOL_LOSS, atol=1e-7, err_msg=k)
    for k in ("class_logits", "boxes_cxcywh"):
        np.testing.assert_allclose(e["outputs"][k].numpy(),
                                   np.asarray(je["outputs"][k]),
                                   atol=ATOL_OUT, err_msg=k)

    ref = jax_evaluate_detector(
        jeval, jstate["params"],
        [jax.tree_util.tree_map(jnp.asarray, b) for b in evs],
        num_classes=6, conf_threshold=0.2)
    res = evaluate_detector(eval_step, state["params"], evs, num_classes=6,
                            conf_threshold=0.2)
    assert set(res) == set(ref)
    assert res["total_predictions"] == ref["total_predictions"] > 0
    assert res["class_prediction_counts"] == ref["class_prediction_counts"]
    assert res["per_class"] == pytest.approx(ref["per_class"], abs=1e-6)
    for k in ("loss", "mAP", "AP50", "AP75", "predictions_per_image",
              "loss_ce", "loss_bbox", "loss_giou", "total"):
        np.testing.assert_allclose(res[k], ref[k], rtol=RTOL_LOSS,
                                   atol=1e-7, err_msg=k)


def test_average_precision_matches_jax_on_fixed_detections():
    from arsvt_tpu.evaluation.detect import (
        average_precision as jax_average_precision,
    )
    from arsvt_tpu_torch.evaluation.detect import average_precision

    rng = np.random.default_rng(4)
    preds, gts = [], []
    for _ in range(5):
        gb = rng.uniform(0, 0.5, (4, 2))
        g = {"boxes": np.concatenate([gb, gb + 0.3], -1),
             "labels": rng.integers(0, 3, 4),
             "iscrowd": np.array([0, 0, 0, 1])}
        jitter = rng.normal(0, 0.03, (4, 4))
        p = {"boxes": g["boxes"] + jitter, "scores": rng.random(4),
             "labels": np.where(rng.random(4) < 0.8, g["labels"], 0)}
        preds.append(p)
        gts.append(g)
    ref = jax_average_precision(preds, gts, num_classes=3)
    got = average_precision(preds, gts, num_classes=3)
    assert got == ref and got["mAP"] > 0


def test_dropout_and_augment_step_runs_and_repeats():
    """The reference recipe's stochastic parts on: detection augmentation
    on a 40 canvas, residual and attention dropout 0.1. The same state,
    batch and step seed give the same step twice."""
    kw = dict(KW, augment="detection", canvas=40, attn_dropout=0.1)
    init, step, _ = make_detector_step_fns(TrainConfig(**kw), device="cpu")
    batch = _batch(np.random.default_rng(5), size=40)
    base = init()
    losses = []
    for _ in range(2):
        _, m = step(_clone(base), batch, step_seed=3)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    _, m = step(_clone(base), batch, step_seed=4)
    assert float(m["loss"]) != losses[0]


def _clone(state):
    from arsvt_tpu_torch.core.dtypes import tree_map

    def copy(x):
        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    return {"params": tree_map(copy, state["params"]),
            "opt_state": tree_map(copy, state["opt_state"]),
            "step": state["step"]}


@pytest.mark.parametrize("override,err", [
    (dict(augment="crop_flip"), ValueError),
    (dict(task="classify"), ValueError),
    (dict(augment="detection", warp_variant="cubic"), KeyError),
    (dict(remat=True, remat_policy="some"), ValueError),
])
def test_wrong_configs_raise(override, err):
    with pytest.raises(err):
        make_detector_step_fns(TrainConfig(**dict(KW, **override)),
                               device="cpu")


@pytest.mark.parametrize("variant", ["shear_matmul", "taps"])
def test_augmented_steps_match_jax(variant):
    """2 steps with the detection augmentation on a 40 canvas through
    `variant`'s warp (``taps``: JAX's exact gather resampler) and full
    remat, JAX's per-image draws fed in: loss and parts, grad_norm and
    the parameters within this file's limits."""
    from arsvt_tpu.data.augment import DetectionAugmentConfig as JaxAug
    from test_torch_detect_augment import _jax_draws, _stack_draws

    kw = dict(augment="detection", canvas=40, warp_variant=variant,
              remat=True)
    (jstep, _, jstate), (step, _, state) = _start(**kw)
    jcfg = JaxAug(image_size=32, warp_variant=variant)
    rng = np.random.default_rng(7)
    base_rng = jax.random.PRNGKey(3)
    for t in range(2):
        batch = _batch(rng, size=40)
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        step_rng = jax.random.fold_in(base_rng, t)
        draws = []
        for a in range(2):
            _, aug_rng = jax.random.split(jax.random.fold_in(step_rng, a))
            draws.append(_stack_draws([_jax_draws(k, jcfg) for k in
                                       jax.random.split(aug_rng, 4)]))
        state, m = step(state, batch, draws=draws)
        for k in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=RTOL_LOSS, atol=1e-7,
                                       err_msg=f"{k} step {t}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_NORM)
        a, b = (_flat(bridge.detector_to_jax_params(state["params"])),
                _flat(jstate["params"]))
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= RL2_PARAMS


def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_detector_step_fns(TrainConfig(**KW))


def test_detector_opt_state_bridge_round_trip():
    from arsvt_tpu.train import optim as jax_optim
    from arsvt_tpu.models.detector import init_detector as jax_init
    from arsvt_tpu.models.registry import DETECTOR_PRESETS as JAX_PRESETS

    jparams = jax_init(jax.random.PRNGKey(0), JAX_PRESETS["detector_test"])
    opt = jax_optim.make_optimizer(JaxTrainConfig(**KW))
    d = _jax_opt_dict(jax_optim.set_lr_scale(opt.init(jparams), 0.49))
    cfg = get_detector_preset("detector_test")
    back = bridge.detector_opt_state_to_jax(
        bridge.detector_opt_state_from_jax(d, cfg))
    assert float(back["lr_scale"]) == pytest.approx(0.49)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(d)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    bad = dict(d, mu={"backbone": d["mu"]["backbone"]})
    with pytest.raises(ValueError, match="keys"):
        bridge.detector_opt_state_from_jax(bad, cfg)


@pytest.mark.parametrize("policy", ["full", "dots", "names", "all_but_mlp",
                                    "mlp_tail"])
def test_step_under_each_remat_policy_matches_jax(policy):
    """Two steps with ``remat=True`` under `policy` on both sides (the DeiT
    backbone's blocks rematerialised; head_dim 16 on the head-major
    attention): loss and parts, grad_norm and the parameters within this
    file's limits of JAX's; the port's step without remat from the same
    state gives the same loss and update to the bit."""
    (jstep, _, jstate), (step, _, state) = _start(remat=True,
                                                  remat_policy=policy)
    _, plain_step, _ = make_detector_step_fns(TrainConfig(**KW),
                                              device="cpu")
    plain = _clone(state)
    rng = np.random.default_rng(3)
    base_rng = jax.random.PRNGKey(2)
    for t in range(2):
        batch = _batch(rng)
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        state, m = step(state, batch)
        plain, pm = plain_step(plain, batch)
        assert float(m["loss"]) == float(pm["loss"])
        for a, b in zip(tree_leaves(state["params"]),
                        tree_leaves(plain["params"])):
            assert torch.equal(a, b)
        for k in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=RTOL_LOSS, atol=1e-7,
                                       err_msg=f"{k} step {t}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_NORM)
    a, b = (_flat(bridge.detector_to_jax_params(state["params"])),
            _flat(jstate["params"]))
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= RL2_PARAMS
