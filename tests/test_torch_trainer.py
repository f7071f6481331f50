"""The port's training loop and checkpoints (``train/trainer.py``,
``train/checkpoint.py``) and synthetic data (``data/synthetic.py``) on the
CPU: the JAX package's trainer tests (``tests/test_train_integration.py``,
``tests/test_failure_recovery.py``) mirrored on the port, the synthetic
batches against JAX's, and two steps of the port's `Trainer` against the
JAX `Trainer` from the same state."""

import itertools
import os

import jax
import numpy as np
import optax._src.transform as optax_transform
import pytest
import torch

from arsvt_tpu.data.synthetic import (
    synthetic_classification_batches as jax_synthetic_batches,
)
from arsvt_tpu.parallel.mesh import MeshConfig, make_mesh
from arsvt_tpu.train.config import TRAIN_PRESETS as JAX_TRAIN_PRESETS
from arsvt_tpu.train.optim import _find_state
from arsvt_tpu.train.trainer import Trainer as JaxTrainer
from arsvt_tpu.utils.logging import MetricLogger as JaxMetricLogger
from arsvt_tpu_torch.core.dtypes import tree_leaves
from arsvt_tpu_torch.data.synthetic import synthetic_classification_batches
from arsvt_tpu_torch.models.bridge import (
    from_jax_params,
    opt_state_from_jax,
    to_jax_params,
)
from arsvt_tpu_torch.train.checkpoint import (
    CheckpointManager,
    latest_step,
    load_for_eval,
    load_params_for_eval,
    peek_config,
)
from arsvt_tpu_torch.train.config import TRAIN_PRESETS, resolve_backbone
from arsvt_tpu_torch.train.optim import PlateauState
from arsvt_tpu_torch.train.trainer import Trainer
from arsvt_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SMOKE = TRAIN_PRESETS["smoke"]  # vit_test_8_32, batch 16, fp32


def _batches(cfg, seed=0):
    return synthetic_classification_batches(batch_size=cfg.batch_size,
                                            image_size=32, seed=seed)


def _trainer(cfg, **kw):
    return Trainer(cfg, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, image_size=32, seed=0),
    dict(batch_size=3, image_size=40, seed=7, noise=0.1, num_classes=4)])
def test_synthetic_batches_equal_jax_to_the_bit(kw):
    ours, theirs = (synthetic_classification_batches(**kw),
                    jax_synthetic_batches(**kw))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_train_reduces_loss_and_checkpoints(tmp_path):
    cfg = SMOKE.with_overrides(
        total_steps=24, checkpoint_every=12,
        checkpoint_dir=str(tmp_path / "ckpt"), eval_every=10**9, log_every=8)
    tr = _trainer(cfg)
    batches = _batches(cfg)
    first_batch = next(batches)
    _, first_metrics = tr.train_step(tr.init_state(), first_batch)
    first_loss = float(first_metrics["loss"])

    tr.init_state()  # fresh state (the step updated the last in place)
    last = tr.fit(batches)
    assert last["loss"] < first_loss
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_000000012.pt", "step_000000024.pt"]

    # resume restores the exact step and equal eval numbers
    def eval_batches():
        return itertools.islice(_batches(cfg, seed=9), 2)

    e1 = tr.evaluate(eval_batches())
    tr2 = _trainer(cfg)
    assert tr2.maybe_resume() == 24
    e2 = tr2.evaluate(eval_batches())
    assert e1["accuracy"] == e2["accuracy"]
    assert e1["confusion"] == e2["confusion"]
    np.testing.assert_allclose(e1["loss"], e2["loss"], rtol=1e-6)


def test_checkpoint_config_mismatch_rejected(tmp_path):
    cfg = SMOKE.with_overrides(total_steps=2, checkpoint_every=2,
                               checkpoint_dir=str(tmp_path / "ckpt2"),
                               log_every=10**9)
    _trainer(cfg).fit(_batches(cfg))
    # a different architecture must refuse the checkpoint
    bad_cfg = cfg.with_overrides(preset="deit_test_8_32")
    bad_tr = _trainer(bad_cfg)
    bad_tr.init_state()
    mgr = CheckpointManager(bad_cfg.checkpoint_dir, bad_cfg)
    with pytest.raises(ValueError, match="different model config"):
        mgr.restore(bad_tr.state)
    with pytest.raises(ValueError, match="different model config"):
        load_params_for_eval(bad_cfg.checkpoint_dir, bad_cfg,
                             bad_tr.state["params"])
    # the config itself reads back without any state
    assert peek_config(cfg.checkpoint_dir) == cfg
    assert latest_step(cfg.checkpoint_dir) == 2
    assert latest_step(str(tmp_path / "none")) is None
    state, saved = load_for_eval(cfg.checkpoint_dir, cfg,
                                 _trainer(cfg).init_state())
    assert saved == cfg and state["step"] == 2
    params, _ = load_params_for_eval(cfg.checkpoint_dir, cfg,
                                     state["params"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(state["params"])))


def test_plateau_state_survives_resume(tmp_path):
    cfg = SMOKE.with_overrides(
        total_steps=4, checkpoint_every=4, schedule="plateau",
        checkpoint_dir=str(tmp_path / "ck"), eval_every=10**9,
        log_every=10**9)
    tr = _trainer(cfg)
    tr.init_state()
    tr.plateau = PlateauState(scale=0.49, best=1.23, bad_epochs=1)
    tr.fit(_batches(cfg))

    tr2 = _trainer(cfg)
    assert tr2.maybe_resume() == 4
    assert tr2.plateau.scale == 0.49
    assert tr2.plateau.best == 1.23
    assert tr2.plateau.bad_epochs == 1


def test_best_checkpoint_gc_keeps_latest_and_best(tmp_path):
    """Garbage collection keeps the latest `keep` steps for resume and the
    single best for deployment, even when the latest are worse."""
    d = tmp_path / "ck"
    mgr = CheckpointManager(str(d), SMOKE, keep=2, best_metric="val_loss")
    state = _trainer(SMOKE).init_state()
    # best at step 1, then the run overfits (worsening val loss)
    for step, loss in [(1, 0.5), (2, 0.8), (3, 0.9), (4, 1.0)]:
        mgr.save(step, state, metrics={"val_loss": loss})
    # a metric-less periodic save must also survive as the most recent
    mgr.save(5, state)
    mgr.wait()
    assert mgr.latest_step == 5          # resume point survives
    assert mgr.best_step == 1            # best survives GC
    assert sorted(os.listdir(d)) == [f"step_00000000{s}.pt" for s in
                                     (1, 4, 5)]
    restored, _ = mgr.restore(state, step=1)
    assert int(restored["step"]) == int(state["step"])
    # a new manager on the same directory sees the same steps
    again = CheckpointManager(str(d), SMOKE, keep=2, best_metric="val_loss")
    assert (again.latest_step, again.best_step) == (5, 1)


def test_resume_is_bit_equivalent_to_uninterrupted(tmp_path):
    """Crash + resume reproduces the uninterrupted run exactly: the
    optimizer state restores, the step's draws come from the seed and the
    step number, and the data stream fast-forwards past consumed batches
    (train/cli.py::make_data): the parameters after 6 steps are equal."""
    base = SMOKE.with_overrides(batch_size=4, eval_every=10**9,
                                log_every=10**9, seed=3,
                                augment="crop_flip", canvas=40)

    def stream(skip=0):
        return itertools.islice(synthetic_classification_batches(
            batch_size=4, image_size=40, seed=3), skip, None)

    tr_a = _trainer(base.with_overrides(total_steps=6,
                                        checkpoint_every=10**9))
    tr_a.fit(stream())

    ck = str(tmp_path / "ck")
    tr_b = _trainer(base.with_overrides(total_steps=3, checkpoint_every=3,
                                        checkpoint_dir=ck))
    tr_b.fit(stream())
    tr_b2 = _trainer(base.with_overrides(total_steps=6,
                                         checkpoint_every=10**9,
                                         checkpoint_dir=ck))
    start = tr_b2.maybe_resume()
    assert start == 3
    tr_b2.fit(stream(start))
    for a, b in zip(tree_leaves(tr_a.state), tree_leaves(tr_b2.state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_crash_saves_checkpoint(tmp_path):
    cfg = SMOKE.with_overrides(total_steps=20, checkpoint_every=100,
                               log_every=10**9,
                               checkpoint_dir=str(tmp_path / "ck"))
    tr = _trainer(cfg)
    inner = _batches(cfg)

    def crashing_batches():
        for _ in range(7):
            yield next(inner)
        raise RuntimeError("simulated data-source failure")

    with pytest.raises(RuntimeError, match="simulated"):
        tr.fit(crashing_batches())

    # a fresh trainer resumes from the emergency checkpoint
    tr2 = _trainer(cfg)
    assert tr2.maybe_resume() == 7
    last = tr2.fit(inner)
    assert np.isfinite(last["loss"])


def test_evaluate_weights_ragged_batches():
    """val loss is a per-example mean: a 1-image tail batch does not get
    the vote of a full batch."""
    def fake_eval(params, batch):
        b = batch["image"].shape[0]
        return {"loss": torch.tensor(1.0 if b == 4 else 0.0)}

    base = _trainer(SMOKE)
    tr = _trainer(SMOKE, step_fns=(base.init_fn, base.train_step, fake_eval))
    tr.init_state()
    out = tr.evaluate(iter([
        {"image": np.zeros((4, 32, 32, 3), np.float32),
         "label": np.zeros((4,), np.int32)},
        {"image": np.zeros((1, 32, 32, 3), np.float32),
         "label": np.zeros((1,), np.int32)}]))
    np.testing.assert_allclose(out["loss"], 4.0 / 5.0)


@pytest.mark.parametrize("mesh", [dict(mesh_data=8), dict(mesh_model=2)])
def test_a_mesh_raises(mesh):
    """A mesh that one process's ranks cannot cover raises JAX's message
    (a process with no group is a world of one)."""
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        _trainer(SMOKE.with_overrides(**mesh))


class _Recorder(MetricLogger):
    def __init__(self):
        super().__init__(quiet=True)
        self.rows = []

    def log(self, step, metrics, *, prefix=""):
        self.rows.append((step, prefix, dict(metrics)))


class _JaxRecorder(JaxMetricLogger):
    def __init__(self):
        super().__init__(quiet=True)
        self.rows = []

    def log(self, step, metrics, *, prefix=""):
        self.rows.append((step, prefix, dict(metrics)))


def _jax_opt_dict(opt_state):
    adam = _find_state(opt_state, optax_transform.ScaleByAdamState)
    sched = _find_state(opt_state, optax_transform.ScaleByScheduleState)
    return jax.tree_util.tree_map(np.asarray, {
        "count": opt_state.count,
        "lr_scale": opt_state.hyperparams["lr_scale"],
        "adam_count": adam.count, "mu": adam.mu, "nu": adam.nu,
        "schedule_count": sched.count,
    })


def test_two_trainer_steps_match_the_jax_trainer():
    """`fit` for 2 steps on both sides: vit_test_8_32 (the smoke preset,
    fp32, no dropout), the same synthetic batches, the port's state
    bridged from the JAX Trainer's init, a seeded random head (the zero
    head sends no gradient into the backbone). Per step the logged loss to
    1e-5 relative and the grad norm to 1e-5; the final parameters within
    half a learning rate (Adam's first updates are close to lr·sign(g), so
    an element whose gradient lies within fp32 noise of zero moves
    differently: tests/test_torch_train.py's limit)."""
    cfg = SMOKE.with_overrides(total_steps=2, warmup_steps=1, log_every=1,
                               eval_every=10**9, checkpoint_every=10**9)
    jlog, log = _JaxRecorder(), _Recorder()
    jtr = JaxTrainer(JAX_TRAIN_PRESETS["smoke"].with_overrides(
        total_steps=2, warmup_steps=1, log_every=1, eval_every=10**9,
        checkpoint_every=10**9), mesh=make_mesh(MeshConfig(), platform="cpu"),
        logger=jlog)
    jstate = jtr.init_state()
    rng = np.random.default_rng(0)
    d = resolve_backbone(cfg).embed_dim
    jstate["params"]["classifier"]["head"] = {
        "kernel": jax.numpy.asarray(rng.standard_normal((d, 6)) * 0.3,
                                    jax.numpy.float32),
        "bias": jax.numpy.asarray(rng.standard_normal(6) * 0.1,
                                  jax.numpy.float32)}
    bb = resolve_backbone(cfg)
    tr = _trainer(cfg, logger=log)
    tr.state = {
        "params": from_jax_params(
            jax.tree_util.tree_map(np.asarray, jstate["params"]), bb),
        "opt_state": opt_state_from_jax(_jax_opt_dict(jstate["opt_state"]),
                                        bb),
        "step": 0}
    jtr.fit(jax_synthetic_batches(batch_size=16, image_size=32, seed=0))
    tr.fit(_batches(cfg))
    assert [r[0] for r in log.rows] == [r[0] for r in jlog.rows] == [1, 2]
    for (_, _, m), (_, _, jm) in zip(log.rows, jlog.rows):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-5)
    lr = cfg.learning_rate
    got = jax.tree_util.tree_leaves(to_jax_params(tr.state["params"]))
    ref = jax.tree_util.tree_leaves(jtr.state["params"])
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=0.5 * lr)


def _det_batch(rng, n, size=40, m=4):
    lo = rng.uniform(0.05, 0.6, (n, m, 2))
    wh = rng.uniform(0.1, 0.35, (n, m, 2))
    return {"image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "boxes": np.concatenate([lo, lo + wh], -1).astype(np.float32),
            "labels": rng.integers(0, 6, (n, m)).astype(np.int32),
            "mask": np.arange(m)[None, :] < rng.integers(1, m + 1, (n, 1))}


def test_detect_trainer_trains_evaluates_and_checkpoints(tmp_path):
    """task="detect": the reference detector recipe (plateau schedule, aux
    loss, detection augmentation, attention dropout 0.1) at detector_test,
    two steps, eval with val mAP, the plateau update and the final
    checkpoint, then a resume."""
    cfg = TRAIN_PRESETS["deit_detector_ref"].with_overrides(
        preset="detector_test", batch_size=4, canvas=40, max_objects=4,
        bf16=False, total_steps=2, eval_every=2, log_every=1,
        checkpoint_dir=str(tmp_path / "ck"))
    rng = np.random.default_rng(0)
    tr = _trainer(cfg)
    last = tr.fit(iter([_det_batch(rng, 4) for _ in range(2)]),
                  eval_batches_fn=lambda: iter([_det_batch(rng, 4)]))
    assert np.isfinite(last["loss"]) and "loss_giou" in last
    ev = tr.evaluate(iter([_det_batch(rng, 4)]))
    assert {"loss", "loss_ce", "mAP", "AP50", "AP75"} <= set(ev)
    assert np.isfinite(tr.plateau.best)  # the step-2 eval updated it
    assert os.listdir(tmp_path / "ck") == ["step_000000002.pt"]
    assert _trainer(cfg).maybe_resume() == 2
