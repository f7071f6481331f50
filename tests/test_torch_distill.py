"""DeiT distillation in the port (``train/train_step.py``, `return_heads=`
of ``models/classifier.py`` and ``models/heads.py``) against the JAX
package's ``make_classifier_step_fns`` on the CPU, step for step.

The student is ``deit_test_8_32`` (CLS + DIST tokens, 2 layers, D = 32,
head_dim 16) with seeded random heads; the teacher a ``vit_test_8_32``
classifier (or a distilled ``deit_test_8_32`` one) with a seeded non-zero
head, written as an orbax checkpoint for JAX and a port checkpoint for the
port from the same numpy arrays (``models/bridge.py``). With augmentation
the port is fed JAX's own draws, as ``test_torch_train.py`` feeds them.
Limits are the fp32 recipes' of ``test_torch_train.py``: loss 1e-5
relative, moments 5e-5 of each leaf's largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.models.classifier import (
    apply_image_classifier as jax_apply_image_classifier,
)
from arsvt_tpu.models.classifier import (
    init_image_classifier as jax_init_image_classifier,
)
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu.train.config import resolve_backbone as jax_resolve_backbone
from arsvt_tpu.train.train_step import (
    make_classifier_step_fns as jax_make_step_fns,
)
from arsvt_tpu.utils.flops import (
    train_gflops_per_image as jax_train_gflops_per_image,
)
from arsvt_tpu_torch.core.dtypes import named_leaves
from arsvt_tpu_torch.models.bridge import (
    from_jax_params,
    opt_state_from_jax,
    opt_state_to_jax,
    to_jax_params,
)
from arsvt_tpu_torch.models.classifier import apply_image_classifier
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.serving.loading import load_inference_bundle
from arsvt_tpu_torch.train import train_step as train_step_module
from arsvt_tpu_torch.train.checkpoint import CheckpointManager
from arsvt_tpu_torch.train.config import TrainConfig, resolve_backbone
from arsvt_tpu_torch.train.optim import init_opt_state
from arsvt_tpu_torch.train.train_step import make_classifier_step_fns
from arsvt_tpu_torch.train.trainer import Trainer
from test_torch_train import (
    ATOL_PARAMS,
    RTOL_LOSS,
    RTOL_MOMENT,
    RTOL_NORM,
    _assert_trees_close,
    _jax_opt_dict,
    replay_recipe_draws,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

STUDENT = "deit_test_8_32"
TEACHER = "vit_test_8_32"


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _seeded_heads(tree, seed):
    """Seeded heads giving logits of a few units (a zero head gives every
    teacher logit 0: uniform soft targets, class 0 as every hard one)."""
    rng = np.random.default_rng(seed)
    for name, head in tree["classifier"].items():
        d, c = head["kernel"].shape
        tree["classifier"][name] = {
            "kernel": (rng.standard_normal((d, c)) * 3 * d ** -0.5).astype(
                np.float32),
            "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    return tree


def write_teacher(root, preset=TEACHER, seed=3, **over) -> str:
    """The same seeded teacher as an orbax checkpoint (JAX) in root/jax
    and a port checkpoint in root/port; returns root."""
    jcfg = JaxTrainConfig(preset=preset, bf16=False, **over)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_image_classifier(
        jax.random.PRNGKey(seed), jax_resolve_backbone(jcfg),
        jcfg.num_classes))
    tree = _seeded_heads(tree, seed)
    mgr = JaxCheckpoints(f"{root}/jax", jcfg)
    mgr.save(0, {"params": jax.tree_util.tree_map(jnp.asarray, tree)})
    mgr.wait()
    mgr.close()
    cfg = TrainConfig.from_json(jcfg.to_json())
    params = from_jax_params(tree, resolve_backbone(cfg))
    CheckpointManager(f"{root}/port", cfg).save(
        0, {"params": params, "opt_state": init_opt_state(params),
            "step": 0})
    return str(root)


def _start(teacher_root, **over):
    """Both packages' distillation step functions and states from the
    same JAX init with seeded CLS and DIST heads."""
    kw = dict(preset=STUDENT, batch_size=8, bf16=False, warmup_steps=1,
              fused_adamw=True, canvas=40, **over)
    jinit, jstep, _ = jax_make_step_fns(JaxTrainConfig(
        **kw, distill_teacher=f"{teacher_root}/jax"))
    _, step, _ = make_classifier_step_fns(
        TrainConfig(**kw, distill_teacher=f"{teacher_root}/port"),
        device="cpu")
    jstate = jinit(jax.random.PRNGKey(0))
    tree = _seeded_heads(jax.tree_util.tree_map(np.asarray,
                                                jstate["params"]), 11)
    jstate["params"] = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = BackboneConfig(**_student_fields())
    state = {"params": from_jax_params(tree, cfg),
             "opt_state": opt_state_from_jax(
                 _jax_opt_dict(jstate["opt_state"]), cfg),
             "step": 0}
    return (jstep, jstate), (step, state)


def _student_fields():
    from arsvt_tpu_torch.models.registry import get_preset

    bb = get_preset(STUDENT)
    return {f: getattr(bb, f) for f in ("image_size", "patch_size",
                                        "embed_dim", "depth", "num_heads",
                                        "mlp_dim", "distilled")}


CASES = {
    "accum1": dict(grad_accum=1),
    "accum2": dict(grad_accum=2),
    "crop_flip_mixup": dict(grad_accum=2, augment="crop_flip",
                            mixup_alpha=0.2, label_smoothing=0.1),
}


def _batches(augment="none"):
    """The three batches of batch 8 the step tests take."""
    size = 40 if augment != "none" else 32
    rng = np.random.default_rng(7)
    return [{"image": rng.integers(0, 256, (8, size, size, 3),
                                   dtype=np.uint8),
             "label": rng.integers(0, 6, 8).astype(np.int32)}
            for _ in range(3)]


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """A ViT and a DeiT teacher whose seeds spread their argmax over the
    test batches: held to at least two classes, since a teacher with one
    answer would test the hard loss on a constant target."""
    root = tmp_path_factory.mktemp("teachers")
    out = {"vit": write_teacher(root / "vit", seed=6),
           "deit": write_teacher(root / "deit", preset=STUDENT, seed=5)}
    images = np.concatenate([b["image"] for b in _batches()])
    for root_dir in out.values():
        params, cfg = load_inference_bundle(f"{root_dir}/port")
        answers = apply_image_classifier(
            params, torch.from_numpy(images).float() / 255,
            resolve_backbone(cfg), 6).argmax(-1)
        assert len(set(answers.tolist())) >= 2, answers
    return out


def _run_three_steps(teacher_root, mode, **over):
    (jstep, jstate), (step, state) = _start(teacher_root, distillation=mode,
                                            **over)
    accum = over.get("grad_accum", 1)
    augment = over.get("augment", "none")
    base_rng = jax.random.PRNGKey(2)
    for t, batch in enumerate(_batches(augment)):
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        draws = mixes = None
        if augment != "none":
            draws, mixes = replay_recipe_draws(
                base_rng, t, accum, 8 // accum, rand_augment=False,
                mixup_alpha=over.get("mixup_alpha", 0.0))
        state, m = step(state, batch, draws=draws, mixup_draws=mixes)
        assert set(m) == set(jm) == {"loss", "accuracy", "loss_distill",
                                     "grad_norm"}
        for key in ("loss", "loss_distill"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL_LOSS, err_msg=key)
        assert float(m["accuracy"]) == float(jm["accuracy"])
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_NORM)
        _assert_trees_close(to_jax_params(state["params"]), jstate["params"],
                            f"params step {t}", atol=ATOL_PARAMS)
        ref = _jax_opt_dict(jstate["opt_state"])
        got = opt_state_to_jax(state["opt_state"])
        for key in ("mu", "nu"):
            _assert_trees_close(got[key], ref[key], f"{key} step {t}",
                                rtol_of_max=RTOL_MOMENT)
    return state


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_distillation_steps_match_jax(teachers, mode, case):
    """3 steps of batch 8 (as 1 or 2 microbatches; crop/flip on a 40
    canvas with mixup 0.2 and label smoothing 0.1, JAX's draws fed in),
    fp32, fused AdamW, warmup 1, from a ViT teacher: loss, loss_distill,
    accuracy (on the mean of the heads, against the argmax of the mixed
    labels), grad_norm, the parameters and both moments."""
    _run_three_steps(teachers["vit"], mode, **CASES[case])


def test_a_distilled_teacher_averages_its_heads(teachers):
    """A DeiT teacher answers the mean of its CLS and DIST heads, in both
    packages: the soft steps agree as with a ViT teacher."""
    _run_three_steps(teachers["deit"], "soft", grad_accum=2,
                     distill_temperature=2.0, distill_alpha=0.7)


def _both_errors(jax_kw, port_kw):
    with pytest.raises(Exception) as ref:
        jax_make_step_fns(JaxTrainConfig(**jax_kw))
    with pytest.raises(Exception) as got:
        make_classifier_step_fns(TrainConfig(**port_kw), device="cpu")
    assert type(got.value) is type(ref.value) is ValueError
    assert str(got.value) == str(ref.value)
    return str(got.value)


@pytest.mark.parametrize("error", ["mode", "student", "no_teacher",
                                   "classes", "image_size"])
def test_validation_errors_match_jax(tmp_path, error):
    """Each of JAX's checks, with its exception type and message: the
    mode, a non-distilled student, no teacher, a teacher with another
    class count or image size."""
    kw = dict(preset=STUDENT, bf16=False, distillation="soft")
    teacher = {"classes": dict(num_classes=5),
               "image_size": dict(image_size=40)}.get(error)
    if teacher is not None:
        root = write_teacher(tmp_path, **teacher)
        jax_kw = dict(kw, distill_teacher=f"{root}/jax")
        port_kw = dict(kw, distill_teacher=f"{root}/port")
    else:
        kw.update({"mode": dict(distillation="bogus", distill_teacher="t"),
                   "student": dict(preset=TEACHER, distill_teacher="t"),
                   "no_teacher": {}}[error])
        jax_kw = port_kw = kw
    msg = _both_errors(jax_kw, port_kw)
    assert {"mode": "must be", "student": "distilled (DeiT)",
            "no_teacher": "requires distill_teacher",
            "classes": "teacher has 5 classes",
            "image_size": "teacher image_size 40"}[error] in msg


def test_the_teacher_is_frozen(teachers, monkeypatch):
    """The teacher the step holds takes no gradient and keeps its values
    over two steps, on the device of the step, as loaded from its
    checkpoint (params only)."""
    held = {}
    load = train_step_module._load_teacher

    def keep(*args):
        held["params"], held["cfg"] = load(*args)
        held["before"] = {k: t.clone()
                          for k, t in named_leaves(held["params"])}
        return held["params"], held["cfg"]

    monkeypatch.setattr(train_step_module, "_load_teacher", keep)
    (_, _), (step, state) = _start(teachers["vit"], distillation="hard",
                                   grad_accum=2)
    rng = np.random.default_rng(9)
    for _ in range(2):
        state, m = step(state, {
            "image": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
            "label": rng.integers(0, 6, 8)})
        assert np.isfinite(float(m["loss_distill"]))
    for name, t in named_leaves(held["params"]):
        assert not t.requires_grad and t.grad is None, name
        assert t.device.type == "cpu"
        assert torch.equal(t, held["before"][name]), name
    saved, _ = load_inference_bundle(f"{teachers['vit']}/port")
    for name, t in named_leaves(saved):
        assert torch.equal(t, held["before"][name]), name


def test_trainer_rows_carry_loss_distill_and_tflops(teachers, tmp_path):
    """`Trainer` on the distillation step: each train row carries a finite
    loss_distill, and tflops = images_per_sec x JAX's
    train_gflops_per_image (the student alone) / 1e3."""
    kw = dict(preset=STUDENT, batch_size=8, bf16=False, warmup_steps=1,
              distillation="soft", log_every=1, eval_every=10**9,
              checkpoint_every=10**9, checkpoint_dir=str(tmp_path / "ck"))
    trainer = Trainer(TrainConfig(**kw,
                                  distill_teacher=f"{teachers['vit']}/port"),
                      device="cpu")
    rng = np.random.default_rng(10)
    batches = iter([{"image": rng.integers(0, 256, (8, 32, 32, 3),
                                           dtype=np.uint8),
                     "label": rng.integers(0, 6, 8)} for _ in range(2)])
    row = trainer.fit(batches, steps=2)
    assert np.isfinite(row["loss_distill"]) and row["loss_distill"] > 0
    gflops = jax_train_gflops_per_image(JaxTrainConfig(
        **kw, distill_teacher=f"{teachers['vit']}/jax"))
    assert row["tflops"] == row["images_per_sec"] * gflops / 1e3 > 0


def _heads_case(name, distilled):
    fields = {"d64": dict(image_size=32, patch_size=8, embed_dim=128,
                          depth=2, num_heads=2, mlp_dim=256),
              "d16": dict(image_size=32, patch_size=8, embed_dim=32,
                          depth=2, num_heads=2, mlp_dim=64)}[name]
    jcfg = JaxBackboneConfig(**fields, distilled=distilled)
    tree = _seeded_heads(jax.tree_util.tree_map(
        np.asarray, jax_init_image_classifier(jax.random.PRNGKey(4), jcfg,
                                              6)), 12)
    cfg = BackboneConfig(**fields, distilled=distilled)
    return jcfg, tree, cfg, from_jax_params(tree, cfg)


@pytest.mark.parametrize("name", ["d64", "d16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_return_heads_matches_jax(name, dtype):
    """(logits_cls, logits_dist) in fp32 against JAX's, at head_dim 64 and
    16, within test_torch_vit.py's classifier limits (fp32 atol 2e-5;
    bf16 0.1, each side rounding at its own sites); their mean is the
    averaged answer to the bit."""
    jcfg, tree, cfg, port = _heads_case(name, True)
    x = np.random.default_rng(13).uniform(size=(3, 32, 32, 3)).astype(
        np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jax_apply_image_classifier(params, jnp.asarray(x).astype(jdt),
                                     jcfg, 6, return_heads=True)
    got = apply_image_classifier(port, torch.from_numpy(x).to(tdt), cfg, 6,
                                 return_heads=True)
    atol = 2e-5 if dtype == "float32" else 0.1
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (3, 6)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)
    averaged = apply_image_classifier(port, torch.from_numpy(x).to(tdt),
                                      cfg, 6)
    assert torch.equal(averaged, (got[0] + got[1]) / 2.0)


def test_return_heads_needs_a_distilled_backbone():
    jcfg, tree, cfg, port = _heads_case("d16", False)
    with pytest.raises(ValueError) as ref:
        jax_apply_image_classifier(jax.tree_util.tree_map(jnp.asarray, tree),
                                   jnp.zeros((1, 32, 32, 3)), jcfg, 6,
                                   return_heads=True)
    with pytest.raises(ValueError) as got:
        apply_image_classifier(port, torch.zeros(1, 32, 32, 3), cfg, 6,
                               return_heads=True)
    assert str(got.value) == str(ref.value)
    assert "requires a distilled backbone" in str(got.value)
