"""``chip_smoke.py --generalization reference`` against the JAX package's
``benchmarks/recipe_ablation.py`` row ``bs64_lr3e4`` on the CPU: the
configuration, seeds, data arguments, log cadence and evaluation
chip_smoke.py runs, each equal to what the ablation's source states (read
with ``ast``: importing it would import JAX's step, and set JAX's
compilation cache), with the data chain of
``benchmarks/reference_recipe_demo.py``'s ``load_split``; every field of
the port's `TrainConfig` against JAX's ``TRAIN_PRESETS["deit_detector_ref"]``
under the ablation's overrides; the floors against JAX's rows; the data
chain at 8 images a split, to the byte; and two full-width
``deit_detector_ref`` steps of the recipe (fp32, dropout 0 on both
sides, triplet on, JAX's augmentation draws fed in) against JAX's
``make_detector_step_fns``."""

import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from arsvt_tpu.data import native_loader as jax_native
from arsvt_tpu.data.augment import DetectionAugmentConfig as JaxAugConfig
from arsvt_tpu.data.coco import CocoDataset as JaxCocoDataset
from arsvt_tpu.data.pipeline import load_letterboxed as jax_load_letterboxed
from arsvt_tpu.data.synthetic import (
    make_synthetic_coco as jax_make_synthetic_coco,
)
from arsvt_tpu.models import registry as jax_registry
from arsvt_tpu.train.config import TRAIN_PRESETS as JAX_TRAIN_PRESETS
from arsvt_tpu.train.detect_step import (
    make_detector_step_fns as jax_make_detector_step_fns,
)
from arsvt_tpu_torch.data import native_loader
from arsvt_tpu_torch.models import bridge, registry
from arsvt_tpu_torch.train.config import TrainConfig
from arsvt_tpu_torch.train.detect_step import make_detector_step_fns
from test_torch_detect_augment import _jax_draws, _stack_draws
from test_torch_detect_train import (
    RL2_PARAMS,
    RTOL_LOSS,
    RTOL_NORM,
    _flat,
    _jax_opt_dict,
)
from test_torch_presets import _evaluate

torch.set_num_threads(1)  # tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABLATION = os.path.join(REPO, "benchmarks", "recipe_ablation.py")
RECIPE_DEMO = os.path.join(REPO, "benchmarks", "reference_recipe_demo.py")
DATA_IMAGES = 8
STEPS = 2
# The steps' rows: the synthetic set's dominant labels are mostly class 0,
# so at 2 or 4 rows no image holds both a positive and a negative and the
# batch-hard triplet term is 0; 8 rows of the seeded order from the first
# 32 images hold 3 such anchors at the first step and 4 at the second
STEP_IMAGES = 32
STEP_BATCH = 8
# The recipe's learning rate at step t is 3e-4 * t / 500 (the warm-up), and
# Adam moves an element whose gradient lies within fp32 noise of zero by
# at most ~lr either way: twice that bounds the update's difference, beside
# the fp32 spacing of the parameter it lands on
UPDATE_ATOL = 2 * 3e-4 * STEPS / 500
# The update as a vector, read as the difference of the parameters (each
# side rounds p + update to fp32 once); test_torch_detection_demo's limit
RL2_UPDATE = 1e-2
# The first moment after the steps is (1 - b1) times a gradient clipped
# to norm 1: the gradient's fp32 summation noise, as the loss's
RL2_MOMENT = RTOL_NORM


def _value(node, names: dict):
    """`test_torch_presets._evaluate` (every knob at its default), with
    `a ** b` as well."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
        return _value(node.left, names) ** _value(node.right, names)
    return _evaluate(node, names)


def _constants(tree) -> dict:
    names = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.isupper()):
            names[node.targets[0].id] = _value(node.value, names)
    return names


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read())


def _ablation() -> dict:
    """What the ablation's source sets: its constants, the row's overrides,
    the overrides it applies to every row, each named call's keywords, its
    seeds, its log cadence and its evaluation."""
    tree = _parse(ABLATION)
    names = _constants(tree)
    (table,) = [n for n in tree.body if isinstance(n, ast.AnnAssign)
                and n.target.id == "ABLATIONS"]
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]

    def called(fn):
        return [c for c in calls if ast.unparse(c.func) == fn]

    def keywords(call):
        return {k.arg: _value(k.value, names) for k in call.keywords
                if k.arg is not None}

    (steps_arg,) = [c for c in called("ap.add_argument")
                    if _value(c.args[0], names) == "--steps"]
    (default,) = [k.value for k in steps_arg.keywords if k.arg == "default"]
    args = {"args.steps": _value(default, names)}
    (config,) = called("TRAIN_PRESETS['deit_detector_ref'].with_overrides")
    assert [ast.unparse(k.value) for k in config.keywords
            if k.arg is None] == ["overrides"]
    overrides = {k: args.get(v, v) for k, v in keywords(config).items()}
    assigned = {ast.unparse(n.targets[0]): n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and len(n.targets) == 1}
    (order,) = called("order_rng.integers")
    (log_if,) = [n for n in ast.walk(tree) if isinstance(n, ast.If)
                 and "step == 0" in ast.unparse(n.test)]
    assert "print" in ast.unparse(log_if)
    (cadence,) = [n.right for n in ast.walk(log_if.test)
                  if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod)]
    return {
        "names": names,
        "rows": ast.literal_eval(table.value),
        "overrides": overrides,
        "coco": [keywords(c) for c in called("make_synthetic_coco")],
        "init_key": _value(called("init_fn")[0].args[0].args[0], names),
        "step_key": _value(assigned["base_rng"].args[0], names),
        "order_seed": _value(assigned["order_rng"].args[0], names),
        "order_draw": (_value(order.args[0], names),
                       ast.unparse(order.args[1]), ast.unparse(order.args[2])),
        "log_every": _value(cadence, names),
        "logs_first_step": "step == 0" in ast.unparse(log_if.test),
        "evaluate": [keywords(c) for c in called("evaluate_detector")],
        "batches": [keywords(c) for c in called("batches_of")],
    }


def _recipe_demo() -> dict:
    """`load_split`'s arguments in reference_recipe_demo.py."""
    tree = _parse(RECIPE_DEMO)
    names = _constants(tree)
    (split,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "load_split"]
    calls = {ast.unparse(c.func): c for c in ast.walk(split)
             if isinstance(c, ast.Call)}
    letterbox = calls["load_letterboxed"]
    return {"names": names,
            "canvas": _value(letterbox.args[1], names),
            "letterbox": {k.arg: ast.unparse(k.value)
                          for k in letterbox.keywords},
            "max_objects": _value(calls["ds.padded_target"].args[1], names)}


def _jax_config(**kw):
    """JAX's configuration of the row: the preset under the ablation's
    overrides and the row's, then `kw`."""
    abl = _ablation()
    row, _ = abl["rows"][cs.REF_GEN_ABLATION]
    return JAX_TRAIN_PRESETS[cs.REF_GEN_TRAIN_PRESET].with_overrides(
        **abl["overrides"], **row).with_overrides(**kw)


@pytest.mark.parametrize("part", [
    "constants", "overrides", "train_config", "data", "seeds", "log_every",
    "evaluation", "order", "launches"])
def test_chip_smoke_runs_the_jax_ablation_row(part):
    """chip_smoke.py's REF_GEN_* and `reference_generalization_config`
    hold the ablation's constants, the row's overrides and those it
    applies to every row, every TrainConfig field of JAX's configuration,
    the data arguments, seeds and log cadence, the evaluation's
    thresholds and train-split limit, the row order, drawn up front by the
    ablation's call once a step, and a step's launches."""
    abl = _ablation()
    names = abl["names"]
    port = cs.reference_generalization_config()
    if part == "constants":
        demo = _recipe_demo()
        assert (names["STEPS"], names["TRAIN_IMAGES"], names["VAL_IMAGES"],
                demo["canvas"], demo["max_objects"]) == (
            cs.REF_GEN_STEPS, cs.REF_GEN_TRAIN_IMAGES, cs.REF_GEN_VAL_IMAGES,
            cs.REF_GEN_CANVAS, cs.REF_GEN_MAX_OBJECTS) == (
            10_000, 8000, 256, 224, 25)
        assert demo["names"]["CANVAS"] == port.canvas == cs.REF_GEN_CANVAS
    elif part == "overrides":
        row, _ = abl["rows"][cs.REF_GEN_ABLATION]
        assert row == {"batch_size": 64, "learning_rate": 3e-4,
                       "schedule": "cosine"}
        assert cs.REF_GEN_OVERRIDES == {**abl["overrides"], **row}
        assert port.batch_size == cs.REF_GEN_BATCH
        assert port.total_steps == cs.REF_GEN_STEPS
        assert port.max_objects == cs.REF_GEN_MAX_OBJECTS
    elif part == "train_config":
        ref = dataclasses.asdict(_jax_config())
        got = dataclasses.asdict(port)
        assert set(got) == set(ref)
        assert got == ref, {k: (got[k], ref[k]) for k in ref
                            if got[k] != ref[k]}
        # the recipe's defining fields, as JAX's preset and defaults
        # give them: cosine, so the ablation's plateau controller never fires
        assert (port.preset, port.task, port.augment, port.canvas,
                port.attn_dropout, port.w_triplet, port.aux_loss,
                port.weight_decay, port.grad_clip_norm, port.warmup_steps,
                port.bf16, port.warp_variant, port.schedule) == (
            "deit_detector_ref", "detect", "detection", 224, 0.1, 0.6, True,
            1e-4, 1.0, 500, True, "", "cosine")
    elif part == "data":
        splits = ("train", "valid")
        counts = (cs.REF_GEN_TRAIN_IMAGES, cs.REF_GEN_VAL_IMAGES)
        assert abl["coco"] == [
            {"splits": (split,), "images_per_split": n,
             "seed": seed, **cs.REF_GEN_COCO}
            for split, n, seed in zip(splits, counts, cs.REF_GEN_DATA_SEEDS)]
        demo = _recipe_demo()
        assert demo["letterbox"] == {"records": "ds.records",
                                     "dtype": "np.uint8"}
        assert cs.REF_GEN_COCO["image_size"] == demo["canvas"]
    elif part == "seeds":
        assert (abl["init_key"], abl["step_key"], abl["order_seed"]) == (
            cs.REF_GEN_INIT_SEED, cs.REF_GEN_STEP_SEED,
            cs.REF_GEN_ORDER_SEED) == (0, 1, 2)
    elif part == "log_every":
        assert abl["log_every"] == cs.REF_GEN_LOG_EVERY == 500
        assert abl["logs_first_step"]
        assert abl["overrides"]["log_every"] == cs.REF_GEN_LOG_EVERY
        lo, hi = cs.REF_GEN_LATE_STEPS
        assert lo % cs.REF_GEN_LOG_EVERY == 0 and hi == cs.REF_GEN_STEPS
    elif part == "evaluation":
        want = {"num_classes": 6, **cs.REF_GEN_THRESHOLDS}
        assert abl["evaluate"] == [want, want]
        assert port.num_classes == want["num_classes"]
        # the val split whole, then the train split's first images
        assert abl["batches"] == [{}, {"limit": cs.REF_GEN_TRAIN_EVAL_IMAGES}]
        assert cs.REF_GEN_TRAIN_EVAL_IMAGES == 256
    elif part == "order":
        low, n, size = abl["order_draw"]
        assert (low, n, size) == (0, "n", "bs")
        got = cs.detection_generalization_order(
            cs.REF_GEN_TRAIN_IMAGES, cs.REF_GEN_STEPS, cs.REF_GEN_BATCH,
            cs.REF_GEN_ORDER_SEED)
        assert got.shape == (cs.REF_GEN_STEPS, cs.REF_GEN_BATCH)
        rng = np.random.default_rng(abl["order_seed"])
        for t in range(cs.REF_GEN_STEPS):
            np.testing.assert_array_equal(
                got[t], rng.integers(low, cs.REF_GEN_TRAIN_IMAGES,
                                     port.batch_size))
    else:
        # phase 9(c)'s deit_detector_ref step at one microbatch: 12 + 6
        # attention layers, 49 dropout sites each way; an eval forward
        det = registry.DETECTOR_PRESETS["deit_detector_ref"]
        step = cs.reference_generalization_launches(1, 0)
        forward = cs.reference_generalization_launches(0, 1)
        layers = det.backbone.depth + det.head.depth
        assert layers == 18
        assert {k: step[k] for k in (
            "flash_attention_fwd", "flash_attention_bwd",
            "flash_attention_fwd_dropout", "flash_attention_bwd_dropout",
            "fused_adamw", "lap", "dropout_apply")} == {
            "flash_attention_fwd": 18, "flash_attention_bwd": 18,
            "flash_attention_fwd_dropout": 18,
            "flash_attention_bwd_dropout": 18, "fused_adamw": 1, "lap": 1,
            "dropout_apply": 98}
        assert {k: v for k, v in forward.items() if v} == {
            "flash_attention_fwd": 18, "lap": 1,
            **{k: v for k, v in cs.norm_launches(det, forwards=1).items()
               if v}}
        off_path = {"encoder_attention_fwd", "encoder_attention_bwd",
                    "encoder_attention_fwd_savep",
                    "encoder_attention_bwd_savep", "fused_mlp_fwd",
                    "fused_mlp_bwd"}
        assert not off_path & set(step) and not off_path & set(forward)
        assert cs.reference_generalization_launches(10, 3) == {
            k: 10 * step[k] + 3 * forward[k] for k in step}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv", [(), ("--ref-seeds", "11,12"),
                                  ("--ref-seeds", "21,22")])
def test_ref_seeds_replace_only_the_step_and_order_seeds(argv, monkeypatch):
    """``--generalization reference --ref-seeds STEP,ORDER``: without the
    option the run takes the ablation's step and order seeds; with it,
    those two seeds alone change, and the data, its seeds and the init
    seed reach `phase_reference_generalization`'s training as before."""
    abl = _ablation()
    args = ("--generalization", "reference", *argv)
    want = ((abl["step_key"], abl["order_seed"]) if not argv
            else tuple(int(v) for v in argv[1].split(",")))
    assert cs.reference_generalization_seeds(list(args)) == want
    seen = {}

    def pools(prefix, counts, seeds, **split):
        seen["data"] = (counts, seeds, split)
        return {"image": np.zeros((counts[0], 1), np.uint8)}, {}, 0.0

    def order(n, steps, batch, seed):
        seen["order"] = (n, steps, batch, seed)
        return np.zeros((steps, batch), np.int64)

    def train(total, path, tag, cfg, train, order, **kw):
        seen["train"] = (cfg, kw["init_seed"], kw["step_seed"])
        raise _Stop

    monkeypatch.setattr(cs, "detection_pools", pools)
    monkeypatch.setattr(cs, "detection_generalization_order", order)
    monkeypatch.setattr(cs, "train_detection_demo", train)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda t, *a, **k: t)
    with pytest.raises(_Stop):
        cs.phase_reference_generalization("card", *want)
    assert seen["data"] == (
        (cs.REF_GEN_TRAIN_IMAGES, cs.REF_GEN_VAL_IMAGES),
        cs.REF_GEN_DATA_SEEDS,
        {"canvas": cs.REF_GEN_CANVAS, "max_objects": cs.REF_GEN_MAX_OBJECTS,
         "coco": cs.REF_GEN_COCO})
    assert seen["order"] == (cs.REF_GEN_TRAIN_IMAGES, cs.REF_GEN_STEPS,
                             cs.REF_GEN_BATCH, want[1])
    cfg, init_seed, step_seed = seen["train"]
    assert cfg == cs.reference_generalization_config()
    assert (init_seed, step_seed) == (abl["init_key"], want[0])
    # the defaults stay the ablation's
    assert (cs.REF_GEN_STEP_SEED, cs.REF_GEN_ORDER_SEED) == (
        abl["step_key"], abl["order_seed"])


@pytest.mark.parametrize("value", [None, "11", "11,x", "1,2,3", "-1,2"])
def test_ref_seeds_refuse_a_malformed_value(value):
    """`--ref-seeds` takes exactly two non-negative integers."""
    args = ["--generalization", "reference", "--ref-seeds"]
    with pytest.raises(SystemExit):
        cs.reference_generalization_seeds(
            args if value is None else args + [value])


def test_floors_separate_the_jax_rows():
    """The floors sit between JAX's bs64_lr3e4 (the mAP floor at most half
    its mAP) and the best of the rows that did not learn, as
    `reference_generalization_jax` reads them from recipe_ablation.json
    and each row's log."""
    rows = cs.reference_generalization_jax()
    with open(os.path.join(REPO, "recipe_ablation.json")) as f:
        table = json.load(f)
    assert set(rows) == set(cs.REF_GEN_JAX_ROWS)
    for name, row in rows.items():
        for k in ("val_mAP", "val_AP50", "val_AP75", "train_mAP",
                  "train_AP50", "final_loss"):
            assert row[k] == table[name][k]
    learned = rows[cs.REF_GEN_ABLATION]
    assert learned["late_loss_mean"] == pytest.approx(
        np.mean([15.0147, 12.989, 13.875, 13.8205, 12.5991]))
    others = [r for name, r in rows.items() if name != cs.REF_GEN_ABLATION]
    assert max(r["val_mAP"] for r in others) < cs.REF_GEN_MIN_MAP <= (
        learned["val_mAP"] / 2)
    assert max(r["val_AP50"] for r in others) < cs.REF_GEN_MIN_AP50 < (
        learned["val_AP50"])
    assert learned["late_loss_mean"] < cs.REF_GEN_MAX_LATE_LOSS < min(
        r["late_loss_mean"] for r in others)
    assert cs.late_loss_mean([{"step": 7500, "loss": 1.0},
                              {"step": 8000, "loss": 2.0},
                              {"step": 10_000, "loss": 4.0}]) == 3.0
    assert np.isnan(cs.late_loss_mean([{"step": 500, "loss": 1.0}]))


def _jax_split(root: str, split: str, n: int) -> tuple:
    """The ablation's chain on JAX's modules (make_synthetic_coco at its
    arguments but n images, then load_split's), as the sources state it."""
    (kw,) = [c for c in _ablation()["coco"] if c["splits"] == (split,)]
    demo = _recipe_demo()
    jax_make_synthetic_coco(root, **{**kw, "images_per_split": n})
    ds = JaxCocoDataset(os.path.join(root, split))
    images, _ = jax_load_letterboxed([r.path for r in ds.records],
                                     demo["canvas"], records=ds.records,
                                     dtype=np.uint8)
    targets = [ds.padded_target(i, demo["max_objects"])
               for i in range(len(ds))]
    return images, {k: np.stack([t[k] for t in targets])
                    for k in ("boxes", "labels", "mask")}


def _port_split(root: str, split: str, n: int) -> tuple:
    seed = dict(zip(("train", "valid"), cs.REF_GEN_DATA_SEEDS))[split]
    return cs.detection_generalization_split(
        root, split, n, seed, canvas=cs.REF_GEN_CANVAS,
        max_objects=cs.REF_GEN_MAX_OBJECTS, coco=cs.REF_GEN_COCO)


@pytest.mark.parametrize("split", ["train", "valid"])
def test_data_chain_matches_jax(split, tmp_path, monkeypatch):
    """`detection_generalization_split` at the REF_GEN_* arguments (the
    port's make_synthetic_coco → CocoDataset → load_letterboxed →
    padded_target) against the ablation's chain on JAX's modules, PIL
    decoding on both sides (the card's machine has no native decoder): the
    uint8 pools on the 224 canvas and the 25-slot targets equal."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    images, targets = _port_split(str(tmp_path / "port"), split, DATA_IMAGES)
    ref, ref_t = _jax_split(str(tmp_path / "jax"), split, DATA_IMAGES)
    assert images.dtype == np.uint8 and images.shape == (
        DATA_IMAGES, cs.REF_GEN_CANVAS, cs.REF_GEN_CANVAS, 3)
    np.testing.assert_array_equal(images, ref)
    assert set(targets) == set(ref_t)
    for k in targets:
        assert targets[k].dtype == ref_t[k].dtype, k
        np.testing.assert_array_equal(targets[k], ref_t[k], err_msg=k)
    assert targets["mask"].shape == (DATA_IMAGES, cs.REF_GEN_MAX_OBJECTS)
    assert targets["mask"].any()


def _no_dropout(det):
    """`det` with its residual and attention dropout off."""
    return dataclasses.replace(
        det, backbone=dataclasses.replace(det.backbone, dropout=0.0,
                                          attn_dropout=0.0),
        head=dataclasses.replace(det.head, dropout=0.0, attn_dropout=0.0))


def recipe_steps(root: str, **jax_overrides) -> list:
    """STEPS steps of the row's configuration at full width (batch
    STEP_BATCH, fp32, then `jax_overrides`) on both sides from JAX's init
    (init key 0, step key 1), under the dropout the two registries hold,
    each batch drawn as the ablation draws its rows (order seed 2) from
    STEP_IMAGES images of its train split under `root`, JAX's per-image
    augmentation draws fed to the port. Returns each step's metrics,
    parameters, updates and first moments on both sides, as (port, jax)
    pairs."""
    abl = _ablation()
    jcfg = _jax_config(batch_size=STEP_BATCH, bf16=False, **jax_overrides)
    kw = dataclasses.asdict(jcfg)
    images, targets = _port_split(root, "train", STEP_IMAGES)
    det = registry.DETECTOR_PRESETS[cs.REF_GEN_TRAIN_PRESET]
    with jax.default_matmul_precision("highest"):
        jinit, jstep, _ = jax_make_detector_step_fns(jcfg)
        _, step, _ = make_detector_step_fns(TrainConfig(**kw), device="cpu")
        jstate = jinit(jax.random.PRNGKey(abl["init_key"]))
        state = {"params": bridge.detector_from_jax_params(
                     jax.tree_util.tree_map(np.asarray, jstate["params"]),
                     det),
                 "opt_state": bridge.detector_opt_state_from_jax(
                     _jax_opt_dict(jstate["opt_state"]), det),
                 "step": 0}
        base_rng = jax.random.PRNGKey(abl["step_key"])
        aug = JaxAugConfig(image_size=det.backbone.image_size,
                           warp_variant=kw["warp_variant"])
        order = np.random.default_rng(abl["order_seed"])
        out = []
        for t in range(STEPS):
            idx = order.integers(0, len(images), STEP_BATCH)
            batch = {"image": images[idx],
                     **{k: v[idx] for k, v in targets.items()}}
            before = (_flat(bridge.detector_to_jax_params(state["params"])),
                      _flat(jstate["params"]))
            jstate, jm = jstep(jstate,
                               jax.tree_util.tree_map(jnp.asarray, batch),
                               base_rng)
            # one microbatch: the step key's second half, split an image
            _, aug_rng = jax.random.split(jax.random.fold_in(base_rng, t))
            draws = [_stack_draws([_jax_draws(k, aug) for k in
                                   jax.random.split(aug_rng, STEP_BATCH)])]
            state, m = step(state, batch, step_seed=abl["step_key"],
                            draws=draws)
            after = (_flat(bridge.detector_to_jax_params(state["params"])),
                     _flat(jstate["params"]))
            out.append({
                "metrics": ({k: float(v) for k, v in m.items()},
                            {k: float(v) for k, v in jm.items()}),
                "params": after,
                "update": (after[0] - before[0], after[1] - before[1]),
                "mu": (_flat(bridge.detector_to_jax_params(
                           state["opt_state"]["mu"])),
                       _flat(_jax_opt_dict(jstate["opt_state"])["mu"])),
            })
    return out


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    """`recipe_steps` with dropout 0 everywhere on both sides (the
    preset's residual dropout set to 0 in both registries, attention
    dropout 0 in the config: the two packages draw their masks from
    different generators; test_torch_recipe_dropout.py holds the steps
    with the recipe's dropout, JAX's masks replayed)."""
    name = cs.REF_GEN_TRAIN_PRESET
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_registry.DETECTOR_PRESETS, name,
                   _no_dropout(jax_registry.DETECTOR_PRESETS[name]))
        mp.setitem(registry.DETECTOR_PRESETS, name,
                   _no_dropout(registry.DETECTOR_PRESETS[name]))
        return recipe_steps(str(tmp_path_factory.mktemp("ref_coco")),
                            attn_dropout=0.0)


def check_recipe_steps(quantity: str, steps: list) -> None:
    """Each step of `recipe_steps`: the loss and its parts, the triplet
    term among them and not 0 (test_torch_detect_train's limits), the
    gradient norm before clipping, Adam's first moment, the update and
    the parameters after it."""
    for t, rec in enumerate(steps):
        port, ref = rec[{"loss": "metrics", "grad_norm": "metrics",
                         "first_moment": "mu"}.get(quantity, quantity)]
        if quantity == "loss":
            assert ref["loss_triplet"] > 0.0, f"step {t}"
            for k in ("loss", "loss_ce", "loss_bbox", "loss_giou",
                      "cardinality_error", "loss_triplet"):
                np.testing.assert_allclose(port[k], ref[k], rtol=RTOL_LOSS,
                                           atol=1e-7, err_msg=f"{k} step {t}")
        elif quantity == "grad_norm":
            # raw norms run far above the clip at 1, so every step clips
            assert ref["grad_norm"] > 1.0
            np.testing.assert_allclose(port["grad_norm"], ref["grad_norm"],
                                       rtol=RTOL_NORM, err_msg=f"step {t}")
        elif quantity == "first_moment":
            assert np.linalg.norm(port - ref) / np.linalg.norm(ref) <= (
                RL2_MOMENT), f"step {t}"
        elif quantity == "update":
            limit = UPDATE_ATOL + 2 * np.spacing(np.abs(rec["params"][1]))
            assert (np.abs(port - ref) <= limit).all(), (
                f"step {t}: {np.abs(port - ref).max()}")
            if t == 0:  # the warm-up's first learning rate is 0
                assert not ref.any() and not port.any()
            else:
                assert np.linalg.norm(port - ref) / np.linalg.norm(ref) <= (
                    RL2_UPDATE), f"step {t}"
        else:
            assert np.linalg.norm(port - ref) / np.linalg.norm(ref) <= (
                RL2_PARAMS), f"step {t}"


@pytest.mark.parametrize("quantity", ["loss", "grad_norm", "first_moment",
                                      "update", "params"])
def test_recipe_steps_match_jax(quantity, two_steps):
    """`check_recipe_steps` on the steps with dropout 0."""
    check_recipe_steps(quantity, two_steps)
