"""``chip_smoke.py --generalization detection`` against the JAX package's
``benchmarks/detection_generalization_demo.py`` on the CPU: the
configuration, seeds and data arguments chip_smoke.py runs, each equal to
the demo's as its source states them (read with ``ast``: importing the
demo would import JAX's step and write its artifact), with ``DEMO_AUG`` at
``detection``, the value JAX's two 6,000-step artifacts ran; the data
chain at the demo's arguments on 16 images, to the byte; and three steps
of the demo's configuration at full width (batch 2, fp32) through the
detection augmentation's default warp, JAX's per-image draws fed in,
against JAX's ``make_detector_step_fns``."""

import ast
import dataclasses
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
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
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
DEMO = os.path.join(REPO, "benchmarks", "detection_generalization_demo.py")
# The demo's environment knobs where JAX's 6,000-step artifacts set one;
# every other knob at the default its source gives
ENV = {"DEMO_AUG": "detection"}
DATA_IMAGES = 16
STEPS = 3
STEP_BATCH = 2
# The steps' learning rate stays under peak x STEPS / warm-up (500 steps
# of warm-up), and Adam moves an element whose gradient lies within fp32
# noise of zero by at most ~lr either way: twice that bounds the update's
# difference, beside the fp32 spacing of the parameter it lands on
UPDATE_ATOL = 2 * 3e-4 * STEPS / 500
# The update as a vector, read as the difference of the parameters: each
# side rounds p + update to fp32 once, so an element carries up to one
# spacing of p, ~20% of an update of ~6e-7 on a LayerNorm scale near 1;
# over the whole vector ~1e-3. An update of 0, or of another direction,
# reads 1 or more
RL2_UPDATE = 1e-2
# The first moment after the steps is (1 - b1) times a gradient clipped
# to norm 0.1: the gradient's fp32 summation noise, as the loss's
RL2_MOMENT = RTOL_NORM


def _value(node, names: dict):
    """`test_torch_presets._evaluate` with ENV's knobs."""
    return _evaluate(node, names, ENV)


def _demo() -> dict:
    """What the demo's source sets: its module constants, each named
    call's keywords (in source order), and its seeds."""
    with open(DEMO) as f:
        tree = ast.parse(f.read())
    names = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.isupper()):
            names[node.targets[0].id] = _value(node.value, names)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]

    def called(fn):
        return [c for c in calls if ast.unparse(c.func) == fn]

    def keywords(call):
        return {k.arg: _value(k.value, names) for k in call.keywords}

    assigned = {ast.unparse(n.targets[0]): n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and len(n.targets) == 1}
    (letterbox,) = called("load_letterboxed")
    (target,) = called("ds.padded_target")
    (order,) = called("order_rng.integers")
    return {
        "names": names,
        "train_config": keywords(called("TrainConfig")[0]),
        "coco": [keywords(c) for c in called("make_synthetic_coco")],
        "letterbox": (_value(letterbox.args[1], names),
                      keywords(letterbox)),
        "max_objects": _value(target.args[1], names),
        "init_key": _value(called("init_fn")[0].args[0].args[0], names),
        "step_key": _value(assigned["base_rng"].args[0], names),
        "order_seed": _value(assigned["order_rng"].args[0], names),
        "order_draw": (_value(order.args[0], names),
                       _value(order.args[2], names)),
        "evaluate": [keywords(c) for c in called("evaluate_detector")],
        "batches": [keywords(c) for c in called("batches_of")],
    }


@pytest.mark.parametrize("part", ["constants", "train_config", "defaults",
                                  "data", "seeds", "evaluation", "order"])
def test_chip_smoke_runs_the_jax_demo_configuration(part):
    """chip_smoke.py's DET_GEN_* and `detection_generalization_config`
    hold the demo's constants, every TrainConfig keyword (every other
    field at TrainConfig's default, as in the demo), the data arguments
    and seeds, the evaluation's thresholds and train-split limit, and the
    row order, drawn up front by the demo's call once a step."""
    demo = _demo()
    names = demo["names"]
    port = cs.detection_generalization_config()
    if part == "constants":
        val_images = demo["coco"][1]["images_per_split"]
        assert (names["CANVAS"], names["BS"], names["STEPS"],
                names["TRAIN_IMAGES"], names["MAX_OBJECTS"], val_images) == (
            cs.DET_GEN_CANVAS, cs.DET_GEN_BATCH, cs.DET_GEN_STEPS,
            cs.DET_GEN_TRAIN_IMAGES, cs.DET_GEN_MAX_OBJECTS,
            cs.DET_GEN_VAL_IMAGES) == (96, 64, 6000, 4000, 8, 1024)
    elif part == "train_config":
        kwargs = demo["train_config"]
        assert kwargs["augment"] == "detection"
        assert kwargs["preset"] == cs.DET_GEN_PRESET == "detector_demo_96"
        assert all(getattr(port, k) == v for k, v in kwargs.items()), {
            k: (getattr(port, k), v) for k, v in kwargs.items()}
    elif part == "defaults":
        default = TrainConfig()
        assert not [f.name for f in dataclasses.fields(TrainConfig)
                    if f.name not in demo["train_config"]
                    and getattr(port, f.name) != getattr(default, f.name)]
        assert port.fused_adamw is False and port.grad_accum == 1
    elif part == "data":
        splits = ("train", "valid")
        counts = (cs.DET_GEN_TRAIN_IMAGES, cs.DET_GEN_VAL_IMAGES)
        assert demo["coco"] == [
            {"splits": (split,), "images_per_split": n,
             "seed": seed, **cs.DET_GEN_COCO}
            for split, n, seed in zip(splits, counts, cs.DET_GEN_DATA_SEEDS)]
        assert demo["letterbox"] == (cs.DET_GEN_CANVAS, {
            "records": "ds.records", "dtype": "np.uint8"})
        assert demo["max_objects"] == cs.DET_GEN_MAX_OBJECTS
    elif part == "seeds":
        assert (demo["init_key"], demo["step_key"], demo["order_seed"]) == (
            cs.DET_GEN_INIT_SEED, cs.DET_GEN_STEP_SEED,
            cs.DET_GEN_ORDER_SEED) == (0, 1, 2)
    elif part == "evaluation":
        want = {"num_classes": 6, **cs.DET_GEN_THRESHOLDS}
        assert demo["evaluate"] == [want, want]
        assert port.num_classes == want["num_classes"]
        # the val split whole, then the train split's first images
        assert demo["batches"] == [
            {}, {"limit": cs.DET_GEN_TRAIN_EVAL_IMAGES}]
    else:
        low, size = demo["order_draw"]
        assert (low, size) == (0, cs.DET_GEN_BATCH)
        got = cs.detection_generalization_order(cs.DET_GEN_TRAIN_IMAGES)
        assert got.shape == (cs.DET_GEN_STEPS, cs.DET_GEN_BATCH)
        rng = np.random.default_rng(demo["order_seed"])
        for t in range(cs.DET_GEN_STEPS):
            np.testing.assert_array_equal(
                got[t], rng.integers(low, cs.DET_GEN_TRAIN_IMAGES, size))


def _jax_split(root: str, split: str, n: int, seed: int) -> tuple:
    """The demo's chain on JAX's modules, at its arguments but n images."""
    demo = _demo()
    (kw,) = [c for c in demo["coco"] if c["splits"] == (split,)]
    jax_make_synthetic_coco(root, **{**kw, "images_per_split": n})
    assert kw["seed"] == seed
    ds = JaxCocoDataset(os.path.join(root, split))
    images, _ = jax_load_letterboxed([r.path for r in ds.records],
                                     demo["letterbox"][0],
                                     records=ds.records, dtype=np.uint8)
    targets = [ds.padded_target(i, demo["max_objects"])
               for i in range(len(ds))]
    return images, {k: np.stack([t[k] for t in targets])
                    for k in ("boxes", "labels", "mask")}


@pytest.mark.parametrize("split", ["train", "valid"])
def test_data_chain_matches_jax(split, tmp_path, monkeypatch):
    """`detection_generalization_split` (the port's make_synthetic_coco →
    CocoDataset → load_letterboxed → padded_target) against the same chain
    on JAX's modules, PIL decoding on both sides (the card's machine has
    no native decoder): the uint8 pools and the targets equal."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    seed = dict(zip(("train", "valid"), cs.DET_GEN_DATA_SEEDS))[split]
    images, targets = cs.detection_generalization_split(
        str(tmp_path / "port"), split, DATA_IMAGES, seed)
    ref, ref_t = _jax_split(str(tmp_path / "jax"), split, DATA_IMAGES, seed)
    assert images.dtype == np.uint8 and images.shape == (
        DATA_IMAGES, cs.DET_GEN_CANVAS, cs.DET_GEN_CANVAS, 3)
    np.testing.assert_array_equal(images, ref)
    assert set(targets) == set(ref_t)
    for k in targets:
        assert targets[k].dtype == ref_t[k].dtype, k
        np.testing.assert_array_equal(targets[k], ref_t[k], err_msg=k)
    assert targets["mask"].shape == (DATA_IMAGES, cs.DET_GEN_MAX_OBJECTS)
    assert targets["mask"].any()


@pytest.fixture(scope="module")
def three_steps(tmp_path_factory):
    """STEPS steps of the demo's configuration at batch STEP_BATCH in fp32
    on both sides from JAX's init (init key 0, step key 1), each batch
    drawn as the demo draws its rows (order seed 2) from 8 images of its
    train split, JAX's per-image augmentation draws fed to the port.
    Returns each step's metrics, parameters, updates and first moments
    on both sides, as (port, jax) pairs."""
    demo = _demo()
    kw = {**demo["train_config"], "batch_size": STEP_BATCH, "bf16": False}
    images, targets = cs.detection_generalization_split(
        str(tmp_path_factory.mktemp("demo_coco")), "train", 8,
        cs.DET_GEN_DATA_SEEDS[0])
    det = registry.DETECTOR_PRESETS[kw["preset"]]
    with jax.default_matmul_precision("highest"):
        jinit, jstep, _ = jax_make_detector_step_fns(JaxTrainConfig(**kw))
        _, step, _ = make_detector_step_fns(TrainConfig(**kw), device="cpu")
        jstate = jinit(jax.random.PRNGKey(demo["init_key"]))
        state = {"params": bridge.detector_from_jax_params(
                     jax.tree_util.tree_map(np.asarray, jstate["params"]),
                     det),
                 "opt_state": bridge.detector_opt_state_from_jax(
                     _jax_opt_dict(jstate["opt_state"]), det),
                 "step": 0}
        base_rng = jax.random.PRNGKey(demo["step_key"])
        aug = JaxAugConfig(image_size=det.backbone.image_size,
                           warp_variant=kw["warp_variant"])
        order = np.random.default_rng(demo["order_seed"])
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
            state, m = step(state, batch, step_seed=demo["step_key"],
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


@pytest.mark.parametrize("quantity", ["loss", "grad_norm", "first_moment",
                                      "update", "params"])
def test_demo_steps_match_jax(quantity, three_steps):
    """Each step: the loss and its parts (test_torch_detect_train's
    limits), the gradient norm before clipping, Adam's first moment (the
    gradient clipped to 0.1), the update and the parameters after it."""
    for t, rec in enumerate(three_steps):
        port, ref = rec[{"loss": "metrics", "grad_norm": "metrics",
                         "first_moment": "mu"}.get(quantity, quantity)]
        if quantity == "loss":
            for k in ("loss", "loss_ce", "loss_bbox", "loss_giou",
                      "cardinality_error", "loss_triplet"):
                np.testing.assert_allclose(port[k], ref[k], rtol=RTOL_LOSS,
                                           atol=1e-7, err_msg=f"{k} step {t}")
        elif quantity == "grad_norm":
            # raw norms run far above the clip, so every step clips
            assert ref["grad_norm"] > 0.1
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
