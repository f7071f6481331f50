"""The port against the JAX package at the presets ``chip_smoke.py`` phase
17 runs on the card: ``vit_tiny_16_224`` (BASELINE config #1, the
``vit_tiny_eval`` train preset), ``vit_small_16_224``, ``vit_demo_8_96``
and ``detector_demo_96``, each at its own width, heads, patch and image
size, on the CPU, fp32, on bridged weights and inputs made from a numpy
seed, JAX under ``default_matmul_precision("highest")``. At head_dim 64
and D % 128 != 0 the port routes attention through #1/#2's plain
versions where JAX's router would take its packed kernel; on the CPU both
run their plain math. Also: ``chip_smoke.py --generalization`` runs
``benchmarks/classification_generalization_demo.py``'s configuration,
read here from that file's source (importing it would import JAX's step
and write its artifact)."""

import ast
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from arsvt_tpu.models import registry as jax_registry
from arsvt_tpu.models.classifier import (
    apply_image_classifier as jax_apply_image_classifier,
)
from arsvt_tpu.models.classifier import (
    init_image_classifier as jax_init_image_classifier,
)
from arsvt_tpu.models.detector import apply_detector as jax_apply_detector
from arsvt_tpu.models.detector import init_detector as jax_init_detector
from arsvt_tpu.objectives import detection_loss as jax_detection_loss
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu.train.detect_step import (
    make_detector_step_fns as jax_make_detector_step_fns,
)
from arsvt_tpu.train.train_step import (
    make_classifier_step_fns as jax_make_step_fns,
)
from arsvt_tpu_torch.models import bridge, registry
from arsvt_tpu_torch.models.classifier import apply_image_classifier
from arsvt_tpu_torch.models.detector import apply_detector
from arsvt_tpu_torch.train import detect_step
from arsvt_tpu_torch.train.config import TRAIN_PRESETS, TrainConfig
from arsvt_tpu_torch.train.detect_step import make_detector_step_fns
from arsvt_tpu_torch.train.train_step import make_classifier_step_fns
from test_torch_detect_train import ATOL_PARAMS as DET_ATOL_PARAMS
from test_torch_detect_train import RL2_PARAMS as DET_RL2_PARAMS
from test_torch_detect_train import RTOL_LOSS as DET_RTOL_LOSS
from test_torch_detect_train import RTOL_NORM as DET_RTOL_NORM
from test_torch_detect_train import _flat
from test_torch_detect_train import _jax_opt_dict as _jax_det_opt_dict
from test_torch_train import (
    ATOL_PARAMS,
    RTOL_LOSS,
    RTOL_MOMENT,
    RTOL_NORM,
    _assert_trees_close,
    _jax_opt_dict,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSIFIERS = ("vit_tiny_16_224", "vit_small_16_224", "vit_demo_8_96")
DETECTOR = "detector_demo_96"
# fp32 forwards on both sides, the same arithmetic in other summation
# orders (measured at depth 2: logits 2.5e-6, 5.3e-6 and 2.4e-6; the full
# detector 2.4e-6 on logits, 3.0e-7 on boxes)
ATOL_OUT = 2e-5
# the step tests' depth-2 copies of the presets, under keys of their own
DEPTH2 = "{}_depth2"
ROUTES = {"default": (),
          "opt_in": ("ARSVT_ATTN_SAVE_PROBS", "ARSVT_ENABLE_FUSED_MLP")}
# The opt-in route against JAX's plain CPU step: the port rounds P, u and
# du to bf16 (as the kernels do) where JAX's jnp math does not, so the
# gradients differ by ~1e-4 relative (grad_norm measured 1.8e-4, held at
# chip_smoke.py's TOL_TRAIN_NORM), the first moment by 1.1e-3 relative L2,
# and an Adam step, close to lr * sign(g), moves the elements whose
# gradient lies near 0 differently: update 1.6e-2 relative L2, its largest
# element 1.19 lr apart (held at chip_smoke.py's 2.5 lr).
RL2_MOMENT_OPT_IN = 5e-3
RL2_UPDATE_OPT_IN = 5e-2


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _depth2(name):
    return (dataclasses.replace(jax_registry.PRESETS[name], depth=2),
            dataclasses.replace(registry.PRESETS[name], depth=2))


def _seeded_head(params, d, seed):
    rng = np.random.default_rng(seed)
    params["classifier"]["head"] = {
        "kernel": jnp.asarray(rng.standard_normal((d, 6)) * 3 * d ** -0.5,
                              jnp.float32),
        "bias": jnp.asarray(rng.standard_normal(6) * 0.1, jnp.float32)}
    return params


@pytest.mark.parametrize("name", CLASSIFIERS)
def test_classifier_logits_match_jax(name):
    """Depth 2 at the preset's width, heads, patch and image size, a
    seeded head, two normalised-range images."""
    jcfg, cfg = _depth2(name)
    params = _seeded_head(jax_init_image_classifier(
        jax.random.PRNGKey(0), jcfg, 6), cfg.embed_dim, 1)
    port = bridge.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    x = np.random.default_rng(2).standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ref = np.asarray(jax_apply_image_classifier(params, jnp.asarray(x),
                                                jcfg, 6))
    with torch.inference_mode():
        got = apply_image_classifier(port, torch.from_numpy(x), cfg, 6)
    assert got.shape == ref.shape == (2, 6)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_OUT, rtol=0)


@functools.lru_cache(maxsize=1)
def _detector_outputs():
    """detector_demo_96 at full depth on the same two images: (JAX's
    outputs, the port's), numpy."""
    jcfg = jax_registry.DETECTOR_PRESETS[DETECTOR]
    cfg = registry.DETECTOR_PRESETS[DETECTOR]
    params = jax_init_detector(jax.random.PRNGKey(0), jcfg)
    port = bridge.detector_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    size = cfg.backbone.image_size
    x = np.random.default_rng(3).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax_apply_detector(params, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got = apply_detector(port, torch.from_numpy(x), cfg)
    keys = ("class_logits", "boxes_cxcywh")
    return ({k: np.asarray(ref[k]) for k in keys},
            {k: got[k].numpy() for k in keys})


@pytest.mark.parametrize("key", ["class_logits", "boxes_cxcywh"])
def test_detector_demo_outputs_match_jax(key):
    ref, got = _detector_outputs()
    cfg = registry.DETECTOR_PRESETS[DETECTOR]
    assert got[key].shape == ref[key].shape
    assert ref[key].shape[:2] == (2, cfg.head.num_queries)
    np.testing.assert_allclose(got[key], ref[key], atol=ATOL_OUT, rtol=0)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_vit_tiny_eval_step_matches_jax(route, monkeypatch):
    """The vit_tiny_eval configuration at depth 2 and batch 2 in fp32,
    warm-up 1, so step 0 runs at lr 0 and step 1 at the full lr: per step
    the loss and the parameters (the update), on the default route also
    the gradient norm and both moments. The opt-in route's switches are
    set for both sides: the port runs #5, #6, #8 and #9's plain versions,
    which round P, u and du to bf16 as the kernels do, JAX on the CPU its
    plain jnp math: that route's gradient norm, first moment and update
    are held at RL2_*_OPT_IN's limits."""
    key = DEPTH2.format("vit_tiny_16_224")
    jcfg, cfg = _depth2("vit_tiny_16_224")
    monkeypatch.setitem(jax_registry.PRESETS, key, jcfg)
    monkeypatch.setitem(registry.PRESETS, key, cfg)
    for env in ("ARSVT_ATTN_SAVE_PROBS", "ARSVT_ENABLE_FUSED_MLP",
                "ARSVT_DISABLE_PALLAS", "ARSVT_FORCE_PALLAS"):
        monkeypatch.delenv(env, raising=False)
    for env in ROUTES[route]:
        monkeypatch.setenv(env, "1")
    over = dict(preset=key, batch_size=2, bf16=False, warmup_steps=1,
                fused_adamw=True)
    tcfg = TRAIN_PRESETS["vit_tiny_eval"].with_overrides(**over)
    jinit, jstep, _ = jax_make_step_fns(JaxTrainConfig(
        **dataclasses.asdict(tcfg)))
    _, step, _ = make_classifier_step_fns(tcfg, device="cpu")
    jstate = jinit(jax.random.PRNGKey(0))
    jstate["params"] = _seeded_head(jstate["params"], cfg.embed_dim, 1)
    state = {"params": bridge.from_jax_params(
                 jax.tree_util.tree_map(np.asarray, jstate["params"]), cfg),
             "opt_state": bridge.opt_state_from_jax(
                 _jax_opt_dict(jstate["opt_state"]), cfg),
             "step": 0}
    rng = np.random.default_rng(4)
    base_rng = jax.random.PRNGKey(1)
    start = _flat(jstate["params"])
    for t in range(2):
        batch = {"image": rng.integers(0, 256, (2, 224, 224, 3),
                                       dtype=np.uint8),
                 "label": rng.integers(0, 6, 2).astype(np.int32)}
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=RTOL_LOSS)
        if ROUTES[route]:
            got = _flat(bridge.to_jax_params(state["params"])) - start
            ref = _flat(jstate["params"]) - start
            mu = [_flat(x["mu"]) for x in (
                bridge.opt_state_to_jax(state["opt_state"]),
                _jax_opt_dict(jstate["opt_state"]))]
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]),
                                       rtol=cs.TOL_TRAIN_NORM)
            assert _rel_l2(*mu) <= RL2_MOMENT_OPT_IN
            assert np.abs(got - ref).max() <= 2.5 * tcfg.learning_rate
            if t:  # step 0 runs at lr 0
                assert _rel_l2(got, ref) <= RL2_UPDATE_OPT_IN
            continue
        _assert_trees_close(bridge.to_jax_params(state["params"]),
                            jstate["params"], f"params step {t}",
                            atol=ATOL_PARAMS)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_NORM)
        ref = _jax_opt_dict(jstate["opt_state"])
        got = bridge.opt_state_to_jax(state["opt_state"])
        for k in ("mu", "nu"):
            _assert_trees_close(got[k], ref[k], f"{k} step {t}",
                                rtol_of_max=RTOL_MOMENT)


def _rel_l2(got, ref) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _det_batch(rng, n, size, m):
    lo = rng.uniform(0.05, 0.6, (n, m, 2))
    wh = rng.uniform(0.1, 0.35, (n, m, 2))
    return {"image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "boxes": np.concatenate([lo, lo + wh], -1).astype(np.float32),
            "labels": rng.integers(0, 6, (n, m)).astype(np.int32),
            "mask": np.arange(m)[None, :] < rng.integers(1, 6, (n, 1))}


def _by_problem(arrays) -> list[bytes]:
    """Each (B, Q) assignment of a step's layers, as sorted bytes: the two
    packages stack the layers in their own order."""
    out = []
    for a in arrays:
        a = np.asarray(a, np.int64)
        out += [x.tobytes() for x in a.reshape(-1, *a.shape[-2:])]
    return sorted(out)


@pytest.mark.parametrize("quantity", ["loss", "matched_pairs", "update"])
def test_detector_demo_step_matches_jax(quantity, monkeypatch):
    """benchmarks/detection_generalization_demo.py's configuration (no
    augmentation, no dropout, 8 box slots, aux loss, no triplet term) on
    detector_demo_96 with backbone and head at depth 2, batch 2, fp32,
    warm-up 1, two steps: the loss and its parts, every layer's matched
    pairs (JAX's read through a debug callback beside its matcher, the
    port's from its one `match_layers` call a step), or the parameters
    after each step."""
    key = DEPTH2.format(DETECTOR)
    jdet = jax_registry.DETECTOR_PRESETS[DETECTOR]
    det = registry.DETECTOR_PRESETS[DETECTOR]
    jdet = dataclasses.replace(
        jdet, backbone=dataclasses.replace(jdet.backbone, depth=2),
        head=dataclasses.replace(jdet.head, depth=2))
    det = dataclasses.replace(
        det, backbone=dataclasses.replace(det.backbone, depth=2),
        head=dataclasses.replace(det.head, depth=2))
    monkeypatch.setitem(jax_registry.DETECTOR_PRESETS, key, jdet)
    monkeypatch.setitem(registry.DETECTOR_PRESETS, key, det)
    jax_matches, port_matches = [], []
    jax_match = jax_detection_loss.match

    def recording_match(*args):
        idx, matched = jax_match(*args)
        jax.debug.callback(lambda i: jax_matches.append(np.asarray(i)), idx)
        return idx, matched

    monkeypatch.setattr(jax_detection_loss, "match", recording_match)
    port_match = detect_step.match_layers

    def recording_layers(*args):
        out = port_match(*args)
        port_matches.append(torch.stack([i for i, _ in out]).numpy())
        return out

    monkeypatch.setattr(detect_step, "match_layers", recording_layers)
    size = det.backbone.image_size
    kw = dict(preset=key, task="detect", num_classes=6, batch_size=2,
              image_size=size, canvas=size, augment="none",
              learning_rate=3e-4, weight_decay=1e-4, warmup_steps=1,
              total_steps=6000, schedule="cosine", bf16=False,
              max_objects=8, aux_loss=True, w_triplet=0.0,
              grad_clip_norm=0.1, fused_adamw=True)
    jinit, jstep, _ = jax_make_detector_step_fns(JaxTrainConfig(**kw))
    _, step, _ = make_detector_step_fns(TrainConfig(**kw), device="cpu")
    jstate = jinit(jax.random.PRNGKey(0))
    state = {"params": bridge.detector_from_jax_params(
                 jax.tree_util.tree_map(np.asarray, jstate["params"]), det),
             "opt_state": bridge.detector_opt_state_from_jax(
                 _jax_det_opt_dict(jstate["opt_state"]), det),
             "step": 0}
    rng = np.random.default_rng(7)
    base_rng = jax.random.PRNGKey(1)
    for t in range(2):
        batch = _det_batch(rng, 2, size, 8)
        jax_matches.clear()
        port_matches.clear()
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           base_rng)
        jax.effects_barrier()
        state, m = step(state, batch)
        if quantity == "loss":
            for k in ("loss", "loss_ce", "loss_bbox", "loss_giou",
                      "cardinality_error"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=DET_RTOL_LOSS, atol=1e-7,
                                           err_msg=f"{k} step {t}")
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]),
                                       rtol=DET_RTOL_NORM)
        elif quantity == "matched_pairs":
            assert len(port_matches) == 1
            assert port_matches[0].shape == (det.head.depth, 2,
                                              det.head.num_queries)
            assert _by_problem(port_matches) == _by_problem(jax_matches)
        else:
            a = _flat(bridge.detector_to_jax_params(state["params"]))
            b = _flat(jstate["params"])
            assert np.linalg.norm(a - b) / np.linalg.norm(b) <= DET_RL2_PARAMS
            np.testing.assert_allclose(a, b, atol=DET_ATOL_PARAMS, rtol=0)


def _demo_source():
    path = os.path.join(REPO, "benchmarks",
                        "classification_generalization_demo.py")
    with open(path) as f:
        return ast.parse(f.read())


def _evaluate(node, names: dict, env=None):
    """The value of an expression of a demo's source: constants, tuples,
    its module constants, `int`/`float`/`min`, `//`, attributes as their
    source text, and `os.environ.get(name, default)` as `env`'s value for
    the name, else its default (the demo's configuration without a
    knob)."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return names[node.id]
    if isinstance(node, ast.Tuple):
        return tuple(_evaluate(e, names, env) for e in node.elts)
    if isinstance(node, ast.Attribute):
        return ast.unparse(node)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.FloorDiv):
        return (_evaluate(node.left, names, env)
                // _evaluate(node.right, names, env))
    assert isinstance(node, ast.Call), ast.dump(node)
    fn = ast.unparse(node.func)
    args = [_evaluate(a, names, env) for a in node.args]
    if fn == "os.environ.get":
        return (env or {}).get(args[0], args[1])
    return {"int": int, "float": float, "min": min}[fn](*args)


def _demo_config(env=None):
    """(module constants, TrainConfig keywords, make_pool seeds, the seeds
    of the init key, the step key and the order rng) of the demo, run with
    the environment `env` (None: no knob set)."""
    tree = _demo_source()
    names = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.isupper()):
            names[node.targets[0].id] = _evaluate(node.value, names, env)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    config = next(c for c in calls if ast.unparse(c.func) == "TrainConfig")
    kwargs = {k.arg: _evaluate(k.value, names, env)
              for k in config.keywords}
    pools = [(_evaluate(c.args[0], names), _evaluate(c.keywords[0].value,
                                                     names))
             for c in calls if ast.unparse(c.func) == "make_pool"]
    seeds = {ast.unparse(c.func): _evaluate(c.args[0], names) for c in calls
             if ast.unparse(c.func) in ("jax.random.PRNGKey",
                                        "np.random.default_rng")
             and isinstance(c.args[0], ast.Constant)}
    keys = [_evaluate(c.args[0].args[0], names) for c in calls
            if ast.unparse(c.func) == "init_fn"]
    rng_key = next(_evaluate(n.value.args[0], names) for n in ast.walk(tree)
                   if isinstance(n, ast.Assign)
                   and ast.unparse(n.targets[0]) == "base_rng")
    return names, kwargs, pools, seeds, keys, rng_key


def test_generalization_mode_runs_the_jax_demo_configuration():
    names, kwargs, pools, seeds, keys, rng_key = _demo_config()
    assert (names["SIZE"], names["CANVAS"], names["BS"], names["STEPS"],
            names["GRAD_ACCUM"], names["TRAIN_IMAGES"],
            names["VAL_IMAGES"]) == (
        cs.GEN_SIZE, cs.GEN_CANVAS, cs.GEN_BATCH, cs.GEN_STEPS,
        cs.GEN_GRAD_ACCUM, cs.GEN_TRAIN_IMAGES, cs.GEN_VAL_IMAGES)
    port = cs.generalization_config()
    assert kwargs and all(getattr(port, k) == v for k, v in kwargs.items()), (
        {k: (getattr(port, k), v) for k, v in kwargs.items()})
    # every other field at TrainConfig's default, as in the demo
    default = TrainConfig()
    assert all(getattr(port, f.name) == getattr(default, f.name)
               for f in dataclasses.fields(TrainConfig)
               if f.name not in kwargs)
    assert pools == [(cs.GEN_TRAIN_IMAGES, cs.GEN_POOL_SEEDS[0]),
                     (cs.GEN_VAL_IMAGES, cs.GEN_POOL_SEEDS[1])]
    assert keys == [cs.GEN_INIT_SEED] and rng_key == cs.GEN_STEP_SEED
    assert seeds["np.random.default_rng"] == cs.GEN_ORDER_SEED
    assert cs.GEN_PRESET == kwargs["preset"] == "vit_demo_8_96"


# JAX's accumulated run: classification_generalization_accum.json
ACCUM_ENV = {"DEMO_GRAD_ACCUM": "8"}


@pytest.mark.parametrize("part", ["config", "parts", "jax_record"])
def test_classification_accum_runs_the_jax_accumulated_demo(part):
    """``--generalization classification_accum``: the demo's configuration
    with DEMO_GRAD_ACCUM=8 (its source read with `ast`: every TrainConfig
    field it sets, grad_accum 8 among them, every other field at its
    default, the pools and seeds of the unaccumulated run); a part run
    only when named; JAX's record of that run beside it."""
    if part == "config":
        names, kwargs, *rest = _demo_config(ACCUM_ENV)
        assert names["GRAD_ACCUM"] == kwargs["grad_accum"] == (
            cs.GEN_ACCUM_GRAD_ACCUM) == 8
        assert names["BS"] // names["GRAD_ACCUM"] == 32
        port = cs.generalization_config(cs.GEN_ACCUM_GRAD_ACCUM)
        assert all(getattr(port, k) == v for k, v in kwargs.items()), (
            {k: (getattr(port, k), v) for k, v in kwargs.items()})
        default = TrainConfig()
        assert all(getattr(port, f.name) == getattr(default, f.name)
                   for f in dataclasses.fields(TrainConfig)
                   if f.name not in kwargs)
        # only grad_accum differs from the unaccumulated run
        assert dataclasses.replace(port, grad_accum=cs.GEN_GRAD_ACCUM) == (
            cs.generalization_config())
        assert rest == list(_demo_config()[2:])
    elif part == "parts":
        assert "classification_accum" in cs.GEN_PARTS_NAMED
        assert "classification_accum" not in cs.GEN_PARTS
        assert not set(cs.GEN_PARTS) & set(cs.GEN_PARTS_NAMED)
    else:
        names, kwargs, *_ = _demo_config(ACCUM_ENV)
        rec = cs.generalization_jax(cs.GEN_ACCUM_GRAD_ACCUM)
        assert rec["record"] == "classification_generalization_accum.json"
        assert rec["grad_accum"] == cs.GEN_ACCUM_GRAD_ACCUM
        assert rec["val_top1"] >= cs.GEN_MIN_VAL_TOP1
        with open(os.path.join(REPO, rec["record"])) as f:
            config = json.load(f)["config"]
        assert (config["preset"], config["steps"], config["batch_size"],
                config["train_images"], config["val_images"],
                config["augment"]) == (
            kwargs["preset"], names["STEPS"], names["BS"],
            names["TRAIN_IMAGES"], names["VAL_IMAGES"], kwargs["augment"])
        plain = cs.generalization_jax(cs.GEN_GRAD_ACCUM)
        assert plain["record"] == "classification_generalization.json"
        assert plain["grad_accum"] == cs.GEN_GRAD_ACCUM
