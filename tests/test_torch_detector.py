"""The port's detector (backbone + DETR head), box functions and
post-processing against the JAX package, on bridged parameters, on the
CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.evaluation.detect import post_process as jax_post_process
from arsvt_tpu.models.detector import DetectorConfig as JaxDetectorConfig
from arsvt_tpu.models.detector import apply_detector as jax_apply_detector
from arsvt_tpu.models.detector import init_detector as jax_init_detector
from arsvt_tpu.models.heads import DetrHeadConfig as JaxDetrHeadConfig
from arsvt_tpu.models.registry import DETECTOR_PRESETS as JAX_DETECTOR_PRESETS
from arsvt_tpu.models.registry import PRESETS as JAX_PRESETS
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.objectives import boxes as jax_boxes
from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.evaluation import detect
from arsvt_tpu_torch.evaluation.detect import post_process
from arsvt_tpu_torch.models import vit
from arsvt_tpu_torch.models.bridge import (
    detector_from_jax_params,
    detector_to_jax_params,
    jax_detector_layout_shapes,
)
from arsvt_tpu_torch.models.detector import (
    DetectorConfig,
    apply_detector,
    init_detector,
)
from arsvt_tpu_torch.models.heads import DetrHeadConfig
from arsvt_tpu_torch.models.registry import (
    DETECTOR_PRESETS,
    PRESETS,
    get_detector_preset,
)
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.objectives import boxes
from arsvt_tpu_torch.ops import flash_attention

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# A head_dim-64 backbone (the encoder-attention kernel, as
# vit_base_detector's) with a DETR head of head_dim 32 (the head-major
# kernel): both attention kernels' plain versions in one model.
SMALL64 = dict(
    backbone=dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
                  num_heads=2, mlp_dim=256),
    head=dict(num_classes=6, num_queries=10, depth=2, num_heads=4,
              ffn_dim=128),
    triplet_dim=32,
)


def _configs(name):
    """(JAX config, port config) for a test detector."""
    if name == "detector_test":
        return JAX_DETECTOR_PRESETS[name], get_detector_preset(name)
    return (JaxDetectorConfig(JaxBackboneConfig(**SMALL64["backbone"]),
                              JaxDetrHeadConfig(**SMALL64["head"]),
                              SMALL64["triplet_dim"]),
            DetectorConfig(BackboneConfig(**SMALL64["backbone"]),
                           DetrHeadConfig(**SMALL64["head"]),
                           SMALL64["triplet_dim"]))


def _jax_params(jcfg, seed=0):
    params = jax_init_detector(jax.random.PRNGKey(seed), jcfg)
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def test_presets_are_the_jax_presets_letter_for_letter():
    assert set(PRESETS) == set(JAX_PRESETS)
    for name, cfg in PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JAX_PRESETS[name]), name
    assert set(DETECTOR_PRESETS) == set(JAX_DETECTOR_PRESETS)
    for name, cfg in DETECTOR_PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JAX_DETECTOR_PRESETS[name]), name
    with pytest.raises(KeyError, match="unknown detector preset"):
        get_detector_preset("nope")


@pytest.mark.parametrize("name", ["detector_test", "small64"])
def test_bridge_round_trip(name):
    jcfg, cfg = _configs(name)
    _, tree = _jax_params(jcfg)
    port = detector_from_jax_params(tree, cfg)
    assert len(port["backbone"]["blocks"]) == cfg.backbone.depth
    assert len(port["detr"]["blocks"]) == cfg.head.depth
    np.testing.assert_array_equal(
        port["detr"]["blocks"][1]["cross_attn"]["kv"]["kernel"].numpy(),
        tree["detr"]["blocks"]["cross_attn"]["kv"]["kernel"][1])
    back = detector_to_jax_params(port)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["detector_test", "small64"])
def test_port_init_has_the_jax_tree_and_shapes(name):
    jcfg, cfg = _configs(name)
    _, tree = _jax_params(jcfg)
    mine = detector_to_jax_params(init_detector(cfg, seed=3))
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    detector_from_jax_params(mine, cfg)


def test_init_is_seeded():
    cfg = get_detector_preset("detector_test")
    a, b, c = (init_detector(cfg, seed=s) for s in (1, 1, 2))
    key = ("detr", "blocks", 0, "mlp", "fc1", "kernel")

    def leaf(p):
        for k in key:
            p = p[k]
        return p

    assert torch.equal(leaf(a), leaf(b)) and not torch.equal(leaf(a),
                                                             leaf(c))
    assert float(a["detr"]["queries"].abs().max()) <= 0.04 + 1e-7


def test_bridge_rejects_a_mismatched_tree():
    jcfg, cfg = _configs("detector_test")
    _, tree = _jax_params(jcfg)
    wrong = dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, num_queries=7))
    with pytest.raises(ValueError, match="shape"):
        detector_from_jax_params(tree, wrong)
    broken = dict(tree, detr={k: v for k, v in tree["detr"].items()
                              if k != "bbox_head"})
    with pytest.raises(ValueError, match="keys"):
        detector_from_jax_params(broken, cfg)
    assert jax_detector_layout_shapes(cfg)["detr"]["blocks"]["cross_attn"][
        "kv"]["kernel"] == (2, 32, 64)


def _images(cfg, seed=12, b=2):
    s = cfg.backbone.image_size
    return np.random.default_rng(seed).uniform(size=(b, s, s, 3)).astype(
        np.float32)


# fp32: the same arithmetic in another summation order through the
# backbone and the decoder: measured <= 1.7e-6 on logits of magnitude
# <= 2.7, so 1e-4. bf16: the JAX CPU path runs the normalise-first
# attention reference and XLA may keep excess precision between fused
# elementwise ops, while the port rounds every op's output and the
# unnormalised p to bf16: measured <= 0.020 on logits, 0.0053 on boxes and
# 0.0024 on the unit-norm features over both models; about three times
# that: 0.06, 0.02 and 0.01.
TOL = {"float32": dict(logits=1e-4, boxes=1e-4, feat=1e-4),
       "bfloat16": dict(logits=0.06, boxes=0.02, feat=0.01)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["detector_test", "small64"])
def test_apply_detector_matches_jax(name, dtype):
    jcfg, cfg = _configs(name)
    params, tree = _jax_params(jcfg)
    port = detector_from_jax_params(tree, cfg)
    x = _images(cfg)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref, ref_feat = jax_apply_detector(params, jnp.asarray(x).astype(jdt),
                                       jcfg, return_aux=True,
                                       return_features=True)
    with torch.inference_mode():
        got, feat = apply_detector(port, torch.from_numpy(x).to(tdt), cfg,
                                   return_aux=True, return_features=True)
    tol = TOL[dtype]
    q, c = cfg.head.num_queries, cfg.head.num_classes + 1
    assert got["class_logits"].shape == (2, q, c)
    assert got["aux"]["boxes_cxcywh"].shape == (cfg.head.depth - 1, 2, q, 4)
    for k, atol in (("class_logits", tol["logits"]),
                    ("boxes_cxcywh", tol["boxes"])):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=atol)
        np.testing.assert_allclose(got["aux"][k].numpy(),
                                   np.asarray(ref["aux"][k]), atol=atol)
    assert feat.dtype == torch.float32 and feat.shape == (
        2, cfg.triplet_dim)
    np.testing.assert_allclose(feat.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_feat),
                               atol=tol["feat"])


@pytest.mark.parametrize("name,encoder_calls,flash_calls", [
    ("detector_test", 0, 4),   # d=16 encoder: 2 + 2 cross-attentions
    ("small64", 2, 2),         # d=64 encoder: #1 twice, #3 twice
])
def test_attention_routes_by_head_dim(name, encoder_calls, flash_calls,
                                      monkeypatch):
    """The kernels each forward reaches, counted at their wrappers (on the
    card the same calls are kernel launches): head_dim 64 to the encoder-
    attention kernel, any other head_dim and every cross-attention to the
    head-major kernel; the decoder's self-attention to neither."""
    _, cfg = _configs(name)
    calls = {"encoder": 0, "flash": 0}
    real_fused, real_fwd = vit.fused_encoder_attention, \
        flash_attention.flash_attention_fwd

    def fused(*a, **kw):
        calls["encoder"] += 1
        return real_fused(*a, **kw)

    def fwd(*a, **kw):
        calls["flash"] += 1
        return real_fwd(*a, **kw)

    monkeypatch.setattr(vit, "fused_encoder_attention", fused)
    monkeypatch.setattr(flash_attention, "flash_attention_fwd", fwd)
    with torch.inference_mode():
        apply_detector(init_detector(cfg), torch.from_numpy(_images(cfg)),
                       cfg)
    assert calls == {"encoder": encoder_calls, "flash": flash_calls}


def test_training_forward_raises():
    """A training forward runs through kernels #3/#4 with dropout, and at
    head_dim 64 through #1/#2 with theirs: it no longer raises for
    attention dropout there. With an rng the backbone's attention dropout
    moves the output away from the same forward without one."""
    cfg = get_detector_preset("detector_test")
    out = apply_detector(init_detector(cfg), torch.zeros(1, 32, 32, 3), cfg,
                         train=True)
    assert out["class_logits"].shape == (1, 5, 7)
    wide = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, embed_dim=128, num_heads=2, dropout=0.0,
        attn_dropout=0.1), head=dataclasses.replace(
        cfg.head, dropout=0.0, attn_dropout=0.0))
    params = init_detector(wide)
    images = torch.from_numpy(np.random.default_rng(1).random(
        (2, 32, 32, 3)).astype(np.float32))
    dropped = apply_detector(params, images, wide, train=True, rng=Rng(5))
    plain = apply_detector(params, images, wide, train=True)
    assert dropped["class_logits"].shape == (2, 5, 7)
    assert bool(torch.isfinite(dropped["class_logits"]).all())
    assert not torch.equal(dropped["class_logits"], plain["class_logits"])


def _boxes_xyxy(seed, shape):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 0.6, size=shape + (2,))
    wh = rng.uniform(0.0, 0.5, size=shape + (2,))
    return np.concatenate([lo, lo + wh], axis=-1).astype(np.float32)


@pytest.mark.parametrize("fn", ["cxcywh_to_xyxy", "xyxy_to_cxcywh",
                                "box_area", "pairwise_iou", "pairwise_giou",
                                "elementwise_giou"])
def test_box_functions_match_jax(fn):
    """The same fp32 expressions in the same order: equal to fp32
    rounding."""
    a, b = _boxes_xyxy(1, (3, 7)), _boxes_xyxy(2, (3, 5))
    if fn in ("pairwise_iou", "pairwise_giou"):
        args = (a, b)
    elif fn == "elementwise_giou":
        args = (a, _boxes_xyxy(3, (3, 7)))
    else:
        args = (a,)
    ref = getattr(jax_boxes, fn)(*(jnp.asarray(x) for x in args))
    got = getattr(boxes, fn)(*(torch.from_numpy(x) for x in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def _detections(seed, b=3, q=12, c=7):
    """Seeded logits and boxes with overlapping same-class boxes and
    exact ties: queries 1 and 2 repeat query 0 (same logits, so the same
    score and class on both sides, and nearly the same box); query 4
    repeats query 3's logits with a disjoint box."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((b, q, c))).astype(np.float32)
    logits[..., 0, 0] += 4.0  # a confident first query
    logits[..., 1, :] = logits[..., 2, :] = logits[..., 0, :]
    logits[..., 4, :] = logits[..., 3, :]
    cxcywh = rng.uniform(0.2, 0.8, size=(b, q, 4)).astype(np.float32)
    cxcywh[..., 2:] = rng.uniform(0.1, 0.4, size=(b, q, 2))
    cxcywh[..., 1, :] = cxcywh[..., 0, :] + 0.01
    cxcywh[..., 2, :] = cxcywh[..., 0, :] - 0.02
    cxcywh[..., 4, :2] = 1.0 - cxcywh[..., 3, :2]
    return logits, cxcywh


@pytest.mark.parametrize("conf", [0.5, 0.05])
@pytest.mark.parametrize("class_aware", [True, False])
def test_post_process_equals_jax(class_aware, conf):
    logits, cxcywh = _detections(seed=int(conf * 100) + class_aware)
    ref = jax_post_process(jnp.asarray(logits), jnp.asarray(cxcywh),
                           conf_threshold=conf, nms_threshold=0.5,
                           class_aware=class_aware)
    got = post_process(torch.from_numpy(logits), torch.from_numpy(cxcywh),
                       conf_threshold=conf, nms_threshold=0.5,
                       class_aware=class_aware)
    assert got["labels"].dtype == torch.int32
    for k in ("valid", "labels", "boxes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    # scores through two softmax implementations: equal to fp32 rounding
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), rtol=1e-6)
    valid = got["valid"].numpy()
    assert valid.any() and not valid.all()  # NMS and the threshold bit


def test_nms_stops_at_its_fixed_point_with_jax_result():
    """The early stop gives the mask of JAX's Q full iterations, on a chain
    where each kept box frees the next."""
    q = 6
    x = np.arange(q, dtype=np.float32) * 0.2
    bx = torch.from_numpy(np.stack([x, np.zeros(q), x + 0.3, np.ones(q)],
                                   -1).astype(np.float32))[None]
    scores = torch.linspace(0.9, 0.4, q)[None]
    labels = torch.zeros(1, q, dtype=torch.int32)
    valid = torch.ones(1, q, dtype=torch.bool)
    keep = detect._nms_mask(bx, scores, labels, valid, 0.1, True)
    full = valid
    for _ in range(q):  # JAX's fori_loop
        full = valid & ~(_suppressor(bx, scores, 0.1) & full[..., None, :]
                         ).any(-1)
    assert torch.equal(keep, full)
    assert keep[0].tolist() == [True, False, True, False, True, False]


def _suppressor(bx, scores, thr):
    iou, _ = boxes.pairwise_iou(bx, bx)
    q = scores.shape[-1]
    idx = torch.arange(q)
    higher = (scores[..., None, :] > scores[..., :, None]) | (
        (scores[..., None, :] == scores[..., :, None])
        & (idx[None, :] < idx[:, None]))
    return (iou > thr) & higher
