"""The port's matcher, detection loss and triplet loss against the JAX
package on the CPU, on the same numpy inputs.

The port solves the assignment on either of JAX's backends: ``device``
(JAX's Jonker-Volgenant, `lap_rect_plain` on the CPU) or ``scipy`` on the
host. Each finds an optimum, so the total cost of the port's and JAX's
assignments must agree, and the assignment itself wherever the optimum is
unique (every real target slot: random costs never tie). On the scipy
route queries left on padded slots tie among those slots, so only matched
queries are compared slot for slot (``tests/test_torch_lap.py`` holds the
device route's whole assignment to JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.objectives import detection_loss as jax_loss
from arsvt_tpu.objectives import matcher as jax_matcher
from arsvt_tpu.objectives.triplet import (
    batch_hard_triplet_loss as jax_triplet,
)
from arsvt_tpu_torch.objectives import detection_loss as port_loss
from arsvt_tpu_torch.objectives import matcher
from arsvt_tpu_torch.objectives.triplet import batch_hard_triplet_loss

torch.set_num_threads(1)  # tier-1 runs several xdist workers

C = 6  # foreground classes
# fp32 on both sides, the same formulas in another summation order
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _problem(b, q, m, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, q, C + 1)).astype(np.float32) * 2
    boxes = (1 / (1 + np.exp(-rng.standard_normal((b, q, 4))))).astype(
        np.float32)
    lo = rng.uniform(0.0, 0.6, (b, m, 2))
    wh = rng.uniform(0.05, 0.4, (b, m, 2))
    tboxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    labels = rng.integers(0, C, (b, m)).astype(np.int32)
    n_real = rng.integers(1, m + 1, (b, 1))
    mask = np.arange(m)[None, :] < n_real
    return logits, boxes, labels, tboxes, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_cost_matrix_matches_jax():
    logits, boxes, labels, tboxes, mask = _problem(3, 5, 9, seed=0)
    ref = jax.jit(jax.vmap(lambda *a: jax_matcher.build_cost_matrix(
        *a, jax_matcher.MatcherConfig())))(
            *(jnp.asarray(a) for a in (logits, boxes, labels, tboxes, mask)))
    got = matcher.build_cost_matrix(*_t(logits, boxes, labels, tboxes, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-5)


def _total(cost, tfq, matched):
    b, q = tfq.shape
    return np.array([sum(cost[i, j, tfq[i, j]] for j in range(q)
                         if matched[i, j]) for i in range(b)])


@pytest.mark.parametrize("backend", matcher.BACKENDS)
@pytest.mark.parametrize("q,m", [(5, 25), (10, 4), (7, 7)],
                         ids=["q<m", "q>m", "square"])
def test_match_finds_jax_optimum(q, m, backend):
    b = 6
    logits, boxes, labels, tboxes, mask = _problem(b, q, m, seed=q * m)
    jt, jm = jax.jit(jax_matcher.match)(
        *(jnp.asarray(a) for a in (logits, boxes, labels, tboxes, mask)))
    jt, jm = np.asarray(jt), np.asarray(jm)
    tt, tm = matcher.match(*_t(logits, boxes, labels, tboxes, mask),
                           matcher.MatcherConfig(backend=backend))
    tt, tm = tt.numpy(), tm.numpy()
    assert tt.shape == (b, q) and tm.dtype == np.bool_
    cost = matcher.build_cost_matrix(
        *_t(logits, boxes, labels, tboxes, mask)).numpy()
    np.testing.assert_allclose(_total(cost, tt, tm), _total(cost, jt, jm),
                               rtol=1e-5)
    # every real slot is taken once on both sides, by the same query
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(np.where(tm, tt, -1), np.where(jm, jt, -1))
    assert (tm.sum(1) == np.minimum(mask.sum(1), q)).all()
    if q > m:  # queries without a slot get the out-of-range m
        assert ((tt == m).sum(1) == q - m).all()


def test_match_layers_copies_once_and_equals_per_layer_match(monkeypatch):
    logits, boxes, labels, tboxes, mask = _problem(2, 5, 8, seed=4)
    rng = np.random.default_rng(9)
    layers = [(torch.from_numpy(logits + rng.standard_normal(
        logits.shape).astype(np.float32)), torch.from_numpy(boxes))
        for _ in range(3)]
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t: copies.append(t.shape) or real_cpu(t))
    scipy = matcher.MatcherConfig(backend="scipy")
    got = matcher.match_layers(layers, *_t(labels, tboxes, mask), scipy)
    assert copies == [(3, 2, 5, 8)]  # the stacked costs, once
    monkeypatch.undo()
    for (cl, bx), (tt, tm) in zip(layers, got):
        rt, rm = matcher.match(cl, bx, *_t(labels, tboxes, mask), scipy)
        assert torch.equal(tt, rt) and torch.equal(tm, rm)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["no_image_weight", "image_weight"])
def test_detection_loss_matches_jax(weighted):
    b, q, m = 8, 5, 6
    logits, boxes, labels, tboxes, mask = _problem(b, q, m, seed=21)
    labels = labels % 3  # few classes: the triplet finds positives
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((b, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    iw = (np.arange(b) < 6).astype(np.float32) if weighted else None
    cfg = jax_loss.DetectionLossConfig()
    jt, jp = jax.jit(jax_loss.detection_loss, static_argnums=2)(
        {"class_logits": jnp.asarray(logits),
         "boxes_cxcywh": jnp.asarray(boxes)},
        {"boxes": jnp.asarray(tboxes), "labels": jnp.asarray(labels),
         "mask": jnp.asarray(mask)}, cfg, jnp.asarray(feats),
        image_weight=None if iw is None else jnp.asarray(iw))
    tl, tb, tb_boxes, tmask, tfeats = _t(logits, boxes, tboxes, mask, feats)
    pt, pp = port_loss.detection_loss(
        {"class_logits": tl, "boxes_cxcywh": tb},
        {"boxes": tb_boxes, "labels": torch.from_numpy(labels),
         "mask": tmask}, port_loss.DetectionLossConfig(), tfeats,
        image_weight=None if iw is None else torch.from_numpy(iw))
    assert set(pp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(float(pp[k]), float(jp[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(pt), float(jt), rtol=RTOL)
    assert float(pp["loss_triplet"]) > 0.0


def test_detection_loss_gradient_flows_and_assignment_is_reused():
    logits, boxes, labels, tboxes, mask = _problem(2, 5, 4, seed=8)
    tl = torch.from_numpy(logits).requires_grad_(True)
    tb = torch.from_numpy(boxes).requires_grad_(True)
    targets = dict(zip(("labels", "boxes", "mask"),
                       _t(labels, tboxes, mask)))
    outputs = {"class_logits": tl, "boxes_cxcywh": tb}
    asg = matcher.match(tl, tb, targets["labels"], targets["boxes"],
                        targets["mask"])
    total, parts = port_loss.detection_loss(outputs, targets,
                                            port_loss.DetectionLossConfig())
    total2, _ = port_loss.detection_loss(outputs, targets,
                                         port_loss.DetectionLossConfig(),
                                         assignment=asg)
    assert torch.equal(total, total2)
    gl, gb = torch.autograd.grad(total, (tl, tb))
    assert gl.abs().sum() > 0 and gb.abs().sum() > 0
    assert not parts["cardinality_error"].requires_grad
    with pytest.raises(ValueError, match="num_classes"):
        port_loss.detection_loss(
            {"class_logits": tl[..., :-1], "boxes_cxcywh": tb}, targets,
            port_loss.DetectionLossConfig())


def test_dominant_labels_match_jax_with_ties():
    labels = np.array([[2, 2, 1, 1, 0], [3, 5, 5, 3, 0], [4, 1, 1, 4, 4],
                       [0, 0, 0, 0, 0]], np.int32)
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 0], [1, 1, 1, 1, 1],
                     [0, 0, 0, 0, 0]], bool)
    jl, jv = jax_loss.dominant_labels(jnp.asarray(labels), jnp.asarray(mask),
                                      C)
    pl, pv = port_loss.dominant_labels(*_t(labels, mask), C)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert pl.tolist()[:3] == [1, 3, 4]  # ties -> the lowest id


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triplet_matches_jax(seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((10, 8)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    labels = rng.integers(0, 3, 10).astype(np.int32)
    valid = rng.random(10) > 0.2
    ref = jax_triplet(jnp.asarray(f), jnp.asarray(labels), jnp.asarray(valid),
                      margin=0.3)
    got = batch_hard_triplet_loss(*_t(f, labels, valid), margin=0.3)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL, atol=1e-7)
