"""The port's classification augmentation and objectives against the JAX
package on the CPU. Random ops are applied with JAX's own draws, replayed
here from the same key splits as ``arsvt_tpu/data/augment.py``; the port's
own draws are checked by their statistics."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.data import augment as jax_augment
from arsvt_tpu.objectives import classification as jax_obj
from arsvt_tpu_torch.core.prng import generator
from arsvt_tpu_torch.data import augment
from arsvt_tpu_torch.objectives import classification as obj

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# fp32 pixels in [0, 1] through two fp32 weight products on both sides,
# with the weights built in fp32 from the same draws (exp/sqrt may differ
# in the last bit): atol 1e-5.
ATOL_PIX = 1e-5


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _images(n, size, seed):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(
        np.float32)


def _jax_crop_draws(key):
    """The draws of ``random_resized_crop(key, ...)``, replayed."""
    ka, kr, kx, ky = jax.random.split(key, 4)
    area = jax.random.uniform(ka, (), minval=0.65, maxval=1.0)
    log_ratio = jax.random.uniform(kr, (), minval=jnp.log(3 / 4),
                                   maxval=jnp.log(4 / 3))
    y_frac = jax.random.uniform(ky, (), minval=0.0, maxval=1.0)
    x_frac = jax.random.uniform(kx, (), minval=0.0, maxval=1.0)
    return area, log_ratio, y_frac, x_frac


def _stack(values):
    return torch.from_numpy(np.array([np.asarray(v) for v in values]))


@pytest.mark.parametrize("canvas", [64, 24], ids=["downscale", "upscale"])
def test_random_resized_crop_with_jax_draws(canvas):
    """Canvas 64 -> 32 widens the triangle kernel (antialias); canvas 24 ->
    32 interpolates. Four images, four keys."""
    imgs = _images(4, canvas, 0)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    ref = np.stack([np.asarray(jax_augment.random_resized_crop(
        k, jnp.asarray(im), 32)) for k, im in zip(keys, imgs)])
    draws = [_jax_crop_draws(k) for k in keys]
    got = augment.random_resized_crop(
        torch.from_numpy(imgs), 32, *(_stack(d) for d in zip(*draws)))
    assert got.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_PIX)


def test_classification_train_augment_with_jax_draws():
    """The whole crop -> flip -> normalize pipeline of one image per key."""
    imgs = _images(6, 40, 1)
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    jcfg = jax_augment.ClassifyAugmentConfig(image_size=32)
    ref = np.stack([np.asarray(jax_augment.classification_train_augment(
        k, jnp.asarray(im), jcfg)) for k, im in zip(keys, imgs)])
    crops, flips = [], []
    for k in keys:
        k1, k2, _, _ = jax.random.split(k, 4)
        crops.append(_jax_crop_draws(k1))
        flips.append(jax.random.bernoulli(k2, 0.5))
    draws = augment.CropFlipDraws(*(_stack(d) for d in zip(*crops)),
                                  _stack(flips))
    got = augment.classification_train_augment(
        torch.from_numpy(imgs), draws,
        augment.ClassifyAugmentConfig(image_size=32))
    # normalize divides by std ~0.22: the pixel tolerance scaled by 1/std
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_PIX / 0.224)


def test_horizontal_flip_with_jax_draws():
    imgs = _images(8, 16, 2)
    keys = jax.random.split(jax.random.PRNGKey(5), 8)
    ref = np.stack([np.asarray(jax_augment.random_horizontal_flip(
        k, jnp.asarray(im))) for k, im in zip(keys, imgs)])
    flips = _stack([jax.random.bernoulli(k, 0.5) for k in keys])
    assert 0 < int(flips.sum()) < 8  # both branches are exercised
    got = augment.horizontal_flip(torch.from_numpy(imgs), flips)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_eval_preprocess_matches_jax():
    """40 -> 32 resize with antialias, then normalize."""
    imgs = _images(3, 40, 3)
    ref = np.stack([np.asarray(jax_augment.eval_preprocess(
        jnp.asarray(im), size=32)) for im in imgs])
    got = augment.eval_preprocess(torch.from_numpy(imgs), size=32)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_PIX / 0.224)
    same = augment.eval_preprocess(torch.from_numpy(imgs[:, :32, :32]), 32)
    np.testing.assert_allclose(same.numpy(), np.asarray(
        jax_augment.normalize(jnp.asarray(imgs[:, :32, :32]))), atol=1e-6)


def test_port_draws_statistics():
    """4000 draws: the flip rate is 0.5 within 4 sigma (0.032), the crop's
    area lies in [0.65, 1) with mean 0.825, the log aspect within
    [log 3/4, log 4/3], the offsets in [0, 1); the same seed tuple gives
    the same draws and another tuple others."""
    cfg = augment.ClassifyAugmentConfig(image_size=32)
    d = augment.draw_classification_augment(generator(0, 0, 0), 4000, cfg)
    assert abs(float(d.flip.float().mean()) - 0.5) < 0.032
    assert 0.65 <= float(d.area.min()) and float(d.area.max()) < 1.0
    assert abs(float(d.area.mean()) - 0.825) < 0.01
    assert math.log(3 / 4) - 1e-6 <= float(d.log_ratio.min())
    assert float(d.log_ratio.max()) <= math.log(4 / 3) + 1e-6
    for f in (d.y_frac, d.x_frac):
        assert 0.0 <= float(f.min()) and float(f.max()) < 1.0
    again = augment.draw_classification_augment(generator(0, 0, 0), 4000, cfg)
    other = augment.draw_classification_augment(generator(0, 1, 0), 4000, cfg)
    assert torch.equal(d.area, again.area)
    assert not torch.equal(d.area, other.area)


def test_unported_augmentations_raise():
    for cfg in (augment.ClassifyAugmentConfig(rand_augment=True),
                augment.ClassifyAugmentConfig(jitter_p=0.6)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            augment.draw_classification_augment(generator(0), 2, cfg)


@pytest.mark.parametrize("case", ["int", "smoothed", "soft", "valid",
                                  "all_pad"])
def test_cross_entropy_matches_jax(case):
    """fp32 log-softmax and means on both sides: rtol 1e-6."""
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((8, 6)) * 3).astype(np.float32)
    labels = rng.integers(0, 6, 8).astype(np.int32)
    kw, valid = {}, None
    if case == "smoothed":
        kw["label_smoothing"] = 0.1
    if case == "soft":
        labels = rng.dirichlet(np.ones(6), 8).astype(np.float32)
    if case == "valid":
        valid = (np.arange(8) < 5).astype(np.int32)
    if case == "all_pad":
        valid = np.zeros(8, np.int32)
    ref = jax_obj.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), num_classes=6,
        valid=None if valid is None else jnp.asarray(valid), **kw)
    got = obj.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), num_classes=6,
        valid=None if valid is None else torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    if case == "all_pad":
        assert float(got) == 0.0


def test_accuracy_and_confusion_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((12, 6)).astype(np.float32)
    logits[0] = 1.0  # a tie: the first maximum wins on both sides
    labels = rng.integers(0, 6, 12).astype(np.int32)
    valid = (rng.random(12) < 0.7).astype(np.int32)
    assert float(obj.accuracy_top1(torch.from_numpy(logits),
                                   torch.from_numpy(labels))) == float(
        jax_obj.accuracy_top1(jnp.asarray(logits), jnp.asarray(labels)))
    preds = np.argmax(logits, -1).astype(np.int32)
    for v in (None, valid):
        ref = jax_obj.confusion_matrix(
            jnp.asarray(preds), jnp.asarray(labels), 6,
            valid=None if v is None else jnp.asarray(v))
        got = obj.confusion_matrix(
            torch.from_numpy(preds), torch.from_numpy(labels), 6,
            valid=None if v is None else torch.from_numpy(v))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
