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


def jax_classify_draws(keys, *, jitter_p=0.0, rand_augment=False):
    """JAX's draws for ``classification_train_augment(key, ...)`` of each
    key, replayed from its splits: crop (k1), flip (k2), color jitter at
    its defaults (k3), RandAugment's two rounds (k4)."""
    from test_torch_randaugment import _draws_of

    crops, flips, jit = [], [], []
    for k in keys:
        k1, k2, k3, _ = jax.random.split(k, 4)
        crops.append(_jax_crop_draws(k1))
        flips.append(jax.random.bernoulli(k2, 0.5))
        kp, ko, kb, kc, ks, kh = jax.random.split(k3, 6)
        jit.append((jax.random.bernoulli(kp, jitter_p),
                    jax.random.uniform(kb, (), minval=0.8, maxval=1.2),
                    jax.random.uniform(kc, (), minval=0.8, maxval=1.2),
                    jax.random.uniform(ks, (), minval=0.8, maxval=1.2),
                    jax.random.uniform(kh, (), minval=-0.2, maxval=0.2)
                    * 2.0 * jnp.pi,
                    jax.random.permutation(ko, 4)))
    jitter = (augment.JitterDraws(*(_stack(c) for c in zip(*jit)))
              if jitter_p > 0 else None)
    ra = (_draws_of([jax.random.split(k, 4)[3] for k in keys])
          if rand_augment else None)
    return augment.CropFlipDraws(*(_stack(d) for d in zip(*crops)),
                                 _stack(flips), jitter, ra)


def test_classification_jitter_and_randaugment_with_jax_draws():
    """Crop -> flip -> jitter (p 0.6) -> RandAugment -> normalize on 8
    images against ``classification_train_augment`` with JAX's draws (the
    pixel tolerance of a warp, scaled by 1/std)."""
    imgs = _images(8, 40, 8)
    keys = jax.random.split(jax.random.PRNGKey(9), 8)
    jcfg = jax_augment.ClassifyAugmentConfig(image_size=32, jitter_p=0.6,
                                             rand_augment=True)
    ref = np.stack([np.asarray(jax_augment.classification_train_augment(
        k, jnp.asarray(im), jcfg)) for k, im in zip(keys, imgs)])
    draws = jax_classify_draws(keys, jitter_p=0.6, rand_augment=True)
    assert 0 < int(draws.jitter.apply.sum()) < 8
    assert int((draws.rand_augment.op == 0).sum()) > 0  # some rotate
    cfg = augment.ClassifyAugmentConfig(image_size=32, jitter_p=0.6,
                                        rand_augment=True)
    got = augment.classification_train_augment(torch.from_numpy(imgs),
                                               draws, cfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_PIX / 0.224)
    own = augment.draw_classification_augment(generator(0), 8, cfg)
    assert own.jitter.order.shape == (8, 4)
    assert own.rand_augment.op.shape == (8, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixup_matches_jax(dtype):
    """JAX's λ and permutation fed to the port: the mixed images (computed
    in fp32 and rounded once to the images' dtype on both sides: equal to
    1e-6 in fp32, to one bf16 rounding step of a value below 4 in bf16)
    and the soft labels (1e-7)."""
    imgs = np.random.default_rng(10).standard_normal(
        (8, 6, 6, 3)).astype(np.float32)
    labels = np.random.default_rng(11).integers(0, 6, 8).astype(np.int32)
    key = jax.random.PRNGKey(12)
    jimgs = jnp.asarray(imgs).astype(dtype)
    ref_x, ref_y = jax_obj.mixup(key, jimgs, jnp.asarray(labels),
                                 num_classes=6, alpha=0.2)
    k_lam, k_perm = jax.random.split(key)
    draws = obj.MixupDraws(
        float(jax.random.beta(k_lam, 0.2, 0.2, ())),
        torch.from_numpy(np.array(jax.random.permutation(k_perm, 8))))
    got_x, got_y = obj.mixup(
        torch.from_numpy(np.array(jimgs.astype(jnp.float32))).to(
            getattr(torch, dtype)), torch.from_numpy(labels), draws,
        num_classes=6)
    assert str(got_x.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(
        got_x.float().numpy(), np.asarray(ref_x.astype(jnp.float32)),
        atol=1e-6 if dtype == "float32" else 2.0 ** -6, rtol=0)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), atol=1e-7)
    hard = got_y.argmax(dim=-1)  # the step's accuracy label
    np.testing.assert_array_equal(hard.numpy(),
                                  np.asarray(jnp.argmax(ref_y, axis=-1)))


def test_draw_mixup_statistics():
    """λ ~ Beta(0.2, 0.2) (mean 1/2, variance 1/(4 (2α + 1)) = 0.179) over
    2,000 microbatches, each a permutation; the same seed repeats."""
    lams = []
    for i in range(2000):
        d = obj.draw_mixup(generator(0, i, 0), 8, 0.2)
        lams.append(d.lam)
        assert sorted(d.perm.tolist()) == list(range(8))
    lams = np.array(lams)
    assert abs(lams.mean() - 0.5) < 0.03
    assert abs(lams.var() - 1 / (4 * 1.4)) < 0.02
    again = obj.draw_mixup(generator(0, 7, 0), 8, 0.2)
    first = obj.draw_mixup(generator(0, 7, 0), 8, 0.2)
    assert again.lam == first.lam and torch.equal(again.perm, first.perm)


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
