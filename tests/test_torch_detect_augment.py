"""The port's detection augmentation (``data/augment.py``) against the JAX
package on the CPU. Each random op is applied with JAX's own draws,
replayed here from the same key splits as ``arsvt_tpu/data/augment.py``
(`_jax_draws`); the port's own draws are checked by their ranges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.data import augment as jax_augment
from arsvt_tpu_torch.core.prng import generator
from arsvt_tpu_torch.data import augment
from arsvt_tpu_torch.data.augment import DetectionDraws

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# fp32 pixels in [0, 1] (normalised: |x| <= 2.7) through the same fp32
# formulas on both sides; the warp's band weights come from positions
# computed from each side's own fp32 matrix inverse, so a few ulps of a
# position move a weight by ~1e-6: atol 1e-5 on pixels and boxes.
ATOL = 1e-5
JCFG = jax_augment.DetectionAugmentConfig(image_size=32,
                                          warp_variant="shear_matmul")
PCFG = augment.DetectionAugmentConfig(image_size=32,
                                      warp_variant="shear_matmul")


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _batch(n, size, m, seed):
    rng = np.random.default_rng(seed)
    images = rng.random((n, size, size, 3)).astype(np.float32)
    lo = rng.uniform(0.05, 0.6, (n, m, 2))
    wh = rng.uniform(0.05, 0.35, (n, m, 2))
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    mask = np.arange(m)[None, :] < rng.integers(1, m + 1, (n, 1))
    return images, boxes, mask


def _u(key, shape, lo, hi):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _jax_draws(key, cfg=JCFG, *, shadow_p=None, flip_p=None, affine_p=None,
               jitter_p=None, dropout_p=None):
    """The draws ``detection_train_augment(key, ...)`` makes, replayed
    from its key splits; a `*_p` overrides that op's probability."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    d = {}
    kp, kn, krest = jax.random.split(k1, 3)
    lo, hi = cfg.shadow_num
    rx1, ry1, rx2, ry2 = cfg.shadow_roi
    d["shadow_apply"] = jax.random.bernoulli(
        kp, cfg.shadow_p if shadow_p is None else shadow_p)
    d["shadow_n"] = jax.random.randint(kn, (), lo, hi + 1)
    cols = {"angle": [], "ox": [], "oy": [], "intensity": []}
    for k in jax.random.split(krest, hi):
        ka, kox, koy, ki = jax.random.split(k, 4)
        cols["angle"].append(_u(ka, (), 0.0, jnp.pi))
        cols["ox"].append(_u(kox, (), rx1, rx2))
        cols["oy"].append(_u(koy, (), ry1, ry2))
        cols["intensity"].append(_u(ki, (), *cfg.shadow_intensity))
    for name, vals in cols.items():
        d[f"shadow_{name}"] = jnp.stack(vals)
    d["flip"] = jax.random.bernoulli(k2, cfg.flip_p if flip_p is None
                                     else flip_p)
    kp, km = jax.random.split(k3)
    ka, ks, kt, ksh = jax.random.split(km, 4)
    d["affine_apply"] = jax.random.bernoulli(
        kp, cfg.affine_p if affine_p is None else affine_p)
    d["theta_deg"] = _u(ka, (), -cfg.degrees, cfg.degrees)
    d["scale"] = _u(ks, (), *cfg.scale)
    d["translate"] = _u(kt, (2,), -cfg.translate, cfg.translate)
    d["shear_deg"] = _u(ksh, (2,), -cfg.shear, cfg.shear)
    kp, ko, kb, kc, ks, kh = jax.random.split(k4, 6)
    d["jitter_apply"] = jax.random.bernoulli(
        kp, cfg.jitter_p if jitter_p is None else jitter_p)
    d["brightness"] = _u(kb, (), 1 - cfg.jitter_brightness,
                         1 + cfg.jitter_brightness)
    d["contrast"] = _u(kc, (), 1 - cfg.jitter_contrast,
                       1 + cfg.jitter_contrast)
    d["saturation"] = _u(ks, (), 1 - cfg.jitter_saturation,
                         1 + cfg.jitter_saturation)
    d["hue"] = _u(kh, (), -cfg.jitter_hue, cfg.jitter_hue) * 2.0 * jnp.pi
    d["order"] = jax.random.permutation(ko, 4)
    kp, kn, ky, kx, kh_, kw_ = jax.random.split(k5, 6)
    lo, hi = cfg.dropout_holes
    d["hole_apply"] = jax.random.bernoulli(
        kp, cfg.dropout_p if dropout_p is None else dropout_p)
    d["hole_n"] = jax.random.randint(kn, (), lo, hi + 1)
    d["hole_h"] = _u(kh_, (hi,), *cfg.dropout_size)
    d["hole_w"] = _u(kw_, (hi,), *cfg.dropout_size)
    d["hole_y"] = _u(ky, (hi,), 0.0, 1.0)
    d["hole_x"] = _u(kx, (hi,), 0.0, 1.0)
    return d


def _stack_draws(per_image) -> DetectionDraws:
    return DetectionDraws(**{
        f.name: torch.from_numpy(np.array([np.asarray(d[f.name])
                                           for d in per_image]))
        for f in dataclasses.fields(DetectionDraws)})


def _keys(n, seed):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def test_random_shadow_with_jax_draws():
    images, _, _ = _batch(6, 32, 1, seed=0)
    keys = _keys(6, 1)
    ref = np.stack([np.asarray(jax_augment.random_shadow(
        jax.random.split(k, 5)[0], jnp.asarray(im), p=0.8))
        for k, im in zip(keys, images)])
    d = _stack_draws([_jax_draws(k, shadow_p=0.8) for k in keys])
    got = augment.random_shadow(torch.from_numpy(images), d.shadow_apply,
                                d.shadow_n, d.shadow_angle, d.shadow_ox,
                                d.shadow_oy, d.shadow_intensity)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    assert not np.array_equal(ref, images)


def test_coarse_dropout_with_jax_draws():
    images, _, _ = _batch(6, 40, 1, seed=2)
    keys = _keys(6, 3)
    ref = np.stack([np.asarray(jax_augment.coarse_dropout(
        jax.random.split(k, 5)[4], jnp.asarray(im), p=0.9,
        hole_height=(0.05, 0.12), hole_width=(0.05, 0.12)))
        for k, im in zip(keys, images)])
    d = _stack_draws([_jax_draws(k, dropout_p=0.9) for k in keys])
    got = augment.coarse_dropout(torch.from_numpy(images), d.hole_apply,
                                 d.hole_n, d.hole_h, d.hole_w, d.hole_y,
                                 d.hole_x)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 1.0).any()


def test_flip_with_boxes_matches_jax():
    images, boxes, _ = _batch(4, 16, 3, seed=4)
    keys = _keys(4, 5)
    refs = [jax_augment.random_horizontal_flip(
        jax.random.split(k, 5)[1], jnp.asarray(im), jnp.asarray(bx))
        for k, im, bx in zip(keys, images, boxes)]
    d = _stack_draws([_jax_draws(k) for k in keys])
    got_im = augment.horizontal_flip(torch.from_numpy(images), d.flip)
    got_bx = augment.flip_boxes(torch.from_numpy(boxes), d.flip)
    np.testing.assert_array_equal(got_im.numpy(),
                                  np.stack([np.asarray(r[0]) for r in refs]))
    np.testing.assert_allclose(got_bx.numpy(),
                               np.stack([np.asarray(r[1]) for r in refs]),
                               atol=1e-7)


def test_color_jitter_with_jax_draws():
    images, _, _ = _batch(8, 16, 1, seed=6)
    keys = _keys(8, 7)
    kw = dict(brightness=0.1, contrast=0.15, saturation=0.2, hue=0.03)
    ref = np.stack([np.asarray(jax_augment.color_jitter(
        jax.random.split(k, 5)[3], jnp.asarray(im), p=0.9, **kw))
        for k, im in zip(keys, images)])
    draws = [_jax_draws(k, jitter_p=0.9) for k in keys]
    assert len({tuple(np.asarray(d["order"])) for d in draws}) > 1
    d = _stack_draws(draws)
    got = augment.color_jitter(torch.from_numpy(images), d.jitter_apply,
                               d.brightness, d.contrast, d.saturation,
                               d.hue, d.order)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_affine_matrix_and_warp_match_jax():
    """The forward matrix, then the shear warp given JAX's own inverse."""
    images, _, _ = _batch(3, 40, 1, seed=8)
    keys = _keys(3, 9)
    d = _stack_draws([_jax_draws(k) for k in keys])
    fwd = augment.affine_matrix(40, 40, d.theta_deg, d.scale, d.translate,
                                d.shear_deg)
    for i, k in enumerate(keys):
        km = jax.random.split(jax.random.split(k, 5)[2])[1]
        jfwd = jax_augment._affine_matrix(km, 40, 40, degrees=45.0,
                                          scale=(0.95, 1.05),
                                          translate=0.05, shear=15.0)
        np.testing.assert_allclose(fwd[i].numpy(), np.asarray(jfwd),
                                   rtol=1e-6, atol=1e-5)
        inv = jnp.linalg.inv(jfwd)
        ref = jax_augment._shear_matmul_warp(jnp.asarray(images[i]), inv)
        got = augment.shear_matmul_warp(
            torch.from_numpy(images[i:i + 1]),
            torch.from_numpy(np.array(inv))[None])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref),
                                   atol=ATOL)


@pytest.mark.parametrize("method", ["ellipse", "largest_box"])
def test_random_affine_with_boxes_matches_jax(method):
    images, boxes, mask = _batch(6, 40, 4, seed=10)
    keys = _keys(6, 11)
    refs = [jax_augment.random_affine(
        jax.random.split(k, 5)[2], jnp.asarray(im), jnp.asarray(bx),
        jnp.asarray(ms), p=0.5, box_method=method,
        warp_variant="shear_matmul")
        for k, im, bx, ms in zip(keys, images, boxes, mask)]
    d = _stack_draws([_jax_draws(k) for k in keys])
    assert 0 < int(d.affine_apply.sum()) < 6
    got = augment.random_affine(
        *(torch.from_numpy(a) for a in (images, boxes, mask)),
        d.affine_apply, d.theta_deg, d.scale, d.translate, d.shear_deg,
        box_method=method)
    for j, name in enumerate(("images", "boxes")):
        np.testing.assert_allclose(
            got[j].numpy(), np.stack([np.asarray(r[j]) for r in refs]),
            atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.stack([np.asarray(r[2]) for r in refs]))


def _pixels(normalized):
    """Back to [0, 1] pixels: normalization divides by std ~0.225, which
    would scale the pixel tolerance by 4.4."""
    return normalized * np.asarray(augment.IMAGENET_STD, np.float32) + \
        np.asarray(augment.IMAGENET_MEAN, np.float32)


def test_detection_train_augment_with_jax_draws():
    """The whole pipeline on a 40 canvas down to 32, eight images: every
    op with the JAX defaults' probabilities; pixels compared before the
    normalization, boxes and masks as they come out."""
    images, boxes, mask = _batch(8, 40, 5, seed=12)
    keys = _keys(8, 13)
    refs = [jax_augment.detection_train_augment(
        k, jnp.asarray(im), jnp.asarray(bx), jnp.asarray(ms), JCFG)
        for k, im, bx, ms in zip(keys, images, boxes, mask)]
    d = _stack_draws([_jax_draws(k) for k in keys])
    got = augment.detection_train_augment(
        *(torch.from_numpy(a) for a in (images, boxes, mask)), d, PCFG)
    assert got[0].shape == (8, 32, 32, 3)
    np.testing.assert_allclose(
        _pixels(got[0].numpy()),
        _pixels(np.stack([np.asarray(r[0]) for r in refs])), atol=ATOL)
    np.testing.assert_allclose(
        got[1].numpy(), np.stack([np.asarray(r[1]) for r in refs]),
        atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.stack([np.asarray(r[2]) for r in refs]))


def test_port_draws_ranges_and_host_apply():
    d = augment.draw_detection_augment(generator(1, 2, 3), 4000, PCFG)
    assert abs(float(d.affine_apply.float().mean()) - 0.5) < 0.03
    assert abs(float(d.jitter_apply.float().mean()) - 0.6) < 0.03
    assert abs(float(d.hole_apply.float().mean()) - 0.25) < 0.03
    assert set(d.shadow_n.tolist()) == {1, 2, 3}
    assert float(d.theta_deg.abs().max()) <= 45.0
    assert float(d.hue.abs().max()) <= 0.03 * 2 * np.pi + 1e-6
    assert torch.equal(d.order.sort(dim=1).values,
                       torch.arange(4).expand(4000, 4))
    moved = d.to("meta")
    assert moved.affine_apply.device.type == "cpu"
    assert moved.flip.device.type == "meta"


@pytest.mark.parametrize("kw", [dict(interpolation="lanczos4"),
                                dict(warp_variant="taps")],
                         ids=["lanczos4", "taps"])
def test_detection_resamplers_match_jax(kw):
    """The whole pipeline, as `test_detection_train_augment_with_jax_draws`,
    through the reference's Lanczos-4 and through the ``taps`` gather
    warp; an unknown name raises KeyError where JAX's lookup does."""
    images, boxes, mask = _batch(8, 40, 5, seed=14)
    keys = _keys(8, 15)
    jcfg = dataclasses.replace(JCFG, **kw)
    refs = [jax_augment.detection_train_augment(
        k, jnp.asarray(im), jnp.asarray(bx), jnp.asarray(ms), jcfg)
        for k, im, bx, ms in zip(keys, images, boxes, mask)]
    d = _stack_draws([_jax_draws(k) for k in keys])
    assert int(d.affine_apply.sum()) > 0
    cfg = dataclasses.replace(PCFG, **kw)
    got = augment.detection_train_augment(
        *(torch.from_numpy(a) for a in (images, boxes, mask)), d, cfg)
    np.testing.assert_allclose(
        _pixels(got[0].numpy()),
        _pixels(np.stack([np.asarray(r[0]) for r in refs])), atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.stack([np.asarray(r[2]) for r in refs]))
    name = "interpolation" if "interpolation" in kw else "warp_variant"
    with pytest.raises(KeyError):
        augment.draw_detection_augment(
            generator(0), 2, dataclasses.replace(cfg, **{name: "cubic"}))
