"""The JAX package's environment switches that the port reads, against
JAX's own reading under the same setting, on the CPU:
``ARSVT_DISABLE_PALLAS`` (the two training opt-ins), ``ARSVT_SHEAR_MAXSKEW``
(the shear warp's pad), ``ARSVT_WARP_VARIANT`` (the detection warp when
the config leaves it empty) and ``ARSVT_AUGMENT_BF16`` (the warp in bf16,
which the port refuses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.data import augment as jax_augment
from arsvt_tpu.ops import dispatch as jax_dispatch
from arsvt_tpu_torch.core.prng import generator
from arsvt_tpu_torch.data import augment
from arsvt_tpu_torch.ops import dispatch

torch.set_num_threads(1)  # tier-1 runs several xdist workers

OPT_INS = ("ARSVT_ATTN_SAVE_PROBS", "ARSVT_ENABLE_FUSED_MLP")


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("disable", [None, "1"])
def test_disable_pallas_turns_off_both_opt_ins(disable, monkeypatch):
    """Both opt-ins set, JAX on its Pallas route (ARSVT_FORCE_PALLAS):
    each side takes both; with ARSVT_DISABLE_PALLAS neither does."""
    for name in OPT_INS:
        monkeypatch.setenv(name, "1")
    monkeypatch.setenv("ARSVT_FORCE_PALLAS", "1")
    if disable is None:
        monkeypatch.delenv("ARSVT_DISABLE_PALLAS", raising=False)
    else:
        monkeypatch.setenv("ARSVT_DISABLE_PALLAS", disable)
    want = disable is None
    assert jax_dispatch.use_attn_save_probs() is want
    assert jax_dispatch.use_fused_mlp() is want
    assert dispatch.use_attn_save_probs() is want
    assert dispatch.use_fused_mlp() is want


def _shear_case(size=16):
    """One image and an out->src map with |x shear| b3 = m01/m00 = 1.2,
    centred so that the sheared rows still cover the image."""
    img = np.random.default_rng(0).random((size, size, 3)).astype(np.float32)
    inv = np.array([[1.0, 1.2, -9.6], [0.1, 0.9, 0.5], [0.0, 0.0, 1.0]],
                   np.float32)
    return img, inv


@pytest.mark.parametrize("skew", ["0.5", "2.5"])
def test_shear_maxskew_sizes_the_pad_as_jax(skew, monkeypatch):
    """JAX reads ARSVT_SHEAR_MAXSKEW once, at import (its module constant
    is set here as that import would have set it); the port reads it at
    each call. Equal warps at the same setting (atol 1e-5, the warp tests'
    limit); at skew 0.5 the pad no longer covers the shear, so the warp
    differs from the default's."""
    img, inv = _shear_case()
    monkeypatch.delenv("ARSVT_SHEAR_MAXSKEW", raising=False)
    default = augment.shear_matmul_warp(torch.from_numpy(img)[None],
                                        torch.from_numpy(inv)[None])[0]
    monkeypatch.setenv("ARSVT_SHEAR_MAXSKEW", skew)
    monkeypatch.setattr(jax_augment, "_SHEAR_MAX_SKEW", float(skew))
    ref = jax_augment._shear_matmul_warp(jnp.asarray(img), jnp.asarray(inv))
    got = augment.shear_matmul_warp(torch.from_numpy(img)[None],
                                    torch.from_numpy(inv)[None])[0]
    assert augment.shear_max_skew() == float(skew)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if skew == "0.5":
        assert not np.allclose(got.numpy(), default.numpy(), atol=1e-3)
    else:
        np.testing.assert_allclose(got.numpy(), default.numpy(), atol=1e-5)


@pytest.mark.parametrize("variant", ["shear_matmul", "taps"])
def test_warp_variant_is_read_where_the_config_leaves_it(variant,
                                                         monkeypatch):
    """With warp_variant "" both sides read ARSVT_WARP_VARIANT: at
    shear_matmul the port's random_affine equals JAX's (atol 1e-5); JAX
    also runs its gather warp for "taps", which the port has not ported
    and refuses, naming the ROADMAP item."""
    monkeypatch.setenv("ARSVT_WARP_VARIANT", variant)
    monkeypatch.delenv("ARSVT_AUGMENT_BF16", raising=False)
    cfg = augment.DetectionAugmentConfig(image_size=16)
    assert augment.warp_variant(cfg) == variant
    img, _ = _shear_case()
    key = jax.random.PRNGKey(3)
    ref = jax_augment.random_affine(key, jnp.asarray(img), p=1.0)
    assert np.isfinite(np.asarray(ref)).all()
    if variant == "taps":
        with pytest.raises(NotImplementedError, match="Queue A item 8"):
            augment.draw_detection_augment(generator(0), 2, cfg)
        return
    draws = augment.draw_detection_augment(generator(0), 1, cfg)
    assert draws.flip.shape == (1,)
    kp, km = jax.random.split(key)
    fwd = jax_augment._affine_matrix(km, 16, 16, degrees=45.0,
                                     scale=(0.95, 1.05), translate=0.05,
                                     shear=15.0)
    got = augment.shear_matmul_warp(
        torch.from_numpy(img)[None],
        torch.from_numpy(np.array(jnp.linalg.inv(fwd)))[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # the config's own variant wins over the environment
    explicit = augment.DetectionAugmentConfig(warp_variant="shear_matmul")
    monkeypatch.setenv("ARSVT_WARP_VARIANT", "taps")
    assert augment.warp_variant(explicit) == "shear_matmul"


def test_augment_bf16_warps_in_bf16_in_jax_and_raises_in_the_port(
        monkeypatch):
    """JAX warps (and continues) in bf16 under ARSVT_AUGMENT_BF16; the port
    has no bf16 augmentation and refuses the switch, in the draws and in
    the apply."""
    monkeypatch.setenv("ARSVT_AUGMENT_BF16", "1")
    monkeypatch.delenv("ARSVT_WARP_VARIANT", raising=False)
    img, _ = _shear_case()
    out = jax_augment.random_affine(jax.random.PRNGKey(0), jnp.asarray(img),
                                    p=1.0)
    assert out.dtype == jnp.bfloat16
    cfg = augment.DetectionAugmentConfig(image_size=16)
    with pytest.raises(NotImplementedError, match="ARSVT_AUGMENT_BF16"):
        augment.draw_detection_augment(generator(0), 2, cfg)
    monkeypatch.delenv("ARSVT_AUGMENT_BF16")
    draws = augment.draw_detection_augment(generator(0), 2, cfg)
    monkeypatch.setenv("ARSVT_AUGMENT_BF16", "1")
    images = torch.rand(2, 16, 16, 3)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        augment.detection_train_augment(
            images, torch.zeros(2, 1, 4), torch.zeros(2, 1, dtype=torch.bool),
            draws, cfg)
