"""The JAX package's environment switches that the port reads, against
JAX's own reading under the same setting, on the CPU:
``ARSVT_DISABLE_PALLAS`` (the two training opt-ins), ``ARSVT_SHEAR_MAXSKEW``
(the shear warp's pad), ``ARSVT_WARP_VARIANT`` (the detection warp when
the config leaves it empty) and ``ARSVT_AUGMENT_BF16`` (the warp and what
follows it in bf16)."""

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


def _port_affine(img, key, cfg):
    """The port's random_affine with the draws of JAX's
    ``random_affine(key, img, p=1.0)``, through cfg's warp."""
    _, km = jax.random.split(key)
    ka, ks, kt, ksh = jax.random.split(km, 4)

    def u(k, shape, lo, hi):
        return torch.from_numpy(np.array(jax.random.uniform(
            k, shape, minval=lo, maxval=hi)))[None]

    out, _, _ = augment.random_affine(
        torch.from_numpy(img)[None], torch.zeros(1, 1, 4),
        torch.zeros(1, 1, dtype=torch.bool), torch.ones(1, dtype=torch.bool),
        u(ka, (), -45.0, 45.0), u(ks, (), 0.95, 1.05),
        u(kt, (2,), -0.05, 0.05), u(ksh, (2,), -15.0, 15.0),
        warp_variant=augment.warp_variant(cfg))
    return out[0]


@pytest.mark.parametrize("variant", ["shear_matmul", "taps"])
def test_warp_variant_is_read_where_the_config_leaves_it(variant,
                                                         monkeypatch):
    """With warp_variant "" both sides read ARSVT_WARP_VARIANT: the port's
    random_affine equals JAX's on each variant (atol 1e-5); the config's
    own variant wins over the environment."""
    monkeypatch.setenv("ARSVT_WARP_VARIANT", variant)
    monkeypatch.delenv("ARSVT_AUGMENT_BF16", raising=False)
    cfg = augment.DetectionAugmentConfig(image_size=16)
    assert augment.warp_variant(cfg) == variant
    img, _ = _shear_case()
    key = jax.random.PRNGKey(3)
    ref = jax_augment.random_affine(key, jnp.asarray(img), p=1.0)
    assert np.isfinite(np.asarray(ref)).all()
    draws = augment.draw_detection_augment(generator(0), 1, cfg)
    assert draws.flip.shape == (1,)
    np.testing.assert_allclose(_port_affine(img, key, cfg).numpy(),
                               np.asarray(ref), atol=1e-5)
    explicit = augment.DetectionAugmentConfig(warp_variant="shear_matmul")
    monkeypatch.setenv("ARSVT_WARP_VARIANT", "taps")
    assert augment.warp_variant(explicit) == "shear_matmul"


def test_augment_bf16_warps_in_bf16_as_jax(monkeypatch):
    """Under ARSVT_AUGMENT_BF16 both sides warp (and continue) in bf16:
    the port's random_affine returns bf16 within two bf16 steps (2^-7) of
    JAX's; unset, both return fp32."""
    monkeypatch.setenv("ARSVT_AUGMENT_BF16", "1")
    monkeypatch.delenv("ARSVT_WARP_VARIANT", raising=False)
    img, _ = _shear_case()
    key = jax.random.PRNGKey(0)
    out = jax_augment.random_affine(key, jnp.asarray(img), p=1.0)
    assert out.dtype == jnp.bfloat16
    cfg = augment.DetectionAugmentConfig(image_size=16)
    got = _port_affine(img, key, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(out.astype(jnp.float32)),
                               atol=2.0 ** -7)
    assert augment.augment_input_cast(torch.zeros(1)).dtype == torch.bfloat16
    monkeypatch.delenv("ARSVT_AUGMENT_BF16")
    assert _port_affine(img, key, cfg).dtype == torch.float32
    assert augment.augment_input_cast(torch.zeros(1)).dtype == torch.float32
