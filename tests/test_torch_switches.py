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


# ---------------------------------------------------------------- routes
# The three switches that take a route off (JAX ``ops/dispatch.py:35-36,
# 48-74``), each held by the route the port takes (the functions it calls;
# on the card the launch table, ``chip_smoke.py`` phase 16(c)) and by the
# logits and gradients against JAX's under the same switch, at a head_dim
# 64 classifier's parity limits (``test_torch_vit.py``: fp32, summation
# order: logits 2e-5; gradients 1e-4 of each leaf's largest value).
ROUTE_SMALL = dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
                   num_heads=2, mlp_dim=256)


def _classifier_pair():
    from arsvt_tpu.models.classifier import (
        init_image_classifier as jax_init,
    )
    from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
    from arsvt_tpu_torch.models.bridge import from_jax_params
    from arsvt_tpu_torch.models.vit import BackboneConfig

    jcfg = JaxBackboneConfig(**ROUTE_SMALL)
    params = jax_init(jax.random.PRNGKey(0), jcfg, 6)
    params["classifier"] = jax.tree_util.tree_map(
        lambda x: 0.2 * jax.random.normal(jax.random.PRNGKey(7), x.shape,
                                          x.dtype), params["classifier"])
    cfg = BackboneConfig(**ROUTE_SMALL)
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jcfg, params, cfg, port


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("switch", [None, "ARSVT_DISABLE_FUSED_ATTN",
                                    "ARSVT_ATTN_JNP", "ARSVT_DISABLE_LN_VJP"])
def test_a_switch_takes_its_route_and_matches_jax(switch, monkeypatch):
    from arsvt_tpu.models.classifier import (
        apply_image_classifier as jax_apply,
    )
    from arsvt_tpu_torch.core.dtypes import named_leaves
    from arsvt_tpu_torch.models import vit
    from arsvt_tpu_torch.models.bridge import from_jax_params
    from arsvt_tpu_torch.models.classifier import apply_image_classifier
    from arsvt_tpu_torch.ops import attention, flash_attention, layernorm

    for name in ("ARSVT_DISABLE_FUSED_ATTN", "ARSVT_ATTN_JNP",
                 "ARSVT_DISABLE_LN_VJP"):
        monkeypatch.delenv(name, raising=False)
    if switch:
        monkeypatch.setenv(switch, "1")
    calls = {}
    _spy(monkeypatch, vit, "fused_encoder_attention", calls)
    _spy(monkeypatch, flash_attention, "flash_self_attention_packed", calls)
    _spy(monkeypatch, attention, "sdpa_reference", calls)
    _spy(monkeypatch, layernorm._LayerNorm, "apply", calls)

    jcfg, jparams, cfg, port = _classifier_pair()
    x = np.random.default_rng(12).uniform(size=(3, 32, 32, 3)).astype(
        np.float32)
    w = np.random.default_rng(13).standard_normal((3, 6)).astype(np.float32)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(port)]
    logits = apply_image_classifier(port, torch.from_numpy(x), cfg, 6)
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(), leaves)

    route = {"fused_encoder_attention": 0, "flash_self_attention_packed": 0,
             "sdpa_reference": 0, "apply": 0}
    route.update(calls)
    want = {None: ("fused_encoder_attention", "apply"),
            "ARSVT_DISABLE_FUSED_ATTN": ("flash_self_attention_packed",
                                         "apply"),
            "ARSVT_ATTN_JNP": ("sdpa_reference", "apply"),
            "ARSVT_DISABLE_LN_VJP": ("fused_encoder_attention",)}[switch]
    assert {k for k, v in route.items() if v} == set(want), route

    def jax_loss(p):
        return jnp.sum(jnp.asarray(w) * jax_apply(p, jnp.asarray(x), jcfg, 6))

    ref = np.asarray(jax_apply(jparams, jnp.asarray(x), jcfg, 6))
    np.testing.assert_allclose(logits.detach().numpy(), ref, atol=2e-5)
    jgrads = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax.grad(jax_loss)(jparams)), cfg)
    for (name, a), g in zip(named_leaves(jgrads), grads):
        scale = max(float(np.abs(a.numpy()).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-4 * scale,
                                   err_msg=f"{switch} {name}")


def test_attn_jnp_takes_the_reference_for_cpu_tensors_only(monkeypatch):
    """``ARSVT_ATTN_JNP`` sends CPU tensors to `sdpa_reference`; a tensor
    on another device (the card's; here a meta tensor) stays on the head-
    major kernels' route, and the fused head_dim-64 route is off on both,
    as ``ARSVT_DISABLE_FUSED_ATTN`` takes it off."""
    from arsvt_tpu_torch.ops import attention, flash_attention

    monkeypatch.setenv("ARSVT_ATTN_JNP", "1")
    taken = []
    monkeypatch.setattr(flash_attention, "flash_self_attention_packed",
                        lambda *a, **k: taken.append("kernel") or "kernel")
    monkeypatch.setattr(flash_attention, "flash_attention",
                        lambda *a, **k: taken.append("kernel") or "kernel")
    monkeypatch.setattr(attention, "sdpa_reference",
                        lambda q, *a, **k: taken.append("plain") or q)
    for device in ("cpu", "meta"):
        qkv = torch.zeros(1, 4, 24, device=device)
        q = torch.zeros(1, 2, 4, 4, device=device)
        attention.self_attention_from_qkv(qkv, 2)
        attention.multi_head_attention(q, q, q)
    assert taken == ["plain", "plain", "kernel", "kernel"]
    assert not dispatch.use_fused_encoder_attention()
    monkeypatch.delenv("ARSVT_ATTN_JNP")
    assert not dispatch.force_plain_attention(torch.zeros(1))
    assert dispatch.use_fused_encoder_attention()
