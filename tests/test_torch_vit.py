"""The port's ViT ops, parameter bridge and classifier against the JAX
package, on the CPU at a small config with head_dim 64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.models.classifier import (
    apply_image_classifier as jax_apply_image_classifier,
)
from arsvt_tpu.models.classifier import (
    init_image_classifier as jax_init_image_classifier,
)
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.ops.layernorm import layer_norm as jax_layer_norm
from arsvt_tpu.ops.mlp import gelu_mlp as jax_gelu_mlp
from arsvt_tpu.ops.mlp import gelu_tanh as jax_gelu_tanh
from arsvt_tpu.ops.patch_embed import patch_embed as jax_patch_embed
from arsvt_tpu_torch.models.bridge import (
    from_jax_params,
    jax_layout_shapes,
    to_jax_params,
)
from arsvt_tpu_torch.models.classifier import (
    apply_image_classifier,
    init_image_classifier,
)
from arsvt_tpu_torch.models.registry import get_preset
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.ops.layernorm import layer_norm
from arsvt_tpu_torch.ops.mlp import gelu_mlp, gelu_tanh
from arsvt_tpu_torch.ops.patch_embed import patch_embed

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SMALL = dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
             num_heads=2, mlp_dim=256)
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# fp32: same arithmetic, other summation order. bf16 op-level: both round
# each op's output to bf16, so one bf16 ulp (2^-8 relative) with slack for
# a flipped rounding: atol = rtol = 2^-7.
TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=2.0 ** -7, rtol=2.0 ** -7)}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _both(x, dtype):
    return (jnp.asarray(x).astype(_JAX[dtype]),
            torch.from_numpy(x).to(_TORCH[dtype]))


def _close(got, ref, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


def test_unit_float_normalize_and_policy_match_jax():
    """uint8 -> [0,1] multiplies by the fp32 reciprocal of 255 on both
    sides (bit-equal); normalize runs in the image dtype (fp32 order)."""
    from arsvt_tpu.core.dtypes import to_unit_float as jax_to_unit_float
    from arsvt_tpu.data.augment import normalize as jax_normalize
    from arsvt_tpu_torch.core.dtypes import Policy, to_unit_float
    from arsvt_tpu_torch.data.augment import normalize

    u8 = np.arange(256 * 3, dtype=np.int64).astype(np.uint8).reshape(
        16, 16, 3)
    ref = jax_to_unit_float(jnp.asarray(u8))
    got = to_unit_float(torch.from_numpy(u8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(normalize(got).numpy(),
                               np.asarray(jax_normalize(ref)), atol=1e-6)
    tree = {"w": torch.ones(2), "step": torch.zeros(2, dtype=torch.int32),
            "blocks": [torch.ones(1)]}
    cast = Policy().cast_to_compute(tree)
    assert cast["w"].dtype == cast["blocks"][0].dtype == torch.bfloat16
    assert cast["step"].dtype == torch.int32
    assert Policy().cast_to_param(cast)["w"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    x, scale, bias = _rand((3, 7, 128), 0, 3.0), _rand((128,), 1), _rand(
        (128,), 2)
    jx, tx = _both(x, dtype)
    ref = jax_layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias), eps=1e-6)
    got = layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                     eps=1e-6)
    assert got.dtype == _TORCH[dtype]
    _close(got, ref, dtype)


def test_gelu_is_the_tanh_approximation():
    u = _rand((1000,), 3, 4.0)
    got = gelu_tanh(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_gelu_tanh(jnp.asarray(u))),
                               atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(u))
    assert float((got - erf).abs().max()) > 1e-4  # not the erf GELU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    x = _rand((2, 9, 64), 4)
    w1, b1 = _rand((64, 256), 5, 0.125), _rand((256,), 6, 0.1)
    w2, b2 = _rand((256, 64), 7, 0.0625), _rand((64,), 8, 0.1)
    jx, tx = _both(x, dtype)
    jw = [jnp.asarray(w).astype(_JAX[dtype]) for w in (w1, w2)]
    ref = jax_gelu_mlp(jx, jw[0], jnp.asarray(b1), jw[1], jnp.asarray(b2),
                       force_reference=True)
    got = gelu_mlp(tx, torch.from_numpy(w1), torch.from_numpy(b1),
                   torch.from_numpy(w2), torch.from_numpy(b2))
    assert got.dtype == _TORCH[dtype]
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_embed_matches_jax(dtype):
    images = np.random.default_rng(9).uniform(
        size=(2, 32, 24, 3)).astype(np.float32)
    kernel, bias = _rand((8 * 8 * 3, 128), 10, 0.07), _rand((128,), 11)
    ji, ti = _both(images, dtype)
    ref = jax_patch_embed(ji, jnp.asarray(kernel), jnp.asarray(bias),
                          patch_size=8)
    got = patch_embed(ti, torch.from_numpy(kernel), torch.from_numpy(bias),
                      patch_size=8)
    assert got.shape == (2, 12, 128) and got.dtype == _TORCH[dtype]
    _close(got, ref, dtype)


def _jax_params(distilled, seed=0):
    jcfg = JaxBackboneConfig(**SMALL, distilled=distilled)
    params = jax_init_image_classifier(jax.random.PRNGKey(seed), jcfg, 6)
    # the head is zero-init: randomise it so logits depend on the backbone
    params["classifier"] = jax.tree_util.tree_map(
        lambda x: 0.2 * jax.random.normal(jax.random.PRNGKey(7), x.shape,
                                          x.dtype),
        params["classifier"],
    )
    return jcfg, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("distilled", [False, True])
def test_bridge_round_trip(distilled):
    cfg = BackboneConfig(**SMALL, distilled=distilled)
    _, _, tree = _jax_params(distilled)
    port = from_jax_params(tree, cfg)
    assert len(port["backbone"]["blocks"]) == cfg.depth
    qkv = port["backbone"]["blocks"][1]["attn"]["qkv"]["kernel"]
    np.testing.assert_array_equal(
        qkv.numpy(), tree["backbone"]["blocks"]["attn"]["qkv"]["kernel"][1])
    assert port["backbone"]["patch_embed"]["kernel"].shape == (8 * 8 * 3,
                                                               128)
    back = to_jax_params(port)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("distilled", [False, True])
def test_port_init_has_the_jax_tree_and_shapes(distilled):
    cfg = BackboneConfig(**SMALL, distilled=distilled)
    _, _, tree = _jax_params(distilled)
    mine = to_jax_params(init_image_classifier(cfg, 6, seed=3))
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # and it round-trips through the bridge's own check
    from_jax_params(mine, cfg)
    head = mine["classifier"]["head"]
    assert not head["kernel"].any() and not head["bias"].any()  # zero init


def test_init_is_seeded():
    cfg = BackboneConfig(**SMALL)
    a, b, c = (init_image_classifier(cfg, 6, seed=s) for s in (1, 1, 2))
    pa, pb, pc = (a["backbone"]["blocks"][0]["mlp"]["fc1"]["kernel"],
                  b["backbone"]["blocks"][0]["mlp"]["fc1"]["kernel"],
                  c["backbone"]["blocks"][0]["mlp"]["fc1"]["kernel"])
    assert torch.equal(pa, pb) and not torch.equal(pa, pc)
    tok = a["backbone"]["pos_embed"]
    assert float(tok.abs().max()) <= 0.04 + 1e-7  # truncated at 2 sigma


def test_bridge_rejects_a_mismatched_tree():
    cfg = BackboneConfig(**SMALL)
    _, _, tree = _jax_params(False)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tree, BackboneConfig(**{**SMALL, "mlp_dim": 128}))
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(tree, BackboneConfig(**SMALL, distilled=True))
    broken = dict(tree, backbone={k: v for k, v in tree["backbone"].items()
                                  if k != "ln_f"})
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(broken, cfg)
    with pytest.raises(ValueError, match="classifier/head/kernel"):
        from_jax_params({"backbone": tree["backbone"]}, cfg)
    assert jax_layout_shapes(cfg, 6)["backbone"]["blocks"]["mlp"]["fc1"][
        "kernel"] == (2, 128, 256)


@pytest.mark.parametrize("distilled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_logits_match_jax(distilled, dtype):
    """fp32: same arithmetic, other summation order (measured ~2e-6 on
    logits of magnitude 5), so atol 2e-5. bf16: the JAX CPU path runs the
    normalise-first attention reference and XLA may keep excess precision
    between fused elementwise ops, while the port rounds every op to bf16
    and casts the unnormalised p; over two blocks that is about 1% of the
    logit scale (measured 0.04), so atol 0.1."""
    cfg = BackboneConfig(**SMALL, distilled=distilled)
    jcfg, params, tree = _jax_params(distilled)
    port = from_jax_params(tree, cfg)
    x = np.random.default_rng(12).uniform(size=(3, 32, 32, 3)).astype(
        np.float32)
    jx, tx = _both(x, dtype)
    ref = np.asarray(jax_apply_image_classifier(params, jx, jcfg, 6))
    got = apply_image_classifier(port, tx, cfg, 6)
    assert got.dtype == torch.float32 and got.shape == (3, 6)
    atol = 2e-5 if dtype == "float32" else 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=atol)


def test_distilled_head_requires_head_dist():
    cfg = BackboneConfig(**SMALL, distilled=True)
    params = init_image_classifier(cfg, 6)
    del params["classifier"]["head_dist"]
    with pytest.raises(ValueError, match="head_dist"):
        apply_image_classifier(params, torch.zeros(1, 32, 32, 3), cfg, 6)


def test_backbone_takes_head_dim_64_only():
    """The fused encoder-attention path takes head_dim 64 only, which every
    ViT preset has; a backbone of another head_dim (vit_test_8_32, d=16)
    runs qkv-proj → the head-major attention kernel → out-proj instead,
    and matches JAX (fp32, summation order only)."""
    from arsvt_tpu_torch.ops.encoder_attention import fused_encoder_attention

    cfg = get_preset("vit_test_8_32")  # head_dim 16
    w = torch.zeros(32, 96)
    with pytest.raises(ValueError, match="head_dim"):
        fused_encoder_attention(torch.zeros(1, 17, 32), w, w[0],
                                torch.zeros(32, 32), torch.zeros(32), 2)
    for name in ("vit_tiny_16_224", "vit_small_16_224", "vit_base_16_224",
                 "vit_large_16_384"):
        assert get_preset(name).head_dim == 64
    jcfg = JaxBackboneConfig(**dataclasses.asdict(cfg))
    params = jax_init_image_classifier(jax.random.PRNGKey(1), jcfg, 6)
    params["classifier"] = jax.tree_util.tree_map(
        lambda x: 0.2 * jax.random.normal(jax.random.PRNGKey(7), x.shape,
                                          x.dtype), params["classifier"])
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg)
    x = np.random.default_rng(13).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jax_apply_image_classifier(params, jnp.asarray(x),
                                                jcfg, 6))
    with torch.inference_mode():
        got = apply_image_classifier(port, torch.from_numpy(x), cfg, 6)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
