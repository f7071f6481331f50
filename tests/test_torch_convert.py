"""The port's checkpoint conversion (``arsvt_tpu_torch/models/convert.py``)
against the JAX package's (``arsvt_tpu/models/convert.py``), one test for
each of ``tests/test_convert.py``'s.

The state dicts are synthetic, seeded numpy arrays with the real key names
and shapes of timm, HF and the reference repo's detector (nothing is
downloaded). Conversions must equal JAX's conversion of the same dict,
carried over by ``models/bridge.py``, to the bit; forwards run in fp32 on
the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.models import convert as jax_convert
from arsvt_tpu.models.classifier import (
    apply_image_classifier as jax_apply_image_classifier,
)
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.serving.loading import (
    load_inference_bundle as jax_load_inference_bundle,
)
from arsvt_tpu.train.config import resolve_backbone as jax_resolve_backbone
from arsvt_tpu_torch.core.dtypes import named_leaves
from arsvt_tpu_torch.models import convert
from arsvt_tpu_torch.models.bridge import (
    detector_from_jax_params,
    from_jax_params,
)
from arsvt_tpu_torch.models.classifier import apply_image_classifier
from arsvt_tpu_torch.models.detector import apply_detector
from arsvt_tpu_torch.models.registry import DETECTOR_PRESETS, get_preset
from arsvt_tpu_torch.models.vit import BackboneConfig, apply_backbone
from arsvt_tpu_torch.serving.loading import load_inference_bundle
from arsvt_tpu_torch.train.config import resolve_backbone

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SMALL = dict(image_size=32, patch_size=8, embed_dim=32, depth=2,
             num_heads=2, mlp_dim=64)
# fp32 forwards of the same weights in the two packages: the same
# arithmetic summed in other orders, a few ulps of values of order 1
ATOL_FP32 = 1e-5


def _w(rng, *shape):
    return rng.normal(0, 0.02, shape).astype(np.float32)


def timm_state(cfg, *, seed=1, distilled=False) -> dict:
    """A timm ViT/DeiT state dict for `cfg` (pos_embed over every token,
    the DIST token's included)."""
    rng = np.random.default_rng(seed)
    d, m, p = cfg.embed_dim, cfg.mlp_dim, cfg.patch_size
    s = {"patch_embed.proj.weight": _w(rng, d, 3, p, p),
         "patch_embed.proj.bias": _w(rng, d),
         "cls_token": _w(rng, 1, 1, d),
         "pos_embed": _w(rng, 1, cfg.seq_len, d),
         "norm.weight": _w(rng, d), "norm.bias": _w(rng, d)}
    if distilled:
        s["dist_token"] = _w(rng, 1, 1, d)
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        s.update({
            b + "norm1.weight": _w(rng, d), b + "norm1.bias": _w(rng, d),
            b + "attn.qkv.weight": _w(rng, 3 * d, d),
            b + "attn.qkv.bias": _w(rng, 3 * d),
            b + "attn.proj.weight": _w(rng, d, d),
            b + "attn.proj.bias": _w(rng, d),
            b + "norm2.weight": _w(rng, d), b + "norm2.bias": _w(rng, d),
            b + "mlp.fc1.weight": _w(rng, m, d),
            b + "mlp.fc1.bias": _w(rng, m),
            b + "mlp.fc2.weight": _w(rng, d, m),
            b + "mlp.fc2.bias": _w(rng, d),
        })
    return s


def hf_state(cfg, *, seed=2, prefix="") -> dict:
    """An HF ViTModel state dict for `cfg` (q, k, v apart);
    ViTForImageClassification's carries the "vit." prefix."""
    rng = np.random.default_rng(seed)
    d, m, p = cfg.embed_dim, cfg.mlp_dim, cfg.patch_size
    s = {"embeddings.patch_embeddings.projection.weight": _w(rng, d, 3, p, p),
         "embeddings.patch_embeddings.projection.bias": _w(rng, d),
         "embeddings.cls_token": _w(rng, 1, 1, d),
         "embeddings.position_embeddings": _w(rng, 1, cfg.seq_len, d),
         "layernorm.weight": _w(rng, d), "layernorm.bias": _w(rng, d)}
    for i in range(cfg.depth):
        b = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            s[b + f"attention.attention.{n}.weight"] = _w(rng, d, d)
            s[b + f"attention.attention.{n}.bias"] = _w(rng, d)
        s.update({
            b + "attention.output.dense.weight": _w(rng, d, d),
            b + "attention.output.dense.bias": _w(rng, d),
            b + "intermediate.dense.weight": _w(rng, m, d),
            b + "intermediate.dense.bias": _w(rng, m),
            b + "output.dense.weight": _w(rng, d, m),
            b + "output.dense.bias": _w(rng, d),
            b + "layernorm_before.weight": _w(rng, d),
            b + "layernorm_before.bias": _w(rng, d),
            b + "layernorm_after.weight": _w(rng, d),
            b + "layernorm_after.bias": _w(rng, d),
        })
    return {prefix + k: v for k, v in s.items()}


def reference_detector_state(det, seed=0) -> dict:
    """The reference's DeiTObjectDetector keys and shapes, wrapped in its
    checkpoint envelope (model_state_dict + epoch, val_loss, config)."""
    bb = det.backbone
    d, m = bb.embed_dim, bb.mlp_dim
    q, ffn, c = det.head.num_queries, det.head.ffn_dim, det.head.num_classes
    rng = np.random.default_rng(seed)
    s = {"backbone.patch_embedding.projection.weight": _w(
             rng, d, 3, bb.patch_size, bb.patch_size),
         "backbone.patch_embedding.projection.bias": _w(rng, d),
         "backbone.cls_token": _w(rng, 1, 1, d),
         "backbone.dist_token": _w(rng, 1, 1, d),
         "backbone.position_embedding": _w(rng, 1, bb.seq_len, d),
         "backbone.layer_norm.weight": _w(rng, d),
         "backbone.layer_norm.bias": _w(rng, d),
         "triplet_projection.weight": _w(rng, det.triplet_dim, d),
         "triplet_projection.bias": _w(rng, det.triplet_dim),
         "detection_head.object_queries": _w(rng, q, d),
         "detection_head.class_head.weight": _w(rng, c + 1, d),
         "detection_head.class_head.bias": _w(rng, c + 1),
         "detection_head.bbox_head.weight": _w(rng, 4, d),
         "detection_head.bbox_head.bias": _w(rng, 4)}
    for i in range(bb.depth):
        b = f"backbone.transformer_blocks.{i}."
        s.update({
            b + "attention.qkv.weight": _w(rng, 3 * d, d),
            b + "attention.qkv.bias": _w(rng, 3 * d),
            b + "attention.projection.weight": _w(rng, d, d),
            b + "attention.projection.bias": _w(rng, d),
            b + "mlp.linear1.weight": _w(rng, m, d),
            b + "mlp.linear1.bias": _w(rng, m),
            b + "mlp.linear2.weight": _w(rng, d, m),
            b + "mlp.linear2.bias": _w(rng, d),
            b + "layer_norm1.weight": _w(rng, d),
            b + "layer_norm1.bias": _w(rng, d),
            b + "layer_norm2.weight": _w(rng, d),
            b + "layer_norm2.bias": _w(rng, d),
        })
    for i in range(det.head.depth):
        b = f"detection_head.decoder.layers.{i}."
        for a in ("self_attn", "multihead_attn"):
            s.update({b + f"{a}.in_proj_weight": _w(rng, 3 * d, d),
                      b + f"{a}.in_proj_bias": _w(rng, 3 * d),
                      b + f"{a}.out_proj.weight": _w(rng, d, d),
                      b + f"{a}.out_proj.bias": _w(rng, d)})
        s.update({b + "linear1.weight": _w(rng, ffn, d),
                  b + "linear1.bias": _w(rng, ffn),
                  b + "linear2.weight": _w(rng, d, ffn),
                  b + "linear2.bias": _w(rng, d)})
        for n in ("norm1", "norm2", "norm3"):
            s[b + f"{n}.weight"] = _w(rng, d)
            s[b + f"{n}.bias"] = _w(rng, d)
    return {"model_state_dict": s, "epoch": 3, "val_loss": 0.5,
            "config": {"EMBED_DIM": d}}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _zero_heads(cfg, num_classes=6) -> dict:
    head = {"kernel": np.zeros((cfg.embed_dim, num_classes), np.float32),
            "bias": np.zeros(num_classes, np.float32)}
    out = {"head": head}
    if cfg.distilled:
        out["head_dist"] = dict(head)
    return out


def _bridged_backbone(jax_backbone, cfg) -> dict:
    tree = {"backbone": _numpy(jax_backbone), "classifier": _zero_heads(cfg)}
    return from_jax_params(tree, cfg)["backbone"]


def assert_same_tree(got, ref):
    got, ref = dict(named_leaves(got)), dict(named_leaves(ref))
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        assert torch.equal(got[name].cpu(), ref[name].cpu()), name


@pytest.mark.parametrize("source", ["timm", "timm_deit", "hf", "hf_vit."])
def test_state_dict_converts_as_jax(source):
    """timm (ViT and DeiT, with dist_token) and HF (ViTModel, and
    ViTForImageClassification's "vit." prefix) state dicts: the port's
    tree equals JAX's conversion of the same dict to the bit, and the
    forward runs to finite tokens of the right shape."""
    distilled = source == "timm_deit"
    cfg = BackboneConfig(**SMALL, distilled=distilled)
    jcfg = JaxBackboneConfig(**SMALL, distilled=distilled)
    state = (timm_state(cfg, distilled=distilled)
             if source.startswith("timm")
             else hf_state(cfg, prefix="vit." if "vit." in source else ""))
    assert convert.detect_source(convert._strip_prefix(state)) == \
        jax_convert.detect_source(jax_convert._strip_prefix(state)) == \
        source.split("_")[0]
    got = convert.from_pretrained_state(state, cfg)
    assert_same_tree(got, _bridged_backbone(
        jax_convert.from_pretrained_state(state, jcfg), cfg))
    out = apply_backbone(got, torch.zeros(1, 32, 32, 3), cfg)
    assert out.shape == (1, cfg.seq_len, 32)
    assert torch.isfinite(out).all()


def test_hf_qkv_concatenates_query_key_value_in_order():
    """HF keeps q, k and v apart: the fused (D, 3D) kernel takes them in
    that order, each transposed; the patch conv becomes (p*p*C, D) in
    (kh, kw, c) order, matching extract_patches."""
    from arsvt_tpu_torch.ops.patch_embed import extract_patches

    cfg = BackboneConfig(**SMALL)
    state = hf_state(cfg)
    got = convert.from_pretrained_state(state, cfg)
    b = "encoder.layer.1.attention.attention."
    qkv = got["blocks"][1]["attn"]["qkv"]["kernel"].numpy()
    for i, n in enumerate(("query", "key", "value")):
        np.testing.assert_array_equal(qkv[:, 32 * i:32 * (i + 1)],
                                      state[b + f"{n}.weight"].T)
    w = state["embeddings.patch_embeddings.projection.weight"]
    x = np.random.default_rng(3).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(x.transpose(0, 3, 1, 2)), torch.from_numpy(w),
        stride=8).flatten(2).transpose(1, 2)
    patches = extract_patches(torch.from_numpy(x), 8)
    np.testing.assert_allclose(
        (patches @ got["patch_embed"]["kernel"]).numpy(), conv.numpy(),
        atol=ATOL_FP32, rtol=0)


def test_hf_vit_forward_parity():
    """The HF ViTModel forward against the port's forward of its converted
    weights, at JAX's limit (HF's exact-erf GELU against the tanh
    approximation of both packages)."""
    transformers = pytest.importorskip("transformers")

    hf_cfg = transformers.ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=32, patch_size=8,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    torch.manual_seed(0)
    model = transformers.ViTModel(hf_cfg, add_pooling_layer=False).eval()
    cfg = BackboneConfig(**SMALL, ln_eps=hf_cfg.layer_norm_eps)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = convert.from_pretrained_state(state, cfg)
    images = np.random.default_rng(0).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(images.transpose(0, 3, 1, 2))
                    ).last_hidden_state.numpy()
        ours = apply_backbone(params, torch.from_numpy(images), cfg).numpy()
    assert np.abs(ours - ref).max() < 5e-3


def test_config_mismatch_raises():
    """A 32-wide state dict under a 64-wide config fails with JAX's error."""
    state = timm_state(BackboneConfig(**{**SMALL, "depth": 1}))
    cfg = BackboneConfig(**{**SMALL, "depth": 1, "embed_dim": 64})
    with pytest.raises(ValueError, match="does not match config") as got:
        convert.from_pretrained_state(state, cfg)
    with pytest.raises(ValueError) as ref:
        jax_convert.from_pretrained_state(
            state, JaxBackboneConfig(**{**SMALL, "depth": 1,
                                        "embed_dim": 64}))
    assert str(got.value) == str(ref.value)


def test_reference_detector_converts_as_jax():
    """The reference detector envelope: the port's detector tree equals
    JAX's conversion to the bit (backbone exact, the decoder's identity
    ln_cross_kv and ones/zeros ln_f as JAX maps them), and it runs."""
    from arsvt_tpu.models.registry import (
        DETECTOR_PRESETS as JAX_DETECTOR_PRESETS,
    )

    det = DETECTOR_PRESETS["detector_test"]
    state = reference_detector_state(det)
    got = convert.from_reference_detector_state(state, det)
    ref = jax_convert.from_reference_detector_state(
        state, JAX_DETECTOR_PRESETS["detector_test"])
    assert_same_tree(got, detector_from_jax_params(_numpy(ref), det))
    d = det.backbone.embed_dim
    assert torch.equal(got["detr"]["blocks"][0]["ln_cross_kv"]["scale"],
                       torch.ones(d))
    out, feats = apply_detector(got, torch.zeros(2, 32, 32, 3), det,
                                return_features=True)
    q, c = det.head.num_queries, det.head.num_classes
    assert out["class_logits"].shape == (2, q, c + 1)
    assert out["boxes_cxcywh"].shape == (2, q, 4)
    assert feats.shape == (2, det.triplet_dim)
    assert torch.isfinite(out["class_logits"]).all()


def test_load_torch_state_unwraps_envelopes(tmp_path):
    """A torch.save'd reference envelope (model_state_dict + int epoch +
    float val_loss) and a {"state_dict": ...} one load to their tensors
    alone, as JAX's loader reads them; a .safetensors file loads through
    safetensors.numpy."""
    path = str(tmp_path / "best_vit_detector.pth")
    torch.save({"model_state_dict": {"w": torch.ones(2, 3)}, "epoch": 7,
                "val_loss": 0.25}, path)
    for load in (convert.load_torch_state, jax_convert.load_torch_state):
        state = load(path)
        assert set(state) == {"w"} and state["w"].shape == (2, 3)
    path = str(tmp_path / "timm.pt")
    torch.save({"state_dict": {"a": torch.arange(4.0)}, "meta": "x"}, path)
    assert set(convert.load_torch_state(path)) == {"a"}
    safetensors = pytest.importorskip("safetensors.numpy")
    path = str(tmp_path / "model.safetensors")
    safetensors.save_file({"b": np.ones((2, 2), np.float32)}, path)
    np.testing.assert_array_equal(convert.load_torch_state(path)["b"],
                                  np.ones((2, 2), np.float32))


def _save_state(path, state):
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)


@pytest.mark.parametrize("source", ["hf", "timm"])
def test_import_gives_the_same_checkpoint_as_jax(tmp_path, source):
    """`import_torch_checkpoint` on the same file in both packages
    (train preset "smoke"): the port's `load_inference_bundle` gives JAX's
    params to the bit and JAX's config, the source's ln_eps included (HF
    1e-12, timm 1e-6); with a seeded head both give the same logits."""
    from arsvt_tpu.models.convert import (
        import_torch_checkpoint as jax_import,
    )

    bb = get_preset("vit_test_8_32")
    path = str(tmp_path / f"{source}.bin")
    _save_state(path, hf_state(bb) if source == "hf" else timm_state(bb))
    manifest = convert.import_torch_checkpoint(
        path, str(tmp_path / "port"), train_preset="smoke", device="cpu")
    jmanifest = jax_import(path, str(tmp_path / "jax"),
                           train_preset="smoke")
    for key in ("train_preset", "task", "imported", "source_keys"):
        assert manifest[key] == jmanifest[key]
    params, cfg = load_inference_bundle(str(tmp_path / "port"))
    jparams, jcfg = jax_load_inference_bundle(str(tmp_path / "jax"))
    # the same config but for where each package wrote its checkpoint
    assert cfg.with_overrides(checkpoint_dir="").to_json() == \
        jcfg.with_overrides(checkpoint_dir="").to_json()
    assert cfg.ln_eps == {"hf": 1e-12, "timm": 1e-6}[source]
    bcfg = resolve_backbone(cfg)
    assert_same_tree(params, from_jax_params(_numpy(jparams), bcfg))

    rng = np.random.default_rng(4)
    head = {"kernel": rng.standard_normal((32, 6)).astype(np.float32),
            "bias": rng.standard_normal(6).astype(np.float32)}
    params["classifier"]["head"] = {k: torch.from_numpy(v)
                                    for k, v in head.items()}
    jparams["classifier"]["head"] = {k: jnp.asarray(v)
                                     for k, v in head.items()}
    images = rng.random((2, 32, 32, 3)).astype(np.float32)
    logits = apply_image_classifier(params, torch.from_numpy(images), bcfg,
                                    6)
    with jax.default_matmul_precision("highest"):
        jlogits = jax_apply_image_classifier(
            jparams, jnp.asarray(images), jax_resolve_backbone(jcfg), 6,
            force_reference=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL_FP32, rtol=0)


def test_import_reference_detector(tmp_path):
    """A reference .pth through source="reference" into a detect
    checkpoint (the preset's default ln_eps kept), equal to JAX's import;
    a classify preset on that file fails with JAX's error."""
    from arsvt_tpu.models.convert import (
        import_torch_checkpoint as jax_import,
    )

    det = DETECTOR_PRESETS["detector_test"]
    path = str(tmp_path / "best_vit_detector.pth")
    env = reference_detector_state(det)
    torch.save({k: torch.from_numpy(v)
                for k, v in env["model_state_dict"].items()} | {"epoch": 3},
               path)
    over = {"preset": "detector_test", "batch_size": 2}
    manifest = convert.import_torch_checkpoint(
        path, str(tmp_path / "port"), train_preset="deit_detector_ref",
        source="reference", overrides=over, device="cpu")
    jax_import(path, str(tmp_path / "jax"),
               train_preset="deit_detector_ref", source="reference",
               overrides=over)
    assert manifest["task"] == "detect"
    assert manifest["imported"] == ["backbone", "detr", "triplet_proj"]
    params, cfg = load_inference_bundle(str(tmp_path / "port"))
    jparams, _ = jax_load_inference_bundle(str(tmp_path / "jax"))
    assert cfg.preset == "detector_test" and cfg.ln_eps == 0.0
    assert_same_tree(params, detector_from_jax_params(_numpy(jparams), det))
    with pytest.raises(ValueError, match="detect train preset"):
        convert.import_torch_checkpoint(
            path, str(tmp_path / "port2"), train_preset="smoke",
            device="cpu")


def _errors(tmp_path, **kw):
    """The error of each package's import of the same reference file."""
    from arsvt_tpu.models.convert import (
        import_torch_checkpoint as jax_import,
    )

    det = DETECTOR_PRESETS["detector_test"]
    path = str(tmp_path / "ref.pth")
    _save_state(path, reference_detector_state(det)["model_state_dict"])
    with pytest.raises(ValueError) as got:
        convert.import_torch_checkpoint(path, str(tmp_path / "port"),
                                        device="cpu", **kw)
    with pytest.raises(ValueError) as ref:
        jax_import(path, str(tmp_path / "jax"), **kw)
    return str(got.value), str(ref.value)


def test_source_mismatch_raises(tmp_path):
    """--source hf on a reference detector file points to --source
    reference, with JAX's message."""
    got, ref = _errors(tmp_path, train_preset="smoke", source="hf")
    assert "--source reference" in got and got == ref


def test_shape_mismatch_raises(tmp_path):
    """A source whose leaves disagree with the target preset (a 7-way
    class head into a 3-class preset) fails the import with JAX's message,
    naming the first leaf in JAX's order and both shapes, and writes no
    checkpoint."""
    got, ref = _errors(
        tmp_path, train_preset="deit_detector_ref", source="reference",
        overrides={"preset": "detector_test", "batch_size": 2,
                   "num_classes": 3})
    assert "'class_head/bias' has shape (7,)" in got
    assert "expects (4,)" in got and got == ref
    assert not (tmp_path / "port").exists() or not list(
        (tmp_path / "port").iterdir())


def test_cli_main_writes_a_checkpoint(tmp_path, monkeypatch, capsys):
    """``python -m arsvt_tpu_torch.models.convert`` with ARSVT_PLATFORM=cpu:
    the manifest on stdout, a step-0 checkpoint whose backbone is the
    converted timm weights and whose config carries --ln-eps."""
    monkeypatch.setenv("ARSVT_PLATFORM", "cpu")
    bb = get_preset("vit_test_8_32")
    state = timm_state(bb)
    path = str(tmp_path / "timm.pth")
    _save_state(path, state)
    out = str(tmp_path / "ckpt")
    convert.main(["--torch-state", path, "--checkpoint-dir", out,
                  "--train-preset", "smoke", "--ln-eps", "1e-6"])
    manifest = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert manifest["imported"] == ["backbone"]
    params, cfg = load_inference_bundle(out)
    assert cfg.ln_eps == 1e-6 and cfg.preset == "vit_test_8_32"
    assert_same_tree(params["backbone"],
                     convert.from_pretrained_state(state, bb))
