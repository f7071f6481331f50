"""The port's int8 W8A8 inference (``ops/quant.py``, ``models/quantized.py``,
the int8 bridge and the engines' ``quantize="int8"``) against the JAX
package's, on the same seeded inputs and bridged weights, on the CPU.

Where the port's attention and JAX's CPU reference differ in a last bit
(the port's plain version of #1 rounds the unnormalised probabilities,
JAX's reference normalises first; LayerNorm sums in another order), the
per-token activation quantization can turn that bit into a one-step
flip of an int8 value. In fp32 most logits then agree to ~1e-6 and a
flip moves a logit by up to ~1e-2 (measured 0.0134, relative L2 4.6e-4,
on the distilled head_dim-64 model); the fp32 limits are set above one
flip and far below a wrong weight or scale, which moves every logit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from arsvt_tpu.evaluation.classify import (
    StreamingClassifier as JaxStreamingClassifier,
)
from arsvt_tpu.evaluation.classify import (
    StreamingDetector as JaxStreamingDetector,
)
from arsvt_tpu.evaluation.classify import (
    evaluate_classifier as jax_evaluate_classifier,
)
from arsvt_tpu.models.classifier import (
    init_image_classifier as jax_init_image_classifier,
)
from arsvt_tpu.models.detector import init_detector as jax_init_detector
from arsvt_tpu.models.quantized import (
    apply_detector_int8 as jax_apply_detector_int8,
)
from arsvt_tpu.models.quantized import (
    apply_image_classifier_int8 as jax_apply_image_classifier_int8,
)
from arsvt_tpu.models.quantized import (
    quantize_detector as jax_quantize_detector,
)
from arsvt_tpu.models.quantized import (
    quantize_image_classifier as jax_quantize_image_classifier,
)
from arsvt_tpu.models.registry import DETECTOR_PRESETS as JAX_DETECTOR_PRESETS
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.ops import quant as jax_quant
from arsvt_tpu.data import native_loader as jax_native_loader
from arsvt_tpu_torch.data import native_loader as port_native_loader
from arsvt_tpu_torch.evaluation.classify import (
    StreamingClassifier,
    StreamingDetector,
    evaluate_classifier,
)
from arsvt_tpu_torch.models.bridge import (
    detector_from_jax_params,
    from_jax_params,
    detector_to_jax_params,
    quantized_classifier_from_jax,
    quantized_detector_from_jax,
    to_jax_params,
)
from arsvt_tpu_torch.models.quantized import (
    apply_detector_int8,
    apply_image_classifier_int8,
    quantize_detector,
    quantize_image_classifier,
)
from arsvt_tpu_torch.models.registry import get_detector_preset
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.ops import encoder_attention, flash_attention, quant

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# vit_test_8_32 (head_dim 16: the head-major kernel #3) and a head_dim-64
# model (the encoder-attention kernel #1)
SHAPES = {
    "d16": dict(image_size=32, patch_size=8, embed_dim=32, depth=2,
                num_heads=2, mlp_dim=64),
    "d64": dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
                num_heads=2, mlp_dim=256),
}
# logits, port against JAX (see the module docstring): relative L2 over
# the batch, and the largest single difference
REL_FP32, ATOL_FP32 = 1e-3, 0.05
# bf16: on top of the flips, bf16 roundings at other sites on either side
# (measured rel 0.0135, max 0.113 on logits of magnitude 7)
REL_BF16, ATOL_BF16 = 0.03, 0.25
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48), (768, 2304)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    ref = _np(jax_quant.quantize_weight(w, axis=-2))
    got = quant.quantize_weight(torch.from_numpy(w), axis=-2)
    assert got["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["q"].numpy(), ref["q"])
    np.testing.assert_array_max_ulp(got["scale"].numpy(), ref["scale"],
                                    maxulp=1)
    # the round trip stays within half a quantization step
    deq = quant.dequantize_weight(got).numpy()
    step = np.expand_dims(got["scale"].numpy(), -2)
    assert np.all(np.abs(deq - w) <= step / 2 + 1e-6)


def test_quantize_activation_matches_jax():
    x = np.random.default_rng(1).normal(size=(4, 17, 64)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero token takes the eps scale
    q_ref, s_ref = (np.asarray(t) for t in
                    jax_quant.quantize_activation(jnp.asarray(x)))
    q, s = quant.quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_max_ulp(s.numpy(), s_ref, maxulp=1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_dense_matches_jax(dtype):
    """(4, 17, 64) x (64, 32): the int32 sums are exact on both sides and
    the dequant and bias run in the same fp32 order, so the results agree
    to one ulp of the output dtype."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 17, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    ref = np.asarray(jax_quant.quant_dense(
        jnp.asarray(x).astype(jdt), jax_quant.quantize_weight(w),
        jnp.asarray(b)).astype(jnp.float32))
    got = quant.quant_dense(torch.from_numpy(x).to(tdt),
                            quant.quantize_weight(torch.from_numpy(w)),
                            torch.from_numpy(b))
    assert got.dtype == tdt and got.shape == (4, 17, 32)
    np.testing.assert_array_max_ulp(got.float().numpy(), ref, maxulp=1)
    out = quant.quant_dense(torch.from_numpy(x),
                            quant.quantize_weight(torch.from_numpy(w)),
                            out_dtype=torch.float32)
    ref_fp = x @ w
    assert _rel(out.numpy(), ref_fp) < 0.03  # JAX's limit against fp32


@pytest.mark.parametrize("m, k, n", [(5, 30, 20), (16, 64, 24), (17, 8, 8),
                                     (200, 129, 77)])
def test_int8_matmul_pads_exactly(m, k, n):
    """Rows, K and N off the card's shape rules are zero-padded: the int32
    result equals the exact integer product."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (k, n), dtype=np.int8)
    got = quant.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def _classifier(name, distilled=False):
    """JAX params with a seeded head (the zero init gives flat logits),
    JAX's int8 tree and its bridge into the port."""
    small = SHAPES[name]
    jcfg = JaxBackboneConfig(**small, distilled=distilled)
    cfg = BackboneConfig(**small, distilled=distilled)
    params = jax_init_image_classifier(jax.random.PRNGKey(0), jcfg, 6)
    params["classifier"] = jax.tree_util.tree_map(
        lambda t: 0.3 * jax.random.normal(jax.random.PRNGKey(7), t.shape),
        params["classifier"])
    qparams = jax_quantize_image_classifier(params, jcfg)
    return jcfg, cfg, params, qparams


def _images(n, seed=5):
    return np.random.default_rng(seed).uniform(size=(n, 32, 32, 3)).astype(
        np.float32)


def _assert_logits_close(got, ref, dtype):
    rel, atol = (REL_FP32, ATOL_FP32) if dtype == "fp32" else (REL_BF16,
                                                               ATOL_BF16)
    assert _rel(got, ref) < rel
    assert np.abs(got - ref).max() < atol
    assert (got.argmax(-1) == ref.argmax(-1)).all()


@pytest.mark.parametrize("distilled", [False, True],
                         ids=["plain", "distilled"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_quantize_image_classifier_equals_jax_tree(name, distilled):
    """The port's quantize_image_classifier on bridged fp32 params gives
    JAX's int8 tree, bit for bit; the int8 bridge round-trips."""
    jcfg, cfg, params, qparams = _classifier(name, distilled)
    own = quantize_image_classifier(from_jax_params(_np(params), cfg), cfg)
    bridged = quantized_classifier_from_jax(_np(qparams), cfg)
    own_leaves = jax.tree_util.tree_leaves(own)
    assert len(own_leaves) == len(jax.tree_util.tree_leaves(bridged))
    for a, b in zip(own_leaves, jax.tree_util.tree_leaves(bridged)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    fc1 = own["backbone"]["blocks"][0]["mlp"]["fc1"]["kernel"]
    assert fc1["q"].dtype == torch.int8
    back = to_jax_params(own)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np(qparams))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="expected a dict"):
        quantized_classifier_from_jax(_np(params), cfg)  # not quantized


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("distilled", [False, True],
                         ids=["plain", "distilled"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_int8_classifier_matches_jax(name, distilled, dtype):
    jcfg, cfg, _, qparams = _classifier(name, distilled)
    tdt, jdt = DTYPES[dtype]
    images = _images(16)
    ref = np.asarray(jax_apply_image_classifier_int8(
        qparams, jnp.asarray(images).astype(jdt), jcfg, 6,
        compute_dtype=jdt))
    port = quantized_classifier_from_jax(_np(qparams), cfg)
    counts = (encoder_attention.LAUNCHES, flash_attention.LAUNCHES)
    got = apply_image_classifier_int8(port, torch.from_numpy(images).to(tdt),
                                      cfg, 6, compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (16, 6)
    _assert_logits_close(got.numpy(), ref, dtype)
    # on the CPU no kernel launches: the plain versions ran
    assert (encoder_attention.LAUNCHES, flash_attention.LAUNCHES) == counts


def _detector():
    jcfg = JAX_DETECTOR_PRESETS["detector_test"]
    cfg = get_detector_preset("detector_test")
    params = jax_init_detector(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, params, jax_quantize_detector(params, jcfg)


# detector outputs, port against JAX: fp32 logits and boxes as the
# classifier's logits; bf16 (measured rel 0.0072 on the logits, 0.0023 on
# the boxes)
DET_REL = {"fp32": 1e-3, "bf16": 0.03}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_detector_matches_jax(dtype):
    jcfg, cfg, params, qparams = _detector()
    tdt, jdt = DTYPES[dtype]
    images = _images(4, seed=11)
    ref = jax_apply_detector_int8(qparams, jnp.asarray(images).astype(jdt),
                                  jcfg, compute_dtype=jdt)
    port = quantized_detector_from_jax(_np(qparams), cfg)
    got = apply_detector_int8(port, torch.from_numpy(images).to(tdt), cfg,
                              compute_dtype=tdt)
    for k in ("class_logits", "boxes_cxcywh"):
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape and got[k].dtype == torch.float32
        assert _rel(got[k].numpy(), r) < DET_REL[dtype], k
    assert (got["class_logits"].numpy().argmax(-1)
            == np.asarray(ref["class_logits"]).argmax(-1)).mean() >= 0.9
    # the port's own quantization equals JAX's; the head stays fp, as is
    own = quantize_detector(detector_from_jax_params(_np(params), cfg), cfg)
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(port)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert own["detr"]["class_head"]["kernel"].dtype == torch.float32
    for a, b in zip(jax.tree_util.tree_leaves(detector_to_jax_params(own)),
                    jax.tree_util.tree_leaves(_np(qparams))):
        np.testing.assert_array_equal(a, b)


def test_evaluate_classifier_int8_matches_jax():
    jcfg, cfg, params, _ = _classifier("d16")
    images = _images(32)
    labels = np.random.default_rng(9).integers(0, 6, 32)
    batches = [{"image": images[i:i + 16], "label": labels[i:i + 16]}
               for i in (0, 16)]
    ref = jax_evaluate_classifier(
        params, iter([{k: jnp.asarray(v) for k, v in b.items()}
                      for b in batches]), jcfg, 6,
        compute_dtype=jnp.float32, quantize="int8")
    got = evaluate_classifier(from_jax_params(_np(params), cfg),
                              iter(batches), cfg, 6,
                              compute_dtype=torch.float32, quantize="int8",
                              device="cpu")
    assert got["n"] == ref["n"] == 32
    assert got["confusion_matrix"] == np.asarray(
        ref["confusion_matrix"]).tolist()
    assert got["top1"] == ref["top1"]
    with pytest.raises(ValueError, match="quantize"):
        evaluate_classifier(from_jax_params(_np(params), cfg), iter(batches),
                            cfg, 6, quantize="int4", device="cpu")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_streaming_classifier_int8_matches_jax(name):
    jcfg, cfg, params, _ = _classifier(name)
    jax_clf = JaxStreamingClassifier(params, jcfg, 6,
                                     compute_dtype=jnp.float32,
                                     quantize="int8")
    port_clf = StreamingClassifier(from_jax_params(_np(params), cfg), cfg, 6,
                                   compute_dtype=torch.float32,
                                   quantize="int8", device="cpu")
    leaf = port_clf._params["backbone"]["blocks"][0]["attn"]["qkv"]["kernel"]
    assert leaf["q"].dtype == torch.int8
    rng = np.random.default_rng(3)
    for _ in range(3):
        img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        j_idx, j_name, j_probs = jax_clf(img)
        idx, cname, probs = port_clf(img)
        assert (idx, cname) == (j_idx, j_name)
        # probabilities of logits within ATOL_FP32 move by at most half
        # of it
        np.testing.assert_allclose(probs, j_probs, atol=ATOL_FP32 / 2)
    batch = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    j_idx, j_probs = jax_clf.infer_batch(batch)
    idx, probs = port_clf.infer_batch(batch)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(probs, j_probs, atol=ATOL_FP32 / 2)
    with pytest.raises(ValueError, match="quantize"):
        StreamingClassifier(from_jax_params(_np(params), cfg), cfg, 6,
                            quantize="int4", device="cpu")


def test_streaming_classifier_preprocess_matches_jax():
    """`preprocess` maps each image before the range check and the
    forward, as JAX's: here a horizontal flip, and a crop-and-resize that
    turns a larger frame into the model's input."""
    jcfg, cfg, params, _ = _classifier("d16")

    def crop_flip(image):
        a = np.asarray(image)[4:-4, 4:-4, ::-1]
        return np.array(Image.fromarray(a).resize((32, 32),
                                                  Image.BILINEAR))

    jax_clf = JaxStreamingClassifier(params, jcfg, 6,
                                     compute_dtype=jnp.float32,
                                     preprocess=crop_flip)
    port_clf = StreamingClassifier(from_jax_params(_np(params), cfg), cfg, 6,
                                   compute_dtype=torch.float32,
                                   preprocess=crop_flip, device="cpu")
    plain = StreamingClassifier(from_jax_params(_np(params), cfg), cfg, 6,
                                compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(2):
        img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
        j_idx, _, j_probs = jax_clf(img)
        idx, _, probs = port_clf(img)
        assert idx == j_idx
        np.testing.assert_allclose(probs, j_probs, atol=1e-5)
        np.testing.assert_allclose(probs, plain(crop_flip(img))[2],
                                   atol=1e-6)


def test_streaming_detector_int8_matches_jax(tmp_path, monkeypatch):
    jcfg, cfg, params, _ = _detector()
    monkeypatch.setattr(jax_native_loader, "available", lambda: False)
    monkeypatch.setattr(port_native_loader, "available", lambda: False)
    jax_det = JaxStreamingDetector(params, jcfg, compute_dtype=jnp.float32,
                                   conf_threshold=0.2, quantize="int8")
    port_det = StreamingDetector(detector_from_jax_params(_np(params), cfg),
                                 cfg, compute_dtype=torch.float32,
                                 conf_threshold=0.2, quantize="int8",
                                 device="cpu")
    n = 0
    for seed in range(2):
        path = tmp_path / f"frame{seed}.png"
        Image.fromarray(np.random.default_rng(seed).integers(
            0, 256, (32, 32, 3), dtype=np.uint8)).save(path)
        ref = jax_det.detect_path(str(path))
        got = port_det.detect_path(str(path))
        assert list(got["labels"]) == list(ref["labels"])
        np.testing.assert_allclose(got["boxes"], np.asarray(ref["boxes"]),
                                   atol=1e-3)
        np.testing.assert_allclose(got["scores"], np.asarray(ref["scores"]),
                                   atol=1e-3)
        n += len(got["labels"])
    assert n > 0  # the comparison has detections
    with pytest.raises(ValueError, match="quantize"):
        StreamingDetector(detector_from_jax_params(_np(params), cfg), cfg,
                          quantize="fp4", device="cpu")


def test_int8_weights_are_a_quarter_of_fp32():
    """The five quantized families hold one byte a weight (plus a fp32
    scale per output channel) where the fp32 tree holds four."""
    _, cfg, params, _ = _classifier("d64")
    port = from_jax_params(_np(params), cfg)
    qtree = quantize_image_classifier(port, cfg)

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in jax.tree_util.tree_leaves(tree))

    blocks_fp, blocks_q = (nbytes(t["backbone"]["blocks"])
                           for t in (port, qtree))
    assert blocks_q < 0.3 * blocks_fp
