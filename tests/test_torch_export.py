"""The port's ``torch.export`` artifacts (``serving/export.py``,
``serving/artifact.py``, ``InferenceServer.from_artifact`` and the two
command lines) on the CPU: round trips, the symbolic batch, the normalize
contract, the custom ops of the kernels in the graph, agreement with the
in-process engines and with the JAX package's own ``jax.export``
artifacts on the same uint8 images and bridged weights.

Limits: an artifact and the engine in the same process run the same ops
on the same device, 1e-6. Against JAX's artifact in fp32, as the engines
(``tests/test_torch_serving.py``): 1e-5; with int8, one int8 flip moves a
logit by up to 0.05 (``tests/test_torch_quant.py``) and a probability by
at most half of that. The checkpoints' artifacts compute in bf16 on both
sides: the bf16 limit of ``tests/test_torch_serving_checkpoint.py``.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.models.classifier import init_image_classifier
from arsvt_tpu.models.detector import init_detector
from arsvt_tpu.models.registry import DETECTOR_PRESETS as JAX_DETECTOR_PRESETS
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.serving import export as jax_export
from arsvt_tpu.serving.loading import (
    load_inference_bundle as jax_load_inference_bundle,
)
from arsvt_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu.train.config import resolve_detector as jax_resolve_detector
from arsvt_tpu_torch.evaluation.classify import (
    StreamingClassifier,
    StreamingDetector,
)
from arsvt_tpu_torch.evaluation.detect import post_process
from arsvt_tpu_torch.models.bridge import (
    detector_from_jax_params,
    from_jax_params,
)
from arsvt_tpu_torch.models.registry import get_detector_preset
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.ops import library
from arsvt_tpu_torch.serving import export
from arsvt_tpu_torch.serving.artifact import (
    ArtifactClassifier,
    ArtifactDetector,
    load_artifact_engine,
)
from arsvt_tpu_torch.serving.server import InferenceServer
from arsvt_tpu_torch.train.checkpoint import CheckpointManager
from arsvt_tpu_torch.train.config import TrainConfig, resolve_detector

torch.set_num_threads(1)  # tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
            mlp_dim=64)  # vit_test_8_32
ATOL_SAME = 1e-6
ATOL_FP32 = 1e-5
ATOL_INT8_PROBS = 0.05 / 2
ATOL_BF16 = 0.05
CONF = 0.2  # low enough that the random-init DETR head keeps a few boxes
STEP = 3


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(batch, size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (batch, size, size,
                                                         3), dtype=np.uint8)


@pytest.fixture(scope="module")
def classifier():
    jcfg, cfg = JaxBackboneConfig(**TINY), BackboneConfig(**TINY)
    params = init_image_classifier(jax.random.PRNGKey(0), jcfg, 6)
    params["classifier"] = jax.tree_util.tree_map(
        lambda t: 0.3 * jax.random.normal(jax.random.PRNGKey(7), t.shape),
        params["classifier"])
    return jcfg, cfg, params, from_jax_params(_np(params), cfg)


@pytest.fixture(scope="module")
def detector():
    jcfg = JAX_DETECTOR_PRESETS["detector_test"]
    cfg = get_detector_preset("detector_test")
    params = init_detector(jax.random.PRNGKey(1), jcfg)
    return jcfg, cfg, params, detector_from_jax_params(_np(params), cfg)


@pytest.fixture(scope="module")
def artifacts(classifier, detector, tmp_path_factory):
    """fp32 artifacts of both models, plain and int8, saved once."""
    root = tmp_path_factory.mktemp("artifacts")
    _, cfg, _, params = classifier
    _, dcfg, _, dparams = detector
    paths = {}
    for quantize in (None, "int8"):
        clf = export.export_classifier(params, cfg, 6,
                                       compute_dtype=torch.float32,
                                       quantize=quantize, device="cpu")
        det = export.export_detector(dparams, dcfg,
                                     compute_dtype=torch.float32,
                                     quantize=quantize, conf_threshold=CONF,
                                     device="cpu")
        for name, ep in (("classify", clf), ("detect", det)):
            path = str(root / f"{name}_{quantize}.pt2")
            export.save_exported(ep, path)
            paths[name, quantize] = path
    return paths


QUANT = pytest.mark.parametrize("quantize", [None, "int8"],
                                ids=["bf16_route", "int8"])


@QUANT
def test_classifier_artifact_round_trip_and_symbolic_batch(
        artifacts, classifier, quantize):
    jcfg, cfg, jparams, params = classifier
    program = export.load_exported(artifacts["classify", quantize],
                                   "cpu").module()
    engine = StreamingClassifier(params, cfg, 6, compute_dtype=torch.float32,
                                 quantize=quantize, device="cpu")
    ref = jax_export.export_classifier(
        jparams, jcfg, 6, compute_dtype=jnp.float32, quantize=quantize,
        platforms=("cpu",))
    for batch in (1, 3, 5):  # one artifact serves every batch size
        images = _images(batch, seed=batch)
        idx, probs = program(torch.from_numpy(images))
        assert idx.dtype == torch.int32 and idx.shape == (batch,)
        assert probs.dtype == torch.float32 and probs.shape == (batch, 6)
        e_idx, e_probs = engine.infer_batch(images)
        np.testing.assert_array_equal(idx.numpy(), e_idx)
        np.testing.assert_allclose(probs.numpy(), e_probs, atol=ATOL_SAME)
        j_idx, j_probs = ref.call(images)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(
            probs.numpy(), np.asarray(j_probs),
            atol=ATOL_FP32 if quantize is None else ATOL_INT8_PROBS)


def test_the_graph_calls_the_kernels_as_custom_ops(classifier, detector,
                                                   monkeypatch):
    """The attention kernels (#3 at head_dim 16: two encoder layers, and
    the detector's two cross-attention layers) are custom ops in the
    graph; so are the LayerNorm and GELU kernels (2 depth + 1 LayerNorms
    and depth GELUs in the classifier, plus the DETR head's 4 LayerNorms
    and a GELU a layer and its final LayerNorm in the detector), on the
    int8 route too; with ARSVT_ENABLE_FUSED_MLP set while tracing, #8 is
    baked in and no GELU op is left; the int8 graph runs its products as
    torch._int_mm."""
    _, cfg, _, params = classifier
    _, dcfg, _, dparams = detector
    ln, gelu = ("torch.ops.arsvt.layer_norm_fwd.default(",
                "torch.ops.arsvt.gelu_tanh_fwd.default(")
    for quantize in (None, "int8"):
        code = export.export_classifier(params, cfg, 6, quantize=quantize,
                                        device="cpu").graph_module.code
        assert code.count("torch.ops.arsvt.flash_attention_fwd.default(") \
            == 2
        assert code.count(ln) == 2 * cfg.depth + 1
        assert code.count(gelu) == cfg.depth
        assert ("torch.ops.aten._int_mm.default(" in code) == bool(quantize)
    code = export.export_detector(dparams, dcfg,
                                  device="cpu").graph_module.code
    assert code.count("torch.ops.arsvt.flash_attention_fwd.default(") == 4
    assert "_int_mm" not in code and "fused_mlp_fwd" not in code
    bb, head = dcfg.backbone, dcfg.head
    assert code.count(ln) == 2 * bb.depth + 1 + 4 * head.depth + 1
    assert code.count(gelu) == bb.depth + head.depth
    monkeypatch.delenv("ARSVT_DISABLE_PALLAS", raising=False)
    monkeypatch.setenv("ARSVT_ENABLE_FUSED_MLP", "1")
    ep = export.export_classifier(params, cfg, 6,
                                  compute_dtype=torch.float32, device="cpu")
    assert ep.graph_module.code.count(
        "torch.ops.arsvt.fused_mlp_fwd.default(") == 2
    assert ep.graph_module.code.count(ln) == 2 * cfg.depth + 1
    assert gelu not in ep.graph_module.code
    engine = StreamingClassifier(params, cfg, 6, compute_dtype=torch.float32,
                                 device="cpu")
    monkeypatch.delenv("ARSVT_ENABLE_FUSED_MLP")
    images = _images(3, seed=8)
    # read at trace time: the artifact keeps the fused MLP without the
    # switch
    idx, probs = ep.module()(torch.from_numpy(images))
    np.testing.assert_allclose(probs.numpy(), engine.infer_batch(images)[1],
                               atol=ATOL_SAME)


def test_custom_ops_pass_opcheck():
    """torch.library.opcheck on each op: schema, fake implementation
    against the real one (the plain versions on the CPU), dispatch."""
    ops = library.register_all()
    assert sorted(ops) == sorted(library.KERNEL_OPS)
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 5, 3 * 128, generator=gen)
    # the last three arguments are the mask offsets (b0, mask_heads, h0):
    # the one-process call's, and a rank's of a parallel step
    torch.library.opcheck(ops["encoder_attention_fwd"],
                          (qkv, 2, 0.0, 0, 0, 2, 0))
    torch.library.opcheck(ops["encoder_attention_fwd"],
                          (qkv, 2, 0.1, 7, 4, 5, 1))
    q, k, v = (torch.randn(2, 3, n, 16, generator=gen) for n in (4, 7, 7))
    torch.library.opcheck(ops["flash_attention_fwd"],
                          (q, k, v, 6, 0.0, 0, 0, 3, 0))
    torch.library.opcheck(ops["flash_attention_fwd"],
                          (q, k, v, 6, 0.1, 7, 2, 4, 1))
    x = torch.randn(9, 12, generator=gen)
    w1, b1 = torch.randn(12, 20, generator=gen), torch.randn(20, generator=gen)
    w2, b2 = torch.randn(20, 12, generator=gen), torch.randn(12, generator=gen)
    torch.library.opcheck(ops["fused_mlp_fwd"], (x, w1, b1, w2, b2))
    scale, bias = torch.randn(12, generator=gen), torch.randn(12,
                                                              generator=gen)
    torch.library.opcheck(ops["layer_norm_fwd"], (x, scale, bias, 1e-5))
    torch.library.opcheck(ops["gelu_tanh_fwd"], (x,))


def test_classifier_artifact_respects_normalize_contract(classifier,
                                                         tmp_path):
    jcfg, cfg, jparams, params = classifier
    images = _images(2, seed=4)
    raw = export.export_classifier(params, cfg, 6,
                                   compute_dtype=torch.float32,
                                   normalize_inputs=False, device="cpu")
    path = str(tmp_path / "raw.pt2")
    export.save_exported(raw, path)
    _, probs = export.load_exported(path, "cpu").module()(
        torch.from_numpy(images))
    engine = StreamingClassifier(params, cfg, 6, compute_dtype=torch.float32,
                                 normalize_inputs=False, device="cpu")
    np.testing.assert_allclose(probs.numpy(), engine.infer_batch(images)[1],
                               atol=ATOL_SAME)
    _, j_probs = jax_export.export_classifier(
        jparams, jcfg, 6, compute_dtype=jnp.float32, normalize_inputs=False,
        platforms=("cpu",)).call(images)
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs),
                               atol=ATOL_FP32)
    normalized = StreamingClassifier(params, cfg, 6,
                                     compute_dtype=torch.float32,
                                     device="cpu").infer_batch(images)[1]
    assert np.abs(probs.numpy() - normalized).max() > 100 * ATOL_FP32
    with pytest.raises(ValueError, match="quantize"):
        export.export_classifier(params, cfg, 6, quantize="fp4",
                                 device="cpu")
    with pytest.raises(ValueError, match=r"\.pt2"):
        export.save_exported(raw, str(tmp_path / "raw.stablehlo"))


@QUANT
def test_detector_artifact_round_trip_and_symbolic_batch(
        artifacts, detector, quantize):
    jcfg, cfg, jparams, params = detector
    program = export.load_exported(artifacts["detect", quantize],
                                   "cpu").module()
    engine = StreamingDetector(params, cfg, compute_dtype=torch.float32,
                               conf_threshold=CONF, quantize=quantize,
                               device="cpu")
    ref = jax_export.export_detector(
        jparams, jcfg, compute_dtype=jnp.float32, conf_threshold=CONF,
        quantize=quantize, platforms=("cpu",))
    q = cfg.head.num_queries
    kept = 0
    for batch in (1, 3, 5):
        images = _images(batch, seed=10 + batch)
        out = program(torch.from_numpy(images))
        assert sorted(out) == ["boxes", "labels", "scores", "valid"]
        assert out["boxes"].shape == (batch, q, 4)
        assert out["labels"].dtype == torch.int32
        assert out["valid"].dtype == torch.bool
        for i, image in enumerate(images):
            raw = engine.forward(image)
            e = post_process(raw["class_logits"][None],
                             raw["boxes_cxcywh"][None],
                             conf_threshold=CONF, nms_threshold=0.5)
            for key in ("labels", "valid"):
                assert torch.equal(out[key][i], e[key][0]), key
            for key in ("boxes", "scores"):
                np.testing.assert_allclose(out[key][i].numpy(),
                                           e[key][0].numpy(),
                                           atol=ATOL_SAME)
        j_out = ref.call(images)
        for key in ("labels", "valid"):
            np.testing.assert_array_equal(out[key].numpy(),
                                          np.asarray(j_out[key]))
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(
                out[key].numpy(), np.asarray(j_out[key]),
                atol=ATOL_FP32 if quantize is None else 1e-3)
        kept += int(out["valid"].sum())
    assert kept > 0  # the comparison has detections


def test_artifact_engines(artifacts, classifier, tmp_path):
    """load_artifact_engine reads the task and the input contract from the
    artifact, answers as the in-process engines, keeps the latency window
    and refuses already-normalized floats."""
    _, cfg, _, params = classifier
    engine = load_artifact_engine(artifacts["classify", None], "cpu")
    assert isinstance(engine, ArtifactClassifier)
    assert engine.image_size == 32 and engine.device.type == "cpu"
    ref = StreamingClassifier(params, cfg, 6, compute_dtype=torch.float32,
                              device="cpu")
    u8 = _images(1, seed=3)[0]
    idx, name, probs = engine(u8)
    r_idx, r_name, r_probs = ref(u8)
    assert (idx, name) == (r_idx, r_name)
    np.testing.assert_allclose(probs, r_probs, atol=ATOL_SAME)
    # a [0,1] float image goes through the artifact's uint8 contract: exact
    # for an image decoded from uint8
    idx, _, probs = engine(u8.astype(np.float32) / 255.0)
    assert idx == r_idx
    np.testing.assert_allclose(probs, r_probs, atol=ATOL_SAME)
    assert engine.latency_stats()["n"] == 2
    bad = np.random.default_rng(0).normal(0.0, 2.0, (32, 32, 3)).astype(
        np.float32)
    with pytest.raises(ValueError, match="already normalized"):
        engine(bad)
    with pytest.raises(ValueError, match="expected"):
        engine(u8[:16])
    from PIL import Image

    path = tmp_path / "frame.png"
    Image.fromarray(u8).save(path)
    assert engine.classify_path(str(path))[0] == r_idx
    det = load_artifact_engine(artifacts["detect", None], "cpu")
    assert isinstance(det, ArtifactDetector)
    out = det.detect_path(str(path))
    assert set(out) == {"boxes", "labels", "scores", "class_names"}
    assert len(out["boxes"]) == len(out["scores"]) == len(out["labels"])
    with pytest.raises(FileNotFoundError, match="no artifact"):
        load_artifact_engine(str(tmp_path / "none.pt2"), "cpu")


def test_artifact_engine_takes_the_card_by_default(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifact_engine(artifacts["classify", None])


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _png(seed, shape=(40, 40, 3)):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def test_from_artifact_serves_classify_and_detect(artifacts):
    """/classify micro-batched (--max-batch 2) from a classify artifact as
    from an engine of the same params; /detect from a detect artifact."""
    srv = InferenceServer.from_artifact(artifacts["classify", None],
                                        max_batch=2, device="cpu")
    host, port = srv.start_background(port=0)
    try:
        body = _png(1)
        status, data = _post(f"http://{host}:{port}/classify", body)
        assert status == 200 and len(data["probs"]) == 6
        assert _get(f"http://{host}:{port}/stats")["batching"][
            "requests"] == 1
        assert _get(f"http://{host}:{port}/healthz") == {
            "status": "ok", "backend": "cpu", "endpoints": ["/classify"]}
    finally:
        srv.shutdown()
    direct = InferenceServer.from_artifact(artifacts["classify", None],
                                           device="cpu")
    host, port = direct.start_background(port=0)
    try:
        _, unbatched = _post(f"http://{host}:{port}/classify", body)
    finally:
        direct.shutdown()
    assert unbatched["class"] == data["class"]
    np.testing.assert_allclose(unbatched["probs"], data["probs"], atol=1e-4)

    with pytest.raises(ValueError, match="single-image"):
        InferenceServer.from_artifact(artifacts["detect", None], max_batch=2,
                                      device="cpu")
    srv = InferenceServer.from_artifact(artifacts["detect", None],
                                        device="cpu")
    host, port = srv.start_background(port=0)
    try:
        status, out = _post(f"http://{host}:{port}/detect", _png(2))
        assert status == 200
        assert set(out) == {"boxes", "labels", "scores", "class_names"}
        assert _get(f"http://{host}:{port}/healthz")["endpoints"] == [
            "/detect"]
    finally:
        srv.shutdown()


_LOADER_PROBE = """
import json, sys
import numpy as np
from arsvt_tpu_torch.serving.artifact import load_artifact_engine
engine = load_artifact_engine(sys.argv[1], "cpu")
idx, name, probs = engine(np.zeros((32, 32, 3), np.uint8))
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "arsvt_tpu", "optax")
             or k.startswith(("jax.", "jaxlib.", "arsvt_tpu.", "optax.",
                              "arsvt_tpu_torch.models",
                              "arsvt_tpu_torch.train",
                              "arsvt_tpu_torch.objectives")))
print(json.dumps({"bad": bad, "idx": idx, "probs": probs.tolist()}))
"""


def test_artifact_loader_imports_no_model_code(artifacts):
    """A serving box needs the loader, the kernels' op registrations and
    the artifact: no model, training or objective module, no JAX."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _LOADER_PROBE, artifacts["classify", "int8"]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert len(out["probs"]) == 6


def _checkpoints(root, task):
    """The same seeded params in a JAX orbax checkpoint and a port
    checkpoint, under one TrainConfig."""
    if task == "classify":
        cfg = JaxTrainConfig(preset="vit_test_8_32", augment="crop_flip",
                             canvas=40, bf16=True)
        params = init_image_classifier(jax.random.PRNGKey(0),
                                       JaxBackboneConfig(**TINY), 6)
        params["classifier"] = jax.tree_util.tree_map(
            lambda t: 0.3 * jax.random.normal(jax.random.PRNGKey(7),
                                              t.shape),
            params["classifier"])
    else:
        cfg = JaxTrainConfig(preset="detector_test", task="detect",
                             augment="detection", canvas=40, bf16=True)
        params = init_detector(jax.random.PRNGKey(1),
                               jax_resolve_detector(cfg))
    mgr = JaxCheckpoints(str(root / "jax"), cfg)
    mgr.save(STEP, {"params": params})
    mgr.wait()
    mgr.close()
    jparams, _ = jax_load_inference_bundle(str(root / "jax"))
    port_cfg = TrainConfig.from_json(cfg.to_json())
    port_params = (from_jax_params(_np(jparams), BackboneConfig(**TINY))
                   if task == "classify" else
                   detector_from_jax_params(_np(jparams),
                                            resolve_detector(port_cfg)))
    CheckpointManager(str(root / "port"), port_cfg).save(
        STEP, {"params": port_params, "opt_state": {}, "step": STEP})
    return str(root / "jax"), str(root / "port")


@pytest.mark.parametrize("task", ["classify", "detect"])
def test_export_checkpoint_matches_jax(tmp_path, task):
    """export_checkpoint on each package's checkpoint of the same params:
    the manifests have the same keys and, but for the path and the
    platforms, the same values; both artifacts (bf16 forwards) agree on
    the same uint8 images."""
    jax_dir, port_dir = _checkpoints(tmp_path, task)
    kw = {"conf_threshold": CONF} if task == "detect" else {}
    j_path, p_path = str(tmp_path / "jax.stablehlo"), str(tmp_path / "p.pt2")
    jman = jax_export.export_checkpoint(jax_dir, j_path, platforms=("cpu",),
                                        **kw)
    man = export.export_checkpoint(port_dir, p_path, device="cpu", **kw)
    json.dumps(man)  # the manifest is JSON
    assert set(man) == set(jman)
    for key in set(man) - {"path", "platforms"}:
        assert man[key] == jman[key], key
    assert man["task"] == task and man["path"] == p_path
    assert man["platforms"] == ["cuda", "cpu"]
    images = _images(3, seed=21)
    out = export.load_exported(p_path, "cpu").module()(
        torch.from_numpy(images))
    ref = jax_export.load_exported(j_path).call(images)
    if task == "classify":
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   atol=ATOL_BF16)
    else:
        np.testing.assert_array_equal(out["valid"].numpy(),
                                      np.asarray(ref["valid"]))
        np.testing.assert_allclose(out["boxes"].numpy(),
                                   np.asarray(ref["boxes"]), atol=ATOL_BF16)


def test_export_checkpoint_rejects_thresholds_for_classify(tmp_path):
    _, port_dir = _checkpoints(tmp_path, "classify")
    with pytest.raises(ValueError, match="detect checkpoints"):
        export.export_checkpoint(port_dir, str(tmp_path / "m.pt2"),
                                 conf_threshold=0.9, device="cpu")
    with pytest.raises(ValueError, match=r"\.pt2"):
        export.export_checkpoint(port_dir, str(tmp_path / "m.hlo"),
                                 device="cpu")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_export_cli_then_server_artifact_subprocess(tmp_path, capsys,
                                                    monkeypatch):
    """``python -m arsvt_tpu_torch.serving.export --int8`` (its main() in
    process, ARSVT_PLATFORM=cpu), then ``python -m arsvt_tpu_torch.serving.
    server --artifact`` as a subprocess, answering /healthz and /classify
    as from_artifact does in process."""
    _, port_dir = _checkpoints(tmp_path, "classify")
    out = str(tmp_path / "model.pt2")
    monkeypatch.setenv("ARSVT_PLATFORM", "cpu")
    export.main(["--checkpoint-dir", port_dir, "--out", out, "--int8"])
    manifest = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert manifest["quantize"] == "int8" and manifest["path"] == out
    body = _png(9, (36, 40, 3))
    srv = InferenceServer.from_artifact(out, device="cpu")
    host, port = srv.start_background(port=0)
    try:
        _, expected = _post(f"http://{host}:{port}/classify", body)
    finally:
        srv.shutdown()
    port = _free_port()
    env = dict(os.environ, ARSVT_PLATFORM="cpu", OMP_NUM_THREADS="1")
    log = tmp_path / "server.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "arsvt_tpu_torch.serving.server",
             "--artifact", out, "--port", str(port)], cwd=REPO, env=env,
            stdout=f, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, log.read_text()[-2000:]
            try:
                health = _get(url + "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline, log.read_text()
                time.sleep(0.2)
        assert health == {"status": "ok", "backend": "cpu",
                          "endpoints": ["/classify"]}
        status, data = _post(url + "/classify", body)
        assert status == 200 and data["class"] == expected["class"]
        assert data["probs"] == expected["probs"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert "serving on http://127.0.0.1" in log.read_text()
