"""The port's StreamingDetector and the server's /detect route against the
JAX package's, on bridged weights, on the CPU."""

import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from arsvt_tpu.data import native_loader
from arsvt_tpu.evaluation.classify import (
    StreamingDetector as JaxStreamingDetector,
)
from arsvt_tpu.models.detector import init_detector as jax_init_detector
from arsvt_tpu.models.registry import DETECTOR_PRESETS as JAX_DETECTOR_PRESETS
from arsvt_tpu.serving.server import InferenceServer as JaxInferenceServer
from arsvt_tpu_torch.data import native_loader as port_native_loader
from arsvt_tpu_torch.evaluation.classify import StreamingDetector
from arsvt_tpu_torch.models.bridge import detector_from_jax_params
from arsvt_tpu_torch.models.registry import get_detector_preset
from arsvt_tpu_torch.serving.server import InferenceServer

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# fp32 engines on both sides: the same arithmetic in another summation
# order (the forward agrees to ~1e-6, tests/test_torch_detector.py)
ATOL_FP32 = 1e-5
# the server rounds boxes and scores to 4 decimals in its response
ATOL_HTTP = 1e-4 + ATOL_FP32
CONF = 0.2  # low enough that the random-init head keeps a few boxes


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(params=["pil", "native"])
def decoder(request, monkeypatch):
    """Both packages on one decoder: PIL (both forced to it) or each
    package's build of the C++ core (skipped where either is not built);
    the two routes' resizes differ."""
    if request.param == "pil":
        monkeypatch.setattr(native_loader, "available", lambda: False)
        monkeypatch.setattr(port_native_loader, "available", lambda: False)
    elif not (native_loader.available() and port_native_loader.available()):
        pytest.skip("a native decoder is not built")
    return request.param


@pytest.fixture(scope="module")
def engines():
    name = "detector_test"
    jcfg, cfg = JAX_DETECTOR_PRESETS[name], get_detector_preset(name)
    params = jax_init_detector(jax.random.PRNGKey(0), jcfg)
    port_params = detector_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    with jax.default_matmul_precision("highest"):
        jax_det = JaxStreamingDetector(params, jcfg,
                                       compute_dtype=jnp.float32,
                                       conf_threshold=CONF)
    port_det = StreamingDetector(port_params, cfg,
                                 compute_dtype=torch.float32,
                                 conf_threshold=CONF, device="cpu")
    return {"jcfg": jcfg, "cfg": cfg, "params": params,
            "port_params": port_params, "jax": jax_det, "port": port_det}


def _image(seed, shape=(32, 32, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _png(image):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def _assert_same_detections(got, ref, atol):
    assert list(got["labels"]) == list(ref["labels"])
    assert got["class_names"] == ref["class_names"]
    np.testing.assert_allclose(np.asarray(got["boxes"], np.float32),
                               np.asarray(ref["boxes"], np.float32),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(got["scores"], np.float32),
                               np.asarray(ref["scores"], np.float32),
                               atol=atol)


@pytest.mark.parametrize("shape", [(32, 32, 3), (40, 27, 3)])
def test_detect_path_matches_jax(engines, tmp_path, shape, decoder):
    path = tmp_path / "frame.png"
    Image.fromarray(_image(sum(shape), shape)).save(path)
    ref = engines["jax"].detect_path(str(path))
    got = engines["port"].detect_path(str(path))
    assert len(got["labels"]) > 0  # the comparison has detections
    assert got["boxes"].dtype == np.float32 and got["boxes"].shape[1] == 4
    assert got["labels"].dtype == np.int32
    assert list(got["scores"]) == sorted(got["scores"], reverse=True)
    _assert_same_detections(got, ref, ATOL_FP32)
    stats = engines["port"].latency_stats()
    assert stats["n"] >= 1 and stats["p50_ms"] > 0
    assert engines["port"].image_size == 32


def test_default_thresholds_match_jax(engines, tmp_path, decoder):
    jax_det = JaxStreamingDetector(engines["params"], engines["jcfg"],
                                   compute_dtype=jnp.float32)
    port_det = StreamingDetector(engines["port_params"], engines["cfg"],
                                 compute_dtype=torch.float32, device="cpu")
    path = tmp_path / "frame.png"
    Image.fromarray(_image(3)).save(path)
    _assert_same_detections(port_det.detect_path(str(path)),
                            jax_det.detect_path(str(path)), ATOL_FP32)


def test_forward_returns_the_raw_head_outputs(engines):
    raw = engines["port"].forward(_image(4))
    cfg = engines["cfg"]
    assert raw["class_logits"].shape == (cfg.head.num_queries,
                                         cfg.head.num_classes + 1)
    assert raw["boxes_cxcywh"].shape == (cfg.head.num_queries, 4)
    assert raw["class_logits"].device.type == "cpu"
    float_img = _image(4).astype(np.float32) / 255.0
    for k, v in engines["port"].forward(float_img).items():
        np.testing.assert_allclose(v.numpy(), raw[k].numpy(), atol=1e-6)


def test_default_device_is_cuda_and_raises_without_it(engines, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingDetector(engines["port_params"], engines["cfg"],
                              device=device)


def test_quantize_option(engines, tmp_path):
    """quantize="int8" serves the W8A8 backbone: int8 kernels on the
    engine, the DETR head in fp32, detections as JAX's int8 engine's (fp32
    compute on both sides, within one int8 flip, tests/test_torch_quant.py);
    an unknown mode raises."""
    jax_det = JaxStreamingDetector(engines["params"], engines["jcfg"],
                                   compute_dtype=jnp.float32,
                                   conf_threshold=CONF, quantize="int8")
    port_det = StreamingDetector(engines["port_params"], engines["cfg"],
                                 compute_dtype=torch.float32,
                                 conf_threshold=CONF, quantize="int8",
                                 device="cpu")
    blocks = port_det._params["backbone"]["blocks"]
    assert blocks[0]["mlp"]["fc2"]["kernel"]["q"].dtype == torch.int8
    assert port_det._params["detr"]["class_head"]["kernel"].dtype == \
        torch.float32
    path = tmp_path / "frame.png"
    Image.fromarray(_image(3)).save(path)
    with jax.default_matmul_precision("highest"):
        ref = jax_det.detect_path(str(path))
    got = port_det.detect_path(str(path))
    assert len(got["labels"]) > 0  # the comparison has detections
    _assert_same_detections(got, ref, 1e-3)
    with pytest.raises(ValueError, match="quantize"):
        StreamingDetector(engines["port_params"], engines["cfg"],
                          quantize="int4", device="cpu")


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def servers(engines):
    jsrv = JaxInferenceServer(detector=engines["jax"])
    psrv = InferenceServer(detector=engines["port"])
    jhost, jport = jsrv.start_background(port=0)
    phost, pport = psrv.start_background(port=0)
    yield f"http://{jhost}:{jport}", f"http://{phost}:{pport}"
    jsrv.shutdown()
    psrv.shutdown()


def test_server_detect_matches_jax_server(servers, decoder):
    jurl, purl = servers
    for seed, shape in ((60, (32, 32, 3)), (61, (20, 45, 3))):
        body = _png(_image(seed, shape))
        jstatus, jdata = _post(jurl + "/detect", body)
        status, data = _post(purl + "/detect", body)
        assert status == jstatus == 200
        assert set(data) == {"boxes", "labels", "scores", "class_names"}
        _assert_same_detections(data, jdata, ATOL_HTTP)


def test_server_healthz_stats_and_errors(servers):
    _, purl = servers
    _post(purl + "/detect", _png(_image(62)))
    assert _get(purl + "/healthz") == {"status": "ok", "backend": "cpu",
                                       "endpoints": ["/detect"]}
    stats = _get(purl + "/stats")
    assert set(stats) == {"detect"}
    assert stats["detect"]["n"] >= 1 and stats["detect"]["p50_ms"] > 0
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(purl + "/detect", b"this is not an image")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(purl + "/classify", _png(_image(63)))
    assert e.value.code == 404


def test_server_with_both_engines_and_batching_rules(engines):
    from arsvt_tpu_torch.evaluation.classify import StreamingClassifier
    from arsvt_tpu_torch.models.classifier import init_image_classifier

    bcfg = engines["cfg"].backbone
    clf = StreamingClassifier(init_image_classifier(bcfg, 6), bcfg, 6,
                              device="cpu")
    srv = InferenceServer(classifier=clf, detector=engines["port"])
    host, port = srv.start_background(port=0)
    url = f"http://{host}:{port}"
    try:
        body = _png(_image(64))
        assert _post(url + "/classify", body)[0] == 200
        assert _post(url + "/detect", body)[0] == 200
        assert _get(url + "/healthz")["endpoints"] == ["/classify",
                                                       "/detect"]
        assert set(_get(url + "/stats")) == {"classify", "detect"}
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="needs a classifier"):
        InferenceServer(detector=engines["port"], max_batch=4)
    with pytest.raises(ValueError, match="classifier and/or a detector"):
        InferenceServer()
