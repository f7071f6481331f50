"""The port's StreamingClassifier and InferenceServer against the JAX
package's, on bridged weights, on the CPU."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from arsvt_tpu.evaluation.classify import (
    StreamingClassifier as JaxStreamingClassifier,
)
from arsvt_tpu.models.classifier import init_image_classifier
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.serving.server import InferenceServer as JaxInferenceServer
from arsvt_tpu_torch.evaluation.classify import StreamingClassifier
from arsvt_tpu_torch.models.bridge import from_jax_params
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.serving.server import InferenceServer

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SMALL = dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
             num_heads=2, mlp_dim=256)
# fp32 engines on both sides: same arithmetic, other summation order
ATOL_FP32 = 1e-5
# the server rounds probs to 4 decimals in its response
ATOL_HTTP = 1e-4 + ATOL_FP32


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = JaxBackboneConfig(**SMALL), BackboneConfig(**SMALL)
    params = init_image_classifier(jax.random.PRNGKey(0), jcfg, 6)
    # the zero-init head gives uniform probs: randomise it
    params["classifier"] = jax.tree_util.tree_map(
        lambda x: 0.3 * jax.random.normal(jax.random.PRNGKey(7), x.shape,
                                          x.dtype),
        params["classifier"],
    )
    port_params = from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    with jax.default_matmul_precision("highest"):
        jax_clf = JaxStreamingClassifier(params, jcfg, 6,
                                         compute_dtype=jnp.float32)
    port_clf = StreamingClassifier(port_params, cfg, 6,
                                   compute_dtype=torch.float32, device="cpu")
    return {"jcfg": jcfg, "cfg": cfg, "params": params,
            "port_params": port_params, "jax": jax_clf, "port": port_clf}


def _image(seed, shape=(32, 32, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _png(image):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def test_call_matches_jax(engines):
    for seed in range(3):
        u8 = _image(seed)
        for img in (u8, u8.astype(np.float32) / 255.0):
            j_idx, j_name, j_probs = engines["jax"](img)
            idx, name, probs = engines["port"](img)
            np.testing.assert_allclose(probs, j_probs, atol=ATOL_FP32)
            assert (idx, name) == (j_idx, j_name)
            assert probs.dtype == np.float32 and probs.shape == (6,)
    assert engines["port"].latency_stats()["n"] >= 6
    assert engines["port"].image_size == 32


def test_infer_batch_matches_jax(engines):
    batch = np.stack([_image(10 + i) for i in range(3)])
    j_idx, j_probs = engines["jax"].infer_batch(batch)
    idx, probs = engines["port"].infer_batch(batch)
    np.testing.assert_allclose(probs, j_probs, atol=ATOL_FP32)
    np.testing.assert_array_equal(idx, j_idx)


@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_classify_path_matches_jax(engines, tmp_path, monkeypatch, decoder):
    """Both engines on one decoder: PIL (both forced to it) or each
    package's build of the C++ core (skipped where either is not built);
    the two routes' resizes differ."""
    from arsvt_tpu.data import native_loader as jax_native
    from arsvt_tpu_torch.data import native_loader

    if decoder == "pil":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native_loader, "available", lambda: False)
    elif not (jax_native.available() and native_loader.available()):
        pytest.skip("a native decoder is not built")
    path = tmp_path / "frame.png"
    Image.fromarray(_image(20, (40, 27, 3))).save(path)  # letterboxed
    j_idx, _, j_probs = engines["jax"].classify_path(str(path))
    idx, _, probs = engines["port"].classify_path(str(path))
    np.testing.assert_allclose(probs, j_probs, atol=ATOL_FP32)
    assert idx == j_idx


@pytest.mark.parametrize("normalize_inputs", [False, True])
def test_bf16_engine_tracks_jax_loosely(engines, normalize_inputs):
    """bf16 on both sides: the rounding sites differ (see
    test_torch_vit.py), so probabilities agree to 0.05."""
    jax_clf = JaxStreamingClassifier(engines["params"], engines["jcfg"], 6,
                                     normalize_inputs=normalize_inputs)
    port_clf = StreamingClassifier(engines["port_params"], engines["cfg"],
                                   6, normalize_inputs=normalize_inputs,
                                   device="cpu")
    img = _image(30)
    np.testing.assert_allclose(port_clf(img)[2], jax_clf(img)[2], atol=0.05)


def test_unit_range_guard(engines):
    with pytest.raises(ValueError, match="already"):
        engines["port"](_image(1).astype(np.float32))  # 0-255 floats


def test_default_device_is_cuda_and_raises_without_it(engines, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingClassifier(engines["port_params"], engines["cfg"], 6,
                                device=device)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def servers(engines):
    jsrv = JaxInferenceServer(classifier=engines["jax"])
    psrv = InferenceServer(classifier=engines["port"])
    jhost, jport = jsrv.start_background(port=0)
    phost, pport = psrv.start_background(port=0)
    yield f"http://{jhost}:{jport}", f"http://{phost}:{pport}"
    jsrv.shutdown()
    psrv.shutdown()


def test_server_classify_matches_jax_server(servers):
    jurl, purl = servers
    for seed, shape in ((40, (32, 32, 3)), (41, (20, 45, 3))):
        body = _png(_image(seed, shape))
        jstatus, jdata = _post(jurl + "/classify", body)
        status, data = _post(purl + "/classify", body)
        assert status == jstatus == 200
        assert (data["class"], data["class_name"]) == (jdata["class"],
                                                       jdata["class_name"])
        np.testing.assert_allclose(data["probs"], jdata["probs"],
                                   atol=ATOL_HTTP)
        assert data["latency_ms"] > 0


def test_server_healthz_and_stats(servers):
    _, purl = servers
    _post(purl + "/classify", _png(_image(42)))
    health = _get(purl + "/healthz")
    assert health == {"status": "ok", "backend": "cpu",
                      "endpoints": ["/classify"]}
    stats = _get(purl + "/stats")
    assert stats["classify"]["n"] >= 1 and stats["classify"]["p50_ms"] > 0


def test_server_bad_payload_is_400(servers):
    _, purl = servers
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(purl + "/classify", b"this is not an image")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(purl + "/detect", b"")
    assert e.value.code == 404


def test_micro_batched_server_matches_jax_server(engines, servers):
    """Four concurrent requests coalesce into one padded forward (a long
    window: the batch closes as soon as four are queued) and answer as
    the JAX server does."""
    jurl, _ = servers
    bodies = [_png(_image(50 + i)) for i in range(4)]
    expected = [_post(jurl + "/classify", b)[1] for b in bodies]
    srv = InferenceServer(classifier=engines["port"], max_batch=4,
                          batch_window_ms=5000.0)
    host, port = srv.start_background(port=0)
    url = f"http://{host}:{port}"
    try:
        barrier = threading.Barrier(4)
        results = [None] * 4

        def client(i):
            barrier.wait(timeout=30)
            results[i] = _post(url + "/classify", bodies[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for (status, data), ref in zip(results, expected):
            assert status == 200
            assert data["class"] == ref["class"]
            np.testing.assert_allclose(data["probs"], ref["probs"],
                                       atol=ATOL_HTTP)
        batching = _get(url + "/stats")["batching"]
        assert batching["requests"] == 4
        assert batching["batches"] == 1 and batching["max_batch_seen"] == 4
    finally:
        srv.shutdown()


def test_server_takes_no_detector(engines):
    """A classify-only server serves no /detect (404, as the JAX server),
    and a server needs at least one engine."""
    with pytest.raises(ValueError, match="classifier and/or a detector"):
        InferenceServer()
    with pytest.raises(ValueError, match="max_batch"):
        InferenceServer(classifier=engines["port"], max_batch=0)
    srv = InferenceServer(classifier=engines["port"])
    host, port = srv.start_background(port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://{host}:{port}/detect", _png(_image(43)))
        assert e.value.code == 404
    finally:
        srv.shutdown()
