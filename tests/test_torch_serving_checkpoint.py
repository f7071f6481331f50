"""Serving from a checkpoint: the port's `load_inference_bundle`,
`InferenceServer.from_checkpoint` and ``python -m
arsvt_tpu_torch.serving.server`` against the JAX package's on the same
params. JAX writes an orbax checkpoint of seeded params; the port writes
its own checkpoint of the same params (``models/bridge.py``) under the
same `TrainConfig` JSON."""

import io
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from arsvt_tpu.data import native_loader as jax_native
from arsvt_tpu.models.classifier import init_image_classifier
from arsvt_tpu.models.detector import init_detector
from arsvt_tpu.serving.loading import (
    load_inference_bundle as jax_load_inference_bundle,
)
from arsvt_tpu.serving.server import InferenceServer as JaxInferenceServer
from arsvt_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu.train.config import resolve_backbone as jax_resolve_backbone
from arsvt_tpu.train.config import resolve_detector as jax_resolve_detector
from arsvt_tpu_torch.core.dtypes import named_leaves
from arsvt_tpu_torch.data import native_loader
from arsvt_tpu_torch.models.bridge import (
    detector_from_jax_params,
    from_jax_params,
)
from arsvt_tpu_torch.serving import server as server_module
from arsvt_tpu_torch.serving.loading import load_inference_bundle
from arsvt_tpu_torch.serving.server import InferenceServer
from arsvt_tpu_torch.train.checkpoint import CheckpointManager
from arsvt_tpu_torch.train.config import (
    TrainConfig,
    resolve_backbone,
    resolve_detector,
)
from arsvt_tpu_torch.train.optim import init_opt_state

torch.set_num_threads(1)  # tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 3
# from_checkpoint serves in bf16 on both sides, whose rounding sites differ
# (test_torch_serving.py's bf16 limit)
ATOL_BF16 = 0.05


def _random_head(head, seed):
    """A zero-initialised head answers uniform probs for every image: fill
    it with seeded values giving logits of a few units."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    d = head["kernel"].shape[0]
    return {"kernel": 3 * d ** -0.5 * jax.random.normal(
                keys[0], head["kernel"].shape),
            "bias": 0.1 * jax.random.normal(keys[1], head["bias"].shape)}


def _jax_checkpoint(directory, cfg, params):
    mgr = JaxCheckpoints(directory, cfg)
    mgr.save(STEP, {"params": params})
    mgr.wait()
    mgr.close()


def _port_checkpoint(directory, jax_cfg, params):
    cfg = TrainConfig.from_json(jax_cfg.to_json())
    CheckpointManager(directory, cfg).save(
        STEP, {"params": params, "opt_state": init_opt_state(params),
               "step": STEP})


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def classify_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("clf_ckpt")
    cfg = JaxTrainConfig(preset="vit_test_8_32", augment="crop_flip",
                         canvas=40, bf16=True)
    params = init_image_classifier(jax.random.PRNGKey(0),
                                   jax_resolve_backbone(cfg), 6)
    params["classifier"]["head"] = _random_head(
        params["classifier"]["head"], 7)
    port_params = from_jax_params(
        _to_numpy(params), resolve_backbone(TrainConfig.from_json(
            cfg.to_json())))
    _jax_checkpoint(str(root / "jax"), cfg, params)
    _port_checkpoint(str(root / "port"), cfg, port_params)
    return {"jax": str(root / "jax"), "port": str(root / "port"),
            "cfg": cfg, "params": params, "port_params": port_params}


@pytest.fixture(scope="module")
def detect_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("det_ckpt")
    cfg = JaxTrainConfig(preset="detector_test", task="detect",
                         augment="detection", canvas=40, bf16=True)
    params = init_detector(jax.random.PRNGKey(1), jax_resolve_detector(cfg))
    params["detr"]["class_head"] = _random_head(params["detr"]["class_head"],
                                                8)
    port_cfg = TrainConfig.from_json(cfg.to_json())
    port_params = detector_from_jax_params(_to_numpy(params),
                                           resolve_detector(port_cfg))
    _jax_checkpoint(str(root / "jax"), cfg, params)
    _port_checkpoint(str(root / "port"), cfg, port_params)
    return {"jax": str(root / "jax"), "port": str(root / "port"),
            "cfg": cfg, "params": params, "port_params": port_params}


def _assert_same_tree(got, ref):
    got, ref = dict(named_leaves(got)), dict(named_leaves(ref))
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        assert torch.equal(got[name], ref[name]), name


@pytest.mark.parametrize("task", ["classify", "detect"])
def test_load_inference_bundle_matches_jax(classify_ckpts, detect_ckpts,
                                           task):
    """Each package's loader on its own checkpoint of the same params: the
    port's params equal the bridged JAX params to the bit, on the CPU, and
    the config reads back the same."""
    ck = classify_ckpts if task == "classify" else detect_ckpts
    params, cfg = load_inference_bundle(ck["port"])
    jparams, jcfg = jax_load_inference_bundle(ck["jax"])
    assert cfg.to_json() == jcfg.to_json() == ck["cfg"].to_json()
    bridge = (from_jax_params(_to_numpy(jparams), resolve_backbone(cfg))
              if task == "classify" else
              detector_from_jax_params(_to_numpy(jparams),
                                       resolve_detector(cfg)))
    _assert_same_tree(params, bridge)
    _assert_same_tree(params, ck["port_params"])
    assert all(t.device.type == "cpu" for _, t in named_leaves(params))
    with pytest.raises(FileNotFoundError):
        load_inference_bundle(ck["port"], step=STEP + 1)


def test_load_inference_bundle_needs_no_moments(classify_ckpts, tmp_path):
    """Params only: a checkpoint saved without optimizer moments loads the
    same params (the loader never restores the optimizer state)."""
    cfg = TrainConfig.from_json(classify_ckpts["cfg"].to_json())
    CheckpointManager(str(tmp_path), cfg).save(
        STEP, {"params": classify_ckpts["port_params"], "opt_state": {},
               "step": STEP})
    params, _ = load_inference_bundle(str(tmp_path))
    _assert_same_tree(params, classify_ckpts["port_params"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_inference_bundle(str(tmp_path / "none"))


def _png(seed, shape):
    img = np.random.default_rng(seed).integers(0, 256, shape,
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture
def pil_on_both(monkeypatch):
    """/detect decodes a spooled file: pin both packages to PIL."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native_loader, "available", lambda: False)


def _served(ck, route, bodies, **kw):
    """{"jax": [...], "port": [...]}: each package's server built by its
    from_checkpoint on its own checkpoint, answering `bodies` on `route`."""
    out = {}
    for name, srv in (
            ("jax", JaxInferenceServer.from_checkpoint(ck["jax"], **kw)),
            ("port", InferenceServer.from_checkpoint(ck["port"],
                                                     device="cpu", **kw))):
        host, port = srv.start_background(port=0)
        try:
            out[name] = [_post(f"http://{host}:{port}{route}", b)
                         for b in bodies]
            if name == "port":
                out["healthz"] = _get(f"http://{host}:{port}/healthz")
        finally:
            srv.shutdown()
    return out


def test_from_checkpoint_classify_matches_jax(classify_ckpts):
    bodies = [_png(s, shape) for s, shape in
              ((1, (40, 40, 3)), (2, (30, 52, 3)), (3, (32, 32, 3)))]
    got = _served(classify_ckpts, "/classify", bodies)
    classes = []
    for (status, data), (jstatus, jdata) in zip(got["port"], got["jax"]):
        assert status == jstatus == 200
        assert (data["class"], data["class_name"]) == (jdata["class"],
                                                       jdata["class_name"])
        np.testing.assert_allclose(data["probs"], jdata["probs"],
                                   atol=ATOL_BF16)
        classes.append(data["class"])
    assert len(set(classes)) > 1  # the seeded head does not tie
    assert got["healthz"] == {"status": "ok", "backend": "cpu",
                              "endpoints": ["/classify"]}


def test_from_checkpoint_detect_matches_jax(detect_ckpts, pil_on_both):
    bodies = [_png(s, shape) for s, shape in
              ((4, (40, 40, 3)), (5, (28, 44, 3)))]
    got = _served(detect_ckpts, "/detect", bodies)
    n = 0
    for (status, data), (jstatus, jdata) in zip(got["port"], got["jax"]):
        assert status == jstatus == 200
        assert data["labels"] == jdata["labels"]
        assert data["class_names"] == jdata["class_names"]
        np.testing.assert_allclose(data["boxes"], jdata["boxes"],
                                   atol=ATOL_BF16)
        np.testing.assert_allclose(data["scores"], jdata["scores"],
                                   atol=ATOL_BF16)
        n += len(data["labels"])
    assert n > 0  # the comparison has detections
    assert got["healthz"]["endpoints"] == ["/detect"]


def test_from_checkpoint_options(classify_ckpts, detect_ckpts):
    """max_batch on a detect checkpoint refuses; quantize="int8" serves
    /classify as JAX's from_checkpoint(quantize="int8") does (bf16 on both
    sides, the int8 limits of tests/test_torch_quant.py); max_batch=2
    micro-batches."""
    with pytest.raises(ValueError, match="single-image"):
        InferenceServer.from_checkpoint(detect_ckpts["port"], max_batch=4,
                                        device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        InferenceServer.from_checkpoint(classify_ckpts["port"],
                                        quantize="int4", device="cpu")
    bodies = [_png(seed, (40, 40, 3)) for seed in (4, 5)]
    got = _served(classify_ckpts, "/classify", bodies, quantize="int8")
    for (status, data), (jstatus, jdata) in zip(got["port"], got["jax"]):
        assert status == jstatus == 200
        assert data["class"] == jdata["class"]
        np.testing.assert_allclose(data["probs"], jdata["probs"],
                                   atol=ATOL_BF16)
    srv = InferenceServer.from_checkpoint(classify_ckpts["port"],
                                          max_batch=2, device="cpu")
    try:
        host, port = srv.start_background(port=0)
        status, data = _post(f"http://{host}:{port}/classify",
                             _png(6, (40, 40, 3)))
        assert status == 200 and len(data["probs"]) == 6
        assert _get(f"http://{host}:{port}/stats")["batching"][
            "requests"] == 1
    finally:
        srv.shutdown()


def test_from_checkpoint_takes_the_card_by_default(classify_ckpts,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer.from_checkpoint(classify_ckpts["port"])


def test_server_cli_flag_validation():
    """JAX's test_server_cli_flag_validation; --artifact and --int8 are
    taken, and a missing artifact or checkpoint surfaces as such."""
    main = server_module.main
    with pytest.raises(SystemExit):
        main(["--artifact", "x.hlo", "--int8"])
    with pytest.raises(SystemExit):
        main(["--artifact", "x.hlo", "--step", "3"])
    with pytest.raises(SystemExit):  # mutually exclusive sources
        main(["--artifact", "x.hlo", "--checkpoint-dir", "d"])
    with pytest.raises(SystemExit):  # one source required
        main([])
    with pytest.raises(FileNotFoundError, match="no artifact"):
        main(["--artifact", "x.pt2"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(["--checkpoint-dir", "d", "--int8"])


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_server_main_serves_a_checkpoint(classify_ckpts, tmp_path):
    """``python -m arsvt_tpu_torch.serving.server --checkpoint-dir`` with
    ARSVT_PLATFORM=cpu answers as from_checkpoint does in process."""
    body = _png(9, (36, 40, 3))
    srv = InferenceServer.from_checkpoint(classify_ckpts["port"],
                                          device="cpu")
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
             "--checkpoint-dir", classify_ckpts["port"], "--port",
             str(port)], cwd=REPO, env=env, stdout=f,
            stderr=subprocess.STDOUT)
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
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/detect", body)
        assert e.value.code == 404
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert "serving on http://127.0.0.1" in log.read_text()
