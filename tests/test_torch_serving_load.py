"""``chip_smoke.py --serving-load`` (and its phase 5(c)) against JAX's
``benchmarks/serving_load.py``, on the CPU: the part's configuration read
from that file's source with ``ast`` (importing it would import JAX's
server and start nothing of use here), its JPEG body rebuilt from that
source, its summary against the source's formulas, and the port's
micro-batched server under the part's closed-loop clients against the
JAX server's answers, on bridged weights at a tiny configuration."""

import ast
import inspect
import io
import os
import threading
import types

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from arsvt_tpu.serving.server import InferenceServer as JaxInferenceServer
from arsvt_tpu_torch.serving import batching
from arsvt_tpu_torch.serving.server import InferenceServer
from test_torch_serving import ATOL_HTTP, _get, _post, engines  # noqa: F401

torch.set_num_threads(1)  # tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING_LOAD = os.path.join(REPO, "benchmarks", "serving_load.py")
REVALIDATE = os.path.join(REPO, "benchmarks", "tpu_revalidate.sh")
# The CPU test's load: 8 clients of 4 requests each through a batch of 8,
# under a window wide enough that the clients' first requests, decoded
# one after another under the interpreter lock, meet in one batch
CPU_CLIENTS = 8
CPU_REQUESTS = 4
CPU_WINDOW_MS = 500.0


def _tree():
    with open(SERVING_LOAD) as f:
        return ast.parse(f.read())


def _function(tree, name):
    (fn,) = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == name]
    return fn


def _calls(node, fn: str):
    return [c for c in ast.walk(node)
            if isinstance(c, ast.Call) and ast.unparse(c.func) == fn]


def _defaults(tree) -> dict:
    """`ap.add_argument(flag, ..., default=...)` -> {flag: default}, and
    --quantize's choices."""
    out = {}
    for call in _calls(tree, "ap.add_argument"):
        kw = {k.arg: k.value for k in call.keywords}
        flag = ast.literal_eval(call.args[0])
        out[flag] = ast.literal_eval(kw["default"])
        if "choices" in kw:
            out[flag + " choices"] = ast.literal_eval(kw["choices"])
    return out


def _revalidate_args() -> dict:
    """The serving_load.py line of tpu_revalidate.sh (and the line after
    it, where the command continues): {flag: value}."""
    with open(REVALIDATE) as f:
        lines = f.read().splitlines()
    (i,) = [i for i, line in enumerate(lines)
            if "benchmarks/serving_load.py" in line]
    words = (lines[i] + " " + lines[i + 1]).replace("\\", " ").split()
    words = words[words.index("benchmarks/serving_load.py") + 1:]
    return {w: words[k + 1] for k, w in enumerate(words)
            if w.startswith("--")}


def _line_of(fn_node, predicate) -> int:
    (line,) = {n.lineno for n in ast.walk(fn_node) if predicate(n)}
    return line


@pytest.mark.parametrize("part", [
    "defaults", "duration", "frame", "model", "warmups", "stats_after_stop",
    "client"])
def test_part_holds_serving_load_configuration(part):
    """The part's constants against serving_load.py's source: the argparse
    defaults (:81-86), the 30 s of tpu_revalidate.sh:38, `_jpeg_frame`'s
    defaults and seed (:46-54), the model and its seed, the three warm-up
    requests (:116-120), /stats read after the clients stop (:141-145)
    on both sides, and the client's timeouts."""
    tree = _tree()
    main = _function(tree, "main")
    defaults = _defaults(tree)
    if part == "defaults":
        assert (defaults["--clients"], defaults["--max-batch"],
                defaults["--batch-window-ms"], defaults["--preset"],
                defaults["--quantize"]) == (
            cs.LOAD_CLIENTS, cs.LOAD_MAX_BATCH, cs.LOAD_WINDOW_MS,
            cs.LOAD_PRESET, None) == (16, 8, 3.0, "vit_base_16_224", None)
        # the runs: the defaults, then --quantize int8, then --max-batch 1
        assert cs.LOAD_RUNS == ((defaults["--quantize"], cs.LOAD_MAX_BATCH),
                                ("int8", cs.LOAD_MAX_BATCH), (None, 1))
        assert "int8" in defaults["--quantize choices"]
    elif part == "duration":
        args = _revalidate_args()
        assert defaults["--duration"] == 20.0  # the harness's own default
        assert (int(args["--clients"]), float(args["--duration"]),
                int(args["--max-batch"]), args["--preset"]) == (
            cs.LOAD_CLIENTS, cs.LOAD_DURATION_S, cs.LOAD_MAX_BATCH,
            cs.LOAD_PRESET)
        assert "--quantize" not in args and cs.LOAD_SMOKE_S < 15.0
    elif part == "frame":
        fn = _function(tree, "_jpeg_frame")
        names = [a.arg for a in fn.args.args]
        values = [ast.literal_eval(d) for d in fn.args.defaults]
        assert dict(zip(names, values)) == cs.LOAD_FRAME
        (rng,) = _calls(fn, "np.random.default_rng")
        assert ast.literal_eval(rng.args[0]) == cs.LOAD_FRAME_SEED
        (save,) = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                   and ast.unparse(c.func).endswith(".save")]
        kw = {k.arg: ast.unparse(k.value) for k in save.keywords}
        assert kw == {"format": "'JPEG'", "quality": "quality"}
    elif part == "model":
        (init,) = _calls(main, "init_image_classifier")
        assert ast.unparse(init.args[0]) == "jax.random.PRNGKey(0)"
        assert ast.literal_eval(init.args[0].args[0]) == cs.LOAD_INIT_SEED
        assert ast.literal_eval(init.args[2]) == cs.LOAD_CLASSES == 6
        (clf,) = _calls(main, "StreamingClassifier")
        assert ast.literal_eval(clf.args[2]) == cs.LOAD_CLASSES
        assert {k.arg: ast.unparse(k.value) for k in clf.keywords} == {
            "quantize": "args.quantize"}
        (srv,) = _calls(main, "InferenceServer")
        assert {k.arg: ast.unparse(k.value) for k in srv.keywords} == {
            "classifier": "clf", "max_batch": "args.max_batch",
            "batch_window_ms": "args.batch_window_ms"}
        params = cs.load_params()
        assert params["classifier"]["head"]["kernel"].abs().sum() > 0
    elif part == "warmups":
        (loop,) = [n for n in ast.walk(main) if isinstance(n, ast.For)
                   and "'POST'" in ast.unparse(n)]
        assert ast.unparse(loop.iter) == f"range({cs.LOAD_WARMUPS})"
        assert cs.LOAD_WARMUPS == 3
    elif part == "stats_after_stop":
        stop = _line_of(main, lambda n: isinstance(n, ast.Call)
                        and ast.unparse(n) == "stop.set()")
        join = _line_of(main, lambda n: isinstance(n, ast.Call)
                        and ast.unparse(n.func) == "t.join")
        stats = _line_of(main, lambda n: isinstance(n, ast.Call)
                         and ast.unparse(n) == "conn.request('GET', "
                                              "'/stats')")
        assert stop < join < stats
        port = ast.parse(inspect.getsource(cs.serving_load_run))
        drive = _line_of(port, lambda n: isinstance(n, ast.Call)
                         and ast.unparse(n.func) == "drive_clients")
        read = _line_of(port, lambda n: isinstance(n, ast.Call)
                        and ast.unparse(n.func) == "get"
                        and "/stats" in ast.unparse(n))
        assert drive < read
        drive_fn = ast.parse(inspect.getsource(cs.drive_clients))
        assert (_line_of(drive_fn, lambda n: isinstance(n, ast.Call)
                         and ast.unparse(n) == "stop.set()")
                < _line_of(drive_fn, lambda n: isinstance(n, ast.Call)
                           and ast.unparse(n.func) == "t.join"))
    elif part == "client":
        loop = _function(tree, "_client_loop")
        timeouts = {ast.literal_eval(k.value)
                    for c in _calls(loop, "http.client.HTTPConnection")
                    for k in c.keywords if k.arg == "timeout"}
        assert timeouts == {cs.LOAD_CLIENT_TIMEOUT_S}
        (join,) = _calls(main, "t.join")
        assert ast.literal_eval(join.keywords[0].value) == cs.LOAD_JOIN_S
        (request,) = _calls(loop, "conn.request")
        assert ast.unparse(request) == (
            "conn.request('POST', '/classify', body, "
            "{'Content-Type': 'image/jpeg'})")


def test_part_body_is_jpeg_frame():
    """`cs.load_frame()` is `_jpeg_frame()` to the byte, the function
    rebuilt from the parsed source."""
    fn = _function(_tree(), "_jpeg_frame")
    namespace = {"np": np, "io": io}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), SERVING_LOAD,
                 "exec"), namespace)
    body = namespace["_jpeg_frame"]()
    assert cs.load_frame() == body
    assert Image.open(io.BytesIO(body)).size == (640, 480)


@pytest.mark.parametrize("case", ["mixed", "one", "none"])
def test_load_result_matches_serving_load_formulas(case):
    """`cs.load_result` against serving_load.py's `lat` and `result`
    statements (:147-163), executed from the source on the same inputs:
    the same keys, formulas and rounding; the backend is the engine's."""
    main = _function(_tree(), "main")
    (start,) = [i for i, n in enumerate(main.body)
                if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == "lat"]
    (end,) = [i for i, n in enumerate(main.body)
              if isinstance(n, ast.Assign)
              and ast.unparse(n.targets[0]) == "result"]
    statements = ast.Module(body=main.body[start:end + 1], type_ignores=[])
    latencies = {"mixed": [0.4681, 0.0123, 2.17999, 0.59252, 0.033, 0.0815,
                           0.1, 0.25, 0.0555, 0.31],
                 "one": [0.0421], "none": []}[case]
    stats = {"batching": {"requests": 13, "batches": 2,
                          "max_batch_seen": 8, "avg_batch": 6.5}}
    for max_batch, quantize in cs.LOAD_RUNS:
        namespace = {
            "np": np, "latencies": latencies, "wall": 30.6123,
            "errors": ["e"] if case == "one" else [], "stats": stats,
            "args": types.SimpleNamespace(
                clients=cs.LOAD_CLIENTS, max_batch=max_batch,
                batch_window_ms=cs.LOAD_WINDOW_MS, preset=cs.LOAD_PRESET,
                quantize=quantize),
        }
        exec(compile(statements, SERVING_LOAD, "exec"), namespace)
        want = namespace["result"]
        got = cs.load_result(latencies, namespace["errors"], 30.6123, stats,
                             max_batch=max_batch, quantize=quantize,
                             backend="cuda")
        assert got.pop("backend") == "cuda"
        want.pop("backend")
        assert got == want


def _recording_pending(monkeypatch, seen, batcher_of):
    """Make every request's wake-up event record the batcher's stats at
    the moment it is set."""

    class Recording(threading.Event):
        def set(self):
            seen.append(batcher_of().stats())
            super().set()

    init = batching._Pending.__init__

    def recording_init(self, image):
        init(self, image)
        self.event = Recording()

    monkeypatch.setattr(batching._Pending, "__init__", recording_init)


def test_batcher_counts_a_batch_before_waking_its_waiters(monkeypatch):
    """A waiter that wakes finds its batch in the stats already, so /stats
    read right after the last answer counts every request."""
    seen = []
    batcher = None
    _recording_pending(monkeypatch, seen, lambda: batcher)

    def infer_batch(images):
        return (np.zeros(len(images), np.int64),
                np.full((len(images), 6), 1 / 6, np.float32))

    batcher = batching.MicroBatcher(infer_batch, max_batch=4,
                                    window_ms=1.0)
    try:
        for i in range(3):
            idx, probs = batcher.infer(np.zeros((2, 2, 3), np.float32))
            assert idx == 0 and probs.shape == (6,)
            assert seen[-1]["requests"] == i + 1
            assert seen[-1]["batches"] == i + 1
    finally:
        batcher.shutdown()


def test_batched_server_under_load_matches_jax_server(engines):  # noqa: F811
    """The part's clients (8 x 4 requests of its JPEG) against the port's
    micro-batched server on an fp32 engine: every answer 200 and within
    ATOL_HTTP of the JAX server's answer for the body, the batcher's
    count equal to the requests, and coalescing."""
    body = cs.load_frame()
    jsrv = JaxInferenceServer(classifier=engines["jax"])
    jhost, jport = jsrv.start_background(port=0)
    try:
        status, expected = _post(f"http://{jhost}:{jport}/classify", body)
    finally:
        jsrv.shutdown()
    assert status == 200
    srv = InferenceServer(classifier=engines["port"],
                          max_batch=cs.LOAD_MAX_BATCH,
                          batch_window_ms=CPU_WINDOW_MS)
    host, port = srv.start_background(port=0)
    try:
        wall, latencies, errors, payloads = cs.drive_clients(
            port, body, CPU_CLIENTS, requests=CPU_REQUESTS)
        stats = _get(f"http://{host}:{port}/stats")
    finally:
        srv.shutdown()
    assert errors == []
    assert len(latencies) == len(payloads) == CPU_CLIENTS * CPU_REQUESTS
    for data in payloads:
        assert data["class"] == expected["class"]
        np.testing.assert_allclose(data["probs"], expected["probs"],
                                   atol=ATOL_HTTP)
    batching_stats = stats["batching"]
    assert batching_stats["requests"] == CPU_CLIENTS * CPU_REQUESTS
    assert batching_stats["max_batch_seen"] > 1
    result = cs.load_result(latencies, errors, wall, stats,
                            max_batch=cs.LOAD_MAX_BATCH, quantize=None,
                            backend="cpu")
    assert result["requests_ok"] == CPU_CLIENTS * CPU_REQUESTS
    assert result["errors"] == 0 and result["batcher"] == batching_stats


def test_clients_count_errors_and_never_retry_them(engines):  # noqa: F811
    """A body the server cannot decode is an error (status 400) each time
    it is sent: no answer, no retry into a success."""
    srv = InferenceServer(classifier=engines["port"],
                          max_batch=cs.LOAD_MAX_BATCH,
                          batch_window_ms=cs.LOAD_WINDOW_MS)
    _, port = srv.start_background(port=0)
    try:
        _, latencies, errors, payloads = cs.drive_clients(
            port, b"not an image", 2, requests=3)
    finally:
        srv.shutdown()
    assert latencies == payloads == [] and len(errors) == 6
