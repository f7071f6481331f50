"""HTTP inference server for the physical sorter loop (counterpart of
``arsvt_tpu/serving/server.py``).

    POST /classify   body = JPEG/PNG bytes -> {"class", "class_name",
                     "probs", "latency_ms"}
    POST /detect     body = JPEG/PNG bytes -> {"boxes", "labels",
                     "scores", "class_names"}
    GET  /healthz    -> {"status": "ok", "backend": <torch device type>,
                     "endpoints": [...]}
    GET  /stats      -> rolling latency percentiles (+ batching counters)

Built from a training checkpoint of the port (bf16, or the int8 W8A8
backbone with ``quantize="int8"``), from an export artifact
(``serving/export.py``; no model code is imported), or from in-memory
`StreamingClassifier` and/or `StreamingDetector` engines:

    server = InferenceServer.from_checkpoint("checkpoints")
    server = InferenceServer.from_artifact("model.pt2")
    server.serve(port=8000)                      # blocking
    host, port = server.start_background(port=0)  # or threaded

or from the command line, on the card unless ``ARSVT_PLATFORM=cpu``:

    python -m arsvt_tpu_torch.serving.server --checkpoint-dir checkpoints \
        [--int8]
    python -m arsvt_tpu_torch.serving.server --artifact model.pt2
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from arsvt_tpu_torch.core.devices import platform_device
from arsvt_tpu_torch.data.pipeline import letterbox
from arsvt_tpu_torch.data.taxonomy import class_name
from arsvt_tpu_torch.serving.batching import MicroBatcher


class InferenceServer:
    def __init__(self, *, classifier=None, detector=None,
                 max_batch: int = 1, batch_window_ms: float = 3.0):
        """Pass a StreamingClassifier and/or StreamingDetector.

        `max_batch > 1` turns on dynamic micro-batching for /classify:
        concurrent requests within `batch_window_ms` share one padded
        device forward (serving/batching.py)."""
        if classifier is None and detector is None:
            raise ValueError("need a classifier and/or a detector")
        if max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1 (1 = unbatched), got {max_batch}"
            )
        self._clf = classifier
        self._det = detector
        self._lock = threading.Lock()  # serialize device access
        self._httpd = None
        self._batcher = None
        if max_batch > 1:
            if classifier is None:
                raise ValueError("max_batch > 1 needs a classifier "
                                 "(/detect stays single-image)")
            self._batcher = MicroBatcher(
                classifier.infer_batch, max_batch=max_batch,
                window_ms=batch_window_ms, lock=self._lock,
            )
            # warm the one padded batch shape now, so the first real
            # request does not pay for the library's first-shape set-up
            s = classifier.image_size
            classifier.infer_batch(
                np.zeros((max_batch, s, s, 3), np.float32)
            )

    # ------------------------------------------------------------ factory
    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, *, step: int | None = None,
                        quantize: str | None = None, max_batch: int = 1,
                        batch_window_ms: float = 3.0, device=None):
        """Build the right streaming engine from a training checkpoint of
        the port (``train/checkpoint.py``), on `device` (None: the card).
        `quantize="int8"` serves the W8A8 backbone (``models/quantized.
        py``): int8 weights on the device; a detector's DETR head stays
        floating point."""
        from arsvt_tpu_torch.evaluation.classify import (
            StreamingClassifier,
            StreamingDetector,
        )
        from arsvt_tpu_torch.serving.loading import load_inference_bundle
        from arsvt_tpu_torch.train.config import (
            resolve_backbone,
            resolve_detector,
        )

        params, cfg = load_inference_bundle(checkpoint_dir, step=step)
        # the preprocessing contract rides with the checkpoint: training
        # with augment="none" feeds raw [0,1] images, every other mode
        # ImageNet-normalizes inside the step, and serving must match
        normalize_inputs = cfg.augment != "none"
        if cfg.task == "detect":
            if max_batch > 1:
                raise ValueError("micro-batching applies to /classify; "
                                 "detect checkpoints serve single-image")
            return cls(detector=StreamingDetector(
                params, resolve_detector(cfg),
                normalize_inputs=normalize_inputs, quantize=quantize,
                device=device,
            ))
        return cls(classifier=StreamingClassifier(
            params, resolve_backbone(cfg), cfg.num_classes,
            normalize_inputs=normalize_inputs, quantize=quantize,
            device=device,
        ), max_batch=max_batch, batch_window_ms=batch_window_ms)

    @classmethod
    def from_artifact(cls, artifact_path: str, *, max_batch: int = 1,
                      batch_window_ms: float = 3.0, device=None):
        """Serve an export artifact (``serving/export.py``) on `device`
        (None: the card): the task and the preprocessing contract live in
        the artifact, and no model code is imported."""
        from arsvt_tpu_torch.serving.artifact import (
            ArtifactDetector,
            load_artifact_engine,
        )

        engine = load_artifact_engine(artifact_path, device)
        if isinstance(engine, ArtifactDetector):
            if max_batch > 1:
                raise ValueError("micro-batching applies to /classify; "
                                 "detect artifacts serve single-image")
            return cls(detector=engine)
        return cls(classifier=engine, max_batch=max_batch,
                   batch_window_ms=batch_window_ms)

    # ----------------------------------------------------------- handlers
    def _decode(self, body: bytes):
        from PIL import Image, ImageOps

        # EXIF orientation applied exactly as the path-based decode does
        # (data/pipeline.py::_open_upright)
        img = ImageOps.exif_transpose(Image.open(io.BytesIO(body)))
        return np.asarray(img.convert("RGB"), np.float32) / 255.0

    def _classify(self, body: bytes) -> dict:
        t0 = time.perf_counter()
        # rescale + normalization happen inside the classifier's forward,
        # per its normalize_inputs contract
        img, _ = letterbox(self._decode(body), self._clf.image_size)
        if self._batcher is not None:
            # decode/letterbox ran on this request thread (parallel); the
            # batcher coalesces concurrent forwards into one device call
            idx, probs = self._batcher.infer(img)
            self._clf.note_latency(time.perf_counter() - t0)
            name = class_name(idx)
        else:
            with self._lock:
                idx, name, probs = self._clf(img)
            # /stats means the same in both modes: decode + letterbox +
            # forward under one sample
            self._clf.replace_last_latency(time.perf_counter() - t0)
        return {
            "class": int(idx),
            "class_name": name,
            "probs": [round(float(p), 4) for p in probs],
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
        }

    def _detect(self, body: bytes) -> dict:
        # the detector's surface is path-based (sorter cameras write
        # frames), so the upload is spooled to a file first
        with tempfile.NamedTemporaryFile(suffix=".jpg", delete=False) as f:
            f.write(body)
            path = f.name
        try:
            with self._lock:
                out = self._det.detect_path(path)
        finally:
            os.unlink(path)
        return {
            "boxes": np.asarray(out["boxes"]).round(4).tolist(),
            "labels": np.asarray(out["labels"]).tolist(),
            "scores": np.asarray(out["scores"]).round(4).tolist(),
            "class_names": out["class_names"],
        }

    def _stats(self) -> dict:
        stats = {}
        if self._clf is not None:
            stats["classify"] = self._clf.latency_stats()
        if self._det is not None:
            stats["detect"] = self._det.latency_stats()
        if self._batcher is not None:
            stats["batching"] = self._batcher.stats()
        return stats

    def _health(self) -> dict:
        engine = self._clf if self._clf is not None else self._det
        return {
            "status": "ok",
            "backend": engine.device.type,
            "endpoints": [p for p, e in (("/classify", self._clf),
                                         ("/detect", self._det))
                          if e is not None],
        }

    # -------------------------------------------------------------- serve
    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server_self._health())
                elif self.path == "/stats":
                    self._send(200, server_self._stats())
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    clf, det = server_self._clf, server_self._det
                    if self.path == "/classify" and clf is not None:
                        self._send(200, server_self._classify(body))
                    elif self.path == "/detect" and det is not None:
                        self._send(200, server_self._detect(body))
                    else:
                        self._send(404, {"error": "unknown path"})
                except (BrokenPipeError, ConnectionError):
                    # the client went away mid-write — a 400 on the same
                    # stream would follow an already-sent 200 status line
                    pass
                except Exception as e:  # undecodable image etc.
                    try:
                        self._send(400, {"error": str(e)[:200]})
                    except (BrokenPipeError, ConnectionError):
                        pass

        return Handler

    def serve(self, *, host: str = "127.0.0.1", port: int = 8000):
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.serve_forever()

    def start_background(self, *, host: str = "127.0.0.1", port: int = 8000):
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self._httpd.server_address

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()  # free the listening socket fd now
            self._httpd = None
        if self._batcher is not None:
            self._batcher.shutdown()
            self._batcher = None


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="arsvt_tpu_torch inference "
                                            "server")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint-dir",
                     help="serve from a training checkpoint of the port")
    src.add_argument("--artifact",
                     help="serve an export artifact "
                          "(python -m arsvt_tpu_torch.serving.export)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=1,
                   help="dynamic micro-batching for /classify: coalesce "
                        "up to N concurrent requests into one forward")
    p.add_argument("--batch-window-ms", type=float, default=3.0,
                   help="how long a lone request waits for batch company")
    p.add_argument("--int8", action="store_true",
                   help="serve the W8A8 quantized backbone (classify and "
                        "detect; int8 weights on the device); with "
                        "--artifact, quantization is baked in at export "
                        "time instead")
    args = p.parse_args(argv)
    if args.artifact:
        if args.int8 or args.step is not None:
            p.error("--int8/--step apply to --checkpoint-dir; with "
                    "--artifact they are baked in at export time")
        server = InferenceServer.from_artifact(
            args.artifact, max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms, device=platform_device(),
        )
    else:
        server = InferenceServer.from_checkpoint(
            args.checkpoint_dir, step=args.step,
            quantize="int8" if args.int8 else None,
            max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
            device=platform_device(),
        )
    print(f"serving on http://{args.host}:{args.port}  "
          f"(POST /classify|/detect, GET /healthz|/stats)", flush=True)
    server.serve(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
