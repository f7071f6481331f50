"""Dynamic micro-batching for the HTTP classify path (copy of
``arsvt_tpu/serving/batching.py``).

Requests queue; a single worker drains up to `max_batch` of them within
`window_ms`, pads the stack to the fixed `max_batch` shape, runs the
engine's `infer_batch`, and fans results back out. A solo request still
completes in ~window_ms + one forward — the window only delays a request
when nothing else is queued behind it.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np


class _Pending:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class MicroBatcher:
    """Batch concurrent single-image requests into one device forward.

    `infer_batch(images[B,S,S,3]) -> (idx[B], probs[B,C])` is the engine
    hook (StreamingClassifier.infer_batch);
    `lock` (optional) serializes device access with other server handlers.
    """

    def __init__(self, infer_batch, *, max_batch: int = 8,
                 window_ms: float = 3.0, lock: threading.Lock | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._infer_batch = infer_batch
        self._max_batch = max_batch
        self._window_s = window_ms / 1e3
        self._lock = lock
        self._q: queue.Queue[_Pending] = queue.Queue()
        self._stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client
    def infer(self, image) -> tuple[int, np.ndarray]:
        """Submit one HWC image; blocks until its (class_idx, probs)."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is shut down")
        item = _Pending(np.asarray(image))
        self._q.put(item)
        # close the shutdown race: if shutdown() ran between the check
        # above and the put (its final drain may already be done), no one
        # will ever drain this item — re-check and self-drain so the
        # waiter below can never block on a dead worker. Queue.get is
        # atomic, so each item is failed or served exactly once.
        if self._stop.is_set():
            self._drain_rejected()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def stats(self) -> dict:
        s = dict(self._stats)
        s["avg_batch"] = (
            round(s["requests"] / s["batches"], 2) if s["batches"] else 0.0
        )
        return s

    def shutdown(self):
        self._stop.set()
        # wake the worker so it can observe the stop flag
        self._q.put(None)  # type: ignore[arg-type]
        self._thread.join(timeout=5)
        # catch any request that raced past the worker's final drain
        self._drain_rejected()

    # ------------------------------------------------------------- worker
    def _collect(self) -> list[_Pending]:
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        deadline = time.perf_counter() + self._window_s
        while len(items) < self._max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _drain_rejected(self):
        """Fail any requests still queued at shutdown — a waiter blocked
        on a dead worker would hang its HTTP handler thread forever."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item.error = RuntimeError("MicroBatcher shut down")
                item.event.set()

    def _loop(self):
        try:
            self._run()
        finally:
            self._drain_rejected()

    def _run(self):
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            try:
                images = np.stack([it.image for it in items])
                n = images.shape[0]
                if n < self._max_batch:  # pad to the one compiled shape
                    pad = np.zeros(
                        (self._max_batch - n,) + images.shape[1:],
                        images.dtype,
                    )
                    images = np.concatenate([images, pad])
                if self._lock is not None:
                    with self._lock:
                        idx, probs = self._infer_batch(images)
                else:
                    idx, probs = self._infer_batch(images)
                for i, it in enumerate(items):
                    it.result = (int(idx[i]), np.asarray(probs[i]))
                    it.event.set()
                self._stats["requests"] += n
                self._stats["batches"] += 1
                self._stats["max_batch_seen"] = max(
                    self._stats["max_batch_seen"], n
                )
            except Exception as e:  # propagate to every waiter
                for it in items:
                    it.error = e
                    it.event.set()
