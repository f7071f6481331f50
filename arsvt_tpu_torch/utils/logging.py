"""Metric logging (counterpart of ``arsvt_tpu/utils/logging.py``): a JSONL
file and stderr, and an images/s meter. The JAX package's optional wandb
sink is left out: the port's runs have no network.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Any


class MetricLogger:
    def __init__(self, out_dir: str | None = None, *, quiet: bool = False):
        self._quiet = quiet
        self._fh = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict[str, Any], *, prefix: str = ""):
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                # arrays (confusion matrices, per-class vectors) and other
                # non-scalars must still produce a valid JSON line
                rec[key] = v.tolist() if hasattr(v, "tolist") else v
        if self._fh:
            # bare NaN/Infinity tokens are invalid JSON (RFC 8259): a
            # diverged run's metrics.jsonl must still parse
            safe = {
                k: (v if not isinstance(v, float) or math.isfinite(v)
                    else str(v))
                for k, v in rec.items()
            }
            self._fh.write(json.dumps(safe, default=str) + "\n")
            self._fh.flush()
        if not self._quiet:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("time",)
            )
            print(parts, file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class Throughput:
    """images/sec meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t = time.perf_counter()
        self._images = 0

    def add(self, n: int):
        self._images += n

    def rate(self) -> float:
        dt = time.perf_counter() - self._t
        return self._images / dt if dt > 0 else 0.0
