"""Rolling serving-latency window (copy of ``arsvt_tpu/utils/latency.py``).

One implementation of the p50/p90/p99 stats surface for the streaming
engines, so /stats payloads cannot diverge between them.
"""

from __future__ import annotations

import collections

import numpy as np

# genuinely ROLLING: a long-lived sorter server must neither grow one
# float per request forever nor let days-old samples mask a fresh latency
# regression in p50/p90
WINDOW = 4096


class LatencyWindow:
    """Mixin: engines append seconds to `self._latencies` (or call
    `note_latency`) and expose percentile stats via `latency_stats`."""

    _latencies: collections.deque

    @staticmethod
    def new_window() -> collections.deque:
        return collections.deque(maxlen=WINDOW)

    def note_latency(self, seconds: float) -> None:
        """External paths (the serving micro-batcher) record into the
        same rolling window latency_stats reads."""
        self._latencies.append(seconds)

    def replace_last_latency(self, seconds: float) -> None:
        """Overwrite the most recent sample — callers that wrap an engine
        call (decode + forward) record the inclusive time under ONE entry
        instead of double-counting."""
        if self._latencies:
            self._latencies[-1] = seconds

    def latency_stats(self) -> dict:
        if not self._latencies:
            return {}
        lat = np.asarray(self._latencies) * 1e3
        return {
            "p50_ms": float(np.percentile(lat, 50)),
            "p90_ms": float(np.percentile(lat, 90)),
            "p99_ms": float(np.percentile(lat, 99)),
            "n": int(lat.size),
        }
