"""Metric logging, latency windows, FLOP counts and profiling helpers
(counterpart of ``arsvt_tpu/utils``)."""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "MetricLogger": "logging",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
