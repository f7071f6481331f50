"""Profiling and NaN guards (counterpart of
``arsvt_tpu/utils/profiling.py``):

* `trace(logdir)`: a ``torch.profiler`` window around the wrapped steps,
  recording the card's kernels when CUDA is in use, written to `logdir`
  as a Chrome trace (JAX writes a TensorBoard trace);
* `StepTimer`: wall-clock per-step timing with warm-up discard and a
  mean / p50 / p99 summary; each step ends with a synchronize of the card
  when CUDA is initialized, so it times the step's work, not only its
  dispatch;
* `assert_all_finite(tree)`: a host-side NaN/Inf guard over a tree of
  dicts and lists (bf16 included); `enable_nan_checks()` turns on
  autograd's anomaly detection, which checks the backward's results for
  NaN (JAX's ``jax_debug_nans`` checks every op).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from arsvt_tpu_torch.core.dtypes import tree_map_with_path


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; on exit write ``trace-<ns>-<pid>.json`` (Chrome
    trace format) under `logdir`. Yields the path it will write."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{time.time_ns()}-{os.getpid()}.json")
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if ProfilerActivity.CUDA in activities:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class StepTimer:
    def __init__(self, warmup: int = 2):
        self._warmup = warmup
        self._times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        # a step body that raised exited early: recording its partial
        # duration would pollute the summary
        if exc_type is None:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        times = np.asarray(self._times[self._warmup:])
        if times.size == 0:
            return {}
        return {
            "steps": int(times.size),
            "mean_ms": float(times.mean() * 1e3),
            "p50_ms": float(np.percentile(times, 50) * 1e3),
            "p99_ms": float(np.percentile(times, 99) * 1e3),
        }


def _finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex()) or bool(
            torch.isfinite(x.detach()).all())
    arr = np.asarray(x)
    return not np.issubdtype(arr.dtype, np.inexact) or bool(
        np.isfinite(arr).all())


def assert_all_finite(tree, name: str = "tree"):
    """Raise FloatingPointError naming the paths of the floating leaves of
    `tree` (tensors of any float dtype, bf16 included, or numpy arrays)
    that hold a NaN or an Inf."""
    bad = []

    def check(path, x):
        if not _finite(x):
            bad.append(path)
        return x

    tree_map_with_path(check, tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def enable_nan_checks(on: bool = True):
    torch.autograd.set_detect_anomaly(on)
