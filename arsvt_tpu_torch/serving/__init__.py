"""Serving: the HTTP server, its micro-batcher, checkpoint loading, the
``torch.export`` artifacts and their engines.

Submodules are loaded lazily (as ``arsvt_tpu/serving/__init__.py`` does),
so ``python -m arsvt_tpu_torch.serving.export`` / ``.server`` run as clean
entry points and importing one surface does not pull in the others'
dependencies.
"""

_EXPORTS = {
    "MicroBatcher": "arsvt_tpu_torch.serving.batching",
    "ArtifactClassifier": "arsvt_tpu_torch.serving.artifact",
    "ArtifactDetector": "arsvt_tpu_torch.serving.artifact",
    "load_artifact_engine": "arsvt_tpu_torch.serving.artifact",
    "export_checkpoint": "arsvt_tpu_torch.serving.export",
    "export_classifier": "arsvt_tpu_torch.serving.export",
    "export_detector": "arsvt_tpu_torch.serving.export",
    "load_exported": "arsvt_tpu_torch.serving.export",
    "save_exported": "arsvt_tpu_torch.serving.export",
    "load_inference_bundle": "arsvt_tpu_torch.serving.loading",
    "InferenceServer": "arsvt_tpu_torch.serving.server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
