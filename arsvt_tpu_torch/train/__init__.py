"""Train and eval steps, optimizer, schedules, configs, the trainer and
checkpoints (counterpart of ``arsvt_tpu/train``)."""

from arsvt_tpu_torch._lazy import lazy

_EXPORTS = {
    "TrainConfig": "config",
    "make_classifier_step_fns": "train_step",
    "TrainState": "train_step",
    "make_detector_step_fns": "detect_step",
    "Trainer": "trainer",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy(__name__, _EXPORTS)
