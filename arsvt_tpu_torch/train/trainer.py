"""The training loop (counterpart of ``arsvt_tpu/train/trainer.py``):
steps, log cadence, in-training eval with the plateau schedule,
checkpoints, resume and the emergency checkpoint on a crash.

Differences from the JAX `Trainer`, by design:
- one device (the card unless the caller asks for the CPU): a mesh of more
  than one device raises (ROADMAP Queue A item 11), so there is no batch
  sharding, host barrier or multi-host eval;
- the state is updated in place by the step functions (``train_step.py``),
  and a checkpoint copies it to the host synchronously;
- the step draws its dropout and augmentation from ``cfg.seed`` and the
  step number, as JAX's step folds its base key by step: a resumed run
  replays the uninterrupted one.

Every train row carries images/s and the effective TFLOP/s beside it
(``utils/flops.py::train_gflops_per_image``: the student's step alone,
no distillation teacher; 0.0 for a preset the registry does not hold,
where JAX falls back to 0.0 on any error of the count).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Iterator

import numpy as np

from arsvt_tpu_torch.train.checkpoint import CheckpointManager
from arsvt_tpu_torch.train.config import TrainConfig
from arsvt_tpu_torch.train.optim import PlateauState, set_lr_scale
from arsvt_tpu_torch.utils.flops import train_gflops_per_image
from arsvt_tpu_torch.utils.logging import MetricLogger, Throughput


class Trainer:
    def __init__(self, cfg: TrainConfig, *, logger: MetricLogger | None = None,
                 step_fns=None, device=None):
        """`step_fns`: (init_fn, train_step, eval_step), by default those
        of `cfg.task` on `device` (None: the card)."""
        if cfg.mesh_data not in (-1, 1) or cfg.mesh_model != 1:
            raise NotImplementedError(
                f"mesh_data={cfg.mesh_data}, mesh_model={cfg.mesh_model}: "
                "the port trains on one device (ROADMAP Queue A item 11, "
                "parallel)")
        self.cfg = cfg
        if step_fns is None:
            if cfg.task == "detect":
                from arsvt_tpu_torch.train.detect_step import (
                    make_detector_step_fns,
                )

                step_fns = make_detector_step_fns(cfg, device)
            else:
                from arsvt_tpu_torch.train.train_step import (
                    make_classifier_step_fns,
                )

                step_fns = make_classifier_step_fns(cfg, device)
        self.init_fn, self.train_step, self.eval_step = step_fns
        self.logger = logger or MetricLogger(quiet=True)
        self.state = None
        self.plateau = PlateauState()
        self._ckpt = None
        self._last_metrics: dict = {}
        try:
            self._gflops_per_image = train_gflops_per_image(cfg)
        except KeyError:  # a preset the registry does not hold
            self._gflops_per_image = 0.0

    # ------------------------------------------------------------- state
    def init_state(self):
        self.state = self.init_fn()
        return self.state

    @property
    def ckpt(self) -> CheckpointManager:
        if self._ckpt is None:
            self._ckpt = CheckpointManager(
                self.cfg.checkpoint_dir, self.cfg,
                keep=self.cfg.keep_checkpoints, best_metric="val_loss",
            )
        return self._ckpt

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint if one exists; returns start step."""
        if self.state is None:
            self.init_state()
        if self.ckpt.latest_step is None:
            return 0
        self.state, _ = self.ckpt.restore(self.state)
        # the plateau controller's counters survive the restart (its lr
        # scale rides in opt_state already)
        plateau = self.ckpt.last_extra.get("plateau")
        if plateau:
            self.plateau = PlateauState(**plateau)
        return int(self.state["step"])

    # -------------------------------------------------------------- loop
    def fit(self, train_batches: Iterator[dict], *,
            eval_batches_fn: Callable[[], Iterator[dict]] | None = None,
            steps: int | None = None):
        cfg = self.cfg
        if self.state is None:
            self.init_state()
        steps = steps if steps is not None else cfg.total_steps
        start = int(self.state["step"])
        meter = Throughput()
        try:
            self._fit_loop(train_batches, eval_batches_fn, steps, start,
                           meter)
        except (KeyboardInterrupt, Exception):
            # persist the last completed step before propagating, so
            # --resume continues from here whatever the checkpoint cadence
            if self.state is not None:
                step_now = int(self.state["step"])
                if step_now > start:
                    try:
                        self.ckpt.save(step_now, self.state, extra={
                            "plateau": dataclasses.asdict(self.plateau)})
                    except Exception as save_err:
                        # never mask the original failure
                        print(f"emergency checkpoint failed: {save_err}",
                              file=sys.stderr)
            raise
        return self._last_metrics

    def _fit_loop(self, train_batches, eval_batches_fn, steps, start, meter):
        cfg = self.cfg
        last_val_loss = float("inf")
        last_val_step = -1  # step the loss was measured at, for freshness
        self._last_metrics = {}

        for step in range(start, steps):
            batch = next(train_batches)
            self.state, metrics = self.train_step(self.state, batch)
            meter.add(int(batch["image"].shape[0]))

            if (step + 1) % cfg.log_every == 0 or step + 1 == steps:
                host = {k: float(v) for k, v in metrics.items()}
                host["images_per_sec"] = meter.rate()
                host["tflops"] = (
                    host["images_per_sec"] * self._gflops_per_image / 1e3)
                self.logger.log(step + 1, host, prefix="train/")
                self._last_metrics = host
                meter.reset()

            if eval_batches_fn and (step + 1) % cfg.eval_every == 0:
                eval_metrics = self.evaluate(eval_batches_fn())
                self.logger.log(step + 1, eval_metrics, prefix="val/")
                last_val_loss = float(eval_metrics.get("loss", last_val_loss))
                last_val_step = step + 1
                if cfg.schedule == "plateau":
                    self.plateau = self.plateau.update(
                        eval_metrics["loss"], cfg)
                    self.state["opt_state"] = set_lr_scale(
                        self.state["opt_state"], self.plateau.scale)

            # >= 10**9 is the presets' "checkpointing off" sentinel; any
            # smaller cadence keeps the final-step save even for runs
            # shorter than one cadence interval
            ckpt_enabled = cfg.checkpoint_every < 10**9
            if ckpt_enabled and (
                (step + 1) % cfg.checkpoint_every == 0 or step + 1 == steps
            ):
                # val_loss rides along only when it was measured at this
                # very step: a stale value would let the best-checkpoint
                # selector credit newer weights with an old loss
                fresh = last_val_step == step + 1
                self.ckpt.save(
                    step + 1, self.state,
                    metrics={"val_loss": last_val_loss} if fresh else None,
                    extra={"plateau": dataclasses.asdict(self.plateau)},
                )

    # -------------------------------------------------------------- eval
    def evaluate(self, batches: Iterator[dict]) -> dict:
        """Aggregate eval metrics. Classification batches (with 'correct' /
        'count' / 'confusion') get accuracy and the confusion matrix; other
        scalar metrics (detection loss parts) are averaged over batches,
        weighted by each batch's valid rows. Detection eval steps return
        raw `outputs`, post-processed here for val mAP/AP50/AP75."""
        sums: dict = {}
        confusion = None
        total_correct = total_count = n_batches = 0
        saw_correct = False
        weight_total = 0.0
        ap_preds: list = []
        ap_gts: list = []
        for batch in batches:
            m = self.eval_step(self.state["params"], batch)
            weight = (float(m["count"]) if "count" in m
                      else float(batch["image"].shape[0]))
            weight_total += weight
            for k, v in m.items():
                if k == "confusion":
                    c = np.asarray(v.cpu()) if hasattr(v, "cpu") else \
                        np.asarray(v)
                    confusion = c if confusion is None else confusion + c
                elif k == "correct":
                    total_correct += int(v)
                    saw_correct = True
                elif k == "count":
                    total_count += int(v)
                elif k == "outputs":
                    if self.cfg.task == "detect" and "boxes" in batch:
                        from arsvt_tpu_torch.evaluation.detect import (
                            collect_batch_detections,
                        )

                        _, ap_p, g = collect_batch_detections(
                            v, batch, conf_threshold=0.5, nms_threshold=0.5)
                        ap_preds.extend(ap_p)
                        ap_gts.extend(g)
                else:
                    sums[k] = sums.get(k, 0.0) + float(v) * weight
            n_batches += 1
        if n_batches == 0 or weight_total == 0.0:
            return {"loss": float("nan"), "accuracy": 0.0}
        out = {k: v / weight_total for k, v in sums.items()}
        if saw_correct and total_count:
            out["accuracy"] = total_correct / total_count
        if confusion is not None:
            out["confusion"] = confusion.tolist()
        if ap_preds:
            from arsvt_tpu_torch.evaluation.detect import average_precision

            ap = average_precision(ap_preds, ap_gts,
                                   num_classes=self.cfg.num_classes)
            out["mAP"] = ap["mAP"]
            out["AP50"] = ap["AP50"]
            out["AP75"] = ap["AP75"]
        return out
