"""The training loop (counterpart of ``arsvt_tpu/train/trainer.py``):
steps, log cadence, in-training eval with the plateau schedule,
checkpoints, resume and the emergency checkpoint on a crash.

The mesh comes from ``cfg.mesh_data`` / ``mesh_model`` (JAX
``trainer.py:37-48``) over the ranks of the default process group
(``parallel/mesh.py``; one process with no group is the 1x1 mesh, the
one-device step). Each rank feeds its local batch (`global_batch_from_
local`); the ranks meet at a host barrier before the first step and
before each evaluation, and multi-process evaluation stops at the
shortest rank's stream, with a warning, where the streams are not padded
to equal lengths (JAX ``trainer.py:147-156, 225-258``); the detector's
outputs are gathered over the data axis so that every rank computes the
same AP (JAX ``:320-340``). Checkpoints hold the gathered tree, written
by the first rank, and restore on any grid.

Differences from the JAX `Trainer`, by design:
- the device is the card unless the caller asks for the CPU;
- the state is updated in place by the step functions (``train_step.py``),
  and a checkpoint copies it to the host synchronously; under a model
  axis the emergency checkpoint on a crash is skipped (gathering the
  shards needs every rank, and a crash may have stopped only one);
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
import warnings
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from arsvt_tpu_torch.parallel.data_parallel import gather_rows
from arsvt_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from arsvt_tpu_torch.parallel.multihost import (
    global_batch_from_local,
    host_barrier,
    process_count,
)
from arsvt_tpu_torch.parallel.sharding import Replicated, TreeLayout
from arsvt_tpu_torch.train.checkpoint import CheckpointManager
from arsvt_tpu_torch.train.config import TrainConfig
from arsvt_tpu_torch.train.optim import PlateauState, set_lr_scale
from arsvt_tpu_torch.utils.flops import train_gflops_per_image
from arsvt_tpu_torch.utils.logging import MetricLogger, Throughput


class Trainer:
    def __init__(self, cfg: TrainConfig, *, mesh=None,
                 logger: MetricLogger | None = None, step_fns=None,
                 device=None):
        """`mesh`: by default ``make_mesh`` of the config's (data, model)
        on `device` (None: the rank's card). `step_fns`: (init_fn,
        train_step, eval_step), by default those of `cfg.task` on the
        mesh."""
        self.cfg = cfg
        self.mesh = mesh or make_mesh(
            MeshConfig(data=cfg.mesh_data, model=cfg.mesh_model),
            device=device)
        # a 1x1 mesh with no group is the one-device step itself
        parallel = self.mesh.data_group is not None or self.mesh.model > 1
        step_mesh = self.mesh if parallel else None
        from arsvt_tpu_torch.train.train_step import num_heads_for

        self._layout = (TreeLayout(self.mesh, num_heads_for(cfg))
                        if parallel else None)
        if step_fns is None:
            if cfg.task == "detect":
                from arsvt_tpu_torch.train.detect_step import (
                    make_detector_step_fns,
                )

                step_fns = make_detector_step_fns(cfg, self.mesh.device,
                                                  mesh=step_mesh)
            else:
                from arsvt_tpu_torch.train.train_step import (
                    make_classifier_step_fns,
                )

                step_fns = make_classifier_step_fns(cfg, self.mesh.device,
                                                    mesh=step_mesh)
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
                layout=self._layout,
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
            if self.state is not None and self.mesh.model == 1:
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
            # one process: the data axis's slice; several: the local rows
            # each rank was fed (parallel/multihost.py)
            batch = global_batch_from_local(next(train_batches), self.mesh)
            if step == start:
                # the ranks reach their first collective after unequal
                # host work (data, restore, kernel builds): align them
                host_barrier("first_train_step")
            self.state, metrics = self.train_step(self.state, batch)
            meter.add(self._global_rows(batch))

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
        raw `outputs`, post-processed here for val mAP/AP50/AP75.

        Several processes: every rank must run the same number of eval
        steps or a collective step deadlocks. Padded equal-count shards
        (``data/pipeline.py`` pad_to_equal_batches, what the train CLI
        feeds) guarantee that; as a backstop the ranks agree per batch
        whether everyone still has one and stop together at the shortest
        stream, with a warning, never a hang."""
        multi = process_count() > 1
        if multi:
            host_barrier("evaluate")
        sums: dict = {}
        confusion = None
        total_correct = total_count = n_batches = 0
        saw_correct = False
        weight_total = 0.0
        ap_preds: list = []
        ap_gts: list = []
        it = iter(batches)
        while True:
            batch = next(it, None)
            if multi and not self._everyone_has(batch is not None):
                if batch is not None:
                    warnings.warn(
                        "multi-process eval stopped at the shortest rank's "
                        "stream: feed pad_to_equal_batches eval streams to "
                        "cover every record", stacklevel=2)
                break
            if batch is None:
                break
            batch = global_batch_from_local(batch, self.mesh)
            m = self.eval_step(self.state["params"], batch)
            weight = (float(m["count"]) if "count" in m
                      else float(self._global_rows(batch)))
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

                        v, det_batch = self._global_detections(v, batch)
                        _, ap_p, g = collect_batch_detections(
                            v, det_batch, conf_threshold=0.5,
                            nms_threshold=0.5)
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

    # --------------------------------------------------------- the mesh
    def _data_sharded(self, batch) -> bool:
        return self.mesh.data_group is not None and not isinstance(
            batch, Replicated)

    def _global_rows(self, batch) -> int:
        """Rows of the global batch this step ran (a rank holds 1/data)."""
        rows = int(batch["image"].shape[0])
        return rows * self.mesh.data if self._data_sharded(batch) else rows

    def _everyone_has(self, has: bool) -> bool:
        """Whether every process still has an eval batch (one all-gather
        of a flag)."""
        flags = [None] * dist.get_world_size()
        dist.all_gather_object(flags, bool(has))
        return all(flags)

    def _global_detections(self, outputs, batch):
        """Detector outputs and the ground truth of the global batch on
        every rank (gathered over the data axis), so each rank computes
        the same AP; the batch as it is on one rank."""
        if not self._data_sharded(batch):
            return outputs, batch
        group = self.mesh.data_group
        outputs = {k: gather_rows(v, group) for k, v in outputs.items()}
        keys = ("boxes", "labels", "mask", "iscrowd", "valid")
        small = {k: gather_rows(torch.as_tensor(np.asarray(batch[k]))
                                .to(self.mesh.device), group).cpu().numpy()
                 for k in keys if k in batch}
        return outputs, small
