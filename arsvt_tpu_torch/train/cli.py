"""Training CLI (counterpart of ``arsvt_tpu/train/cli.py``):

    python -m arsvt_tpu_torch.train.cli --train-preset smoke --steps 20

Every `TrainConfig` field is a flag; `--train-preset` starts from a named
preset, `--steps` sets total_steps and `--resume` restores the latest
checkpoint in `--checkpoint-dir` (default ``checkpoints``, relative to the
working directory, as is the ``metrics.jsonl`` it appends to). Runs on the
card; ``ARSVT_PLATFORM=cpu`` selects the CPU. Data comes from
`--data-dir` (a COCO root with train/ and valid/ splits, or a TrashNet
folder-per-class tree, split or unsplit) through ``data/pipeline.py``, or
without one from the synthetic classification set; detection needs a
`--data-dir`.

Multi-process (JAX ``train/cli.py:85-99, 148, 191-205``): with
``ARSVT_MULTIHOST=1``, every process runs the same command line with
``ARSVT_COORDINATOR_ADDRESS`` (host:port of rank 0),
``ARSVT_NUM_PROCESSES`` and its own ``ARSVT_PROCESS_ID``, one a card
(NCCL; gloo under ``ARSVT_PLATFORM=cpu``); ``--mesh-data`` /
``--mesh-model`` lay the ranks out. Each data rank reads its own shard of
the data at ``batch_size // data`` rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys

from arsvt_tpu_torch.core.devices import platform_device
from arsvt_tpu_torch.train.config import TRAIN_PRESETS, TrainConfig


def _parse_bool(s: str) -> bool:
    v = s.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    # anything else must fail, not silently become False
    raise argparse.ArgumentTypeError(f"expected true/false, got {s!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="arsvt_tpu_torch trainer")
    p.add_argument("--train-preset", default=None,
                   help=f"one of {sorted(TRAIN_PRESETS)}")
    p.add_argument("--resume", action="store_true",
                   help="resume from latest checkpoint in checkpoint_dir")
    p.add_argument("--steps", type=int, default=None,
                   help="override total_steps")
    for f in dataclasses.fields(TrainConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(flag, type=_parse_bool, default=None)
        elif isinstance(f.default, int):
            p.add_argument(flag, type=int, default=None)
        elif isinstance(f.default, float) or "float" in str(f.type):
            p.add_argument(flag, type=float, default=None)
        else:
            p.add_argument(flag, type=str, default=None)
    return p


def config_from_args(args) -> TrainConfig:
    if args.train_preset:
        if args.train_preset not in TRAIN_PRESETS:
            raise SystemExit(
                f"unknown --train-preset {args.train_preset!r}; "
                f"one of {sorted(TRAIN_PRESETS)}"
            )
        cfg = TRAIN_PRESETS[args.train_preset]
    else:
        cfg = TrainConfig()
    overrides = {}
    for f in dataclasses.fields(TrainConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    if args.steps is not None:
        overrides["total_steps"] = args.steps
    return cfg.with_overrides(**overrides)


def make_data(cfg: TrainConfig, *, skip_batches: int = 0, mesh=None):
    """Returns (train_batches, eval_batches_fn): the whole batch in one
    process, this data rank's shard of `mesh` in several.

    `skip_batches`: fast-forward the train stream past the batches an
    interrupted run already consumed (one a step), so a resumed run sees
    the data an uninterrupted one would (skipping is index-level: nothing
    is decoded)."""
    from arsvt_tpu_torch.parallel.multihost import (
        data_shard,
        local_batch,
        process_count,
    )
    from arsvt_tpu_torch.train.config import input_canvas

    pidx, pcount = (data_shard(mesh) if mesh is not None
                    and process_count() > 1 else (0, 1))
    try:
        local_bs = (local_batch(cfg.batch_size, mesh) if pcount > 1
                    else cfg.batch_size)
    except ValueError as e:
        raise SystemExit(str(e))
    if not cfg.data_dir:
        if cfg.task == "detect":
            raise SystemExit("--data-dir required for detection training")
        from arsvt_tpu_torch.data.synthetic import (
            synthetic_classification_batches,
        )

        size = input_canvas(cfg)
        train = synthetic_classification_batches(
            batch_size=local_bs, image_size=size, seed=cfg.seed + pidx)
        if skip_batches:
            # synthetic draws are cheap; replaying the stream keeps the
            # resumed data order identical to the uninterrupted run
            train = itertools.islice(train, skip_batches, None)

        def eval_batches():
            return itertools.islice(
                synthetic_classification_batches(
                    batch_size=local_bs, image_size=size, seed=9999 + pidx),
                8,
            )

        return train, eval_batches

    from arsvt_tpu_torch.data.pipeline import (
        classification_batches,
        detection_batches,
    )

    if cfg.task == "detect":
        from arsvt_tpu_torch.data.coco import CocoDataset

        train_ds = CocoDataset(f"{cfg.data_dir}/train")
        val_ds = CocoDataset(f"{cfg.data_dir}/valid")
    else:
        # COCO splits or the TrashNet folder-per-class layout (unsplit
        # trees split by a stable per-file hash)
        from arsvt_tpu_torch.data.folder import open_classification_split

        train_ds = open_classification_split(cfg.data_dir, "train")
        val_ds = open_classification_split(cfg.data_dir, "valid")
    if train_ds.num_classes > cfg.num_classes:
        raise SystemExit(
            f"dataset has {train_ds.num_classes} classes "
            f"({train_ds.class_names}) but num_classes={cfg.num_classes}; "
            f"pass --num-classes {train_ds.num_classes} (labels beyond "
            f"num_classes would silently contribute zero CE gradient)"
        )
    canvas = input_canvas(cfg)
    host_shard = dict(process_index=pidx, process_count=pcount)
    if cfg.task == "detect":
        train = detection_batches(
            train_ds, batch_size=local_bs, canvas=canvas,
            max_objects=cfg.max_objects, seed=cfg.seed,
            skip_batches=skip_batches, **host_shard,
        )

        def eval_batches():
            # padded to whole batches: the eval shape is fixed and the pad
            # rows carry valid=0, so they drop out of every metric
            return detection_batches(
                val_ds, batch_size=local_bs, canvas=canvas,
                max_objects=cfg.max_objects, seed=1, repeat=False,
                shuffle=False, drop_remainder=False,
                pad_to_equal_batches=True, **host_shard,
            )
    else:
        train = classification_batches(
            train_ds, batch_size=local_bs, canvas=canvas,
            seed=cfg.seed, skip_batches=skip_batches, **host_shard,
        )

        def eval_batches():
            return classification_batches(
                val_ds, batch_size=local_bs, canvas=canvas,
                seed=1, repeat=False, shuffle=False, drop_remainder=False,
                pad_to_equal_batches=True, **host_shard,
            )

    return train, eval_batches


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    # every process runs this command line with ARSVT_MULTIHOST=1 and the
    # three coordinator variables (parallel/multihost.py)
    multi = bool(os.environ.get("ARSVT_MULTIHOST"))
    if multi:
        from arsvt_tpu_torch.parallel.multihost import (
            initialize_multihost,
            process_count,
            process_index,
        )

        if not initialize_multihost():
            # never degrade silently to N independent trainings writing
            # the same checkpoint_dir: the operator asked for several
            raise SystemExit(
                "ARSVT_MULTIHOST=1 but torch.distributed failed to "
                "initialize (no ARSVT_COORDINATOR_ADDRESS / "
                "ARSVT_NUM_PROCESSES / ARSVT_PROCESS_ID, or a "
                "single-process group). Unset ARSVT_MULTIHOST for "
                "single-process runs.")
        print(f"multihost: process {process_index()}/{process_count()}",
              file=sys.stderr)

    from arsvt_tpu_torch.train.trainer import Trainer
    from arsvt_tpu_torch.utils.logging import MetricLogger

    # one metrics.jsonl: the first rank's (every rank logs the same
    # global metrics)
    rank0 = not multi or process_index() == 0
    logger = MetricLogger(out_dir="." if rank0 else None, quiet=not rank0)
    try:
        trainer = Trainer(cfg, logger=logger,
                          device=None if multi else platform_device())
        start = 0
        if args.resume:
            start = trainer.maybe_resume()
            print(f"resumed at step {start}", file=sys.stderr)
        train_batches, eval_batches_fn = make_data(
            cfg, skip_batches=start, mesh=trainer.mesh)
        last = trainer.fit(train_batches, eval_batches_fn=eval_batches_fn)
    finally:
        logger.close()
    print(f"done: {last}", file=sys.stderr)
    return last


if __name__ == "__main__":
    main()
