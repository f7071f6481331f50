"""Training CLI (counterpart of ``arsvt_tpu/train/cli.py``):

    python -m arsvt_tpu_torch.train.cli --train-preset smoke --steps 20

Every `TrainConfig` field is a flag; `--train-preset` starts from a named
preset, `--steps` sets total_steps and `--resume` restores the latest
checkpoint in `--checkpoint-dir` (default ``checkpoints``, relative to the
working directory, as is the ``metrics.jsonl`` it appends to). Runs on the
card; ``ARSVT_PLATFORM=cpu`` selects the CPU. Data is the synthetic
classification set; a `--data-dir`, detection (which needs one) and
``ARSVT_MULTIHOST`` raise (ROADMAP Queue A items 4 and 11).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys

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


def make_data(cfg: TrainConfig, *, skip_batches: int = 0):
    """Returns (train_batches, eval_batches_fn) from the synthetic set.

    `skip_batches`: fast-forward the train stream past the batches an
    interrupted run already consumed (one a step), so a resumed run sees
    the data an uninterrupted one would."""
    from arsvt_tpu_torch.data.synthetic import (
        synthetic_classification_batches,
    )
    from arsvt_tpu_torch.train.config import input_canvas

    if cfg.data_dir:
        raise NotImplementedError(
            f"--data-dir {cfg.data_dir!r}: the port has no COCO or folder "
            "loader yet (ROADMAP Queue A item 4, host data)")
    if cfg.task == "detect":
        raise SystemExit("--data-dir required for detection training, and "
                         "the port has no COCO loader yet (ROADMAP Queue A "
                         "item 4, host data)")
    size = input_canvas(cfg)
    train = synthetic_classification_batches(
        batch_size=cfg.batch_size, image_size=size, seed=cfg.seed)
    if skip_batches:
        train = itertools.islice(train, skip_batches, None)

    def eval_batches():
        return itertools.islice(
            synthetic_classification_batches(
                batch_size=cfg.batch_size, image_size=size, seed=9999),
            8,
        )

    return train, eval_batches


def _device() -> str:
    """``ARSVT_PLATFORM``: unset (the card) or "cpu"."""
    platform = os.environ.get("ARSVT_PLATFORM", "")
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"ARSVT_PLATFORM={platform!r}: the port runs on 'cpu' "
                     "or the card")


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if os.environ.get("ARSVT_MULTIHOST"):
        raise NotImplementedError(
            "ARSVT_MULTIHOST: the port trains on one device (ROADMAP Queue "
            "A item 11, parallel); unset it for a single-device run")

    from arsvt_tpu_torch.train.trainer import Trainer
    from arsvt_tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(out_dir=".")
    try:
        trainer = Trainer(cfg, logger=logger, device=_device())
        start = 0
        if args.resume:
            start = trainer.maybe_resume()
            print(f"resumed at step {start}", file=sys.stderr)
        train_batches, eval_batches_fn = make_data(cfg, skip_batches=start)
        last = trainer.fit(train_batches, eval_batches_fn=eval_batches_fn)
    finally:
        logger.close()
    print(f"done: {last}", file=sys.stderr)
    return last


if __name__ == "__main__":
    main()
