"""Evaluation CLI (counterpart of ``arsvt_tpu/evaluation/cli.py``):

    python -m arsvt_tpu_torch.evaluation.cli --checkpoint-dir checkpoints \
        --data-dir data --split valid

The model is rebuilt from the config stored in the checkpoint (one of the
port's, ``train/checkpoint.py``) and the params are loaded as serving
loads them (``serving/loading.py``). Classification reports the loss,
top-1 accuracy and the confusion matrix (`Trainer.evaluate`); detection
reports COCO-style mAP, AP50 and AP75 (`evaluate_detector`) and can save
prediction images (`--visualize`). The results go to stdout and to
`--out` with the step and the split. Runs on the card unless
``ARSVT_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="arsvt_tpu_torch evaluator")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--data-dir", default="")
    p.add_argument("--split", default="test")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--conf-threshold", type=float, default=0.5)
    p.add_argument("--nms-threshold", type=float, default=0.5)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--visualize", type=int, default=0,
                   help="save this many prediction visualizations")
    p.add_argument("--out", default="eval_results.json")
    args = p.parse_args(argv)

    from arsvt_tpu_torch.train.checkpoint import latest_step

    step = (args.step if args.step is not None
            else latest_step(args.checkpoint_dir))
    if step is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")

    from arsvt_tpu_torch.core.dtypes import tree_map
    from arsvt_tpu_torch.evaluation.classify import resolve_device
    from arsvt_tpu_torch.serving.loading import load_inference_bundle
    from arsvt_tpu_torch.train.cli import platform_device
    from arsvt_tpu_torch.train.trainer import Trainer

    params, cfg = load_inference_bundle(args.checkpoint_dir, step=step)
    print(f"checkpoint step {step}: preset={cfg.preset} task={cfg.task}",
          file=sys.stderr)
    device = resolve_device(platform_device())
    # one device whatever mesh the config names: the saved params are
    # whole tensors
    trainer = Trainer(cfg.with_overrides(
        checkpoint_dir=args.checkpoint_dir, mesh_data=-1, mesh_model=1,
    ), device=device)
    trainer.state = {"params": tree_map(lambda t: t.to(device), params)}

    data_dir = args.data_dir or cfg.data_dir
    if not data_dir:
        raise SystemExit("--data-dir required (checkpoint has none)")

    from arsvt_tpu_torch.data.pipeline import (
        classification_batches,
        detection_batches,
    )
    from arsvt_tpu_torch.train.config import input_canvas

    if cfg.task == "detect":
        from arsvt_tpu_torch.data.coco import CocoDataset

        ds = CocoDataset(f"{data_dir}/{args.split}")
    else:
        # COCO split dirs or the TrashNet folder-per-class layout
        from arsvt_tpu_torch.data.folder import open_classification_split

        ds = open_classification_split(data_dir, args.split)
    canvas = input_canvas(cfg)

    if cfg.task == "detect":
        from arsvt_tpu_torch.evaluation.detect import evaluate_detector

        if args.visualize:
            _visualize_first_batches(trainer, ds, cfg, args, canvas)
        batches = detection_batches(
            ds, batch_size=args.batch_size, canvas=canvas,
            max_objects=cfg.max_objects, repeat=False, shuffle=False,
            drop_remainder=False,
        )
        results = evaluate_detector(
            trainer.eval_step, trainer.state["params"], batches,
            num_classes=cfg.num_classes,
            conf_threshold=args.conf_threshold,
            nms_threshold=args.nms_threshold,
        )
    else:
        batches = classification_batches(
            ds, batch_size=args.batch_size, canvas=canvas,
            repeat=False, shuffle=False, drop_remainder=False,
        )
        results = trainer.evaluate(batches)

    print(json.dumps(results, indent=1))
    with open(args.out, "w") as f:
        json.dump({"step": int(step), "split": args.split, **results}, f,
                  indent=1)
    return results


def _visualize_first_batches(trainer, ds, cfg, args, canvas):
    """Prediction images of the first batches, two a batch, into
    ``eval_visualizations/``."""
    from arsvt_tpu_torch.data.pipeline import detection_batches
    from arsvt_tpu_torch.evaluation.detect import post_process
    from arsvt_tpu_torch.evaluation.visualize import visualize_batch

    it = detection_batches(
        ds, batch_size=args.batch_size, canvas=canvas,
        max_objects=cfg.max_objects, repeat=False, shuffle=False,
        drop_remainder=False,
    )
    saved = []
    for bi, batch in enumerate(it):
        if len(saved) >= args.visualize:
            it.close()
            break
        out = trainer.eval_step(trainer.state["params"], batch)["outputs"]
        posts = post_process(
            out["class_logits"].float().cpu(),
            out["boxes_cxcywh"].float().cpu(),
            conf_threshold=args.conf_threshold,
            nms_threshold=args.nms_threshold,
        )
        images_f32 = np.asarray(batch["image"], np.float32)
        if batch["image"].dtype == np.uint8:
            images_f32 /= 255.0
        saved += visualize_batch(
            images_f32, {k: v.numpy() for k, v in posts.items()},
            {"boxes": batch["boxes"], "labels": batch["labels"],
             "mask": batch["mask"]},
            out_dir="eval_visualizations", batch_index=bi,
            max_images=min(2, args.visualize - len(saved)),
        )
    print(f"wrote {len(saved)} visualizations to eval_visualizations/",
          file=sys.stderr)


if __name__ == "__main__":
    main()
