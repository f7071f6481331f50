"""The port's eval CLI (``python -m arsvt_tpu_torch.evaluation.cli``): the
train CLI then the eval CLI on a TrashNet folder tree and on a COCO root,
as ``tests/test_cli.py`` drives JAX's, and parity with JAX's eval CLI on
the same params in both packages' checkpoints, in fp32."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from arsvt_tpu.data import native_loader as jax_native
from arsvt_tpu.evaluation import cli as jax_eval_cli
from arsvt_tpu.models.classifier import init_image_classifier
from arsvt_tpu.models.detector import init_detector
from arsvt_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu.train.config import resolve_backbone as jax_resolve_backbone
from arsvt_tpu.train.config import resolve_detector as jax_resolve_detector
from arsvt_tpu_torch.core.dtypes import to_unit_float
from arsvt_tpu_torch.data import native_loader
from arsvt_tpu_torch.data.augment import eval_preprocess
from arsvt_tpu_torch.data.folder import open_classification_split
from arsvt_tpu_torch.data.pipeline import classification_batches
from arsvt_tpu_torch.data.synthetic import make_synthetic_coco
from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES
from arsvt_tpu_torch.evaluation import cli as eval_cli
from arsvt_tpu_torch.models.bridge import (
    detector_from_jax_params,
    from_jax_params,
)
from arsvt_tpu_torch.models.classifier import apply_image_classifier
from arsvt_tpu_torch.train import cli as train_cli
from arsvt_tpu_torch.train.checkpoint import CheckpointManager
from arsvt_tpu_torch.train.config import (
    TrainConfig,
    resolve_backbone,
    resolve_detector,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

try:
    import matplotlib  # noqa: F401
    HAVE_MATPLOTLIB = True
except ImportError:
    HAVE_MATPLOTLIB = False

# fp32 logits, the port against JAX (tests/test_torch_vit.py)
ATOL_LOGITS_FP32 = 2e-5
# mAP, AP50 and AP75 of the same fp32 detections
ATOL_AP = 1e-4


@pytest.fixture(autouse=True)
def _cpu_and_tmp_cwd(monkeypatch, tmp_path):
    monkeypatch.setenv("ARSVT_PLATFORM", "cpu")
    monkeypatch.delenv("ARSVT_MULTIHOST", raising=False)
    monkeypatch.chdir(tmp_path)


@pytest.fixture
def pil_on_both(monkeypatch):
    """Pin both packages to the PIL decoder, so both evaluate the same
    pixels."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native_loader, "available", lambda: False)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return make_synthetic_coco(
        str(tmp_path_factory.mktemp("evalcoco")), images_per_split=16,
        image_size=32, max_boxes=2)


@pytest.fixture(scope="module")
def trashnet(tmp_path_factory):
    """An unsplit folder-per-class tree of random JPEGs (tests/test_cli.py's
    layout) whose hash split leaves images in valid."""
    root = tmp_path_factory.mktemp("evaltrash") / "trashnet"
    rng = np.random.default_rng(0)
    for cls in RECYCLING_CLASSES:
        d = root / cls
        d.mkdir(parents=True)
        for i in range(8):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)).save(
                str(d / f"{cls}{i}.jpg"), quality=90)
    return str(root)


TRAIN = ["--train-preset", "smoke", "--batch-size", "8", "--log-every", "2",
         "--canvas", "32", "--bf16", "false"]


def test_train_then_eval_cli_detection(coco_root, tmp_path):
    last = train_cli.main(TRAIN + [
        "--preset", "detector_test", "--task", "detect", "--data-dir",
        coco_root, "--total-steps", "3", "--checkpoint-every", "3",
        "--max-objects", "4", "--checkpoint-dir", "ckpt"])
    assert np.isfinite(last["loss"])
    args = ["--checkpoint-dir", "ckpt", "--data-dir", coco_root, "--split",
            "valid", "--batch-size", "8", "--conf-threshold", "0.05",
            "--out", str(tmp_path / "res.json")]
    if HAVE_MATPLOTLIB:
        args += ["--visualize", "2"]
    results = eval_cli.main(args)
    assert {"mAP", "AP50", "AP75", "loss"} <= set(results)
    saved = json.load(open(tmp_path / "res.json"))
    assert saved["split"] == "valid" and saved["step"] == 3
    assert saved["mAP"] == results["mAP"]
    if HAVE_MATPLOTLIB:
        viz = sorted(os.listdir(tmp_path / "eval_visualizations"))
        assert viz == ["eval_batch_0_img_0.png", "eval_batch_0_img_1.png"]


def test_train_then_eval_cli_classification_on_coco(coco_root, tmp_path):
    train_cli.main(TRAIN + [
        "--data-dir", coco_root, "--total-steps", "3",
        "--checkpoint-every", "3", "--image-size", "32", "--augment",
        "crop_flip", "--checkpoint-dir", "ckpt_cls"])
    results = eval_cli.main([
        "--checkpoint-dir", "ckpt_cls", "--data-dir", coco_root, "--split",
        "valid", "--batch-size", "8", "--out", str(tmp_path / "r.json")])
    assert "accuracy" in results and "confusion" in results


def test_train_then_eval_cli_folder_dataset(trashnet, tmp_path):
    """An unsplit TrashNet root drives both CLIs: the train CLI trains on
    the hash split's train side and evaluates on its valid side, the eval
    CLI takes --split valid."""
    last = train_cli.main(TRAIN + [
        "--data-dir", trashnet, "--total-steps", "3", "--checkpoint-every",
        "3", "--eval-every", "3", "--image-size", "32", "--augment",
        "crop_flip", "--checkpoint-dir", "ckpt_folder"])
    assert np.isfinite(last["loss"])
    rows = [json.loads(line) for line in open("metrics.jsonl")]
    val = [r for r in rows if "val/accuracy" in r]
    assert [r["step"] for r in val] == [3]
    n_valid = len(open_classification_split(trashnet, "valid"))
    assert np.asarray(val[0]["val/confusion"]).sum() == n_valid
    results = eval_cli.main([
        "--checkpoint-dir", "ckpt_folder", "--data-dir", trashnet,
        "--split", "valid", "--batch-size", "8",
        "--out", str(tmp_path / "r.json")])
    assert np.asarray(results["confusion"]).sum() == n_valid
    saved = json.load(open(tmp_path / "r.json"))
    assert saved["step"] == 3 and saved["accuracy"] == results["accuracy"]


def test_eval_cli_refusals(tmp_path, trashnet):
    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_cli.main(["--checkpoint-dir", str(tmp_path / "none")])
    train_cli.main(TRAIN + ["--total-steps", "1", "--checkpoint-every", "1",
                            "--checkpoint-dir", "ck"])
    with pytest.raises(SystemExit, match="--data-dir required"):
        eval_cli.main(["--checkpoint-dir", "ck"])


def _random_head(head, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    d = head["kernel"].shape[0]
    return {"kernel": 3 * d ** -0.5 * jax.random.normal(
                keys[0], head["kernel"].shape),
            "bias": 0.1 * jax.random.normal(keys[1], head["bias"].shape)}


def _both_checkpoints(root, cfg, params, port_params):
    jdir, pdir = str(root / "jax"), str(root / "port")
    mgr = JaxCheckpoints(jdir, cfg)
    mgr.save(3, {"params": params})
    mgr.wait()
    mgr.close()
    CheckpointManager(pdir, TrainConfig.from_json(cfg.to_json())).save(
        3, {"params": port_params, "opt_state": {}, "step": 3})
    return jdir, pdir


def test_eval_cli_classification_matches_jax(trashnet, tmp_path,
                                             pil_on_both):
    """The same seeded params in a JAX orbax checkpoint and the port's
    checkpoint, fp32: the same confusion matrix and top-1 from both eval
    CLIs, with every image's top-2 logit margin above the fp32 tolerance
    (so the equality is not a tie broken alike)."""
    cfg = JaxTrainConfig(preset="vit_test_8_32", image_size=32, canvas=40,
                         augment="crop_flip", bf16=False,
                         data_dir=trashnet)
    params = init_image_classifier(jax.random.PRNGKey(3),
                                   jax_resolve_backbone(cfg), 6)
    params["classifier"]["head"] = _random_head(
        params["classifier"]["head"], 4)
    port_cfg = TrainConfig.from_json(cfg.to_json())
    port_params = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                  resolve_backbone(port_cfg))
    jdir, pdir = _both_checkpoints(tmp_path, cfg, params, port_params)
    args = ["--split", "valid", "--batch-size", "4"]
    with jax.default_matmul_precision("highest"):
        ref = jax_eval_cli.main(["--checkpoint-dir", jdir, "--out",
                                 str(tmp_path / "jax.json")] + args)
    got = eval_cli.main(["--checkpoint-dir", pdir, "--out",
                         str(tmp_path / "port.json")] + args)
    assert np.asarray(got["confusion"]).tolist() == np.asarray(
        ref["confusion"]).tolist()
    assert got["accuracy"] == ref["accuracy"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)

    ds = open_classification_split(trashnet, "valid")
    bb = resolve_backbone(port_cfg)
    margins = []
    for b in classification_batches(ds, batch_size=4, canvas=40,
                                    repeat=False, shuffle=False,
                                    drop_remainder=False):
        x = eval_preprocess(to_unit_float(torch.from_numpy(b["image"])),
                            size=bb.image_size)
        logits = apply_image_classifier(port_params, x, bb, 6)
        top = torch.sort(logits, dim=-1).values
        margins += (top[:, -1] - top[:, -2]).tolist()
    assert len(margins) == np.asarray(got["confusion"]).sum() > 0
    assert min(margins) > 2 * ATOL_LOGITS_FP32


def _annotate_with_detections(src, dst, params, det_cfg):
    """A copy of the COCO split `src` whose ground truth is the port's own
    fp32 detections at conf 0.3 (the images are 32 px, the model's size, so
    the letterbox is the identity): a random detector then scores an AP
    well above 0, and the comparison below means something."""
    import shutil

    from arsvt_tpu_torch.evaluation.classify import StreamingDetector

    engine = StreamingDetector(params, det_cfg, compute_dtype=torch.float32,
                               conf_threshold=0.3, device="cpu")
    os.makedirs(dst)
    coco = json.load(open(os.path.join(src, "_annotations.coco.json")))
    anns = []
    for img in coco["images"]:
        path = os.path.join(src, img["file_name"])
        shutil.copy(path, dst)
        det = engine.detect_path(path)
        for box, label in zip(det["boxes"], det["labels"]):
            x1, y1, x2, y2 = (float(v) * 32 for v in box)
            anns.append({"id": len(anns) + 1, "image_id": img["id"],
                         "bbox": [x1, y1, x2 - x1, y2 - y1],
                         "category_id": int(label) + 1,
                         "area": (x2 - x1) * (y2 - y1), "iscrowd": 0})
    coco["annotations"] = anns
    with open(os.path.join(dst, "_annotations.coco.json"), "w") as f:
        json.dump(coco, f)
    return len(anns)


def test_eval_cli_detection_matches_jax(coco_root, tmp_path, pil_on_both):
    """The same seeded detector in both checkpoints, fp32: mAP, AP50 and
    AP75 within 1e-4 from both eval CLIs, on ground truth the detector
    partly finds."""
    cfg = JaxTrainConfig(preset="detector_test", task="detect", canvas=32,
                         augment="detection", bf16=False, max_objects=4)
    params = init_detector(jax.random.PRNGKey(5), jax_resolve_detector(cfg))
    params["detr"]["class_head"] = _random_head(params["detr"]["class_head"],
                                                6)
    port_params = detector_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params),
        resolve_detector(TrainConfig.from_json(cfg.to_json())))
    jdir, pdir = _both_checkpoints(tmp_path, cfg, params, port_params)
    root = tmp_path / "annotated"
    n_gt = _annotate_with_detections(
        os.path.join(coco_root, "valid"), str(root / "valid"), port_params,
        resolve_detector(TrainConfig.from_json(cfg.to_json())))
    assert n_gt > 0
    args = ["--data-dir", str(root), "--split", "valid", "--batch-size", "8",
            "--conf-threshold", "0.3"]
    with jax.default_matmul_precision("highest"):
        ref = jax_eval_cli.main(["--checkpoint-dir", jdir, "--out",
                                 str(tmp_path / "jax.json")] + args)
    got = eval_cli.main(["--checkpoint-dir", pdir, "--out",
                         str(tmp_path / "port.json")] + args)
    for k in ("mAP", "AP50", "AP75"):
        assert abs(got[k] - ref[k]) <= ATOL_AP, (k, got[k], ref[k])
    assert got["AP50"] > 0.5
    assert got["total_predictions"] == ref["total_predictions"] > 0
    assert got["class_prediction_counts"] == ref["class_prediction_counts"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)


def test_visualize_matches_jax(tmp_path):
    """The display image (denormalized or not) equals JAX's; a batch gives
    one PNG per image, predictions beside the ground truth."""
    from arsvt_tpu.evaluation import visualize as jax_visualize
    from arsvt_tpu_torch.evaluation import visualize

    img = np.random.default_rng(0).normal(size=(16, 16, 3)).astype(
        np.float32)
    for denormalize in (False, True):
        np.testing.assert_allclose(
            visualize._to_display(img, denormalize=denormalize),
            np.asarray(jax_visualize._to_display(img,
                                                 denormalize=denormalize)),
            atol=1e-6)
    if not HAVE_MATPLOTLIB:
        return
    posts = {"boxes": np.tile([[[0.1, 0.1, 0.6, 0.7]]], (3, 2, 1)),
             "labels": np.array([[0, 5], [1, 2], [3, 3]]),
             "scores": np.full((3, 2), 0.9),
             "valid": np.array([[True, False], [True, True], [False, False]])}
    targets = {"boxes": posts["boxes"], "labels": posts["labels"],
               "mask": np.ones((3, 2), bool)}
    paths = visualize.visualize_batch(
        np.clip(img, 0, 1)[None].repeat(3, 0), posts, targets,
        out_dir=str(tmp_path / "viz"), batch_index=4, max_images=2)
    assert [os.path.basename(p) for p in paths] == [
        "eval_batch_4_img_0.png", "eval_batch_4_img_1.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
