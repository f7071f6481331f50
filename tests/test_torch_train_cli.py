"""The port's training CLI (``python -m arsvt_tpu_torch.train.cli``) on the
CPU: its flags and configs against the JAX package's ``train/cli.py``, a
run that trains, evaluates, checkpoints and resumes under
``ARSVT_PLATFORM=cpu`` (from a temporary working directory: the CLI writes
metrics.jsonl and checkpoints/ there), and what it refuses."""

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from arsvt_tpu.train import cli as jax_cli
from arsvt_tpu_torch.models import registry
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.train import cli

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# a tiny head_dim-64 ViT, so attention dropout runs in the encoder-attention
# kernels' plain versions
PRESET = "vit_port_test_8_32"
SMALL = dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
             num_heads=2, mlp_dim=256)


@pytest.fixture(autouse=True)
def _tiny_preset_cpu_and_tmp_cwd(monkeypatch, tmp_path):
    monkeypatch.setitem(registry.PRESETS, PRESET, BackboneConfig(**SMALL))
    monkeypatch.setenv("ARSVT_PLATFORM", "cpu")
    monkeypatch.delenv("ARSVT_MULTIHOST", raising=False)
    monkeypatch.chdir(tmp_path)


ARGVS = [
    [],
    ["--train-preset", "smoke"],
    ["--train-preset", "vit_base_bf16_flash", "--attn-dropout", "0.1",
     "--augment", "crop_flip", "--fused-adamw", "true", "--steps", "4",
     "--eval-every", "2", "--checkpoint-every", "2"],
    ["--train-preset", "deit_detector_ref", "--schedule", "constant",
     "--bf16", "off", "--learning-rate", "3e-4", "--mesh-data", "1",
     "--checkpoint-dir", "elsewhere", "--grad-accum", "4"],
    ["--attn-dropout", "0", "--ln-eps", "1e-6", "--warp-variant",
     "shear_matmul", "--aux-loss", "no", "--keep-checkpoints", "5"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_from_args_matches_jax(argv):
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    theirs = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_parsers_take_the_same_flags():
    def flags(parser):
        return sorted(s for a in parser._actions for s in a.option_strings)

    assert flags(cli.build_parser()) == flags(jax_cli.build_parser())
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--bf16", "ture"])


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _losses(path):
    return {r["step"]: r["train/loss"] for r in _metrics(path)
            if "train/loss" in r}


ARGS = ["--train-preset", "smoke", "--preset", PRESET, "--batch-size", "4",
        "--attn-dropout", "0.1", "--augment", "crop_flip", "--canvas", "40",
        "--log-every", "1"]


def test_main_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    """4 steps with eval and checkpoints every 2, then --resume to step 6:
    steps 5-6 equal an uninterrupted 6-step run's to the bit (the state
    restores, the step's draws and dropout masks come from the seed and
    the step number, the data stream skips the batches already used)."""
    run = tmp_path / "run"
    run.mkdir()
    monkeypatch.chdir(run)
    last = cli.main(ARGS + ["--steps", "4", "--eval-every", "2",
                            "--checkpoint-every", "2"])
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "step_000000002.pt", "step_000000004.pt"]
    rows = _metrics(run / "metrics.jsonl")
    assert [r["step"] for r in rows if "val/loss" in r] == [2, 4]
    assert all("val/accuracy" in r and "val/confusion" in r
               for r in rows if "val/loss" in r)
    assert set(_losses(run / "metrics.jsonl")) == {1, 2, 3, 4}
    assert last["loss"] == _losses(run / "metrics.jsonl")[4]
    cli.main(ARGS + ["--steps", "6", "--eval-every", "2",
                     "--checkpoint-every", "2", "--resume"])
    resumed = _losses(run / "metrics.jsonl")

    whole = tmp_path / "whole"
    whole.mkdir()
    monkeypatch.chdir(whole)
    cli.main(ARGS + ["--steps", "6", "--eval-every", str(10**9),
                     "--checkpoint-every", str(10**9)])
    ref = _losses(whole / "metrics.jsonl")
    assert not (whole / "checkpoints").exists()
    assert resumed == ref and len(ref) == 6


def test_unknown_preset_raises():
    with pytest.raises(SystemExit, match="unknown --train-preset"):
        cli.main(["--train-preset", "nope"])


def test_data_dir_and_detection_raise(tmp_path):
    """A missing --data-dir raises as JAX's CLI does (no dataset to open);
    detection without one raises JAX's message."""
    missing = str(tmp_path / "nonexistent")
    with pytest.raises(FileNotFoundError):
        cli.main(ARGS + ["--steps", "1", "--data-dir", missing])
    with pytest.raises(FileNotFoundError):
        jax_cli.make_data(jax_cli.config_from_args(
            jax_cli.build_parser().parse_args(["--data-dir", missing])))
    with pytest.raises(SystemExit,
                       match="--data-dir required for detection training"):
        cli.main(["--train-preset", "deit_detector_ref", "--steps", "1"])


def test_multihost_raises(monkeypatch):
    """ARSVT_MULTIHOST without the coordinator variables is refused with
    JAX's SystemExit, never run as independent single processes."""
    monkeypatch.setenv("ARSVT_MULTIHOST", "1")
    for name in ("ARSVT_COORDINATOR_ADDRESS", "ARSVT_NUM_PROCESSES",
                 "ARSVT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit, match="ARSVT_MULTIHOST=1 but"):
        cli.main(ARGS + ["--steps", "1"])


def test_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    """Without ARSVT_PLATFORM the CLI takes the card and raises without
    one; another platform name raises."""
    monkeypatch.delenv("ARSVT_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(ARGS + ["--steps", "1"])
    monkeypatch.setenv("ARSVT_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="ARSVT_PLATFORM"):
        cli.main(ARGS + ["--steps", "1"])


def test_vit_large_recipe_trains_through_the_cli(monkeypatch):
    """``--train-preset vit_large_384`` as it stands (RandAugment, mixup
    0.2, label smoothing 0.1, full remat, bf16), cut to the tiny ViT at a
    batch of 4 on a 40 canvas: the config equals JAX's parse of the same
    flags; 2 steps, an eval at the model's 32 px and a checkpoint."""
    monkeypatch.setitem(registry.PRESETS, "vit_large_16_384",
                        BackboneConfig(**SMALL))
    argv = ["--train-preset", "vit_large_384", "--batch-size", "4",
            "--canvas", "40", "--steps", "2", "--eval-every", "2",
            "--checkpoint-every", "2", "--log-every", "1"]
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    theirs = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.augment, ours.mixup_alpha, ours.label_smoothing,
            ours.remat, ours.remat_policy, ours.bf16) == (
        "randaugment", 0.2, 0.1, True, "full", True)
    last = cli.main(argv)
    rows = _metrics("metrics.jsonl")
    assert set(_losses("metrics.jsonl")) == {1, 2}
    assert all(math.isfinite(v) for v in _losses("metrics.jsonl").values())
    assert [r["step"] for r in rows if "val/loss" in r] == [2]
    assert last["loss"] == _losses("metrics.jsonl")[2]
    assert [p.name for p in Path("checkpoints").iterdir()] == [
        "step_000000002.pt"]
