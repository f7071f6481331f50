"""The port's ``utils/flops.py`` and ``utils/profiling.py`` against the
JAX package's ``arsvt_tpu/utils/flops.py`` and ``profiling.py``.

The FLOP counts are the same Python arithmetic on the same config fields,
so they must be equal exactly, on every preset; the profiling helpers are
held to JAX's behaviour on the CPU (the card's side of `trace` and
`StepTimer`, CUDA activity and the synchronize, runs in ``chip_smoke.py``
phase 15)."""

import json
import os

import numpy as np
import pytest
import torch

from arsvt_tpu.models.registry import DETECTOR_PRESETS as JAX_DETECTORS
from arsvt_tpu.models.registry import PRESETS as JAX_PRESETS
from arsvt_tpu.train.config import TRAIN_PRESETS as JAX_TRAIN_PRESETS
from arsvt_tpu.utils import flops as jax_flops
from arsvt_tpu_torch.models.registry import DETECTOR_PRESETS, PRESETS
from arsvt_tpu_torch.train.config import TRAIN_PRESETS, TrainConfig
from arsvt_tpu_torch.utils import flops
from arsvt_tpu_torch.utils.profiling import (
    StepTimer,
    assert_all_finite,
    enable_nan_checks,
    trace,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

REMATS = [(False, "full"), (True, "full"), (True, "dots"), (True, "names"),
          (True, "all_but_mlp"), (True, "mlp_tail")]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_backbone_fwd_gflops_equals_jax(name):
    assert flops.backbone_fwd_gflops(PRESETS[name]) == \
        jax_flops.backbone_fwd_gflops(JAX_PRESETS[name])


@pytest.mark.parametrize("name", sorted(DETECTOR_PRESETS))
def test_detector_gflops_equal_jax(name):
    det, jdet = DETECTOR_PRESETS[name], JAX_DETECTORS[name]
    assert flops.detr_head_fwd_gflops(
        det.head, det.backbone.embed_dim, det.backbone.num_patches) == \
        jax_flops.detr_head_fwd_gflops(
            jdet.head, jdet.backbone.embed_dim, jdet.backbone.num_patches)
    assert flops.backbone_fwd_gflops(det.backbone) == \
        jax_flops.backbone_fwd_gflops(jdet.backbone)


@pytest.mark.parametrize("name", sorted(TRAIN_PRESETS))
@pytest.mark.parametrize("remat,policy", REMATS)
def test_train_gflops_per_image_equals_jax(name, remat, policy):
    """Every train preset (classify and detect) under every remat policy,
    and the same preset as a distilled student (the teacher is not
    counted, in either package)."""
    over = dict(remat=remat, remat_policy=policy)
    got = flops.train_gflops_per_image(TRAIN_PRESETS[name].with_overrides(
        **over))
    ref = jax_flops.train_gflops_per_image(
        JAX_TRAIN_PRESETS[name].with_overrides(**over))
    assert got == ref > 0
    distilled = TrainConfig(preset="deit_ref_400_16_224",
                            distillation="soft", distill_teacher="t", **over)
    assert flops.train_gflops_per_image(distilled) == \
        jax_flops.train_gflops_per_image(
            JAX_TRAIN_PRESETS["smoke"].with_overrides(
                preset="deit_ref_400_16_224", distillation="soft",
                distill_teacher="t", **over))


def test_train_flops_multiplier_table():
    assert flops.train_flops_multiplier(False) == 3.0
    assert flops.train_flops_multiplier(True, "full") == 4.0
    assert flops.train_flops_multiplier(True, "dots") == 4.0
    assert flops.train_flops_multiplier(True, "names") == 4.0
    assert flops.train_flops_multiplier(True, "all_but_mlp") == 3.3
    assert flops.train_flops_multiplier(True, "mlp_tail") == 3.05
    for remat, policy in REMATS:
        assert flops.train_flops_multiplier(remat, policy) == \
            jax_flops.train_flops_multiplier(remat, policy)


def test_pinned_forward_counts():
    """ViT-B/16@224: JAX's pinned 35.13 GFLOP (its count matched
    torch.profiler to 0.1%); ViT-L/16@384: the 382.1 GFLOP phase 14 of
    chip_smoke.py reports; the distillation teacher ViT-B beside the
    DeiT-400 student."""
    vit_b = flops.backbone_fwd_gflops(PRESETS["vit_base_16_224"])
    assert abs(vit_b - 35.13) / 35.13 < 0.005
    assert round(flops.backbone_fwd_gflops(PRESETS["vit_large_16_384"]),
                 1) == 382.1
    assert 9.0 < flops.backbone_fwd_gflops(
        PRESETS["deit_ref_400_16_224"]) < 11.0


def test_step_timer_summary():
    t = StepTimer(warmup=1)
    for _ in range(4):
        with t:
            np.dot(np.ones((50, 50)), np.ones((50, 50)))
    s = t.summary()
    assert s["steps"] == 3  # the warm-up step is excluded
    assert s["mean_ms"] >= 0.0 and s["p99_ms"] >= s["p50_ms"]
    assert StepTimer().summary() == {}


def test_step_timer_skips_raising_steps():
    t = StepTimer(warmup=0)
    with t:
        pass
    with pytest.raises(RuntimeError):
        with t:
            raise RuntimeError("boom")
    assert t.summary()["steps"] == 1  # the aborted step is not recorded


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_assert_all_finite_names_the_leaves(dtype):
    """A NaN or an Inf in any float dtype (bf16 included) raises
    FloatingPointError naming its path through dicts and lists; integer
    leaves, numpy arrays and Python numbers pass."""
    good = {"a": torch.ones(2, 2, dtype=dtype),
            "b": [{"c": torch.zeros(3, dtype=dtype)}],
            "n": torch.arange(3), "np": np.ones(2), "step": 4}
    assert_all_finite(good, "good")
    bad = {"a": torch.ones(2, 2, dtype=dtype),
           "b": [{"c": torch.tensor([1.0, float("nan"), 2.0], dtype=dtype)}],
           "d": torch.tensor([float("inf")], dtype=dtype),
           "np": np.array([np.nan])}
    with pytest.raises(FloatingPointError, match="state") as err:
        assert_all_finite(bad, "state")
    assert "b/0/c" in str(err.value) and "'d'" in str(err.value)
    assert "'np'" in str(err.value) and "'a'" not in str(err.value)


def test_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace records the host's ops, written as a Chrome
    trace under the log directory."""
    logdir = str(tmp_path / "trace")
    with trace(logdir) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(path) == logdir and os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_enable_nan_checks_turns_on_anomaly_detection():
    """Autograd's anomaly detection, the port's counterpart of
    jax_debug_nans: a NaN made in a backward raises."""
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0 - 1).sum().backward()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
