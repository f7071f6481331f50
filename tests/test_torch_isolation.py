"""The port stands alone: importing all of it loads neither JAX nor the
JAX package, and no attention core comes from a library call."""

import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "arsvt_tpu_torch"

MODULES = [
    "arsvt_tpu_torch",
    "arsvt_tpu_torch.core.dtypes",
    "arsvt_tpu_torch.data.taxonomy",
    "arsvt_tpu_torch.data.pipeline",
    "arsvt_tpu_torch.data.augment",
    "arsvt_tpu_torch.ops.patch_embed",
    "arsvt_tpu_torch.ops.layernorm",
    "arsvt_tpu_torch.ops.mlp",
    "arsvt_tpu_torch.ops.attention",
    "arsvt_tpu_torch.ops.encoder_attention",
    "arsvt_tpu_torch.ops.build",
    "arsvt_tpu_torch.models.vit",
    "arsvt_tpu_torch.models.heads",
    "arsvt_tpu_torch.models.classifier",
    "arsvt_tpu_torch.models.registry",
    "arsvt_tpu_torch.models.bridge",
    "arsvt_tpu_torch.utils.latency",
    "arsvt_tpu_torch.evaluation.classify",
    "arsvt_tpu_torch.serving.batching",
    "arsvt_tpu_torch.serving.server",
    "arsvt_tpu_torch.core.prng",
    "arsvt_tpu_torch.ops.fused_adamw",
    "arsvt_tpu_torch.objectives.classification",
    "arsvt_tpu_torch.train.config",
    "arsvt_tpu_torch.train.optim",
    "arsvt_tpu_torch.train.accum",
    "arsvt_tpu_torch.train.train_step",
    "arsvt_tpu_torch.ops.flash_attention",
    "arsvt_tpu_torch.models.detector",
    "arsvt_tpu_torch.objectives.boxes",
    "arsvt_tpu_torch.evaluation.detect",
    "arsvt_tpu_torch.data.folder",
    "arsvt_tpu_torch.data.coco",
    "arsvt_tpu_torch.data.native_loader",
    "arsvt_tpu_torch.serving.loading",
    "arsvt_tpu_torch.evaluation.visualize",
    "arsvt_tpu_torch.evaluation.cli",
    "arsvt_tpu_torch.core.devices",
    "arsvt_tpu_torch.ops.quant",
    "arsvt_tpu_torch.ops.library",
    "arsvt_tpu_torch.models.quantized",
    "arsvt_tpu_torch.serving.export",
    "arsvt_tpu_torch.serving.artifact",
    "arsvt_tpu_torch.models.convert",
    "arsvt_tpu_torch.utils.flops",
    "arsvt_tpu_torch.utils.profiling",
    "arsvt_tpu_torch.parallel",
    "arsvt_tpu_torch.parallel.mesh",
    "arsvt_tpu_torch.parallel.sharding",
    "arsvt_tpu_torch.parallel.multihost",
    "arsvt_tpu_torch.parallel.dryrun",
    "arsvt_tpu_torch.parallel.tensor_parallel",
    "arsvt_tpu_torch.parallel.data_parallel",
]

_PROBE = """
import importlib, json, pkgutil, sys
import arsvt_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    arsvt_tpu_torch.__path__, "arsvt_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "arsvt_tpu", "optax")
             or k.startswith(("jax.", "jaxlib.", "arsvt_tpu.", "optax.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert set(MODULES[1:]) <= set(out["modules"])


def test_no_library_attention_and_no_jax_imports_in_the_package():
    files = sorted(PACKAGE.rglob("*.py")) + sorted(PACKAGE.rglob("*.cu"))
    assert len(files) >= len(MODULES)
    importing = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|arsvt_tpu|optax)(\.|\s|$)",
        re.M)
    for path in files:
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path
        assert "torch.optim" not in text, path
        assert not importing.search(text), path


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['chip_smoke.py']; import chip_smoke; "
         "sys.exit(chip_smoke.main())"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
