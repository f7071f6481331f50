"""The port's package surface (ROADMAP Queue A item 13): every name that
an ``arsvt_tpu`` subpackage's ``__init__`` exports imports from the port's
counterpart, or is one of the written absences by design; re-exports are
lazy, so importing a subpackage loads no kernel module."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PACKAGE = REPO / "arsvt_tpu"

# absent by design, with where the port keeps their job
ABSENT = {
    ("core", "KeySeq"): "core/prng.py::Rng (explicit streams, no JAX keys)",
    ("core", "fold_host"): "core/prng.py::Rng.fold_in",
    ("train", "make_optimizer"): "optax's chain: train/optim.py runs it "
                                 "as fused_adamw_update",
    ("ops", "use_pallas"): "no Pallas: each kernel's wrapper takes its "
                           "plain version on a CPU tensor",
}


def _jax_exports(init: Path) -> list[str]:
    """The names an ``arsvt_tpu`` __init__ exports: its from-imports, or
    its lazy `_EXPORTS` keys."""
    tree = ast.parse(init.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_EXPORTS" for t in node.targets):
            names += [k.value for k in node.value.keys]
    return names


SUBPACKAGES = sorted(p.parent.name for p in JAX_PACKAGE.glob("*/__init__.py")
                     if p.parent.name != "pallas")
CASES = [(sub, name) for sub in SUBPACKAGES
         for name in _jax_exports(JAX_PACKAGE / sub / "__init__.py")]


def test_the_walk_covers_every_jax_subpackage():
    assert {"core", "data", "evaluation", "models", "objectives", "ops",
            "parallel", "serving", "train", "utils"} <= set(SUBPACKAGES)
    assert len(CASES) >= 50
    assert set(ABSENT) <= set(CASES)


@pytest.mark.parametrize("sub,name", CASES,
                         ids=[f"{s}.{n}" for s, n in CASES])
def test_each_jax_name_imports_from_the_port(sub, name):
    import importlib

    package = importlib.import_module(f"arsvt_tpu_torch.{sub}")
    if (sub, name) in ABSENT:
        assert not hasattr(package, name), (sub, name)
        return
    assert getattr(package, name) is not None
    assert name in package.__all__ and name in dir(package)


def test_importing_the_subpackages_loads_no_kernel_module():
    probe = (
        "import sys, importlib\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    importlib.import_module('arsvt_tpu_torch.' + sub)\n"
        "heavy = [m for m in sys.modules if m.startswith(("
        "'arsvt_tpu_torch.ops.', 'arsvt_tpu_torch.models.', "
        "'arsvt_tpu_torch.train.'))]\n"
        "print(heavy)\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_taxonomy_and_policies():
    from arsvt_tpu.core import dtypes as jax_dtypes
    from arsvt_tpu.data import taxonomy as jax_taxonomy
    from arsvt_tpu_torch.core import DEFAULT_POLICY, FP32_POLICY
    from arsvt_tpu_torch.data import NUM_CLASSES, class_index

    assert NUM_CLASSES == jax_taxonomy.NUM_CLASSES == 6
    for name in jax_taxonomy.RECYCLING_CLASSES:
        assert class_index(name) == jax_taxonomy.class_index(name)
        assert class_index(name.upper()) == jax_taxonomy.class_index(name)
    for port, jax in ((DEFAULT_POLICY, jax_dtypes.DEFAULT_POLICY),
                      (FP32_POLICY, jax_dtypes.FP32_POLICY)):
        assert str(port.compute_dtype).split(".")[-1] == \
            jax.compute_dtype.__name__
        assert str(port.param_dtype).split(".")[-1] == \
            jax.param_dtype.__name__
