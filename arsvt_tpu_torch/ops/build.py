"""Build the port's CUDA sources (``arsvt_tpu_torch/csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ctypes. The library is written under
``build/arsvt_tpu_torch/`` at the root of the checkout, named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is not. `build_all` starts one ``nvcc`` per source, all at once.
Nothing here runs at import: the CPU tests import every module and have no
compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arsvt_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills into the build log
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> Path:
    path = CSRC_DIR / f"{name}.cu"
    if not path.is_file():
        raise FileNotFoundError(f"no CUDA source {path}")
    return path


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """Named by a hash of the source, the shared headers beside it and the
    flags."""
    digest = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


def nvcc_command(source: Path, output: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build_all(names: list[str] | None = None) -> dict[str, dict]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together. Returns {name: {"seconds", "log"}} for the
    sources it compiled; raises with the compiler's output on a failure."""
    names = kernel_names() if names is None else names
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        final = library_path(name)
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, final, subprocess.Popen(
            nvcc_command(source_path(name), tmp, nvcc),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    results, failures = {}, []
    for name, (tmp, final, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, final)  # atomic: a concurrent loader sees all or none
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The shared library of source `name`, built first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
