"""ctypes binding for the C++ decode + letterbox core,
``native/arsvt_loader.cpp`` (counterpart of
``arsvt_tpu/data/native_loader.py``).

The core decodes JPEG/PNG with libjpeg/libpng on a thread pool, applies
the EXIF orientation and letterboxes straight into one contiguous
(B, canvas, canvas, 3) buffer.

The port compiles that source itself, at first use, with the flags of
``native/Makefile`` into ``build/arsvt_tpu_torch/`` at the root of the
checkout, named by a hash of the source, the flags and the host CPU's
``-march=native`` expansion (a library built on one host is never loaded
on another). It reads nothing in ``native/`` but the source and writes
nothing there. Where the build fails (no compiler, no libjpeg/libpng
headers), `available()` is False and `route()` is ``"pil"``: the pipeline
decodes with PIL, as the JAX package does without its library;
`build_error()` holds the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "arsvt_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arsvt_tpu_torch"
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LIBS = ("-ljpeg", "-lpng")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def _compiler() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def library_path(cxx: str) -> Path:
    """Named by a hash of the source, the flags, the compiler and what
    ``-march=native`` means on this host."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=60)
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((cxx,) + CXX_FLAGS + LIBS).encode())
    digest.update(target.stdout.encode())
    return BUILD_DIR / f"libarsvt_loader-{digest.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on the PATH")
    path = library_path(cxx)
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} exit {proc.returncode}\n"
                               f"{proc.stderr.strip()}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(path))
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    paths_t = ctypes.POINTER(ctypes.c_char_p)
    c_int = ctypes.c_int
    for name, args in (
            ("arsvt_load_batch", [paths_t, c_int, c_int, c_int, f32p, f32p]),
            ("arsvt_load_batch_u8", [paths_t, c_int, c_int, c_int, u8p,
                                     f32p]),
            ("arsvt_load_batch_ex", [paths_t, c_int, c_int, c_int, c_int,
                                     f32p, f32p]),
            ("arsvt_load_batch_u8_ex", [paths_t, c_int, c_int, c_int, c_int,
                                        u8p, f32p]),
            ("arsvt_probe_image", [ctypes.c_char_p, ctypes.POINTER(c_int),
                                   ctypes.POINTER(c_int)]),
            ("arsvt_decode_raw", [ctypes.c_char_p, u8p, ctypes.c_longlong]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = c_int
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _build()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = str(e)
        return _lib


def available() -> bool:
    return _load() is not None


def route() -> str:
    """The host decoder in use: ``"native"`` or ``"pil"``."""
    return "native" if available() else "pil"


def build_error() -> str | None:
    """The build's error output when `route()` is ``"pil"``, else None."""
    _load()
    return _error


def load_letterboxed_batch(paths: list[str], canvas: int,
                           *, threads: int | None = None,
                           dtype=np.float32, strict: bool = True,
                           scaled_decode: bool | None = None):
    """Decode + letterbox a batch natively.

    Returns (images (B, canvas, canvas, 3), meta fp32). Meta rows are
    [scale, pad_x, pad_y, ok], plus [dec_w, dec_h] (the post-EXIF dims the
    letterbox consumed) when `scaled_decode` is on. `dtype=np.uint8` emits
    raw 0..255 bytes (the device rescales), `np.float32` [0, 1]. Raises
    RuntimeError if the library is unavailable.

    `scaled_decode` (None = honour ``ARSVT_SCALED_DECODE``): JPEGs decode
    at the smallest libjpeg M/8 DCT scale whose longest side is still >=
    canvas; box transforms consume the decoded dims from meta.

    `strict=True` raises ValueError when any image fails to decode, as the
    PIL route does; the core zero-fills failed slots and flags meta ok=0,
    which `strict=False` returns instead.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    if scaled_decode is None:
        scaled_decode = bool(os.environ.get("ARSVT_SCALED_DECODE"))
    n = len(paths)
    if threads is None:
        threads = min(max(os.cpu_count() or 1, 1), 16)
    meta = np.empty((n, 6 if scaled_decode else 4), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    mp = meta.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if np.dtype(dtype) == np.uint8:
        images = np.empty((n, canvas, canvas, 3), np.uint8)
        ip = images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if scaled_decode:
            lib.arsvt_load_batch_u8_ex(arr, n, canvas, threads, 1, ip, mp)
        else:
            lib.arsvt_load_batch_u8(arr, n, canvas, threads, ip, mp)
    else:
        images = np.empty((n, canvas, canvas, 3), np.float32)
        ip = images.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if scaled_decode:
            lib.arsvt_load_batch_ex(arr, n, canvas, threads, 1, ip, mp)
        else:
            lib.arsvt_load_batch(arr, n, canvas, threads, ip, mp)
    if strict:
        failed = np.where(meta[:, 3] == 0.0)[0]
        if failed.size:
            sample = [paths[i] for i in failed[:5]]
            raise ValueError(
                f"{failed.size} image(s) failed to decode, e.g. {sample}"
            )
    return images, meta


def decode_image(path: str) -> np.ndarray:
    """One image -> upright uint8 HWC RGB through the native core (EXIF
    orientation applied in C++)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    w = ctypes.c_int()
    h = ctypes.c_int()
    encoded = path.encode()
    if lib.arsvt_probe_image(encoded, ctypes.byref(w),
                             ctypes.byref(h)) != 0:
        raise ValueError(f"undecodable image: {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.arsvt_decode_raw(
        encoded, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
    )
    if rc != 0:
        raise ValueError(f"decode failed ({rc}): {path}")
    return out


def _native_resized_dims(orig_w: int, orig_h: int, canvas: int):
    """The exact resized dims the C++ core produces (``letterbox_into``):
    an integer box-reduce by k first for >= 2x downscales, then a float32
    scale and lround. Python's round() on the original dims would differ
    by 1 px on odd-width >= 2x downscales."""
    if max(orig_w, orig_h) <= 0:
        return 1, 1
    s0 = np.float32(canvas) / np.float32(max(orig_w, orig_h))
    # the reciprocal in fp32 like the C++ (1.0f / s0): at exact >= 3x
    # integer ratios fp32 rounds 1/s0 up to the integer where fp64 stays
    # just below it
    k = max(1, int(np.float32(1.0) / np.maximum(s0, np.float32(1e-6))))
    w, h = orig_w, orig_h
    if k >= 2:
        w, h = max(1, orig_w // k), max(1, orig_h // k)
    scale = np.float32(canvas) / np.float32(max(w, h))
    # lround = round half away from zero (positive: floor(x + 0.5))
    nw = max(1, int(np.floor(np.float32(w) * scale + np.float32(0.5))))
    nh = max(1, int(np.floor(np.float32(h) * scale + np.float32(0.5))))
    return nw, nh


def box_transform_from_meta(meta_row, canvas: int):
    """Box transform matching the native letterbox's geometry (each
    route's boxes align with its own pixels; the PIL route's resize may
    differ by 1 px). 6-wide meta rows carry the decoded dims, which the
    transform replays the resize on."""
    pad_x, pad_y = float(meta_row[1]), float(meta_row[2])
    dec_w = dec_h = 0
    if len(meta_row) >= 6:
        dec_w, dec_h = int(meta_row[4]), int(meta_row[5])

    def transform(boxes: np.ndarray, orig_w: int, orig_h: int) -> np.ndarray:
        if boxes.size == 0:
            return boxes
        if dec_w > 0 and dec_h > 0:
            nw, nh = _native_resized_dims(dec_w, dec_h, canvas)
        else:
            nw, nh = _native_resized_dims(orig_w, orig_h, canvas)
        px = boxes * np.array([nw, nh, nw, nh], np.float32)
        px += np.array([pad_x, pad_y, pad_x, pad_y], np.float32)
        return px / canvas

    return transform
