"""Host decode and letterbox (copy of the single-image part of
``arsvt_tpu/data/pipeline.py`` and of the PIL path of
``arsvt_tpu/evaluation/classify.py::_load_letterboxed_single``).

Letterboxing = resize the longest side to the canvas, then center
reflect-pad to a square, with the matching normalized-bbox remap.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def _open_upright(path: str):
    """Open + apply EXIF orientation — sorter cameras write rotated
    frames with only the tag to say so."""
    from PIL import ImageOps

    with Image.open(path) as im:
        return ImageOps.exif_transpose(im).convert("RGB")


def load_image_u8(path: str) -> np.ndarray:
    """JPEG/PNG -> uint8 HWC RGB (raw bytes; the device rescales to [0,1])."""
    return np.asarray(_open_upright(path), np.uint8)


def _pad_and_box_transform(image: np.ndarray, canvas: int):
    """Center-pad an (nh, nw, 3) image to the square canvas; returns the
    padded image and the normalized-box remap."""
    nh, nw = image.shape[:2]
    pad_y, pad_x = (canvas - nh) // 2, (canvas - nw) // 2
    out = np.pad(
        image,
        ((pad_y, canvas - nh - pad_y), (pad_x, canvas - nw - pad_x), (0, 0)),
        mode="reflect" if min(nh, nw) > 1 else "edge",
    )

    def box_transform(boxes: np.ndarray) -> np.ndarray:
        if boxes.size == 0:
            return boxes
        px = boxes * np.array([nw, nh, nw, nh], np.float32)
        px += np.array([pad_x, pad_y, pad_x, pad_y], np.float32)
        return px / canvas

    return out, box_transform


def letterbox_u8(image: np.ndarray, canvas: int):
    """uint8 resize-longest-side + center reflect-pad to square.

    Returns (uint8 canvas image, box_transform mapping normalized
    x1y1x2y2 boxes of the original image to the canvas)."""
    h, w = image.shape[:2]
    scale = canvas / max(h, w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    if (nh, nw) != (h, w):
        im = Image.fromarray(image)
        image = np.asarray(im.resize((nw, nh), Image.BILINEAR), np.uint8)
    return _pad_and_box_transform(image, canvas)


def letterbox(image: np.ndarray, canvas: int):
    """fp32 [0,1] variant of `letterbox_u8` (same resize rounding).

    Float input that already matches the canvas size is only padded, never
    quantized through uint8 — off-grid fp32 pixels survive exactly."""
    if (np.issubdtype(image.dtype, np.floating)
            and max(image.shape[:2]) == canvas):
        return _pad_and_box_transform(image.astype(np.float32), canvas)
    u8, box_transform = letterbox_u8(
        np.rint(image * 255).astype(np.uint8)
        if np.issubdtype(image.dtype, np.floating) else image,
        canvas,
    )
    return u8.astype(np.float32) / 255.0, box_transform


def load_letterboxed_single(path: str, size: int) -> np.ndarray:
    """Decode one image (PIL, EXIF-upright) and letterbox it to
    (size, size, 3) raw uint8; the device rescales it."""
    image, _ = letterbox_u8(load_image_u8(path), size)
    return image
