"""Host input pipeline: decode → letterbox → batch → prefetch (copy of
``arsvt_tpu/data/pipeline.py``).

The host only decodes JPEGs and letterboxes them to a fixed canvas;
everything per-pixel and random (augmentation, normalization) runs on the
device inside the train step (`data/augment.py`), and a background thread
(`Prefetcher`) overlaps the host's work with the device's.

Letterboxing = resize the longest side to the canvas, then center
reflect-pad to a square, with the matching normalized-bbox remap. Decode
takes the C++ core (`data/native_loader.py`) where it is built and PIL
otherwise. The shuffle is ``np.random.default_rng(seed)``, as in JAX, so
a dataset and a seed give JAX's batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
from PIL import Image

from arsvt_tpu_torch.data import native_loader
from arsvt_tpu_torch.data.coco import CocoDataset


def _open_upright(path: str):
    """Open + apply EXIF orientation — sorter cameras write rotated
    frames with only the tag to say so."""
    from PIL import ImageOps

    with Image.open(path) as im:
        return ImageOps.exif_transpose(im).convert("RGB")


def load_image(path: str) -> np.ndarray:
    """JPEG/PNG -> float32 HWC RGB in [0,1]."""
    return np.asarray(_open_upright(path), np.float32) / 255.0


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
    """Decode one image (EXIF-upright) and letterbox it to (size, size, 3)
    raw uint8 — the C++ core where it is built, PIL otherwise, as JAX's
    ``evaluation/classify.py::_load_letterboxed_single``. The device
    rescales it."""
    if native_loader.available():
        images, meta = native_loader.load_letterboxed_batch(
            [path], size, dtype=np.uint8, strict=False)
        if meta[0, 3] == 0.0:
            raise ValueError(f"undecodable image: {path}")
        return images[0]
    image, _ = letterbox_u8(load_image_u8(path), size)
    return image


def load_letterboxed(paths, canvas: int, records=None, dtype=np.uint8):
    """Batch decode + letterbox: the C++ core where it is built, PIL
    otherwise (`native_loader.route()`).

    Returns (images (B,canvas,canvas,3) in `dtype`, transforms: list of
    boxes->boxes callables in normalized coords). The default uint8 ships
    4x fewer bytes to the device than fp32; the steps rescale to [0,1] on
    the device (`core.dtypes.to_unit_float`).
    """
    if native_loader.available():
        images, meta = native_loader.load_letterboxed_batch(
            paths, canvas, dtype=dtype
        )
        transforms = []
        for i, p in enumerate(paths):
            if records is not None:
                w, h = records[i].width, records[i].height
            else:
                w = h = canvas  # unused when no boxes follow
            tf = native_loader.box_transform_from_meta(meta[i], canvas)
            transforms.append(
                lambda boxes, tf=tf, w=w, h=h: tf(boxes, w, h)
            )
        return images, transforms
    images, transforms = [], []
    u8 = np.dtype(dtype) == np.uint8
    for p in paths:
        # decode is 8-bit either way (JPEG/PNG); letterbox in uint8 and
        # rescale once at the end for float callers — no fp32 decode pass,
        # no quantization round-trip
        img, tf = letterbox_u8(load_image_u8(p), canvas)
        if not u8:
            img = img.astype(np.float32) / 255.0
        images.append(img)
        transforms.append(tf)
    return np.stack(images), transforms


class Prefetcher:
    """Background-thread prefetch with a bounded queue (host↔device overlap).

    Stoppable: `close()` (also wired to GC) makes the worker exit instead of
    blocking forever in `put` — abandoned infinite iterators otherwise leave
    daemon threads decoding for the rest of the process.
    """

    def __init__(self, it: Iterator, depth: int = 2):
        # the worker closure must capture only these LOCALS, never `self`:
        # a worker referencing self keeps the Prefetcher reachable for as
        # long as the thread lives, so __del__ could never fire and an
        # abandoned iterator (e.g. a caller breaking out of its loop
        # without close()) would leak the thread plus `depth` decoded
        # batches for the rest of the process
        q: queue.Queue = queue.Queue(maxsize=depth)
        done = object()
        err: list[BaseException] = []
        stop = threading.Event()
        self._q, self._done, self._err, self._stop = q, done, err, stop
        self._exhausted = False

        def worker():
            try:
                for item in it:
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on next()
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(done, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def close(self, *, wait: bool = False):
        """Stop the worker. `wait=True` joins it — an in-flight batch
        decode otherwise keeps consuming host CPU briefly after close(),
        which can contaminate a timing section that starts right after."""
        self._stop.set()
        if wait:
            self._t.join(timeout=30)

    def __del__(self):
        self._stop.set()

    def __iter__(self):
        return self

    def __next__(self):
        # the _done sentinel is enqueued exactly once — remember it, or a
        # second next() after exhaustion would block forever in q.get()
        if self._exhausted or (self._stop.is_set() and self._q.empty()):
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if self._stop.is_set():  # close() racing a blocked consumer
                    raise StopIteration from None
        if item is self._done:
            self._exhausted = True
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


def _raise_empty_shard(shard_len: int, batch_size: int,
                       process_index: int, process_count: int):
    """A repeating shard that fills no batch would otherwise busy-spin the
    generator forever — training blocks in next() with a pegged core and no
    error (worse with several hosts: one starved host deadlocks the first
    collective while the others proceed)."""
    raise RuntimeError(
        f"data shard {process_index}/{process_count} has {shard_len} usable"
        f" records — no batch of {batch_size} can ever fill with "
        f"drop_remainder; lower batch_size or add data"
    )


def _check_pad_mode(pad_to_equal_batches, repeat, drop_remainder):
    if pad_to_equal_batches and (repeat or drop_remainder):
        raise ValueError(
            "pad_to_equal_batches is an eval-stream mode: it needs "
            "repeat=False (one finite epoch) and drop_remainder=False "
            "(the padded tail IS the remainder)"
        )


def _batch_starts(shard_len: int, total: int, batch_size: int,
                  process_count: int, pad_to_equal_batches: bool):
    """Batch start offsets into this host's shard for one epoch.

    Padded mode: every host walks the SAME count — ceil(max_shard_len /
    batch_size), where the largest stride shard has ceil(total /
    process_count) records — computable locally on every host from the
    shared dataset index (no collective needed to agree)."""
    if not pad_to_equal_batches:
        return range(0, shard_len, batch_size)
    max_shard = -(-total // process_count)
    n_batches = -(-max_shard // batch_size)
    return [b * batch_size for b in range(n_batches)]


def detection_batches(
    ds: CocoDataset,
    *,
    batch_size: int,
    canvas: int,
    max_objects: int,
    seed: int = 0,
    shuffle: bool = True,
    repeat: bool = True,
    drop_remainder: bool = True,
    prefetch: int = 2,
    process_index: int = 0,
    process_count: int = 1,
    image_dtype=np.uint8,
    skip_batches: int = 0,
    pad_to_equal_batches: bool = False,
) -> Iterator[dict]:
    """Yields {"image": (B,canvas,canvas,3) uint8 raw bytes (default; the
    step rescales on the device) or f32 [0,1] with image_dtype=float32,
    "boxes": (B,M,4), "labels": (B,M), "mask": (B,M), "area": (B,M),
    "iscrowd": (B,M), "image_id": (B,)} — area/iscrowd ride along for the
    full target contract; losses ignore them, COCO eval reads iscrowd as
    ignore regions.

    `skip_batches` fast-forwards past already-consumed batches (resume):
    index-level only — the seeded shuffle replays identically, nothing is
    decoded for skipped batches.

    `pad_to_equal_batches` (eval streams): every host yields the SAME
    number of batches, each exactly `batch_size` rows, padding the tail
    with zero images flagged by a per-row "valid" (B,) float32 key — pad
    rows carry empty targets (mask all-False, image_id -1) and are masked
    out of every metric (train/detect eval_steps). This is what makes
    collective-bearing multi-host eval deadlock-free: a stride shard one
    record shorter than its peers would otherwise stop one batch early.
    Single-host it also pins the eval batch shape. Requires repeat=False
    and drop_remainder=False."""
    _check_pad_mode(pad_to_equal_batches, repeat, drop_remainder)
    overflow = sum(
        1 for r in ds.records if len(r.boxes) > max_objects
    )
    if overflow:
        import warnings

        warnings.warn(
            f"{overflow} image(s) carry more than max_objects="
            f"{max_objects} boxes — the excess ground truth is TRUNCATED "
            "(never matched in training, counted absent in eval); raise "
            "--max-objects to cover the dataset",
            stacklevel=2,
        )

    def gen():
        # per-host sharding: every host shuffles with the same seed and
        # takes a disjoint stride of the order
        rng = np.random.default_rng(seed)
        to_skip = skip_batches
        while True:
            order = np.arange(len(ds))
            if shuffle:
                rng.shuffle(order)
            order = order[process_index::process_count]
            yielded = False
            starts = _batch_starts(
                len(order), len(ds), batch_size, process_count,
                pad_to_equal_batches,
            )
            for start in starts:
                idxs = order[start : start + batch_size]
                if drop_remainder and len(idxs) < batch_size:
                    continue
                if to_skip > 0:  # resume fast-forward: no decode
                    to_skip -= 1
                    yielded = True  # the shard does fill batches
                    continue
                n_real = len(idxs)
                recs = [ds.records[i] for i in idxs]
                if n_real:
                    images, tfs = load_letterboxed(
                        [r.path for r in recs], canvas, records=recs,
                        dtype=image_dtype,
                    )
                else:  # all-pad batch (this shard ran out before its peers)
                    images = np.zeros(
                        (0, canvas, canvas, 3),
                        np.uint8 if np.dtype(image_dtype) == np.uint8
                        else np.float32,
                    )
                    tfs = []
                boxes, labels, masks, areas, crowds, ids = (
                    [], [], [], [], [], []
                )
                for i, rec, tf in zip(idxs, recs, tfs):
                    t = ds.padded_target(int(i), max_objects)
                    n = min(len(rec.boxes), max_objects)
                    if n:
                        t["boxes"][:n] = tf(rec.boxes[:n])
                    boxes.append(t["boxes"])
                    labels.append(t["labels"])
                    masks.append(t["mask"])
                    areas.append(t["area"])
                    crowds.append(t["iscrowd"])
                    ids.append(t["image_id"])
                for _ in range(batch_size - n_real if pad_to_equal_batches
                               else 0):
                    boxes.append(np.zeros((max_objects, 4), np.float32))
                    labels.append(np.zeros((max_objects,), np.int32))
                    masks.append(np.zeros((max_objects,), bool))
                    areas.append(np.zeros((max_objects,), np.float32))
                    crowds.append(np.zeros((max_objects,), np.int32))
                    ids.append(-1)
                if pad_to_equal_batches and n_real < batch_size:
                    images = np.concatenate([
                        images,
                        np.zeros((batch_size - n_real,) + images.shape[1:],
                                 images.dtype),
                    ])
                batch = {
                    "image": images,
                    "boxes": np.stack(boxes),
                    "labels": np.stack(labels),
                    "mask": np.stack(masks),
                    "area": np.stack(areas),
                    "iscrowd": np.stack(crowds),
                    "image_id": np.asarray(ids, np.int32),
                }
                if pad_to_equal_batches:
                    valid = np.zeros((batch_size,), np.float32)
                    valid[:n_real] = 1.0
                    batch["valid"] = valid
                yield batch
                yielded = True
            if not repeat:
                return
            if not yielded:
                _raise_empty_shard(len(order), batch_size,
                                   process_index, process_count)

    return Prefetcher(gen(), depth=prefetch)


def classification_batches(
    ds: CocoDataset,
    *,
    batch_size: int,
    canvas: int,
    seed: int = 0,
    shuffle: bool = True,
    repeat: bool = True,
    drop_remainder: bool = True,
    prefetch: int = 2,
    process_index: int = 0,
    process_count: int = 1,
    image_dtype=np.uint8,
    skip_batches: int = 0,
    pad_to_equal_batches: bool = False,
) -> Iterator[dict]:
    """Dominant-class labels; images with no boxes are skipped.

    Yields {"image": (B,canvas,canvas,3) uint8 (default, see
    detection_batches) or f32 [0,1], "label": (B,) i32}.
    `skip_batches`: see detection_batches (resume fast-forward).
    `pad_to_equal_batches`: see detection_batches — equal per-host batch
    counts with a per-row "valid" mask (multi-host eval, fixed eval shape).
    """
    _check_pad_mode(pad_to_equal_batches, repeat, drop_remainder)
    labels_all = ds.classification_labels()
    keep = np.nonzero(labels_all >= 0)[0]

    def gen():
        rng = np.random.default_rng(seed)
        to_skip = skip_batches
        while True:
            order = keep.copy()
            if shuffle:
                rng.shuffle(order)
            order = order[process_index::process_count]
            yielded = False
            starts = _batch_starts(
                len(order), len(keep), batch_size, process_count,
                pad_to_equal_batches,
            )
            for start in starts:
                idxs = order[start : start + batch_size]
                if drop_remainder and len(idxs) < batch_size:
                    continue
                if to_skip > 0:  # resume fast-forward: no decode
                    to_skip -= 1
                    yielded = True  # the shard does fill batches
                    continue
                n_real = len(idxs)
                if n_real:
                    images, _ = load_letterboxed(
                        [ds.records[i].path for i in idxs], canvas,
                        dtype=image_dtype,
                    )
                else:  # all-pad batch (shard shorter than its peers)
                    images = np.zeros(
                        (0, canvas, canvas, 3),
                        np.uint8 if np.dtype(image_dtype) == np.uint8
                        else np.float32,
                    )
                if pad_to_equal_batches:
                    if n_real < batch_size:
                        images = np.concatenate([
                            images,
                            np.zeros(
                                (batch_size - n_real,) + images.shape[1:],
                                images.dtype,
                            ),
                        ])
                    labels = np.zeros((batch_size,), np.int32)
                    labels[:n_real] = labels_all[idxs]
                    valid = np.zeros((batch_size,), np.float32)
                    valid[:n_real] = 1.0
                    yield {"image": images, "label": labels, "valid": valid}
                else:
                    yield {
                        "image": images,
                        "label": labels_all[idxs].astype(np.int32),
                    }
                yielded = True
            if not repeat:
                return
            if not yielded:
                _raise_empty_shard(len(order), batch_size,
                                   process_index, process_count)

    return Prefetcher(gen(), depth=prefetch)
