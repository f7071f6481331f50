"""Folder-per-class image dataset, the TrashNet layout (copy of
``arsvt_tpu/data/folder.py``).

TrashNet-family datasets ship as one directory per class (glass/ paper/
cardboard/ plastic/ metal/ trash/), not as COCO JSON. `FolderDataset`
duck-types the classification surface of `CocoDataset` (`records[i].path`,
`classification_labels()`, `num_classes`, `class_names`), so
`pipeline.classification_batches` and the train CLI take either format.

Layouts accepted (auto-detected by `open_classification_split`):

    root/train/<class>/*.jpg + root/valid/<class>/*.jpg   (pre-split)
    root/<class>/*.jpg                                    (unsplit —
        use split="train"/"valid": a stable per-file hash puts
        ~val_fraction of each class in "valid", so the same file always
        lands in the same split on every host and every run, and in the
        same split as in the JAX package)

Class-name → label mapping: when every directory name is in the
canonical recycling taxonomy (data/taxonomy.py) the taxonomy order is
used (glass=0 … trash=5) so checkpoints and confusion matrices line up
across datasets; otherwise sorted directory order.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


@dataclasses.dataclass
class FolderRecord:
    path: str
    label: int


def _stable_val_hash(path: str) -> int:
    """Split hash from the file's BASENAME (not the absolute path): moving
    the dataset directory must not reshuffle the split."""
    name = os.path.basename(path).encode()
    return int.from_bytes(hashlib.md5(name).digest()[:4], "big") % 1000


class FolderDataset:
    def __init__(self, root: str, *, split: str | None = None,
                 val_fraction: float = 0.1):
        if split not in (None, "train", "valid"):
            raise ValueError(f"split must be None/'train'/'valid', "
                             f"got {split!r}")
        class_dirs = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
            and not d.startswith((".", "_"))
        )
        if not class_dirs:
            raise ValueError(f"no class directories under {root}")
        if all(d.lower() in RECYCLING_CLASSES for d in class_dirs):
            order = [c for c in RECYCLING_CLASSES
                     if c in [d.lower() for d in class_dirs]]
            by_lower = {d.lower(): d for d in class_dirs}
            class_dirs = [by_lower[c] for c in order]
        self.class_names = [d.lower() for d in class_dirs]
        self.num_classes = len(class_dirs)
        cut = int(round(val_fraction * 1000))
        self.records: list[FolderRecord] = []
        for label, d in enumerate(class_dirs):
            droot = os.path.join(root, d)
            for fname in sorted(os.listdir(droot)):
                if not fname.lower().endswith(_IMAGE_EXTS):
                    continue
                path = os.path.join(droot, fname)
                if split is not None:
                    in_val = _stable_val_hash(path) < cut
                    if (split == "valid") != in_val:
                        continue
                self.records.append(FolderRecord(path=path, label=label))
        if not self.records:
            raise ValueError(
                f"no images found under {root} (split={split!r})"
            )

    def __len__(self) -> int:
        return len(self.records)

    def classification_labels(self) -> np.ndarray:
        return np.asarray([r.label for r in self.records], np.int32)


def open_classification_split(data_dir: str, split: str):
    """Resolve `data_dir` to a classification dataset for `split`
    ("train"/"valid"): COCO layout if the split dir carries COCO
    annotations, folder-per-class otherwise (pre-split subdir, or the
    unsplit TrashNet layout via the stable hash split)."""
    split_dir = os.path.join(data_dir, split)
    if os.path.exists(os.path.join(split_dir,
                                   "_annotations.coco.json")):
        from arsvt_tpu_torch.data.coco import CocoDataset

        return CocoDataset(split_dir)
    if os.path.isdir(split_dir):
        return FolderDataset(split_dir)
    if split not in ("train", "valid"):
        raise ValueError(
            f"{data_dir} has no {split!r} subdirectory and the unsplit "
            f"folder layout only derives 'train'/'valid' (stable hash "
            f"split) — pass --split valid"
        )
    return FolderDataset(data_dir, split=split)
