"""COCO-format detection/classification reader — pure JSON, no
pycocotools (copy of ``arsvt_tpu/data/coco.py``).

  * reads `<split>/_annotations.coco.json` and the image files beside it;
  * maps COCO category ids → contiguous labels sorted by id (or by the
    recycling taxonomy when the names are exactly it), and keeps the
    inverse map and the names;
  * validates boxes: COCO [x, y, w, h] pixels → normalized x1y1x2y2,
    clipped to [0, 1]; degenerate boxes (w or h <= 1 px, or inverted
    after clipping) are dropped;
  * classification view: an image's label is the MOST FREQUENT class
    among its boxes (ties resolve to the lowest label id; -1 without
    boxes).

Ragged targets become padded fixed-shape arrays with validity masks
(`padded_target`), so the matcher and the losses see static shapes.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class ImageRecord:
    path: str
    width: int
    height: int
    boxes: np.ndarray      # (n, 4) normalized x1y1x2y2 float32
    labels: np.ndarray     # (n,) contiguous int32
    areas: np.ndarray      # (n,) normalized area float32
    iscrowd: np.ndarray    # (n,) int32
    image_id: int

    @property
    def dominant_label(self) -> int:
        """Most-frequent class (count-based; ties → lowest label id); -1
        for background-only images."""
        if len(self.labels) == 0:
            return -1
        uniq, counts = np.unique(self.labels, return_counts=True)
        return int(uniq[np.argmax(counts)])


class CocoDataset:
    def __init__(self, split_dir: str, *,
                 annotations_file: str = "_annotations.coco.json",
                 min_box_pixels: float = 1.0):
        self.split_dir = split_dir
        with open(os.path.join(split_dir, annotations_file)) as f:
            coco = json.load(f)

        # contiguous label maps. When the category names are exactly the
        # canonical recycling taxonomy, labels follow the taxonomy order, so
        # class indices mean the same thing across datasets and match the
        # RECYCLING_CLASSES names that evaluation and serving display (a
        # sorted-id mapping mislabels every prediction of an export whose
        # id order differs, e.g. an alphabetical one). The remap needs the
        # FULL taxonomy (set equality): labels are compacted to 0..n-1, so
        # for a strict subset a reordered compaction would not equal the
        # canonical indices, and splits listing different subsets would get
        # inconsistent maps. Subsets and unknown names keep sorted-id order.
        from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES

        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        names = [c["name"].lower() for c in cats]
        if cats and set(names) == set(RECYCLING_CLASSES) and (
                len(set(names)) == len(names)):
            order = {n: i for i, n in enumerate(RECYCLING_CLASSES)}
            cats = sorted(cats, key=lambda c: order[c["name"].lower()])
        self.category_id_to_label = {c["id"]: i for i, c in enumerate(cats)}
        self.label_to_category_id = {i: c["id"] for i, c in enumerate(cats)}
        self.class_names = [c["name"] for c in cats]
        self.num_classes = len(cats)

        anns_by_image: dict[int, list] = {}
        for ann in coco.get("annotations", []):
            anns_by_image.setdefault(ann["image_id"], []).append(ann)

        self.records: list[ImageRecord] = []
        for img in coco.get("images", []):
            w, h = float(img["width"]), float(img["height"])
            boxes, labels, areas, iscrowd = [], [], [], []
            for ann in anns_by_image.get(img["id"], []):
                x, y, bw, bh = ann["bbox"]
                # degenerate in pixel space
                if bw <= min_box_pixels or bh <= min_box_pixels:
                    continue
                x1 = np.clip(x / w, 0.0, 1.0)
                y1 = np.clip(y / h, 0.0, 1.0)
                x2 = np.clip((x + bw) / w, 0.0, 1.0)
                y2 = np.clip((y + bh) / h, 0.0, 1.0)
                if x2 <= x1 or y2 <= y1:  # inverted after clipping
                    continue
                if ann["category_id"] not in self.category_id_to_label:
                    continue
                boxes.append([x1, y1, x2, y2])
                labels.append(self.category_id_to_label[ann["category_id"]])
                areas.append((x2 - x1) * (y2 - y1))
                iscrowd.append(int(ann.get("iscrowd", 0)))
            self.records.append(
                ImageRecord(
                    path=os.path.join(split_dir, img["file_name"]),
                    width=int(w), height=int(h),
                    boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int32),
                    areas=np.asarray(areas, np.float32),
                    iscrowd=np.asarray(iscrowd, np.int32),
                    image_id=int(img["id"]),
                )
            )

    def __len__(self) -> int:
        return len(self.records)

    def padded_target(self, idx: int, max_objects: int) -> dict[str, np.ndarray]:
        """Fixed-shape target: boxes (M,4), labels (M,), mask (M,) bool,
        plus `area`/`iscrowd`: unused by the losses, but part of the data
        contract (COCO eval protocols read them)."""
        rec = self.records[idx]
        n = min(len(rec.labels), max_objects)
        boxes = np.zeros((max_objects, 4), np.float32)
        labels = np.zeros((max_objects,), np.int32)
        mask = np.zeros((max_objects,), bool)
        area = np.zeros((max_objects,), np.float32)
        iscrowd = np.zeros((max_objects,), np.int32)
        boxes[:n] = rec.boxes[:n]
        labels[:n] = rec.labels[:n]
        mask[:n] = True
        area[:n] = rec.areas[:n]
        iscrowd[:n] = rec.iscrowd[:n]
        return {
            "boxes": boxes,
            "labels": labels,
            "mask": mask,
            "area": area,
            "iscrowd": iscrowd,
            "image_id": np.int32(rec.image_id),
        }

    def classification_labels(self) -> np.ndarray:
        """Dominant-class label per image; -1 where no boxes."""
        return np.asarray([r.dominant_label for r in self.records], np.int32)
