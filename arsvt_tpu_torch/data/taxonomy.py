"""The 6-class recycling taxonomy (copy of ``arsvt_tpu/data/taxonomy.py``)."""

from __future__ import annotations

RECYCLING_CLASSES: tuple[str, ...] = (
    "glass",
    "paper",
    "cardboard",
    "plastic",
    "metal",
    "trash",
)
NUM_CLASSES = len(RECYCLING_CLASSES)

_INDEX = {name: i for i, name in enumerate(RECYCLING_CLASSES)}


def class_name(index: int) -> str:
    """Display name for a class index; indices beyond the taxonomy (e.g.
    a checkpoint trained with extra classes) fall back to the number so
    serving responses never crash on an unknown label."""
    return (
        RECYCLING_CLASSES[index]
        if 0 <= index < len(RECYCLING_CLASSES)
        else str(index)
    )


def class_index(name: str) -> int:
    return _INDEX[name.lower()]
