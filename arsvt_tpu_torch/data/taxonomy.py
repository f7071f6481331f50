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


def class_name(index: int) -> str:
    """Display name for a class index; indices beyond the taxonomy (e.g.
    a checkpoint trained with extra classes) fall back to the number so
    serving responses never crash on an unknown label."""
    return (
        RECYCLING_CLASSES[index]
        if 0 <= index < len(RECYCLING_CLASSES)
        else str(index)
    )
