"""Memory layout helpers (counterpart of heat_tpu/core/memory.py)."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["copy", "sanitize_memory_layout"]


def copy(x: DNDarray) -> DNDarray:
    """A deep copy: the same values, split and type in new memory."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
    return x.copy()


def sanitize_memory_layout(x, order: str = "C"):
    """``x`` itself: every rank's chunk is row-major; 'F' is accepted and,
    as in the reference, changes nothing."""
    if order not in ("C", "F"):
        raise ValueError(f"invalid memory layout order, expected 'C' or 'F', got {order!r}")
    return x
