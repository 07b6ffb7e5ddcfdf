"""Input validation (counterpart of heat_tpu/core/sanitation.py).

Ported so far: :func:`sanitize_in`, which the linear algebra entry points
call on their operands.
"""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["sanitize_in"]


def sanitize_in(x) -> None:
    """Raise unless ``x`` is a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
