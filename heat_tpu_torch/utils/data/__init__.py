"""Data helpers (counterpart of heat_tpu/utils/data): so far
:func:`synthetic_mnist`.  The rest of heat_tpu/utils/data waits (ROADMAP
queue 1, item 14)."""

from .mnist import synthetic_mnist

__all__ = ["synthetic_mnist"]
