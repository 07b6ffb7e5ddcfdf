"""Optimizers (counterpart of heat_tpu/optim).

heat itself falls through to ``torch.optim`` (its optim/__init__.py:16-31),
so ``heat_tpu_torch.optim.SGD``, ``Adam``, ``AdamW`` or any other name not
defined here is torch's own; the JAX package maps the same names to optax.
Beside them: :class:`DataParallelOptimizer`, :class:`DASO` (hierarchical
skipped and delayed averaging on a ``HierarchicalCommunication``) and
:class:`DetectMetricPlateau`.
"""

from . import lr_scheduler
from .dp_optimizer import DASO, DataParallelOptimizer
from .utils import DetectMetricPlateau

__all__ = ["DASO", "DataParallelOptimizer", "DetectMetricPlateau", "lr_scheduler"]


def __getattr__(name):
    """Fall back to torch.optim for optimizers not defined here."""
    import torch.optim as _optim

    try:
        return getattr(_optim, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.optim' has no attribute {name!r}") from None
