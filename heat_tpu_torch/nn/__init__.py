"""Neural-network layer (counterpart of heat_tpu/nn).

heat mounts ``torch.nn`` behind a module ``__getattr__``, so any layer not
overridden here resolves to torch's; the port does the same.  What it
overrides is the sequence-parallel attention of :mod:`.attention`,
:class:`DataParallel` and the hierarchical :class:`DataParallelMultiGPU`
(:mod:`.data_parallel`).
``heat_tpu_torch.nn.functional`` falls through to ``torch.nn.functional``.
"""

from . import functional
from .attention import ring_attention, scaled_dot_product_attention, ulysses_attention
from .data_parallel import DataParallel, DataParallelMultiGPU

__all__ = ["DataParallel", "DataParallelMultiGPU", "functional", "ring_attention", "scaled_dot_product_attention", "ulysses_attention"]


def __getattr__(name):
    """Fall back to torch.nn for layers not overridden here."""
    import torch.nn as _nn

    try:
        return getattr(_nn, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn' has no attribute {name!r}") from None
