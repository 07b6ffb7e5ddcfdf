"""Functional NN ops (counterpart of heat_tpu/nn/functional.py): names
resolve against ``torch.nn.functional``, as heat's ``func_getattr`` does."""

__all__ = ["func_getattr"]


def func_getattr(name):
    """Resolve ``name`` against ``torch.nn.functional``."""
    import torch.nn.functional as _F

    try:
        return getattr(_F, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn.functional' has no attribute {name!r}") from None


def __getattr__(name):
    return func_getattr(name)
