"""Learning-rate schedulers (counterpart of heat_tpu/optim/lr_scheduler.py):
every name falls through to ``torch.optim.lr_scheduler``, as heat's own
lr_scheduler.py does."""


def __getattr__(name):
    import torch.optim.lr_scheduler as _sched

    try:
        return getattr(_sched, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.optim.lr_scheduler' has no attribute {name!r}") from None
