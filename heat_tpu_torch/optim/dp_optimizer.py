"""Data-parallel optimizers (counterpart of heat_tpu/optim/dp_optimizer.py).

:class:`DataParallelOptimizer` binds a ``torch.optim`` optimizer to the
data-parallel cycle, as heat's own does (its dp_optimizer.py:851-897): the
gradients are averaged across ranks by :class:`~heat_tpu_torch.nn.DataParallel`
before :meth:`DataParallelOptimizer.step`, and its ``blocking`` flag picks
how.  ``DASO`` waits for ``HierarchicalCommunication`` (ROADMAP queue 1,
items 2 and 14).
"""

from __future__ import annotations

import torch

__all__ = ["DataParallelOptimizer"]


class DataParallelOptimizer:
    """A ``torch.optim.Optimizer`` in the data-parallel cycle.

    ``blocking`` selects the gradient-reduction schedule a
    :class:`~heat_tpu_torch.nn.DataParallel` built on this optimizer uses:
    ``True`` -> one flat all-reduce of the whole gradient ("fused"),
    ``False`` (default) -> byte-bounded buckets in reverse layer order
    ("bucketed", :func:`heat_tpu_torch.nn.data_parallel.reduce_gradients`).
    Both sum the same elements over the same ranks in the same order, so
    they give the same updates bitwise."""

    def __init__(self, optimizer: torch.optim.Optimizer, blocking: bool = False):
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"optimizer must be a torch.optim.Optimizer, got {type(optimizer)}")
        if not isinstance(blocking, bool):
            raise ValueError(
                "blocking must be True (one fused all-reduce) or False (bucketed all-reduces), "
                f"got {blocking!r}"
            )
        self.optimizer = optimizer
        self.blocking = blocking

    @property
    def schedule(self) -> str:
        """Gradient-reduction schedule this optimizer selects
        (``'fused'`` when blocking, else ``'bucketed'``)."""
        return "fused" if self.blocking else "bucketed"

    def step(self) -> None:
        """Apply one update from the parameters' (averaged) gradients."""
        self.optimizer.step()

    def zero_grad(self) -> None:
        """Clear the parameters' gradients."""
        self.optimizer.zero_grad(set_to_none=True)
