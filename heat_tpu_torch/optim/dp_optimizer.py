"""Data-parallel optimizers (counterpart of heat_tpu/optim/dp_optimizer.py).

:class:`DataParallelOptimizer` binds a ``torch.optim`` optimizer to the
data-parallel cycle, as heat's own does (its dp_optimizer.py:851-897): the
gradients are averaged across ranks by :class:`~heat_tpu_torch.nn.DataParallel`
before :meth:`DataParallelOptimizer.step`, and its ``blocking`` flag picks
how.

:class:`DASO` (Distributed Asynchronous and Selective Optimization, heat's
dp_optimizer.py:64-850) drives the hierarchy of a
:class:`~heat_tpu_torch.parallel.HierarchicalCommunication`: every rank holds
its node's replica of the parameters (the module it trains), the gradients
are averaged within the node every batch
(:class:`~heat_tpu_torch.nn.DataParallelMultiGPU`), and the replicas are
averaged across the nodes only every ``global_skip`` batches, in bfloat16,
the average replacing the local parameters ``batches_to_wait`` batches
later.  The average is the JAX package's
``mean(p.astype(bf16), axis=0).astype(p.dtype)`` over the node axis: XLA
sums the bfloat16 values in float32, divides by the node count in float32
and rounds to bfloat16 once; the port gathers every node's bfloat16 buffer
over the ``'global'`` group and adds them in node order the same way, so
that the bits do not depend on a collective's ring.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..parallel.comm import Communication, HierarchicalCommunication, sanitize_comm
from .utils import DetectMetricPlateau

__all__ = ["DASO", "DataParallelOptimizer"]


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


def _bf16_mean_over_nodes(flat: torch.Tensor, comm: Communication, down: torch.dtype) -> torch.Tensor:
    """The cross-node mean of ``flat`` (this node's values) as the
    reference's ``mean(p.astype(down), axis=0).astype(p.dtype)``: every
    node's ``down`` buffer gathered over ``comm`` (the 'global' group), the
    values added in float32 in node order, divided by the node count in
    float32 and rounded to ``down`` once."""
    low = flat.to(down)
    parts = comm.all_gather(low.reshape(1, -1), axis=0) if comm.size > 1 else low.reshape(1, -1)
    total = parts[0].to(torch.float32)
    for r in range(1, parts.shape[0]):
        total = total + parts[r].to(torch.float32)
    return (total / float(parts.shape[0])).to(down).to(flat.dtype)


class DASO:
    """Hierarchical skipped and delayed global averaging (heat's
    dp_optimizer.py:64; the JAX package's heat_tpu/optim/dp_optimizer.py:
    92-291).

    ``local_optimizer`` is a ``torch.optim.Optimizer`` over the module's
    parameters; the other parameters are the reference's.  The schedule
    state (``global_skip``, ``batches_to_wait``, ``epoch``, ``batch``, the
    pending average, the plateau detector) follows the reference step for
    step.  On a plain communication the global sync is the bfloat16 round
    trip of the parameters (its only observable effect on one replica); on
    a hierarchical one it is :func:`_bf16_mean_over_nodes` of the
    parameters, in chunks of ``sending_chunk_size`` elements.
    """

    def __init__(
        self,
        local_optimizer: torch.optim.Optimizer,
        total_epochs: int,
        comm: Optional[Communication] = None,
        warmup_epochs: int = 4,
        cooldown_epochs: int = 4,
        scheduler: Optional[Callable] = None,
        stability_level: float = 0.05,
        max_global_skips: int = 8,
        sending_chunk_size: int = 10_000_000,
        downcast_type: torch.dtype = torch.bfloat16,
        verbose: bool = False,
    ):
        self.local_optimizer = DataParallelOptimizer(local_optimizer)
        self.comm = sanitize_comm(comm)
        self.total_epochs = total_epochs
        self.warmup_epochs = warmup_epochs
        self.cooldown_epochs = cooldown_epochs
        self.scheduler = scheduler
        self.max_global_skips = max_global_skips
        self.sending_chunk_size = int(sending_chunk_size)
        self.downcast_type = downcast_type
        self.verbose = verbose

        self.global_skip = 0
        self.batches_to_wait = 0
        self.epoch = 0
        self.batch = 0
        self._pending = None  # (due batch, the averaged parameters)
        self.stability = DetectMetricPlateau(patience=2, threshold=stability_level)
        self.split_inds = None
        #: True on a HierarchicalCommunication: each node holds its own replica
        self.hierarchical = isinstance(self.comm, HierarchicalCommunication)

    # ------------------------------------------------------------------
    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.local_optimizer.optimizer.param_groups for p in g["params"]]

    def _global_average(self, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """New tensors holding the global average of ``params`` (a snapshot:
        the optimizer's later in-place updates do not reach it)."""
        down = self.downcast_type
        if not self.hierarchical:
            return [p.detach().to(down).to(p.dtype) for p in params]
        out: List[torch.Tensor] = [None] * len(params)
        for dtype in dict.fromkeys(p.dtype for p in params):  # one flat buffer per dtype
            group = [i for i, p in enumerate(params) if p.dtype == dtype]
            flat = torch.cat([params[i].detach().reshape(-1) for i in group])
            step = max(self.sending_chunk_size, 1)
            avg = torch.cat([_bf16_mean_over_nodes(flat[lo:lo + step], self.comm.global_comm, down)
                             for lo in range(0, flat.numel(), step)]) if flat.numel() else flat.clone()
            offset = 0
            for i in group:
                out[i] = avg[offset:offset + params[i].numel()].reshape(params[i].shape)
                offset += params[i].numel()
        return out

    @staticmethod
    def _install(params: List[torch.Tensor], values: List[torch.Tensor]) -> None:
        with torch.no_grad():
            for p, v in zip(params, values):
                p.copy_(v)

    def replicate(self, params):
        """The reference stacks one replica per node; here every rank holds
        its node's replica already, so the parameters come back as they
        are (the stacked layout exists only in ``interop``)."""
        return params

    def collect(self, params):
        """This rank's (its node's) parameters: after :meth:`last_batch`
        every node holds the same."""
        return params

    # ------------------------------------------------------------------
    def epoch_loss_logic(self, loss, loss_globally_averaged: bool = False) -> None:
        """Adjust ``global_skip`` and ``batches_to_wait`` from the loss
        plateau state (heat's dp_optimizer.py:354)."""
        plateaued = self.stability.test_if_improving(float(loss))
        if self.epoch < self.warmup_epochs or self.epoch >= self.total_epochs - self.cooldown_epochs:
            self.global_skip = 0
            self.batches_to_wait = 0
        elif self.global_skip == 0:
            self.global_skip = 4
            self.batches_to_wait = 1
        elif plateaued:  # the loss plateaued: sync more often
            self.global_skip = max(1, self.global_skip // 2)
        else:
            self.global_skip = min(self.max_global_skips, self.global_skip * 2)

    def add_scaler(self, scaler) -> None:
        """The AMP scaler hook of heat's DASO (dp_optimizer.py:260); as in
        the JAX package it takes no part in the update."""

    def zero_grad(self) -> None:
        self.local_optimizer.zero_grad()

    def step(self) -> None:
        """The local update from the parameters' gradients, then a due
        pending average replaces the parameters, then the global sync of
        this batch (skipped, immediate, or pending ``batches_to_wait``
        batches), as the reference's ``step``."""
        self.local_optimizer.step()
        params = self._params()
        if self._pending is not None and self.batch >= self._pending[0]:
            self._install(params, self._pending[1])
            self._pending = None
        if self.global_skip == 0 or self.batch % max(self.global_skip, 1) == 0:
            avg = self._global_average(params)
            if self.batches_to_wait == 0:
                self._install(params, avg)
            else:
                self._pending = (self.batch + self.batches_to_wait, avg)
        self.batch += 1

    def last_batch(self) -> None:
        """Apply any pending average now (at the end of an epoch)."""
        if self._pending is not None:
            self._install(self._params(), self._pending[1])
            self._pending = None

    def next_epoch(self) -> None:
        self.epoch += 1
        self.batch = 0

    def get_state(self) -> Dict:
        return {
            "epoch": self.epoch,
            "batch": self.batch,
            "global_skip": self.global_skip,
            "batches_to_wait": self.batches_to_wait,
            "stability": self.stability.get_state(),
        }

    def set_state(self, state: Dict) -> None:
        self.epoch = state["epoch"]
        self.batch = state["batch"]
        self.global_skip = state["global_skip"]
        self.batches_to_wait = state["batches_to_wait"]
        self.stability.set_state(state["stability"])
