"""Data-parallel training (counterpart of heat_tpu/nn/data_parallel.py).

Parameters are replicated: every rank holds the whole ``torch.nn.Module``,
drawn from one explicit ``torch.Generator`` (:meth:`DataParallel.init`,
the counterpart of heat's shared seed) or set from given values.  The batch
is split over the ranks in the canonical layout of
:mod:`heat_tpu_torch.parallel.comm`: each rank computes the loss of its own
rows, weighted by its share of the batch, so that the gradients, averaged
across ranks, are those of the mean loss over the whole batch -- the JAX
package's gradient of a mean over the sharded batch axis.

How the gradients are averaged is the schedule (``grad_reduction``):

* ``"implicit"``: each parameter's gradient on its own, after the backward;
* ``"bucketed"``: byte-bounded buckets (``HEAT_TPU_GRAD_BUCKET_MB``,
  default 4) in reverse layer order, each one flat buffer
  (:func:`reduce_gradients`; :data:`GRAD_BUCKETS` counts the buckets
  issued);
* ``"fused"``: one flat buffer of the whole gradient.

Every schedule gathers its buffers and adds the ranks' values in rank order
(:func:`_mean_over_ranks`), so an element's sum does not depend on which
buffer it travels in, and the three schedules give bitwise equal updates,
as the reference promises.  That costs ``size`` times the bytes of a ring
all-reduce, which a gradient of the sizes trained here does not notice.
The buckets are issued after the backward, not overlapped with it.

The reference caches compiled loss programs (``_loss_key``,
``_cached_program``), because JAX compiles; eager torch has no program to
cache.  Its observable contract -- a new ``loss_fn`` takes effect on the
next :meth:`DataParallel.step` -- holds here by construction
(tests/test_torch_data_parallel.py checks it, as the reference's
``test_step_rebuilds_on_new_loss_fn`` does).  The reference tests of the
cache itself, ``test_loss_cache_reuses_closure_free_lambdas``,
``test_loss_cache_kwdefaults_and_alternation`` and
``test_loss_cache_pins_captured_state`` in tests/test_nn_optim.py, inspect
``_programs`` and ``_loss_key`` and have no counterpart.
:class:`DataParallelMultiGPU` trains on a
:class:`~heat_tpu_torch.parallel.HierarchicalCommunication`: each node takes
a contiguous slab of the batch, split over its ranks; the gradient of the
node's mean loss is averaged over the node's ranks in rank order, and
:class:`~heat_tpu_torch.optim.DASO` steps and decides the cross-node
averages.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import _env
from ..core.dndarray import DNDarray
from ..optim.dp_optimizer import DataParallelOptimizer
from ..parallel.comm import Communication, HierarchicalCommunication, sanitize_comm

__all__ = ["DataParallel", "DataParallelMultiGPU", "bucket_partition", "reduce_gradients"]

#: default collective bucket size for the bucketed schedule, MiB
DEFAULT_GRAD_BUCKET_MB = float(_env.knob_default("HEAT_TPU_GRAD_BUCKET_MB"))
#: buckets issued by :func:`reduce_gradients` in this process
GRAD_BUCKETS = 0


def _grad_bucket_bytes() -> int:
    return int(_env.env_float("HEAT_TPU_GRAD_BUCKET_MB") * 2**20)


def bucket_partition(leaves: Sequence[torch.Tensor], bucket_bytes: Optional[int]) -> List[List[int]]:
    """Partition gradient tensors into collective buckets.

    Returns lists of indices in **reverse layer order** (the order
    gradients become ready in the backward), each bucket bounded by
    ``bucket_bytes`` (``None``: unbounded, the fused schedule) and of a
    single dtype.  A tensor larger than the bound gets its own bucket:
    tensors are never split."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i in reversed(range(len(leaves))):
        leaf = leaves[i]
        nbytes = leaf.numel() * leaf.element_size()
        over = bucket_bytes is not None and cur_bytes + nbytes > bucket_bytes
        if cur and (over or leaf.dtype != cur_dtype):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = leaf.dtype
    if cur:
        buckets.append(cur)
    return buckets


def _mean_over_ranks(buf: torch.Tensor, comm: Communication) -> torch.Tensor:
    """The mean of ``buf`` over the ranks: every rank's buffer gathered and
    added in rank order, then scaled by 1 / size."""
    if comm.size == 1:
        return buf
    parts = comm.all_gather(buf.reshape(1, -1), axis=0)
    total = parts[0].clone()
    for r in range(1, comm.size):
        total += parts[r]
    return (total * (1.0 / comm.size)).reshape(buf.shape)


def reduce_gradients(
    grads: Sequence[torch.Tensor],
    comm: Optional[Communication] = None,
    blocking: bool = False,
    bucket_bytes: Optional[int] = None,
) -> List[torch.Tensor]:
    """The cross-rank mean of each of ``grads`` (a list of this rank's
    gradient tensors, in layer order), returned as a new list.

    ``blocking=False`` (default): one flat buffer per byte-bounded bucket,
    in reverse layer order; ``blocking=True``: one flat buffer of the
    whole gradient (per dtype).  Both add the same elements over the same
    ranks in the same order, so the results are bitwise equal.  The
    buckets issued are added to :data:`GRAD_BUCKETS` and to the overlap
    counter ``grad_buckets``."""
    from ..utils.overlap import _bump

    global GRAD_BUCKETS
    comm = sanitize_comm(comm)
    grads = list(grads)
    if not grads:
        return grads
    bound = None if blocking else (_grad_bucket_bytes() if bucket_bytes is None else bucket_bytes)
    buckets = bucket_partition(grads, bound)
    GRAD_BUCKETS += len(buckets)
    _bump("grad_buckets", len(buckets))
    out: List[Any] = [None] * len(grads)
    for bucket in buckets:
        flat = [grads[i].reshape(-1) for i in bucket]
        buf = _mean_over_ranks(flat[0] if len(flat) == 1 else torch.cat(flat), comm)
        offset = 0
        for i in bucket:
            n = grads[i].numel()
            out[i] = buf[offset : offset + n].reshape(grads[i].shape)
            offset += n
    return out


def _lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init, ``lecun_normal``: a normal of variance
    1 / fan_in truncated at two standard deviations (its std corrected for
    the truncation), drawn from ``generator`` on its own device."""
    fan_in = t[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(t.shape, dtype=t.dtype, device=generator.device)
    torch.nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    t.copy_(draw)


class DataParallel(torch.nn.Module):
    """Distributed data-parallel wrapper of a ``torch.nn.Module`` (heat's
    data_parallel.py:22).

    Parameters
    ----------
    module : torch.nn.Module
        The model, the same on every rank.
    comm : Communication, optional
        The ranks over which the batch is split (default: the world).
    optimizer : torch.optim.Optimizer or DataParallelOptimizer, optional
        Bound to ``module``'s parameters; enables :meth:`step` and
        :meth:`train_steps`.  A :class:`DataParallelOptimizer` selects the
        schedule by its ``blocking`` flag (``True``: fused, ``False``:
        bucketed).
    blocking_parameter_updates : bool
        ``True`` selects the fused schedule (heat's ``_blocking_hook``);
        ``False`` (default) the implicit one.
    grad_reduction : str, optional
        ``"implicit"``, ``"bucketed"`` or ``"fused"``; overrides the two
        above.  Unknown values raise.

    Float32 convolutions run in full float32 (cuDNN's TF32 is switched off
    when a DataParallel is made), as the reference's convolutions do.
    """

    def __init__(
        self,
        module: torch.nn.Module,
        comm: Optional[Communication] = None,
        optimizer: Any = None,
        blocking_parameter_updates: bool = False,
        grad_reduction: Optional[str] = None,
    ):
        super().__init__()
        if not isinstance(module, torch.nn.Module):
            raise TypeError(f"module must be a torch.nn.Module, got {type(module)}")
        if isinstance(optimizer, DataParallelOptimizer):
            if grad_reduction is None:
                grad_reduction = optimizer.schedule
            optimizer = optimizer.optimizer
        if optimizer is not None and not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"optimizer must be a torch.optim.Optimizer or a DataParallelOptimizer, got {type(optimizer)}")
        if grad_reduction is None:
            grad_reduction = "fused" if blocking_parameter_updates else "implicit"
        if grad_reduction not in ("implicit", "bucketed", "fused"):
            raise ValueError(f"grad_reduction must be 'implicit', 'bucketed' or 'fused', got {grad_reduction!r}")
        self.module = module
        self.comm = sanitize_comm(comm)
        self.blocking_parameter_updates = blocking_parameter_updates
        self.grad_reduction = grad_reduction
        self.optimizer = optimizer
        torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, sample_input) -> "DataParallel":
        """Draw the parameters from ``generator``, the same on every rank
        that passes a generator of the same seed: kernels (two or more
        dimensions) as flax's ``lecun_normal``, biases zero, other vectors
        (norm scales) one, as the JAX package's flax layers start.  A
        forward of ``sample_input`` first creates any lazy parameter."""
        with torch.no_grad():
            self.module(self._rows(sample_input)[0])
            for name, p in self.module.named_parameters():
                if p.dim() >= 2:
                    _lecun_normal_(p, generator)
                elif name.rsplit(".", 1)[-1] == "bias":
                    p.zero_()
                else:
                    p.fill_(1.0)
        self._reset_optimizer()
        return self

    def set_params(self, params: Mapping[str, Any]) -> None:
        """Set every parameter from ``params`` (name -> tensor or array, the
        names of ``module.named_parameters()``), and start the optimizer
        afresh."""
        own = dict(self.module.named_parameters())
        if set(params) != set(own):
            raise KeyError(f"parameters {sorted(own)} expected, got {sorted(params)}")
        with torch.no_grad():
            for name, p in own.items():
                value = torch.as_tensor(np.asarray(params[name]) if not isinstance(params[name], torch.Tensor)
                                        else params[name])
                if value.shape != p.shape:
                    raise ValueError(f"{name}: shape {tuple(value.shape)} given for {tuple(p.shape)}")
                p.copy_(value)
        self._reset_optimizer()

    @property
    def params(self) -> dict:
        """The parameters by name (detached)."""
        return {name: p.detach() for name, p in self.module.named_parameters()}

    def _reset_optimizer(self) -> None:
        if self.optimizer is not None:
            self.optimizer.state.clear()

    # ------------------------------------------------------------------
    def _device(self) -> Optional[torch.device]:
        p = next(self.module.parameters(), None)
        return None if p is None else p.device

    def _rows(self, x, axis: int = 0) -> Tuple[torch.Tensor, int, int]:
        """This rank's true rows of a batch along ``axis``, their count and
        the batch's: a DNDarray split along ``axis`` gives its own chunk;
        any other input (a DNDarray not split there, a tensor or an array,
        the whole batch on every rank) is cut in the canonical layout."""
        if isinstance(x, DNDarray) and x.split == axis:
            local, n = x.larray, x.shape[axis]
        else:
            if isinstance(x, DNDarray):
                full = x._dense()
            else:
                full = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
            n = full.shape[axis]
            local = full[self.comm.chunk(full.shape, axis)[2]]
        dev = self._device()
        return (local if dev is None else local.to(dev)), local.shape[axis], n

    def forward(self, x):
        """The module on a batch (heat's data_parallel.py:150): each rank
        runs its own rows.  A DNDarray split along the batch comes back
        split the same way, and a DNDarray carries no gradient; any other
        input comes back whole on every rank."""
        local, _, n = self._rows(x)
        out = self.module(local)
        if isinstance(x, DNDarray):
            out = out.detach()
        if isinstance(x, DNDarray) and x.split == 0:
            pad = self.comm.padded_extent(n) // self.comm.size - local.shape[0]
            if pad:
                out = torch.cat([out, out.new_zeros((pad,) + tuple(out.shape[1:]))])
            return x._like(out, gshape=(n,) + tuple(out.shape[1:]))
        counts = self.comm.counts_displs_shape((n,), 0)[0]
        full = torch.cat(self.comm.all_gather_varying(out, counts, axis=0)) if self.comm.size > 1 else out
        if isinstance(x, DNDarray):
            return DNDarray.from_dense(full, None, x.device, x.comm)
        return full

    # ------------------------------------------------------------------
    def _loss_and_grads(self, loss_fn: Callable, xl, yl, n_local: int, n: int, comm=None):
        """The batch's mean loss and the parameters' gradients, averaged
        across the ranks of ``comm`` (by default this instance's) by this
        instance's schedule."""
        comm = self.comm if comm is None else comm
        params = [p for p in self.module.parameters() if p.requires_grad]
        if n_local:
            # the rank's share of the batch's mean: summed over ranks, the mean
            local = loss_fn(self.module(xl), yl) * (n_local * comm.size / n)
            grads = torch.autograd.grad(local, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            local = local.detach().reshape(1)
        else:  # a rank with no rows of this batch adds nothing
            dev = self._device()
            local = torch.zeros(1, device=dev)
            grads = [torch.zeros_like(p) for p in params]
        if self.grad_reduction == "implicit":
            grads = [_mean_over_ranks(g, comm) for g in grads]
        else:
            grads = reduce_gradients(grads, comm, blocking=self.grad_reduction == "fused")
        return _mean_over_ranks(local, comm)[0], params, grads

    def value_and_grad(self, loss_fn: Callable, x, y) -> Tuple[torch.Tensor, dict]:
        """The mean loss over the batch and the cross-rank-averaged
        parameter gradients by name; the parameters are left as they are.
        ``loss_fn(pred, target)`` must reduce with a mean over the batch."""
        xl, n_local, n = self._rows(x)
        yl = self._rows(y)[0]
        loss, params, grads = self._loss_and_grads(loss_fn, xl, yl, n_local, n)
        names = {id(p): name for name, p in self.module.named_parameters()}
        return loss, {names[id(p)]: g for p, g in zip(params, grads)}

    def _step(self, loss_fn: Callable, xl, yl, n_local: int, n: int) -> torch.Tensor:
        loss, params, grads = self._loss_and_grads(loss_fn, xl, yl, n_local, n)
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss

    def step(self, loss_fn: Callable, x, y) -> float:
        """One train step: forward and backward of this rank's rows, the
        gradients averaged across ranks, one optimizer update (heat's hooks
        plus DataParallelOptimizer.step).  Returns the batch's mean loss."""
        if self.optimizer is None:
            raise RuntimeError("construct DataParallel with an optimizer to use step()")
        xl, n_local, n = self._rows(x)
        return float(self._step(loss_fn, xl, self._rows(y)[0], n_local, n))

    def train_steps(self, loss_fn: Callable, xs, ys) -> torch.Tensor:
        """The steps of a stack of batches, in order: ``xs[k]``, ``ys[k]``
        is step k's batch, split over the ranks as in :meth:`step`.  Returns
        the (n_steps,) losses, on the card where the parameters are, without
        waiting for them between steps."""
        if self.optimizer is None:
            raise RuntimeError("construct DataParallel with an optimizer to use train_steps()")
        (xl, n_local, n), yl = self._stage_stack(xs, ys)
        return torch.stack([self._step(loss_fn, xl[k], yl[k], n_local, n) for k in range(xl.shape[0])])

    def _stage_stack(self, xs, ys):
        """This rank's rows of each batch of an (n_steps, batch, ...) stack:
        ``((xs rows, their count, the batch), ys rows)``."""
        steps_x = xs.shape[0]
        steps_y = ys.shape[0]
        if steps_x != steps_y:
            raise ValueError(f"step axes disagree: xs has {steps_x} batches, ys {steps_y}")
        return self._rows(xs, axis=1), self._rows(ys, axis=1)[0]


class DataParallelMultiGPU(DataParallel):
    """Hierarchical data-parallel training (heat's data_parallel.py:313; the
    JAX package's heat_tpu/nn/data_parallel.py:497-624): node-local
    averaging every batch plus :class:`~heat_tpu_torch.optim.DASO`'s
    skipped, delayed cross-node averages.

    The batch of ``b`` rows is cut into ``n_node`` contiguous slabs (``b``
    must be divisible by the node count), and each node's slab is split
    over the node's ranks in the canonical layout.  Each rank holds its
    node's replica (the module): the gradient of the node's mean loss --
    the reference's ``vmap`` of ``value_and_grad`` over the node dimension
    -- is the rank-order mean of the ranks' weighted gradients over the
    ``'node'`` group (:func:`_mean_over_ranks`), then ``DASO.step``.

    Pass ``daso`` (built on a :class:`HierarchicalCommunication`), or an
    ``optimizer``, for which a DASO of one epoch without warm-up or
    cool-down is made.  Without either there is no :meth:`step`.
    """

    def __init__(self, module: torch.nn.Module, comm: Optional[Communication] = None, optimizer: Any = None,
                 daso: Any = None):
        from ..optim.dp_optimizer import DASO

        if daso is not None:
            # DASO owns the hierarchy: a conflicting comm would split the
            # batch on one grid and average on another
            if comm is not None and comm != daso.comm:
                raise ValueError("pass either comm or daso, not both: the DASO instance's communication defines the "
                                 "(node x local) grid")
            if not daso.hierarchical:
                raise ValueError("DataParallelMultiGPU requires a DASO built on a HierarchicalCommunication (e.g. "
                                 "DASO(..., comm=HierarchicalCommunication(grid=(n_node, per_node)))); a plain-comm "
                                 "DASO has no node axis to sync across")
            comm = daso.comm
        if not isinstance(comm, HierarchicalCommunication):
            comm = HierarchicalCommunication(group=None if comm is None else comm.group)
        if isinstance(optimizer, DataParallelOptimizer):
            optimizer = optimizer.optimizer
        super().__init__(module, comm=comm, optimizer=optimizer)
        if daso is None and optimizer is not None:
            daso = DASO(local_optimizer=optimizer, total_epochs=1, comm=comm, warmup_epochs=0, cooldown_epochs=0)
        self.daso = daso

    def _reset_optimizer(self) -> None:
        super()._reset_optimizer()
        daso = getattr(self, "daso", None)
        if daso is not None:
            daso.local_optimizer.optimizer.state.clear()
            daso._pending = None

    def _node_rows(self, x) -> Tuple[torch.Tensor, int, int]:
        """This rank's rows of its node's slab of a batch: ``(rows, their
        count, the slab's extent)``.  A DNDarray split along the batch whose
        chunks are the slabs' chunks gives its own (no communication)."""
        comm = self.comm
        n_node, per_node = comm.num_nodes, comm.node_size
        b = x.shape[0]
        if b % n_node:
            raise ValueError(f"batch {b} not divisible by {n_node} nodes")
        slab = b // n_node
        node, local = divmod(comm.rank, per_node)
        if isinstance(x, DNDarray) and x.split == 0 and slab % per_node == 0:
            rows = x.larray  # the canonical chunk is the node slab's chunk
        else:
            if isinstance(x, DNDarray):
                full = x._dense()
            else:
                full = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
            part = full.narrow(0, node * slab, slab)
            rows = part[comm.node_comm.chunk(part.shape, 0, rank=local)[2]]
        dev = self._device()
        return (rows if dev is None else rows.to(dev)), rows.shape[0], slab

    def step(self, loss_fn: Callable, x, y) -> float:
        """One hierarchical step: the node's mean-loss gradient averaged over
        the node's ranks, then :meth:`DASO.step`.  Returns the mean over the
        nodes of the nodes' losses, as the reference's."""
        if self.daso is None:
            raise RuntimeError("construct DataParallelMultiGPU with an optimizer or a DASO to use step()")
        xl, n_local, slab = self._node_rows(x)
        yl = self._node_rows(y)[0]
        loss, params, grads = self._loss_and_grads(loss_fn, xl, yl, n_local, slab, self.comm.node_comm)
        for p, g in zip(params, grads):
            p.grad = g
        self.daso.step()
        self.daso.zero_grad()
        return float(_mean_over_ranks(loss.reshape(1), self.comm.global_comm)[0])

    def train_steps(self, loss_fn: Callable, xs, ys):
        """Always raises: DASO's skipped and delayed global syncs are
        decided between steps (call :meth:`step` per batch, or use a plain
        DataParallel for a stack of steps)."""
        raise NotImplementedError("train_steps does not drive the DASO hierarchical sync protocol; call step() per "
                                  "batch (DASO decides syncs between steps), or use a plain DataParallel for "
                                  "scanned epochs")

    def collect_params(self) -> dict:
        """This rank's (its node's) parameters by name; after
        :meth:`DASO.last_batch` every node holds the same."""
        return self.daso.collect(self.params) if self.daso is not None else self.params
