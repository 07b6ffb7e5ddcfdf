"""Communication over ``torch.distributed`` (counterpart of heat_tpu/parallel/comm.py).

The port is SPMD: one process (rank) per card, and a :class:`Communication`
is a ``torch.distributed`` process group seen from one rank.  With no process
group initialised the world has one rank.

Canonical distribution (pad-and-mask), the same as the JAX package's: a
global shape ``g`` split along axis ``s`` over ``n`` ranks is padded along
``s`` to the next multiple of ``n`` and cut into equal chunks.  The real data
is a contiguous prefix and the padding a suffix owned by the highest ranks.
Each rank stores its padded chunk; anything that reduces or contracts across
the split axis masks the padding with its own neutral element first.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Communication", "WORLD", "get_comm", "sanitize_comm", "use_comm"]


class Communication:
    """One rank's view of a process group.

    ``size`` and ``rank`` may be given to describe a world without joining
    it: such a communicator answers the layout questions (``chunk``,
    ``lshape_map``, ``counts_displs_shape``) and refuses collectives."""

    def __init__(self, group=None, size: Optional[int] = None, rank: Optional[int] = None):
        if (size is None) != (rank is None):
            raise ValueError("give both size and rank, or neither")
        if size is not None and not 0 <= rank < size:
            raise ValueError(f"rank {rank} is outside a world of size {size}")
        self.group = group
        self._size = size
        self._rank = rank

    @property
    def size(self) -> int:
        """Number of ranks."""
        if self._size is not None:
            return self._size
        return dist.get_world_size(self.group) if dist.is_initialized() else 1

    @property
    def rank(self) -> int:
        """This process's rank."""
        if self._rank is not None:
            return self._rank
        return dist.get_rank(self.group) if dist.is_initialized() else 0

    def __repr__(self) -> str:
        return f"Communication(size={self.size}, rank={self.rank})"

    # ------------------------------------------------------------------
    # canonical layout (heat_tpu/parallel/comm.py:271-368)
    # ------------------------------------------------------------------
    def pad_amount(self, extent: int) -> int:
        """Padding needed to make ``extent`` divisible by ``size``."""
        return (-extent) % self.size

    def padded_extent(self, extent: int) -> int:
        return extent + self.pad_amount(extent)

    def chunk(
        self, shape: Sequence[int], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """``(offset, true local shape, slices)`` of one rank's block: every
        rank gets ``ceil(extent / size)`` rows, so the true local shape of
        the highest ranks may be smaller or zero."""
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        rank = self.rank if rank is None else rank
        extent = shape[split]
        per = self.padded_extent(extent) // self.size
        start = min(rank * per, extent)
        stop = min(start + per, extent)
        lshape = shape[:split] + (stop - start,) + shape[split + 1 :]
        slices = tuple(slice(start, stop) if d == split else slice(0, s) for d, s in enumerate(shape))
        return start, lshape, slices

    def lshape_map(self, shape: Sequence[int], split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of true local shapes, one row per rank."""
        shape = tuple(int(s) for s in shape)
        out = np.empty((self.size, max(len(shape), 1)), dtype=np.int64)
        for r in range(self.size):
            out[r, : len(shape)] = self.chunk(shape, split, rank=r)[1]
        return out[:, : len(shape)]

    def counts_displs_shape(
        self, shape: Sequence[int], axis: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
        """Counts and displacements along ``axis`` per rank, and this rank's
        true local shape."""
        counts, displs = [], []
        for r in range(self.size):
            off, lsh, _ = self.chunk(shape, axis, rank=r)
            counts.append(lsh[axis])
            displs.append(off)
        return tuple(counts), tuple(displs), tuple(self.chunk(shape, axis)[1])

    # ------------------------------------------------------------------
    # collectives: eager, on this rank's tensors
    # ------------------------------------------------------------------
    def _check_joined(self) -> None:
        if self._size is not None and self._size > 1:
            raise RuntimeError("this Communication only describes a world; it has joined no process group")

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size > 1:
            self._check_joined()
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over all ranks, in place; returns ``x``.  A tensor that
        takes part in a gradient (``requires_grad`` under grad mode) is
        summed out of place instead, and its gradient is the sum of the
        ranks' gradients, as ``jax.lax.psum`` transposes."""
        if self.size > 1 and torch.is_grad_enabled() and x.requires_grad:
            self._check_joined()
            return _PSum.apply(x, self)
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (all of one shape), concatenated along ``axis``
        in rank order."""
        if self.size == 1:
            return x
        self._check_joined()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=axis)

    def all_gather_varying(self, x: torch.Tensor, extents: Sequence[int], axis: int) -> List[torch.Tensor]:
        """Every rank's ``x``, in rank order, where rank r's extent along
        ``axis`` is ``extents[r]`` and all else is equal: each is padded to
        the largest extent for one equal-shape all-gather and cut back."""
        extents = [int(e) for e in extents]
        if len(extents) != self.size or x.shape[axis] != extents[self.rank]:
            raise ValueError(f"rank {self.rank} holds extent {x.shape[axis]}; extents are {extents}")
        pad = max(extents) - x.shape[axis]
        if pad:
            widths = list(x.shape)
            widths[axis] = pad
            x = torch.cat([x, x.new_zeros(widths)], dim=axis)
        if self.size == 1:
            return [x.narrow(axis, 0, extents[0])]
        self._check_joined()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return [p.narrow(axis, 0, e) for p, e in zip(parts, extents)]

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """The tiled all-to-all of ``jax.lax.all_to_all(..., tiled=True)``:
        ``x`` is cut into ``size`` equal blocks along ``split_axis``, block r
        goes to rank r, and the blocks received are concatenated along
        ``concat_axis`` in rank order.  A complex tensor travels as its real
        view.  Differentiable: the gradient goes back by the all-to-all with
        the two axes swapped."""
        size = self.size
        if x.shape[split_axis] % size:
            raise ValueError(f"all_to_all: extent {x.shape[split_axis]} of axis {split_axis} is not divisible by {size} ranks")
        if size == 1:
            return x
        self._check_joined()
        return _AllToAll.apply(x, self, split_axis % x.ndim, concat_axis % x.ndim)

    def _all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """The exchange itself, outside autograd (both axes non-negative)."""
        if x.is_complex():
            return torch.view_as_complex(self._all_to_all(torch.view_as_real(x), split_axis, concat_axis))
        parts = [p.contiguous() for p in torch.tensor_split(x, self.size, dim=split_axis)]
        got = [torch.empty_like(parts[0]) for _ in range(self.size)]
        dist.all_to_all(got, parts, group=self.group)
        return torch.cat(got, dim=concat_axis)

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute``: for each ``(src, dst)`` pair rank src sends
        its ``x`` to rank dst; a rank that is no pair's destination gets
        zeros.  Every rank passes the same ``perm``, with each rank at most
        once as a source and once as a destination.  Differentiable: the
        gradient goes back by the ppermute with every pair reversed (a
        rank that sent nothing gets a zero gradient)."""
        if self.size == 1:
            return x
        self._check_joined()
        perm = tuple((int(s), int(d)) for s, d in perm)
        return _PPermute.apply(x, self, perm)

    def _ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """The exchange itself, outside autograd."""
        rank = self.rank
        dst = [d for s, d in perm if s == rank]
        src = [s for s, d in perm if d == rank]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"rank {rank} appears more than once as a source or a destination in {perm}")
        x = x.contiguous()
        out = torch.zeros_like(x)
        if dst == [rank]:
            out.copy_(x)
            return out
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, x, self._global_rank(dst[0]), self.group))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, self._global_rank(src[0]), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def ring_shift(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Cyclic shift by ``shift`` ranks: rank i's ``x`` goes to rank
        ``(i + shift) % size`` (the ring of ring attention).  Its gradient
        goes back by ``ring_shift(-shift)``."""
        n = self.size
        return self.ppermute(x, [(i, (i + shift) % n) for i in range(n)])

    def _global_rank(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


class _PSum(torch.autograd.Function):
    """psum out of place; the gradient of every rank's sum is the sum of
    the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm._reduce(x.clone(), dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._reduce(g.clone(), dist.ReduceOp.SUM), None


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its transpose swaps the split and concat axes."""

    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return comm._all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return ctx.comm._all_to_all(g, concat_axis, split_axis), None, None, None


class _PPermute(torch.autograd.Function):
    """ppermute; its transpose sends back along every pair reversed."""

    @staticmethod
    def forward(ctx, x, comm, perm):
        ctx.comm, ctx.perm = comm, perm
        return comm._ppermute(x, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._ppermute(g, [(d, s) for s, d in ctx.perm]), None, None


WORLD = Communication()

__default_comm = WORLD


def get_comm() -> Communication:
    """The current default communication."""
    return __default_comm


def sanitize_comm(comm: Optional[Communication]) -> Communication:
    """Validate ``comm`` or return the default."""
    if comm is None:
        return get_comm()
    if not isinstance(comm, Communication):
        raise TypeError(f"Unknown communication, must be instance of Communication, got {type(comm)}")
    return comm


def use_comm(comm: Optional[Communication] = None) -> None:
    """Set the default communication."""
    global __default_comm
    __default_comm = sanitize_comm(comm)
